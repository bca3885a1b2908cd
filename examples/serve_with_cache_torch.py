"""Serve cached requests through the PyTorch/CUDA port: the compact
encoder embeds each query, the tiered ``CacheService`` looks it up with
the fused cascade kernel, misses are answered by the echo backend
(``engine=None``) and admitted.

    PYTHONPATH=src python examples/serve_with_cache_torch.py            # card
    PYTHONPATH=src python examples/serve_with_cache_torch.py \\
        --device cpu --reduced --queries 128 --batch 16                 # CPU

On a card the cascade runs the hand-written CUDA kernel; on the CPU the
same call runs its plain torch version.  The encoder is initialised from
``--seed`` at the config's widths (no published weights ship with the
repo), so its hit threshold is a property of that seed, not the paper's.
"""
import argparse
import time

from repro_torch.cache_service import CacheConfig, CacheService, TieringConfig
from repro_torch.configs import get_config
from repro_torch.core import EmbedderTrainer, FinetuneConfig
from repro_torch.data import HashTokenizer, make_query_stream
from repro_torch.obs import Telemetry
from repro_torch.serving import CachedLLMService


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size encoder (2 layers, d_model 128)")
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--threshold", type=float, default=0.999)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-op", action="store_true",
                    help="run the four-op cascade instead of the kernel")
    args = ap.parse_args()

    cfg = get_config("modernbert-149m")
    if args.reduced:
        cfg = cfg.reduced(vocab_size=4096)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    trainer = EmbedderTrainer(cfg, FinetuneConfig(max_len=32,
                                                  seed=args.seed),
                              device=args.device)
    telemetry = Telemetry()
    cache = CacheService(CacheConfig(
        dim=cfg.d_model, threshold=args.threshold, telemetry=telemetry,
        tiering=TieringConfig(fused=not args.four_op)), device=args.device)
    svc = CachedLLMService(trainer.make_embed_fn(tok), cache, None, tok)
    print(f"encoder {cfg.name} on {cache.device}; cascade "
          f"{'four-op' if args.four_op else 'fused kernel'}")

    texts = [q.text for q in make_query_stream("medical", args.queries,
                                               seed=11, repeat_frac=0.4)]
    t0 = time.perf_counter()
    for i in range(0, len(texts), args.batch):
        results = svc.handle(texts[i:i + args.batch], tenant=0)
        if i // args.batch < 3:
            for r in results[:2]:
                tag = "HIT " if r.cache_hit else "MISS"
                print(f"  [{tag}] {r.query[:60]!r}")
    wall = time.perf_counter() - t0

    st = svc.stats()
    bk = st["backend"]
    print(f"queries {st['requests']} in {wall:.2f} s: hits {st['hits']} "
          f"(hot {bk['traffic']['hot_hits']}, warm "
          f"{bk['traffic']['warm_hits']}), misses {st['misses']}, hit rate "
          f"{st['hit_rate']:.1%}")
    print(f"demotions {bk['tiers']['demotions']}, rebuilds "
          f"{bk['rebuild']['rebuilds']}, live responses "
          f"{bk['tiers']['live_responses']}")
    stage_h = telemetry.stage_histogram()
    for stage in ("embed", "plan", "generate", "commit"):
        agg = stage_h.aggregate(stage=stage)
        if agg.count:
            print(f"  stage {stage:<8} p50 {agg.quantile(0.5) * 1e3:8.3f} ms"
                  f"  mean {agg.mean * 1e3:8.3f} ms  x{agg.count}")


if __name__ == "__main__":
    main()
