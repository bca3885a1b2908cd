"""Serve cached requests through the PyTorch/CUDA port: the compact
encoder embeds each query, the tiered ``CacheService`` looks it up with
the fused cascade kernel (or, with ``--flat``, the paper's
``SemanticCache`` with the cosine top-k kernel), misses are answered by
the echo backend (``engine=None``) and admitted.

    PYTHONPATH=src python examples/serve_with_cache_torch.py            # card
    PYTHONPATH=src python examples/serve_with_cache_torch.py \\
        --device cpu --reduced --queries 128 --batch 16                 # CPU
    PYTHONPATH=src python examples/serve_with_cache_torch.py \\
        --device cpu --reduced --finetune --flat --threshold 0.95       # CPU
    PYTHONPATH=src python examples/serve_with_cache_torch.py \\
        --device cpu --reduced --ensemble 3 --learned-admission         # CPU

``--ensemble E`` serves E embedders through the fused ensemble cascade:
the (optionally fine-tuned) encoder is the pilot panel, panels 1..E-1
are random-projection embedders (seeds 101, 102, ...), as the
reference's ``launch/serve.py``; ``--learned-admission`` learns each
tenant's threshold (and, under an ensemble, its mixture weights) from
the feedback stream.  On a card the lookups run the hand-written CUDA
kernels; on the CPU the same calls run their plain torch versions.  The
encoder is initialised from ``--seed`` at the config's widths (no
published weights ship with the repo); ``--finetune`` first fine-tunes
it on medical pairs (the paper's recipe at the published widths; at
``--reduced`` size the reference example's two epochs at lr 5e-4).  The
hit threshold is a property of those weights, not the paper's.
"""
import argparse
import time

import numpy as np

from repro_torch.cache_service import (
    CacheConfig, CacheService, EnsembleConfig, LearningConfig, TieringConfig,
)
from repro_torch.configs import get_config
from repro_torch.core import (
    EmbedderTrainer, FinetuneConfig, RandomProjectionEmbedder, SemanticCache,
)
from repro_torch.data import HashTokenizer, make_pair_dataset, make_query_stream
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
    ap.add_argument("--finetune", action="store_true",
                    help="fine-tune the encoder on medical pairs first")
    ap.add_argument("--flat", action="store_true",
                    help="the paper's flat SemanticCache (capacity 4096) "
                         "instead of the tiered CacheService")
    ap.add_argument("--ensemble", type=int, default=0, metavar="E",
                    help="serve E embedders through the fused ensemble "
                         "cascade: the encoder is the pilot, panels "
                         "1..E-1 are random-projection embedders")
    ap.add_argument("--learned-admission", action="store_true",
                    help="learn per-tenant thresholds (and ensemble "
                         "mixture weights) from the feedback stream")
    args = ap.parse_args()
    if args.flat and (args.four_op or args.ensemble
                      or args.learned_admission):
        ap.error("--four-op, --ensemble and --learned-admission select "
                 "the tiered cache; drop --flat")

    cfg = get_config("modernbert-149m")
    if args.reduced:
        cfg = cfg.reduced(vocab_size=4096)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    ft = FinetuneConfig(max_len=32, seed=args.seed)
    if args.reduced:
        ft = FinetuneConfig(epochs=2, batch_size=32, lr=5e-4, max_len=32,
                            margin=0.7, seed=args.seed)
    trainer = EmbedderTrainer(cfg, ft, device=args.device)
    if args.finetune:
        out = trainer.fit(make_pair_dataset("medical", 1024, seed=0), tok)
        print(f"fine-tuned the encoder: {out['steps']} steps in "
              f"{out['train_seconds']:.1f} s")
    telemetry = Telemetry()
    if args.flat:
        cache = SemanticCache(capacity=4096, dim=cfg.d_model,
                              threshold=args.threshold, telemetry=telemetry,
                              device=args.device)
    else:
        cache = CacheService(CacheConfig(
            dim=cfg.d_model, threshold=args.threshold, telemetry=telemetry,
            tiering=TieringConfig(fused=not args.four_op),
            learning=LearningConfig(
                learned_admission=args.learned_admission),
            ensemble=EnsembleConfig(embedders=args.ensemble or None)),
            device=args.device)
    embed_fn = trainer.make_embed_fn(tok)
    if args.ensemble:
        extras = [RandomProjectionEmbedder(dim=cfg.d_model, seed=101 + e)
                  for e in range(args.ensemble - 1)]
        pilot_fn = embed_fn

        def embed_fn(texts):
            return np.stack([pilot_fn(texts)]
                            + [e.embed(texts) for e in extras], axis=1)
    svc = CachedLLMService(embed_fn, cache, None, tok)
    path = ("flat SemanticCache" if args.flat else "four-op cascade"
            if args.four_op else "fused cascade kernel")
    if args.ensemble:
        path += f", ensemble of {args.ensemble} embedders"
    if args.learned_admission:
        path += ", learned admission"
    print(f"encoder {cfg.name} on {cache.device}; {path}")

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
    print(f"queries {st['requests']} in {wall:.2f} s: hits {st['hits']}, "
          f"misses {st['misses']}, hit rate {st['hit_rate']:.1%}")
    if args.flat:
        print(f"flat store occupancy {bk['occupancy']:.4f}, live "
              f"responses {bk['live_responses']}")
    else:
        print(f"hot hits {bk['traffic']['hot_hits']}, warm hits "
              f"{bk['traffic']['warm_hits']}; demotions "
              f"{bk['tiers']['demotions']}, rebuilds "
              f"{bk['rebuild']['rebuilds']}, live responses "
              f"{bk['tiers']['live_responses']}")
        lrn = bk["learning"]
        if lrn:
            print(f"feedback events {lrn['feedback_events']} "
                  f"({lrn['duplicate_events']} duplicates), threshold "
                  f"refits {lrn['refits_applied']}, weight refits "
                  f"{lrn['weight_refits_applied']}; published "
                  f"{lrn['learned_policies']} "
                  f"{lrn.get('ensemble_weights', '')}")
    stage_h = telemetry.stage_histogram()
    for stage in ("embed", "plan", "generate", "commit"):
        agg = stage_h.aggregate(stage=stage)
        if agg.count:
            print(f"  stage {stage:<8} p50 {agg.quantile(0.5) * 1e3:8.3f} ms"
                  f"  mean {agg.mean * 1e3:8.3f} ms  x{agg.count}")


if __name__ == "__main__":
    main()
