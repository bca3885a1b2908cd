"""Serving launcher: batched generation for a decoder config, with an
optional semantic cache in front (the paper's deployment) — the port of
`repro/launch/serve.py` for the options the port has.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b --requests 32 --batch 8 --cache      # card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --cache --requests 16 --batch 8 --max-new-tokens 4         # CPU

``--arch`` takes any decoder config of the registry (the ten assigned
archs: attention with dense or MoE FFNs, Jamba's Mamba hybrid, xLSTM,
MusicGen and Pixtral, whose frontends the launcher does not pass, as
the reference's does not).  ``--smoke`` is on, as in the reference (it
cannot be turned off): the decoder and the encoder run at their reduced
sizes.  The full-width decoders are driven by ``chip_smoke.py`` through
the library's entry points.  ``--tiered`` swaps the flat SemanticCache
for the tiered CacheService; ``--warm-dtype int8`` scans the warm panel from its
quantized form, ``--learned-admission`` learns the per-tenant operating
points online (DESIGN.md §9), ``--warm-block N`` is accepted as in the
reference and changes nothing (a TPU streaming knob with no counterpart
in the CUDA kernel), ``--ensemble E`` serves E embedders
through the fused ensemble cascade (the fine-tuned embedder as the
pilot, random-projection panels beside it; §13), ``--ttl`` stamps a
default TTL on admitted entries (§14.2), ``--conformal`` floors each
tenant's threshold at a recency-window quantile of its audited
negatives (§14.3), ``--cold-capacity N`` puts a host-RAM cold tier
of N rows behind the warm ring (§12) and ``--learned-embedder``
refreshes the embedder online from the serving stream (§11; the
reference's smoke-scale policy, so the refresh trips inside a short
stream).  ``--cache-shards N`` shards the warm tier over a
``model``-axis mesh of N ranks (DESIGN.md §8): under ``torchrun
--nproc-per-node N`` each rank serves its own shard of the same stream
and only rank 0 prints and writes telemetry; as a single process the
mesh has one rank, so one shard serves.  ``--metrics-json PATH`` dumps
the telemetry registry as JSON-lines after the run, and
``--metrics-interval N`` every N batches too.

The prompts of cache misses are encoded with a tokenizer of the
*decoder's* vocab, not the encoder's: the encoder's ids would fall
outside the decoder's embedding table.  ``--scenario``, which the port
lacks, is refused with the slice that brings it.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import EmbedderTrainer, FinetuneConfig, SemanticCache
from repro_torch.data import HashTokenizer, make_pair_dataset, make_query_stream
from repro_torch.launch.mesh import make_cache_mesh
from repro_torch.models import LM
from repro_torch.obs import Telemetry, write_jsonl
from repro_torch.serving import CachedLLMService, ServeEngine

# reference options the port does not run yet, with the slice that brings
# each (ROADMAP.md queue A)
_NOT_PORTED = {
    "scenario": ("--scenario", "the benchmarks slice"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--cache", action="store_true")
    ap.add_argument("--threshold", type=float, default=0.93)
    ap.add_argument("--tiered", action="store_true",
                    help="tiered CacheService instead of the flat "
                         "SemanticCache")
    ap.add_argument("--warm-dtype", choices=("float32", "int8"),
                    default="float32",
                    help="warm-panel scan precision (implies --tiered)")
    ap.add_argument("--learned-admission", action="store_true",
                    help="learn per-tenant thresholds online (implies "
                         "--tiered)")
    ap.add_argument("--ensemble", type=int, default=0, metavar="E",
                    help="serve E embedders through the fused ensemble "
                         "cascade (implies --tiered)")
    ap.add_argument("--ttl", type=float, default=0.0, metavar="SECONDS",
                    help="default TTL of admitted entries (0 = never "
                         "expire; implies --tiered)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the telemetry registry as JSON-lines after "
                         "the run (requires --cache)")
    ap.add_argument("--metrics-interval", type=int, default=0, metavar="N",
                    help="with --metrics-json: also a snapshot every N "
                         "batches")
    ap.add_argument("--cache-shards", type=int, default=0,
                    help="shard the warm tier over a model-axis mesh of "
                         "N ranks (0 = unsharded; implies --tiered)")
    ap.add_argument("--cold-capacity", type=int, default=0,
                    help="host-RAM cold-tier rows behind the warm ring "
                         "(0 = no cold tier; DESIGN.md §12; implies "
                         "--tiered)")
    ap.add_argument("--warm-block", type=int, default=0,
                    help="the reference's warm-panel streaming block "
                         "(rows; implies --tiered).  Accepted for the "
                         "reference's command line: it does not change "
                         "results, and the CUDA kernel has no counterpart "
                         "(it stages rows in its own tiles)")
    ap.add_argument("--learned-embedder", action="store_true",
                    help="refresh the embedder online: one-epoch "
                         "contrastive fine-tunes on pooled serving pairs, "
                         "gated, re-embedded and hot-swapped (DESIGN.md "
                         "§11; implies --tiered)")
    ap.add_argument("--conformal", action="store_true",
                    help="per-tenant split-conformal hit calibration: "
                         "serve only above a recency-window quantile of "
                         "observed negative scores (DESIGN.md §14.3; "
                         "implies --tiered)")
    ap.add_argument("--scenario", default=None)
    args = ap.parse_args(argv)
    for dest, (flag, slice_name) in _NOT_PORTED.items():
        if getattr(args, dest):
            ap.error(f"{flag} is not supported by the PyTorch port yet; it "
                     f"arrives with {slice_name} (ROADMAP.md queue A)")
    if args.metrics_json and not args.cache:
        ap.error("--metrics-json instruments the cached serving path; "
                 "add --cache")
    if args.cache_shards or args.warm_dtype != "float32" \
            or args.learned_admission or args.learned_embedder \
            or args.ensemble or args.ttl or args.warm_block \
            or args.cold_capacity or args.conformal:
        args.tiered = True
    if args.cold_capacity and args.cache_shards:
        ap.error("--cold-capacity needs the unsharded warm ring; drop "
                 "--cache-shards (DESIGN.md §12)")
    if args.ensemble == 1:
        ap.error("--ensemble needs E >= 2 (a single embedder is the "
                 "default cascade)")
    if args.ensemble and args.learned_embedder:
        ap.error("--ensemble and --learned-embedder are exclusive: the "
                 "§11 refresh re-embeds one key panel, the §13 ensemble "
                 "serves several (swap panels via publish_panel instead)")
    return args


def _rank() -> int:
    """This process's rank: the group's, or ``torchrun``'s before the
    group starts (0 for a single process)."""
    return dist.get_rank() if dist.is_initialized() \
        else int(os.environ.get("RANK", 0))


def _say(*a, **kw) -> None:
    """Print on rank 0 only."""
    if _rank() == 0:
        print(*a, **kw)


def make_cache(args, dim: int, telemetry: Telemetry, trainer=None,
               tok=None, mesh=None):
    """The flat or tiered cache the flags ask for; ``--learned-embedder``
    needs the embedder's ``trainer`` and ``tok``, ``--cache-shards`` the
    ``mesh`` (`launch.mesh.make_cache_mesh`)."""
    if not args.tiered:
        return SemanticCache(capacity=4096, dim=dim,
                             threshold=args.threshold, telemetry=telemetry,
                             device=args.device)
    from repro_torch.cache_service import (
        CacheConfig, CacheService, EmbedderRefreshPolicy, EnsembleConfig,
        LearningConfig, ShardingConfig, StalenessConfig, TieringConfig,
    )
    # smoke-scale refresh policy: trip the trigger inside a short
    # stream, backfill thin splits from the medical grammar (§11)
    refresh = EmbedderRefreshPolicy(
        min_pairs=24, min_class=4, refresh_interval=32,
        synth_domain="medical", synth_min_pairs=128, recalibrate=True,
    ) if args.learned_embedder else None
    cache = CacheService(CacheConfig(
        dim=dim, threshold=args.threshold, telemetry=telemetry,
        tiering=TieringConfig(hot_capacity=512, warm_capacity=4096,
                              n_clusters=32, bucket=256,
                              warm_dtype=args.warm_dtype,
                              warm_block=args.warm_block or None,
                              cold_capacity=args.cold_capacity),
        sharding=ShardingConfig(mesh=mesh),
        learning=LearningConfig(
            learned_admission=args.learned_admission,
            conformal=args.conformal,
            learned_embedder=args.learned_embedder,
            embedder_trainer=trainer if args.learned_embedder else None,
            embedder_tokenizer=tok if args.learned_embedder else None,
            refresh_policy=refresh),
        ensemble=EnsembleConfig(embedders=args.ensemble or None),
        staleness=StalenessConfig(default_ttl=args.ttl or None)),
        device=args.device)
    caps = cache.capabilities()
    _say(f"tiered cache: warm shards "
         f"{cache.warm_shards if caps.warm_sharded else 0}, warm dtype "
         f"{caps.warm_dtype}, learned admission "
          f"{'on' if caps.learned_admission else 'off'}, learned embedder "
          f"{'on' if caps.learned_embedder else 'off'}, cold tier "
          f"{args.cold_capacity if caps.cold_tier else 0} rows, ensemble "
          f"{f'E={caps.ensemble}' if caps.ensemble else 'off'}, ttl "
          f"{args.ttl or 'off'}, conformal "
          f"{'on' if caps.conformal else 'off'}")
    return cache


def main(argv=None):
    args = parse_args(argv)
    # the mesh first: under torchrun it starts the group and takes this
    # rank's card, where the models below are built
    mesh = make_cache_mesh(args.cache_shards, device=args.device) \
        if args.cache_shards else None
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    engine = ServeEngine(LM(cfg, seed=0, device=args.device), max_len=64)
    _say(f"serving {cfg.name} ({cfg.param_count():,} params) on "
          f"{engine.model.device}")

    if not args.cache:
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for i in range(0, args.requests, args.batch):
            prompts = rng.integers(0, cfg.vocab_size,
                                   (args.batch, 16)).astype(np.int32)
            res = engine.generate(prompts, args.max_new_tokens)
            _say(f"batch {i // args.batch}: generated "
                  f"{res.tokens.shape[1]} tokens x {res.tokens.shape[0]}")
        _say(f"total {time.perf_counter() - t0:.1f}s")
        return

    enc_cfg = get_config("modernbert-149m").reduced(vocab_size=4096)
    tok = HashTokenizer(vocab_size=enc_cfg.vocab_size)
    trainer = EmbedderTrainer(enc_cfg, FinetuneConfig(
        epochs=1, batch_size=32, lr=5e-4, max_len=24), device=args.device)
    trainer.fit(make_pair_dataset("medical", 512, seed=0), tok)
    telemetry = Telemetry()
    cache = make_cache(args, enc_cfg.d_model, telemetry, trainer, tok, mesh)
    if dist.is_initialized() and dist.get_world_size() > 1:
        # the ranks' lookups merge collectively, but miss coalescing
        # reads each rank's own embeddings: serve from rank 0's encoder
        for p in trainer.model.parameters():
            dist.broadcast(p.data, 0)
    embed_fn = trainer.make_embed_fn(tok)
    if args.ensemble:
        from repro_torch.core import RandomProjectionEmbedder
        extras = [RandomProjectionEmbedder(dim=enc_cfg.d_model, seed=101 + e)
                  for e in range(args.ensemble - 1)]
        pilot_fn = embed_fn

        def embed_fn(texts):
            panels = [pilot_fn(texts)] + [np.asarray(e.embed(texts))
                                          for e in extras]
            return np.stack(panels, axis=1)        # (B, E, D)
    svc = CachedLLMService(embed_fn, cache, engine,
                           HashTokenizer(vocab_size=cfg.vocab_size),
                           max_new_tokens=args.max_new_tokens)

    def dump_metrics(batch_idx, append):
        if _rank() != 0:
            return
        write_jsonl(args.metrics_json, telemetry.registry.snapshot(),
                    meta={"arch": cfg.name, "batch": batch_idx,
                          "tiered": args.tiered}, append=append)

    stream = [q.text for q in make_query_stream("medical", args.requests,
                                                seed=1, repeat_frac=0.4)]
    t0 = time.perf_counter()
    wrote = False
    for i in range(0, len(stream), args.batch):
        svc.handle(stream[i:i + args.batch])
        b = i // args.batch
        if args.metrics_json and args.metrics_interval \
                and (b + 1) % args.metrics_interval == 0:
            dump_metrics(b, append=wrote)
            wrote = True
    cache.maintenance(block=True)     # final idle tick: drain SLO gauges
    st = svc.stats()
    _say(f"{args.requests} requests in {time.perf_counter() - t0:.1f}s; "
          f"hit rate {svc.hit_rate:.1%} ({st['hits']} LLM calls saved, "
          f"{st['generations']} generations)")
    stage_h = telemetry.stage_histogram()
    for stage in ("embed", "plan", "cold_fetch", "generate", "commit",
                  "maintenance"):
        agg = stage_h.aggregate(stage=stage)
        if agg.count:
            _say(f"  stage {stage:<12} p50 {agg.quantile(0.5) * 1e3:7.2f} "
                  f"ms  mean {agg.mean * 1e3:7.2f} ms  x{agg.count}")
    if args.cold_capacity:
        cd = cache.stats_snapshot().tiers["cold"]
        _say(f"cold tier: {cd['cold_rows']} rows "
              f"({cd['cold_occupancy']:.0%} of {args.cold_capacity}), "
              f"{cd['cold_hits']} hits from {cd['cold_fetches']} fetches "
              f"({cd['cold_fetched_rows']} rows shipped, "
              f"{cd['cold_router_skips']} router skips); "
              f"{cd['cold_promoted']} promoted back to warm, "
              f"{cd['cold_dropped']} final drops")
    if args.ensemble:
        ws = cache.policies.weights_state()
        _say(f"ensemble: {cache.capabilities().ensemble} embedders, "
              f"{len(ws)} tenant(s) with learned mixture weights")
    if args.learned_admission:
        lrn = st["backend"]["learning"]
        _say(f"learned admission: {lrn['refits_applied']} refits from "
              f"{lrn['feedback_events']} events "
              f"({lrn['duplicate_events']} duplicates, "
              f"{lrn['wasted_admissions']} wasted admissions); "
              f"policies {lrn['learned_policies']}")
    if args.learned_embedder:
        rf = st["backend"]["refresh"]
        _say(f"learned embedder: version {rf['embed_version']} "
              f"({rf['refreshes_published']} published, "
              f"{rf['refreshes_rolled_back']} rolled back from "
              f"{rf['refreshes_started']} started; "
              f"{rf['pairs_held']} pairs pooled, "
              f"{rf['stale_version_commits']} stale-version commits; "
              f"recalibrated threshold "
              f"{rf['recalibrated_threshold']})")
    if args.ttl:
        stl = cache.stats_snapshot().tiers["staleness"]
        _say(f"ttl: {stl['ttl_stamped']} stamped, "
              f"{stl['expired_masked']} masked at plan time, "
              f"{stl['expired_reaped']} reaped")
    if args.conformal:
        cs = cache.stats_snapshot().learning["conformal"]
        _say(f"conformal: {cs['hit_audits']} hit audits "
              f"({cs['audited_false_hits']} false), "
              f"{len(cs['tenants'])} tenant window(s)")
    if args.metrics_json:
        dump_metrics(args.requests // args.batch, append=wrote)
        _say(f"metrics -> {args.metrics_json}")
    return svc


if __name__ == "__main__":
    main()
