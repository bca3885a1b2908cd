#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card (the kernels target Hopper, ``sm_90a``) and
``nvcc``.  Exits non-zero, printing no result, when CUDA is unavailable
or the port is not beside the script.  Phases, each fatal on failure:

1. build every CUDA kernel of the serving path from the checkout's
   sources (one ``nvcc`` per source, all started together);
2. kernel parity at the serving shapes (``TieringConfig`` defaults:
   D=768, Q=64, Nh=1024, warm ring 16384, K=64, bucket=256, n_probe=8,
   tail = flush_size * rebuild_every = 256) on a populated hot tier and
   a wrapped warm ring with a real IVF rebuild, several tenants,
   invalid rows and an unindexed tail: the kernel against its plain
   torch version on the same CUDA tensors, fp32 and int8, k in {1, 4};
   ints and flags equal, scores within ``SCORE_ATOL``; both timed with
   CUDA events (median of repeats after warm-up);
3. serving: the full-width ``modernbert-149m`` encoder (seeded random
   weights) behind ``CacheService(fused=True)`` and
   ``CachedLLMService(engine=None)``, a 4096-query medical trace in
   batches of 64; the kernel's launch count must equal the plan count,
   with hits, misses and at least one flush + IVF rebuild; the final
   tiers are re-queried fused and four-op, which must agree.

Prints the card's name and power limit, the stage latencies, a JSON
line of per-kernel numbers and, last, ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SCORE_ATOL = 1e-5          # fp32 sums in another order (~1e-7 observed)
SHAPES = dict(D=768, Q=64, Nh=1024, cap=16384, K=64, bucket=256,
              n_probe=8, tail=256)
N_REQUESTS = 4096
BATCH = 64
# The encoder is random-init (no published weights in the repo), so its
# scores cannot tell a paraphrase from an unrelated query.  On the card
# (encoder seed 0, this trace) the largest score between two different
# texts is 0.9941 and the smallest between two equal texts 0.999999:
# 0.999 serves exact repeats only, with no false hit (PERF.md).
THRESHOLD = 0.999
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median per-call device time over ``reps`` runs of ``iters``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


# ---------------------------------------------------------------------------
# phase 2: kernel parity at serving shapes
# ---------------------------------------------------------------------------

def build_states(dev, seed: int = 0):
    """A populated hot tier, a wrapped warm ring with a rebuilt IVF and
    an unindexed tail, and a query batch — on the card."""
    import torch
    from repro_torch.cache_service import tiers
    s = SHAPES
    D, Nh, cap = s["D"], s["Nh"], s["cap"]
    g = torch.Generator(device=dev).manual_seed(seed)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    centres = unit(torch.randn(512, D, generator=g, device=dev))

    def rows(n, noise=0.03):
        c = torch.randint(0, 512, (n,), generator=g, device=dev)
        return unit(centres[c] + noise * torch.randn(n, D, generator=g,
                                                     device=dev))

    def tenants(n):
        return torch.randint(0, 4, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    hot = tiers.init_hot(Nh, D, dev)
    hot, _ = tiers.hot_insert_batch(
        hot, rows(Nh), torch.arange(Nh, device=dev, dtype=torch.int32),
        tenants(Nh))
    hot = hot._replace(valid=hot.valid & (torch.rand(
        Nh, generator=g, device=dev) > 0.2))
    warm = tiers.init_warm(cap, D, s["K"], s["bucket"], dev)
    vid = 10_000
    flush = 256

    def append(warm, n):
        nonlocal vid
        dem = tiers.Demoted(
            keys=rows(n), tenants=tenants(n),
            value_ids=torch.arange(vid, vid + n, device=dev,
                                   dtype=torch.int32),
            mask=torch.ones(n, dtype=torch.bool, device=dev))
        vid += n
        return tiers.warm_append(warm, dem)[0]

    for _ in range((cap + 4096) // flush):         # wraps: cursor 4096
        warm = append(warm, flush)
    warm = tiers.warm_rebuild(warm, iters=4, seed=seed)
    warm = append(warm, 200)                        # the unindexed tail
    warm = warm._replace(valid=warm.valid & (torch.rand(
        cap, generator=g, device=dev) > 0.1))
    # queries: paraphrase-like copies of live warm rows (tail rows
    # included) and hot rows, under the row's tenant, plus fresh rows
    Q = s["Q"]
    live_w = torch.nonzero(warm.valid).squeeze(1)
    tail_w = (int(warm.cursor) - 1 - torch.arange(150, device=dev)) % cap
    src_w = torch.cat([live_w[torch.randint(0, len(live_w), (Q // 2 - 8,),
                                            generator=g, device=dev)],
                       tail_w[:8]])
    live_h = torch.nonzero(hot.valid).squeeze(1)
    src_h = live_h[torch.randint(0, len(live_h), (Q // 4,), generator=g,
                                 device=dev)]
    n_new = Q - len(src_w) - len(src_h)
    q = torch.cat([warm.keys[src_w], hot.keys[src_h], rows(n_new)])
    q = unit(q + 0.015 * torch.randn(Q, D, generator=g, device=dev))
    qt = torch.cat([warm.tenants[src_w], hot.tenants[src_h],
                    tenants(n_new)])
    thr = 0.6 + 0.35 * torch.rand(Q, generator=g, device=dev)
    return hot, tiers.requantize(warm), q.contiguous(), qt, thr


def lookup_args(hot, warm, q, qt, thr):
    return (q, qt, thr, hot.keys, hot.valid, hot.tenants, hot.value_ids,
            warm.keys, warm.valid, warm.tenants, warm.value_ids,
            warm.write_seq, warm.centroids, warm.members, warm.cursor,
            warm.indexed_total, warm.keys_q, warm.scales)


def compare(a, b, what: str) -> float:
    """Ints and flags equal, scores within SCORE_ATOL; returns max
    |score difference|."""
    import torch
    names = ("scores", "value_ids", "warm_slots", "hot_slots", "hot_hit",
             "hit")
    err = 0.0
    for name, x, y in zip(names, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"{what}: {name} {tuple(y.shape)}/{y.dtype} vs plain "
                 f"{tuple(x.shape)}/{x.dtype}")
        if name == "scores":
            if not torch.isfinite(y).all():
                fail(f"{what}: non-finite scores")
            err = float((x - y).abs().max())
            if err > SCORE_ATOL:
                fail(f"{what}: max |score diff| {err:.3g} > {SCORE_ATOL}")
        elif not torch.equal(x, y):
            n = int((x != y).sum())
            fail(f"{what}: {name} differs in {n} entries")
    return err


def work_bound_ms(hot, warm, q, qt, k: int, quantized: bool):
    """Least time for one lookup on this card, and what bounds it: the
    bytes this run's inputs make the lookup read (each needed row once)
    and write, over HBM bandwidth, vs its fp32 dot products over the
    fp32 rate."""
    import torch
    from repro_torch.kernels.cascade_lookup.ref import topk_stable
    s = SHAPES
    Q, D, tail, bucket = s["Q"], s["D"], s["tail"], s["bucket"]
    cap = warm.valid.shape[0]
    K = warm.members.shape[0]
    hot_ok = hot.valid[None] & (hot.tenants[None] == qt[:, None])
    _, probes = topk_stable(q @ warm.centroids.T, min(s["n_probe"], K))
    cand = warm.members[probes].reshape(Q, -1)
    offs = torch.arange(tail, device=q.device)
    tail_idx = (warm.cursor - 1 - offs) % cap
    tail_cand = torch.where(warm.write_seq[tail_idx] > warm.indexed_total,
                            tail_idx, -1)
    cand = torch.cat([cand, tail_cand[None].expand(Q, tail)], 1).long()
    is_tail = torch.zeros_like(cand, dtype=torch.bool)
    is_tail[:, -tail:] = True
    safe = cand.clamp(0, cap - 1)
    ok = (cand >= 0) & warm.valid[safe] \
        & (warm.tenants[safe] == qt[:, None]) \
        & (is_tail | (warm.write_seq[safe] <= warm.indexed_total))
    row_bytes = (D + 4) if quantized else 4 * D
    n_bytes = (
        Q * (4 * D + 8)                                   # q, tenant, thr
        + hot.valid.shape[0] * 5                          # valid, tenant
        + int(hot_ok.any(0).sum()) * 4 * D                # live hot rows
        + K * 4 * D                                       # centroids
        + int(torch.unique(probes).numel()) * bucket * 4  # probed lists
        + tail * 4                                        # tail write_seq
        + int(torch.unique(cand[cand >= 0]).numel()) * 9  # valid/ten/seq
        + int(torch.unique(safe[ok]).numel()) * row_bytes  # scored rows
        + Q * k * 12 + Q * 6)                             # outputs
    flops = 2 * D * (int(hot_ok.sum()) + Q * K + int(ok.sum()))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    print(f"  work at k={k} ({'int8' if quantized else 'fp32'}): "
          f"{n_bytes / 1e6:.3f} MB unique bytes, {flops / 1e6:.1f} MFLOP")
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(dev):
    import torch
    from repro_torch.kernels.cascade_lookup import ops, ref
    hot, warm, q, qt, thr = build_states(dev)
    args = lookup_args(hot, warm, q, qt, thr)
    s = SHAPES
    kw = dict(n_probe=s["n_probe"], tail=s["tail"])
    out = {"max_abs_err": 0.0}
    for quantized in (False, True):
        for k in (1, 4):
            a = ref.cascade_lookup(*args, k=k, quantized=quantized, **kw)
            b = ops.cascade_lookup(*args, k=k, quantized=quantized, **kw)
            torch.cuda.synchronize()
            err = compare(a, b, f"cascade_lookup quantized={quantized} "
                                f"k={k}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            tag = "int8" if quantized else "fp32"
            print(f"  parity {tag} k={k}: ints/flags equal, max |dscore| "
                  f"{err:.3g}; hits {int(b[5].sum())}/{s['Q']} "
                  f"(hot {int(b[4].sum())})")
        tag = "int8_" if quantized else ""
        out[f"{tag}ms"] = cuda_ms(lambda: ops.cascade_lookup(
            *args, k=1, quantized=quantized, **kw))
        out[f"{tag}plain_ms"] = cuda_ms(lambda: ref.cascade_lookup(
            *args, k=1, quantized=quantized, **kw), iters=5)
        out[f"{tag}bound_ms"], out[f"{tag}bound_by"] = work_bound_ms(
            hot, warm, q, qt, 1, quantized)
        print(f"  {tag or 'fp32_'}k=1: kernel {out[f'{tag}ms']:.4f} ms, "
              f"plain {out[f'{tag}plain_ms']:.4f} ms, bound "
              f"{out[f'{tag}bound_ms']:.4f} ms ({out[f'{tag}bound_by']})")
    return out


# ---------------------------------------------------------------------------
# phase 3: serving through the port's entry points
# ---------------------------------------------------------------------------

def serving_phase(dev):
    import numpy as np
    import torch
    from repro_torch.cache_service import (
        CacheConfig, CacheService, TieringConfig, tiers,
    )
    from repro_torch.configs import get_config
    from repro_torch.core import EmbedderTrainer, FinetuneConfig
    from repro_torch.data import HashTokenizer, make_query_stream
    from repro_torch.kernels.cascade_lookup import kernel
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.serving import CachedLLMService

    cfg = get_config("modernbert-149m")
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
              cfg.vocab_size, cfg.dtype)
    if widths != (22, 768, 12, 1152, 50368, "bfloat16"):
        fail(f"modernbert-149m is not at its published widths: {widths}")
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    t0 = time.perf_counter()
    trainer = EmbedderTrainer(cfg, FinetuneConfig(max_len=32, seed=0),
                              device=dev)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    telemetry = Telemetry(tracer=Tracer(keep=N_REQUESTS))
    cache = CacheService(CacheConfig(
        dim=cfg.d_model, threshold=THRESHOLD, telemetry=telemetry,
        tiering=TieringConfig(fused=True)), device=dev)
    svc = CachedLLMService(trainer.make_embed_fn(tok), cache, None, tok)
    stream = make_query_stream("medical", N_REQUESTS, seed=11,
                               repeat_frac=0.4)
    texts = [x.text for x in stream]
    print(f"  encoder {cfg.name}: {n_params:,} params, built in "
          f"{time.perf_counter() - t0:.1f} s")

    kernel.COUNTS["cascade_lookup"] = 0
    t0 = time.perf_counter()
    served = []
    for i in range(0, N_REQUESTS, BATCH):
        served += svc.handle(texts[i:i + BATCH], tenant=0)
    wall = time.perf_counter() - t0
    launches = kernel.COUNTS["cascade_lookup"]

    st = svc.stats()
    bk = st["backend"]
    plans = bk["traffic"]["plans"]
    print(f"  served {len(served)} requests in {wall:.2f} s: hits "
          f"{st['hits']} (hot {bk['traffic']['hot_hits']}, warm "
          f"{bk['traffic']['warm_hits']}), misses {st['misses']}, hit rate "
          f"{st['hit_rate']:.3f}; demotions {bk['tiers']['demotions']}, "
          f"rebuilds {bk['rebuild']['rebuilds']}, warm occupancy "
          f"{bk['tiers']['warm_occupancy']:.4f}")
    if launches != plans:
        fail(f"cascade kernel launched {launches} times for {plans} plans")
    if not (st["hits"] > 0 and st["misses"] > 0):
        fail(f"need hits and misses: {st['hits']} / {st['misses']}")
    if bk["rebuild"]["rebuilds"] < 1 or bk["tiers"]["demotions"] < 1 \
            or bk["tiers"]["warm_occupancy"] <= 0:
        fail("no flush + IVF rebuild happened: the warm ring is unused")
    # the threshold sits in the gap between scores of different texts
    # and of equal texts (embedded at different batch positions), so a
    # hit, and a miss coalesced under its group leader, must be answered
    # with the echo of the very same query text
    emb = svc.embed_fn(texts)
    uniq = {t: i for i, t in enumerate(texts)}
    first = np.asarray(list(uniq.values()))
    sims = emb[first] @ emb[first].T
    np.fill_diagonal(sims, -1.0)
    idx = np.asarray([uniq[t] for t in texts])
    same = np.einsum("nd,nd->n", emb, emb[idx])
    print(f"  score gap: max different-text {sims.max():.6f}, min "
          f"equal-text {same.min():.6f} ({len(uniq)} distinct texts)")
    # paraphrases (same entity and aspect, other wording) against
    # unrelated pairs: how far the seeded encoder separates meaning
    meaning = np.asarray([hash((stream[i].entity, stream[i].aspect))
                          for i in first])
    iu = np.triu_indices(len(first), 1)
    para = meaning[iu[0]] == meaning[iu[1]]
    for name, v in (("paraphrase", sims[iu][para]),
                    ("unrelated", sims[iu][~para])):
        qs = np.quantile(v, [0.01, 0.5, 0.99])
        print(f"  {name} pairs ({len(v)}): p1 {qs[0]:.4f} median "
              f"{qs[1]:.4f} p99 {qs[2]:.4f} max {v.max():.4f}")
    if not sims.max() < THRESHOLD <= same.min():
        fail(f"threshold {THRESHOLD} outside the observed score gap")
    for r in served:
        if r.response != f"answer({r.query})":
            fail(f"request {r.query!r} answered {r.response!r}")

    stages = {}
    for root in telemetry.tracer.roots():
        for child in root.children:
            stages.setdefault(child.name, []).append(child.duration_s)
    p50 = {n: 1e3 * statistics.median(v) for n, v in stages.items()}
    print("  stage p50 (ms, host wall incl. sync): " + ", ".join(
        f"{n} {p50[n]:.3f}" for n in ("embed", "plan", "generate",
                                      "commit") if n in p50))
    hit_scores = [r.score for r in served if r.cache_hit]
    print(f"  hit scores: min {min(hit_scores):.5f} median "
          f"{statistics.median(hit_scores):.5f}")

    # what came out is right: unit-norm finite keys of the right shape,
    # and the final tiers answer the same through the kernel and the
    # four-op composition
    emb = svc.embed_fn(texts[-BATCH:])
    if emb.shape != (BATCH, cfg.d_model) or not np.isfinite(emb).all() \
            or np.abs(np.linalg.norm(emb, axis=1) - 1).max() > 1e-3:
        fail(f"bad embeddings: {emb.shape}")
    qd = torch.as_tensor(emb, device=dev)
    qt = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    thr = torch.full((BATCH,), THRESHOLD, device=dev)
    fused = tiers.cascade_query(cache.hot, cache.warm, qd, qt, thr,
                                k=cache.topk, n_probe=cache._n_probe,
                                tail=cache._tail, fused=True)
    four = tiers.cascade_query(cache.hot, cache.warm, qd, qt, thr,
                               k=cache.topk, n_probe=cache._n_probe,
                               tail=cache._tail, fused=False)
    torch.cuda.synchronize()
    for name in ("value_ids", "hot_slots", "hot_hit", "hit"):
        if not torch.equal(getattr(fused, name), getattr(four, name)):
            fail(f"final tiers: fused vs four-op {name} differ")
    err = float((fused.scores - four.scores).abs().max())
    if err > SCORE_ATOL:
        fail(f"final tiers: fused vs four-op scores differ by {err:.3g}")
    profile_batch(svc, texts[:BATCH])
    return {"launches": launches, "plans": plans, "p50_ms": p50,
            "hits": st["hits"], "hit_rate": st["hit_rate"]}


def profile_batch(svc, batch) -> None:
    """Where one serving batch's time goes: ``torch.profiler`` over one
    more ``handle`` (after the counted run), device busy time against
    the host wall clock, and the top operations by device and host
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    svc.handle(batch, tenant=0)                     # warm
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        svc.handle(batch, tenant=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels (device events) only: a host op's device time repeats them
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"  profile of one batch: host wall {wall * 1e3:.3f} ms, device "
          f"busy {dev_us / 1e3:.3f} ms (idle share "
          f"{1 - dev_us / 1e3 / (wall * 1e3):.3f}) over "
          f"{sum(e.count for e in kernels)} kernel launches")
    for key, label, pool in (("self_device_time_total", "device", kernels),
                             ("self_cpu_time_total", "host", events)):
        top = sorted(pool, key=lambda e: getattr(e, key),
                     reverse=True)[:8]
        print(f"  top by {label} time: " + "; ".join(
            f"{e.key[:48]} {getattr(e, key) / 1e3:.3f} ms x{e.count}"
            for e in top))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels.cascade_lookup import kernel as cascade_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    print("phase 1: build")
    t0 = time.perf_counter()
    builders = {"cascade_lookup": cascade_kernel.build}
    with ThreadPoolExecutor(len(builders)) as pool:
        futs = {n: pool.submit(b) for n, b in builders.items()}
        for n, f in futs.items():
            print(f"  {n}: {os.path.relpath(f.result(), ROOT)}")
    print(f"  built in {time.perf_counter() - t0:.1f} s")

    print("phase 2: kernel parity at serving shapes")
    kp = kernel_phase(dev)

    print("phase 3: serving (full-width encoder, fused cascade)")
    sv = serving_phase(dev)

    kernels = [{
        "name": "cascade_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/cascade_lookup/csrc/"
                  "cascade_lookup.cu",
        "replaces": "src/repro/kernels/cascade_lookup/kernel.py:626",
        "launches": sv["launches"], "max_abs_err": kp["max_abs_err"],
        "ms": kp["ms"], "plain_ms": kp["plain_ms"],
        "bound_ms": kp["bound_ms"], "bound_by": kp["bound_by"],
        "library_ms": None,
        "int8_ms": kp["int8_ms"], "int8_plain_ms": kp["int8_plain_ms"],
        "int8_bound_ms": kp["int8_bound_ms"],
        "serving_p50_ms": sv["p50_ms"], "serving_hit_rate": sv["hit_rate"],
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
