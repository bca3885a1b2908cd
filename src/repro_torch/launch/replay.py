"""Replay of one serving-scenario trace (`launch.scenarios`) through a
fresh tiered ``CacheService`` under the trace's logical clock (DESIGN.md
§14.1): the port of the reference's ``benchmarks/bench_scenarios.py``
replay (``_tiering``, ``_service``, ``replay``), without its asserts,
bench loop or JSON writer.  ``launch.serve --scenario`` prints its row.

Each step sets the clock to the step's arrival time, plans the batch
(``coalesce=False``), scores every hit against the trace's ground truth
(true, false, or stale: a hit on a group past its latest TTL deadline),
feeds the verdicts to ``FeedbackAccumulator.observe_hit_audit`` in
conformal mode, commits the misses with the response ``ans-g{group}``
and runs ``maintenance()``.  ``plan`` is timed on the host up to a
device sync, µs per row, leaving out each batch size's first plan, as
the reference leaves out its compiles.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.cache_service import (
    CacheConfig, CacheRequest, CacheService, FeedbackConfig,
    LearningConfig, StalenessConfig, TieringConfig,
)
from repro_torch.launch.scenarios import ScenarioTrace


def _tiering(name: str, fused: bool) -> TieringConfig:
    """The trace's tier sizes: ``ttl_churn`` squeezes the hot tier so
    live-but-doomed entries demote through warm (and into cold) while
    their deadline runs, so expiry must hold in every tier.  ``fused``
    (not the reference's: its replay runs the four-op lookup) sends each
    plan through the cascade kernel."""
    if name == "ttl_churn":
        return TieringConfig(hot_capacity=32, warm_capacity=512,
                             n_clusters=8, bucket=64, n_probe=8,
                             cold_capacity=1024, fused=fused)
    return TieringConfig(hot_capacity=2048, warm_capacity=4096,
                         n_clusters=8, bucket=256, n_probe=8, fused=fused)


def _service(trace: ScenarioTrace, clock: dict, *, conformal: bool,
             device, fused: bool) -> CacheService:
    cfg = CacheConfig(
        dim=trace.dim,
        threshold=trace.threshold,
        tiering=_tiering(trace.name, fused),
        learning=LearningConfig(
            conformal=conformal,
            # a small split so the floor activates off calibration-scale
            # traffic; the window and alpha are the serving defaults
            feedback=FeedbackConfig(conformal_min=16)),
        staleness=StalenessConfig(clock=lambda: clock["t"]),
    )
    svc = CacheService(cfg, device=device)
    for tenant, (scores, labels) in trace.calibration.items():
        budget = float(trace.meta.get("max_false_hit_rate", 0.02))
        svc.calibrate_tenant(tenant, scores, labels,
                             max_false_hit_rate=budget)
    return svc


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def replay(trace: ScenarioTrace, *, conformal: bool, device="cuda",
           fused: bool = False) -> dict:
    """Run ``trace`` through a fresh service on ``device``; returns the
    scored row (the reference's keys).  ``serve --scenario`` runs the
    reference's four-op lookup; ``fused=True`` looks up through the
    cascade kernel (`kernels.cascade_lookup`) instead, which is how
    ``chip_smoke.py`` holds that kernel to the four-op outcomes on these
    traces."""
    clock = {"t": 0.0}
    svc = _service(trace, clock, conformal=conformal, device=device,
                   fused=fused)
    deadline = {}                    # gid -> latest live TTL deadline
    n_q = hits = false_hits = stale = 0
    per_tenant = {}                  # tenant -> [queries, false_hits]
    timed, seen_sizes = [], set()
    expired_masked = ttl_stamped = expired_reaped = 0
    prewin_hits = prewin_total = 0   # ttl_churn inside-deadline repeats

    for step in trace.steps:
        clock["t"] = float(step.t)
        B = len(step.tenants)
        req = CacheRequest.build(step.embs, step.tenants, ttl=step.ttl)
        _sync(device)
        t0 = time.perf_counter()
        plan = svc.plan(req, coalesce=False)
        np.asarray(plan.hit)
        _sync(device)
        dt = time.perf_counter() - t0
        if B in seen_sizes:
            timed.append(dt / B * 1e6)
        else:
            seen_sizes.add(B)        # first sight of this batch size
        expired_masked += plan.expired_masked

        responses = [None] * B
        for i in range(B):
            gid = int(step.group[i])
            tn = int(step.tenants[i])
            own = f"ans-g{gid}"
            n_q += 1
            pt = per_tenant.setdefault(tn, [0, 0])
            pt[0] += 1
            prewindow = (trace.name == "ttl_churn" and step.ttl is None
                         and not step.must_miss[i])
            if plan.hit[i]:
                hits += 1
                is_dup = plan.responses[i] == own
                if is_dup:
                    if deadline.get(gid, np.inf) < step.t:
                        stale += 1
                else:
                    false_hits += 1
                    pt[1] += 1
                if conformal:
                    svc.feedback.observe_hit_audit(
                        tn, float(plan.scores[i]), is_dup)
                prewin_hits += prewindow
            else:
                responses[i] = own
            prewin_total += prewindow

        receipt = svc.commit(plan, responses)
        ttl_stamped += receipt.ttl_stamped
        admitted = np.asarray(plan.admit, bool) & ~np.asarray(plan.hit, bool)
        ttl_col = (np.asarray(step.ttl, np.float32)
                   if step.ttl is not None else None)
        for i in np.flatnonzero(admitted):
            gid = int(step.group[i])
            if ttl_col is None or not np.isfinite(ttl_col[i]):
                deadline[gid] = np.inf
            else:
                deadline[gid] = max(deadline.get(gid, -np.inf),
                                    float(step.t) + float(ttl_col[i]))
        expired_reaped += svc.maintenance().expired_reaped

    timed_a = np.asarray(timed) if timed else np.asarray([0.0])
    row = {
        "scenario": trace.name,
        "mode": "conformal" if conformal else "learned",
        "seed": trace.seed,
        "dim": trace.dim,
        "n_steps": len(trace.steps),
        "n_queries": n_q,
        "hits": hits,
        "hit_rate": hits / max(n_q, 1),
        "false_hits": false_hits,
        "false_hit_rate": false_hits / max(n_q, 1),
        "false_hit_budget": trace.false_hit_budget,
        "stale_serves": stale,
        "p50_us_per_row": float(np.percentile(timed_a, 50)),
        "p99_us_per_row": float(np.percentile(timed_a, 99)),
        "timed_batches": len(timed),
        "ttl_stamped": ttl_stamped,
        "expired_masked": expired_masked,
        "expired_reaped": expired_reaped,
        "per_tenant_false_hit_rate": {
            str(t): (fh / q if q else 0.0)
            for t, (q, fh) in sorted(per_tenant.items())},
        "per_tenant_queries": {str(t): q for t, (q, _)
                               in sorted(per_tenant.items())},
    }
    if trace.name == "ttl_churn":
        row["prewindow_hit_rate"] = prewin_hits / max(prewin_total, 1)
    if conformal:
        cs = svc.feedback.conformal_state()
        row["conformal_floors"] = {
            str(t): v["floor"] for t, v in cs["tenants"].items()
            if v["floor"] is not None}
        row["hit_audits"] = cs["hit_audits"]
        row["audited_false_hits"] = cs["audited_false_hits"]
    return row
