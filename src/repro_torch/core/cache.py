"""SemanticCache — the paper's artifact, assembled: the port of
`repro/core/cache.py`.

A compact encoder's embeddings, the flat device store (`core.store`)
and one threshold.  The store lives on the card (its lookup is the
hand-written cosine top-k kernel); the response strings live on the
host.  It serves the typed ``CacheBackend`` lifecycle, so
`serving.engine.CachedLLMService` takes it as it takes ``CacheService``:

    cache = SemanticCache(capacity=4096, dim=768, threshold=0.85)
    plan = cache.plan(CacheRequest.build(embeddings))    # (B, D)
    cache.commit(plan, miss_responses)
    cache.stats_snapshot()                               # flat dict

Single-tenant (``capabilities().tenants`` is False) and admit-all; the
tiered multi-tenant backend is ``cache_service.CacheService``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache_service.protocol import (
    CacheCapabilities, CachePlan, CacheRequest, CommitReceipt,
    MaintenanceReport, coalesce_misses, ungrouped_misses,
)
from repro_torch.core import store as store_lib
from repro_torch.device import resolve_device
from repro_torch.obs import Telemetry


class SemanticCache:
    def __init__(self, capacity: int, dim: int, threshold: float = 0.85,
                 topk: int = 1, ttl: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.dim = dim
        self.threshold = threshold
        self.topk = topk
        self.ttl = ttl
        self.state = store_lib.init_store(capacity, dim, self.device)
        self.responses: List[str] = []
        # counters live on the telemetry registry; the single-tenant
        # flat store labels every stage tenant "0"
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        reg = self.telemetry.registry
        self._stage_h = self.telemetry.stage_histogram()
        self._c_plans = reg.counter(
            "cache_plans_total", "plan() calls").labels()
        self._c_commits = reg.counter(
            "cache_commits_total", "commit() calls").labels()
        self._c_rows = reg.counter(
            "cache_lookup_rows_total", "rows planned").labels()
        self._c_hits = reg.counter(
            "cache_hits_total", "plan-time hits by tier",
            labels=("tier",)).labels(tier="flat")
        self._c_inserts = reg.counter(
            "cache_admissions_total", "commit-time admission decisions",
            labels=("tenant", "decision")).labels(tenant=0,
                                                  decision="admitted")

    # ------------------------------------------------------------------
    # CacheBackend protocol
    # ------------------------------------------------------------------
    def capabilities(self) -> CacheCapabilities:
        return CacheCapabilities()   # flat, single-tenant, admit-all

    def plan(self, request: CacheRequest, *,
             coalesce: bool = True) -> CachePlan:
        """Read side: TTL sweep, exact top-k, LRU touch; responses are
        resolved here so later overwrites cannot invalidate them.
        ``coalesce=False`` skips the miss-grouping work."""
        if np.any(request.tenants != 0):
            raise ValueError("SemanticCache is single-tenant; route "
                             "multi-tenant traffic to CacheService")
        t0 = time.perf_counter()
        if self.ttl:
            self.state = store_lib.evict_older_than(self.state, self.ttl)
        q = torch.as_tensor(np.asarray(request.embeddings),
                            device=self.device)
        res = store_lib.query(self.state, q, self.threshold, self.topk)
        self.state = store_lib.touch(self.state, res.slots[:, 0], res.hit)
        hit = res.hit.cpu().numpy()
        scores = res.scores[:, 0].cpu().numpy()
        vids = res.value_ids[:, 0].cpu().numpy().astype(np.int64)
        values = [self.responses[v] if h and 0 <= v < len(self.responses)
                  else None for h, v in zip(hit, vids)]
        self._c_plans.inc()
        self._c_rows.inc(len(hit))
        self._c_hits.inc(int(hit.sum()))
        thr = np.full(len(hit), self.threshold, np.float32)
        leader = coalesce_misses(request.embeddings, hit,
                                 request.tenants, thr) \
            if coalesce else ungrouped_misses(hit)
        wall = time.perf_counter() - t0
        self._stage_h.observe(wall, stage="plan", tenant="0")
        return CachePlan(
            request=request, hit=hit, scores=scores,
            value_ids=np.where(hit, vids, -1), responses=values,
            admit=~hit,                       # no admission policy: cache
            miss_leader=leader,               # every generated miss
            epoch=0, margins=thr - scores, top_value_ids=vids,
            plan_wall_s=wall)

    def commit(self, plan: CachePlan,
               responses: Sequence[Optional[str]]) -> CommitReceipt:
        """Write side: append admitted miss responses and insert their
        embeddings (value ids are list positions, always fresh)."""
        t0 = time.perf_counter()
        self._c_commits.inc()
        rows = plan.miss_rows()
        rows = rows[plan.admit[rows]]
        texts = []
        for i in rows:
            if responses[i] is None:
                raise ValueError(f"admitted row {int(i)} has no response")
            texts.append(responses[i])
        if len(rows):
            base = len(self.responses)
            self.responses.extend(texts)
            vids = torch.arange(base, base + len(rows), dtype=torch.int32,
                                device=self.device)
            embs = torch.as_tensor(
                np.asarray(plan.request.embeddings)[rows],
                device=self.device)
            self.state = store_lib.insert_batch(self.state, embs, vids)
        self._c_inserts.inc(len(rows))
        wall = time.perf_counter() - t0
        self._stage_h.observe(wall, stage="commit", tenant="0")
        return CommitReceipt(admitted=len(rows),
                             skipped=int(len(plan.miss_rows()) - len(rows)),
                             evicted=0, commit_wall_s=wall,
                             trace_id=plan.request.trace_id)

    def maintenance(self, block: bool = False) -> MaintenanceReport:
        """Flat store: no background obligations (TTL sweeps run at
        plan time); still observes the stage so the flat backend's
        stage coverage matches the tiered one."""
        t0 = time.perf_counter()
        reg = self.telemetry.registry
        reg.gauge("cache_occupancy",
                  "flat-store occupancy fraction").set(self.occupancy)
        wall = time.perf_counter() - t0
        self._stage_h.observe(wall, stage="maintenance", tenant="-")
        return MaintenanceReport(wall_s=wall)

    def stats_snapshot(self) -> Dict[str, object]:
        """Flat backend snapshot: a plain dict (the protocol allows a
        mapping or an object with ``to_dict()``)."""
        reg = self.telemetry.registry
        return {
            "lookups": int(reg.value("cache_lookup_rows_total")),
            "hits": int(reg.value("cache_hits_total", tier="flat")),
            "inserts": int(reg.value("cache_admissions_total",
                                     decision="admitted")),
            "plans": int(reg.value("cache_plans_total")),
            "commits": int(reg.value("cache_commits_total")),
            "occupancy": self.occupancy,
            "live_responses": len(self.responses),
        }

    # ------------------------------------------------------------------
    @property
    def occupancy(self) -> float:
        return float(store_lib.occupancy(self.state))

    def __len__(self) -> int:
        return int(self.state.valid.sum())
