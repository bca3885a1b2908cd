"""Host-RAM cold tier: the memory level below the warm ring.

The port of `repro/cache_service/cold.py` (DESIGN.md §12).  A warm-ring
overwrite used to drop the evicted row's response; the cold tier catches
those demotions in *host* memory, so the corpus is bounded by host RAM,
not device memory:

  * storage is the int8 symmetric per-row quantization the warm tier
    already keeps: the key panel arrives pre-quantized from the warm
    ring's ``keys_q``/``scales`` (never re-quantized), plus value ids,
    tenant ids and TTL deadlines, in flat pre-allocated numpy arrays;
  * routing is a coarse IVF of its own: spherical k-means centroids fit
    host-side on a bounded sample (`_kmeans_np`, numpy, so the port's
    routes equal the reference's draw for draw) and a per-row cluster
    assignment kept up to date on insert;
  * lookup is budgeted and conditional: only queries whose hot/warm
    verdict fell below threshold are offered, and only those whose best
    centroid clears ``threshold - router_margin - route_slack`` are
    consulted (``route_slack``, the clusters' 10th-percentile spread, is
    calibrated at route-fit time).  A consulted query's candidates are
    ranked by their int8 score on the host and the best
    ``fetch_budget`` rows go to the tier's device for an exact fp32
    re-score of the dequantized keys (`_rescore_device`);
  * promotion is asynchronous: a cold row that produces a hit is queued,
    and the service's ``maintenance()`` drains the queue back into the
    warm ring, invalidating the cold copy.

The cold ring's own overwrites are the hierarchy's final drops (the
service frees their strings).  ``evict_tenant`` and ``reap_expired``
also purge pending promotions, so nothing resurrects through the drain.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache_service.policy import ColdRoutingPolicy
from repro_torch.device import resolve_device

NEG = -1e30


class ColdFetch(NamedTuple):
    """Per-batch result of a budgeted cold lookup: ``consulted`` marks
    queries whose fetch the router approved (others carry score NEG,
    vid -1); ``scores`` are exact fp32 cosines of the dequantized keys."""
    scores: np.ndarray       # (Q,) float32, NEG where no candidate
    value_ids: np.ndarray    # (Q,) int64, -1 where no candidate
    slots: np.ndarray        # (Q,) int32 cold row of the best candidate
    consulted: np.ndarray    # (Q,) bool
    fetched_rows: int        # candidate rows shipped to the device
    router_skips: int        # offered queries the router turned down


class Promotion(NamedTuple):
    """A drained promotion batch, ready for the warm ring's append."""
    keys: np.ndarray         # (m, D) float32 dequantized unit keys
    value_ids: np.ndarray    # (m,) int32
    tenants: np.ndarray      # (m,) int32
    expires: np.ndarray      # (m,) float32 deadline it was demoted with


def _rescore_device(qn: torch.Tensor, panel: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 re-score of the fetched panel: qn (Q, D) unit queries,
    panel (Q, B, D) dequantized keys, mask (Q, B).  Returns (best score
    (Q,), best column (Q,)); ties go to the lowest column, as
    ``jnp.argmax``."""
    s = torch.einsum("qd,qbd->qb", qn, panel)
    s = torch.where(mask, s, torch.full_like(s, NEG))
    best = torch.argmax(s, dim=1)
    return s.gather(1, best[:, None])[:, 0], best


def _kmeans_np(x: np.ndarray, k: int, iters: int, seed: int) -> np.ndarray:
    """Host-side spherical k-means (unit rows in, unit centroids out)."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if n <= k:
        cent = np.zeros((k, x.shape[1]), np.float32)
        cent[:n] = x
        return cent
    cent = x[rng.choice(n, k, replace=False)].copy()
    for _ in range(iters):
        a = np.argmax(x @ cent.T, axis=1)
        sums = np.zeros_like(cent)
        np.add.at(sums, a, x)
        norms = np.linalg.norm(sums, axis=1, keepdims=True)
        live = norms[:, 0] > 1e-9
        cent[live] = (sums / np.maximum(norms, 1e-9))[live]
    return cent.astype(np.float32)


class ColdTier:
    """Host-RAM int8 ring with coarse IVF routing (DESIGN.md §12).

    Single-writer: every mutating call happens on the service's thread
    (commit flushes, maintenance drains); the only device work is the
    exact re-score of fetched panels, on ``device``.
    """

    def __init__(self, capacity: int, dim: int, *,
                 policy: Optional[ColdRoutingPolicy] = None,
                 device="cuda"):
        if capacity <= 0:
            raise ValueError(f"cold capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.policy = policy or ColdRoutingPolicy()
        self.device = resolve_device(device)
        self.keys_q = np.zeros((capacity, dim), np.int8)
        self.scales = np.zeros((capacity,), np.float32)
        self.value_ids = np.full((capacity,), -1, np.int64)
        self.tenants = np.full((capacity,), -1, np.int32)
        self.valid = np.zeros((capacity,), bool)
        self.expires_at = np.full((capacity,), np.inf, np.float32)
        self._cursor = 0
        self.centroids: Optional[np.ndarray] = None    # (Kc, D) unit
        self.route_slack = 0.0
        self._assign = np.full((capacity,), -1, np.int32)
        self._inserts_since_route = 0
        self._promote: Dict[int, int] = {}             # vid -> cold slot
        self.n_inserted = 0
        self.n_dropped = 0          # cold-ring overwrites (final drops)
        self.n_fetches = 0          # consulted queries
        self.n_fetched_rows = 0
        self.n_hits = 0
        self.n_promoted = 0
        self.n_router_skips = 0
        self.n_route_rebuilds = 0
        self.n_expired_reaped = 0

    def __len__(self) -> int:
        return int(self.valid.sum())

    @property
    def occupancy(self) -> float:
        return float(self.valid.mean())

    @property
    def pending_promotions(self) -> int:
        return len(self._promote)

    @property
    def maintenance_due(self) -> bool:
        """An idle tick now would drain promotions or re-fit routes."""
        return bool(self._promote) or self._route_due()

    def _dequant(self, slots: np.ndarray) -> np.ndarray:
        return self.keys_q[slots].astype(np.float32) \
            * self.scales[slots, None]

    # ------------------------------------------------------------------
    # writes: demotion insert / bulk load / eviction
    # ------------------------------------------------------------------
    def insert(self, keys_q: np.ndarray, scales: np.ndarray,
               value_ids: np.ndarray, tenants: np.ndarray,
               expires: Optional[np.ndarray] = None) -> np.ndarray:
        """Ring-append pre-quantized rows with their deadlines (None =
        no TTL).  Returns the value ids of overwritten valid cold rows
        (the hierarchy's final drops) for host GC."""
        n = len(value_ids)
        if n == 0:
            return np.empty((0,), np.int64)
        if expires is None:
            expires = np.full((n,), np.inf, np.float32)
        expires = np.asarray(expires, np.float32)
        if n > self.capacity:
            # only the last `capacity` rows can survive a ring this size
            drop_head = np.asarray(value_ids[:n - self.capacity], np.int64)
            tail = self.insert(keys_q[n - self.capacity:],
                               scales[n - self.capacity:],
                               value_ids[n - self.capacity:],
                               tenants[n - self.capacity:],
                               expires[n - self.capacity:])
            self.n_dropped += len(drop_head)
            return np.concatenate([drop_head, tail])
        pos = (self._cursor + np.arange(n)) % self.capacity
        overwritten = self.valid[pos]
        dropped = np.asarray(self.value_ids[pos][overwritten], np.int64)
        for v in dropped:       # a pending promotion dies with its row
            self._promote.pop(int(v), None)
        self.keys_q[pos] = keys_q
        self.scales[pos] = scales
        self.value_ids[pos] = value_ids
        self.tenants[pos] = tenants
        self.valid[pos] = True
        self.expires_at[pos] = expires
        if self.centroids is not None:
            sims = (keys_q.astype(np.float32) * scales[:, None]) \
                @ self.centroids.T
            self._assign[pos] = np.argmax(sims, axis=1).astype(np.int32)
        else:
            self._assign[pos] = -1
        self._cursor = int((self._cursor + n) % self.capacity)
        self.n_inserted += n
        self.n_dropped += len(dropped)
        self._inserts_since_route += n
        if self._route_due():
            self.rebuild_routes()
        return dropped

    def bulk_load(self, keys: np.ndarray, value_ids: np.ndarray,
                  tenants: np.ndarray,
                  expires: Optional[np.ndarray] = None) -> np.ndarray:
        """Quantize (the warm tier's int8 rule) and insert fp32 keys,
        then rebuild the routing — for benches and migration, not the
        serving path."""
        from repro_torch.cache_service.tiers import quantize_rows
        kn = np.asarray(keys, np.float32)
        kn /= np.maximum(np.linalg.norm(kn, axis=1, keepdims=True), 1e-9)
        k8, sc = quantize_rows(torch.from_numpy(kn))
        dropped = self.insert(k8.numpy(), sc.numpy(),
                              np.asarray(value_ids, np.int64),
                              np.asarray(tenants, np.int32), expires)
        self.rebuild_routes()
        return dropped

    def evict_tenant(self, tenant: int) -> np.ndarray:
        """Invalidate one tenant's cold rows and purge its pending
        promotions.  Returns the freed value ids for host GC."""
        kill = self.valid & (self.tenants == tenant)
        vids = np.asarray(self.value_ids[kill], np.int64)
        self.valid[kill] = False
        for v in vids:
            self._promote.pop(int(v), None)
        return vids

    def reap_expired(self, now: float) -> np.ndarray:
        """Invalidate TTL-expired cold rows and purge their pending
        promotions (DESIGN.md §14).  Returns the freed value ids."""
        kill = self.valid & (self.expires_at <= np.float32(now))
        vids = np.asarray(self.value_ids[kill], np.int64)
        self.valid[kill] = False
        for v in vids:
            self._promote.pop(int(v), None)
        self.n_expired_reaped += len(vids)
        return vids

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def _route_due(self) -> bool:
        return (self.centroids is None
                and len(self) >= self.policy.min_rows_for_routing) \
            or self._inserts_since_route >= self.policy.route_rebuild_every

    def rebuild_routes(self) -> None:
        """Re-fit the coarse centroids on a bounded sample, re-assign
        every valid row and calibrate ``route_slack``.  Host-only."""
        live = np.flatnonzero(self.valid)
        self._inserts_since_route = 0
        if len(live) < self.policy.min_rows_for_routing:
            return
        pol = self.policy
        rng = np.random.default_rng(pol.seed + self.n_route_rebuilds)
        fit = live if len(live) <= pol.kmeans_sample \
            else rng.choice(live, pol.kmeans_sample, replace=False)
        x = self._dequant(fit)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
        self.centroids = _kmeans_np(x, pol.n_clusters, pol.kmeans_iters,
                                    pol.seed)
        own = np.empty((len(live),), np.float32)
        for lo in range(0, len(live), 1 << 16):
            chunk = live[lo:lo + (1 << 16)]
            rows = self._dequant(chunk)
            rows /= np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-9)
            sims = rows @ self.centroids.T
            self._assign[chunk] = np.argmax(sims, axis=1).astype(np.int32)
            own[lo:lo + (1 << 16)] = sims.max(axis=1)
        # 90% of members sit within `route_slack` of their centroid: a
        # loose clustering opens the router gate instead of falsely
        # skipping reachable rows
        self.route_slack = float(np.clip(1.0 - np.quantile(own, 0.1),
                                         0.0, 2.0))
        self.n_route_rebuilds += 1

    # ------------------------------------------------------------------
    # budgeted lookup
    # ------------------------------------------------------------------
    def lookup(self, qn: np.ndarray, q_tenants: np.ndarray,
               thresholds: np.ndarray, need: np.ndarray,
               now: Optional[float] = None) -> ColdFetch:
        """Consult the cold tier for the ``need`` queries: router rule,
        budgeted host gather, one device re-score.  ``now`` masks
        TTL-expired rows out of the candidates (they can never be
        served, hit or queued for promotion)."""
        qn = np.asarray(qn, np.float32)
        Q = qn.shape[0]
        out = ColdFetch(scores=np.full((Q,), NEG, np.float32),
                        value_ids=np.full((Q,), -1, np.int64),
                        slots=np.full((Q,), -1, np.int32),
                        consulted=np.zeros((Q,), bool),
                        fetched_rows=0, router_skips=0)
        need = np.asarray(need, bool)
        live = self.valid if now is None \
            else self.valid & (self.expires_at > np.float32(now))
        if not need.any() or not live.any():
            return out
        pol = self.policy
        B = pol.fetch_budget
        thresholds = np.asarray(thresholds, np.float32)
        if self.centroids is not None:
            csims = qn @ self.centroids.T                       # (Q, Kc)
            n_probe = min(pol.n_probe, self.centroids.shape[0])
            probes = np.argpartition(-csims, n_probe - 1,
                                     axis=1)[:, :n_probe]
            worth = csims.max(axis=1) \
                >= thresholds - pol.router_margin - self.route_slack
        else:
            probes = None
            worth = np.ones((Q,), bool)     # unrouted: small corpus
        sel = need & worth
        skips = int((need & ~worth).sum())
        if not sel.any():
            self.n_router_skips += skips
            return out._replace(router_skips=skips)
        # membership scan: one vectorized pass per probed cluster
        members: Dict[int, np.ndarray] = {}
        if probes is not None:
            for c in np.unique(probes[sel]):
                members[int(c)] = np.flatnonzero(
                    live & (self._assign == c))
        else:
            members[-1] = np.flatnonzero(live)
        slots = np.full((Q, B), -1, np.int64)
        fetched = 0
        for q in np.flatnonzero(sel):
            cl = probes[q] if probes is not None else [-1]
            cand = np.concatenate([members[int(c)] for c in cl]) \
                if len(cl) > 1 else members[int(cl[0])]
            cand = cand[self.tenants[cand] == q_tenants[q]]
            if len(cand) == 0:
                continue
            if len(cand) > B:
                # the int8 ranking picks the budgeted subset; the
                # device re-score below produces the score
                approx = self._dequant(cand) @ qn[q]
                cand = cand[np.argpartition(-approx, B - 1)[:B]]
            slots[q, :len(cand)] = cand
            fetched += len(cand)
        consulted = slots[:, 0] >= 0
        if not consulted.any():
            self.n_router_skips += skips
            return out._replace(router_skips=skips)
        safe = np.maximum(slots, 0)
        panel = self._dequant(safe.ravel()).reshape(Q, B, self.dim)
        dev = self.device
        best_s, best_c = _rescore_device(
            torch.from_numpy(qn).to(dev), torch.from_numpy(panel).to(dev),
            torch.from_numpy(slots >= 0).to(dev))
        best_s = best_s.cpu().numpy()
        best_slot = slots[np.arange(Q), best_c.cpu().numpy()]
        best_slot = np.where(consulted, best_slot, -1).astype(np.int32)
        vids = np.where(best_slot >= 0,
                        self.value_ids[np.maximum(best_slot, 0)], -1)
        self.n_fetches += int(consulted.sum())
        self.n_fetched_rows += fetched
        self.n_router_skips += skips
        hits = consulted & (best_s >= thresholds)
        self.n_hits += int(hits.sum())
        for q in np.flatnonzero(hits):
            self._promote[int(vids[q])] = int(best_slot[q])
        return ColdFetch(
            scores=np.where(consulted, best_s, NEG).astype(np.float32),
            value_ids=vids.astype(np.int64), slots=best_slot,
            consulted=consulted, fetched_rows=fetched, router_skips=skips)

    # ------------------------------------------------------------------
    # async promotion (drained by the service's maintenance tick)
    # ------------------------------------------------------------------
    def take_promotions(self, max_rows: int) -> Optional[Promotion]:
        """Pop up to ``max_rows`` pending re-hot rows and invalidate
        their cold copies (one live copy per value id).  Entries whose
        row was overwritten or evicted since they queued are dropped.
        Returns None when nothing is pending."""
        taken: List[Tuple[int, int]] = []
        while self._promote and len(taken) < max_rows:
            vid, slot = self._promote.popitem()
            if self.valid[slot] and int(self.value_ids[slot]) == vid:
                taken.append((vid, slot))
        if not taken:
            return None
        slots = np.asarray([s for _, s in taken])
        keys = self._dequant(slots)
        keys /= np.maximum(np.linalg.norm(keys, axis=1, keepdims=True),
                           1e-9)
        prom = Promotion(keys=keys.astype(np.float32),
                         value_ids=np.asarray([v for v, _ in taken],
                                              np.int32),
                         tenants=self.tenants[slots].copy(),
                         expires=self.expires_at[slots].copy())
        self.valid[slots] = False
        self.n_promoted += len(taken)
        return prom

    def stats(self) -> Dict[str, object]:
        return {
            "cold_occupancy": self.occupancy,
            "cold_rows": len(self),
            "cold_inserted": self.n_inserted,
            "cold_dropped": self.n_dropped,
            "cold_fetches": self.n_fetches,
            "cold_fetched_rows": self.n_fetched_rows,
            "cold_hits": self.n_hits,
            "cold_promoted": self.n_promoted,
            "cold_pending_promotions": self.pending_promotions,
            "cold_router_skips": self.n_router_skips,
            "cold_route_rebuilds": self.n_route_rebuilds,
            "cold_routed": self.centroids is not None,
            "cold_route_slack": round(self.route_slack, 4),
            "cold_expired_reaped": self.n_expired_reaped,
        }
