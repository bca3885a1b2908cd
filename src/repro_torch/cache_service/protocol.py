"""Typed cache serving protocol: ``CacheBackend`` + plan/commit lifecycle.

The serving pipeline used to capability-sniff its cache with
``hasattr(cache, "set_fused")`` / ``supports_tenants`` and drive it
through two untyped calls (``lookup`` then ``insert``).  This module is
the typed replacement (DESIGN.md §7):

  * ``CacheCapabilities`` — a static descriptor every backend returns
    from ``capabilities()``; the pipeline branches on fields, never on
    ``hasattr``.
  * ``CacheRequest``  — one embedded batch: embeddings, the per-row
    tenant column, a trace id.
  * ``CachePlan``     — the backend's read-side verdict per row: hit
    flag, best same-tenant score, value id, the response string
    (resolved at plan time, so a later eviction cannot invalidate a
    response already promised to a request), the admission
    pre-decision carrying the observed neighbour scores, and the
    miss-coalescing map (near-identical misses grouped so one
    generation serves the whole group).
  * ``CommitReceipt`` — the write-side outcome: rows admitted/skipped,
    host strings freed, and maintenance obligations (``rebuild_due``)
    the pipeline discharges by calling ``maintenance()`` between
    batches — the hook behind the double-buffered warm-IVF rebuild.

Lifecycle invariants every backend must honor:

  * ``plan`` performs all read-side effects (LRU touch, TTL sweep) and
    resolves hit responses immediately; ``commit`` performs all
    write-side effects and never re-reads plan-time device state.
  * ``commit`` assigns **fresh** value ids to admitted rows — a plan
    can never resurrect a value id freed (e.g. by ``evict_tenant``)
    between plan and commit.
  * ``commit`` accepts a plan from an older backend epoch; it must
    stay safe (at worst admitting rows the current policy would now
    skip), never corrupt (dangling value ids, leaked host strings).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (
    List, Optional, Protocol, Sequence, Tuple, Union,
    runtime_checkable,
)

import numpy as np

TenantArg = Union[int, Sequence[int], np.ndarray]


# ---------------------------------------------------------------------------
# capability descriptor
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheCapabilities:
    """Static feature descriptor; replaces hasattr capability sniffing.

    ``fused_lookup=True`` additionally guarantees the backend exposes
    ``set_fused(bool)`` (the cascade execution-path switch).
    """
    tenants: bool = False            # isolates per-tenant id spaces
    fused_lookup: bool = False       # has set_fused() / Pallas cascade
    admission: bool = False          # plan carries a real admit decision
    background_rebuild: bool = False  # maintenance() can double-buffer
    tiered: bool = False             # hot/warm cascade vs flat store
    warm_sharded: bool = False       # warm tier spans a mesh axis (§8)
    warm_dtype: str = "float32"      # warm scan precision (int8 = quantized)
    learned_admission: bool = False  # maintenance() refits policies (§9)
    learned_embedder: bool = False   # maintenance() refreshes embedder (§11)
    cold_tier: bool = False          # host-RAM cold tier below warm (§12)
    ensemble: int = 0                # embedder count of the fused multi-
    #                                  embedder cascade (§13); 0 = single
    #                                  embedder.  When > 0, requests carry
    #                                  (B, E, D) embeddings and plans carry
    #                                  per-embedder ``panel_scores``.
    ttl: bool = False                # honours CacheRequest.ttl / default
    #                                  TTL: expired rows masked at plan
    #                                  time, reaped on maintenance (§14.2)
    conformal: bool = False          # per-tenant conformal threshold
    #                                  floor rides every plan (§14.3)


# ---------------------------------------------------------------------------
# request lifecycle dataclasses
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheRequest:
    """One embedded query batch entering the cache.

    ``texts`` (optional) carries the raw query strings alongside their
    embeddings.  Backends that refresh their embedder online (§11)
    retain the text of every admitted row so the corpus can be
    re-embedded under a new embedder version; without texts the entry
    is still served but pinned to the embedding it was admitted with.
    """
    embeddings: np.ndarray           # (B, D) float32, unit-norm rows;
    #                                  (B, E, D) under an ensemble backend
    #                                  (§13), one row per embedder
    tenants: np.ndarray              # (B,)  int32 tenant per row
    trace_id: int = 0
    texts: Optional[Tuple[str, ...]] = None   # raw query strings (§11)
    ttl: Optional[np.ndarray] = None  # (B,) float32 seconds-to-live per
    #                                   row (§14.2); +inf = never expire.
    #                                   None defers to the backend's
    #                                   configured default TTL.

    @classmethod
    def build(cls, embeddings, tenant: TenantArg = 0,
              trace_id: int = 0,
              texts: Optional[Sequence[str]] = None,
              ttl=None) -> "CacheRequest":
        """Normalize a scalar-or-array tenant argument to a (B,) row;
        likewise a scalar-or-array ``ttl`` (seconds) to a (B,) float32
        column (NaN rows fall back to no-TTL)."""
        embs = np.asarray(embeddings)
        t = np.asarray(tenant, np.int32)
        if t.ndim == 0:
            t = np.full(embs.shape[0], int(t), np.int32)
        if t.shape != (embs.shape[0],):
            raise ValueError(f"tenant row {t.shape} != batch "
                             f"({embs.shape[0]},)")
        if texts is not None and len(texts) != embs.shape[0]:
            raise ValueError(f"texts row {len(texts)} != batch "
                             f"({embs.shape[0]},)")
        ttl_col = None
        if ttl is not None:
            ttl_col = np.asarray(ttl, np.float32)
            if ttl_col.ndim == 0:
                ttl_col = np.full(embs.shape[0], float(ttl_col),
                                  np.float32)
            if ttl_col.shape != (embs.shape[0],):
                raise ValueError(f"ttl row {ttl_col.shape} != batch "
                                 f"({embs.shape[0]},)")
            ttl_col = np.where(np.isnan(ttl_col), np.inf, ttl_col)
            if np.any(ttl_col <= 0):
                raise ValueError("ttl must be positive seconds "
                                 "(+inf/NaN = never expire)")
        return cls(embeddings=embs, tenants=t, trace_id=trace_id,
                   texts=tuple(texts) if texts is not None else None,
                   ttl=ttl_col)

    def __len__(self) -> int:
        return int(self.embeddings.shape[0])


@dataclass
class CachePlan:
    """Read-side verdict for every row of one request.

    ``miss_leader`` encodes the miss-coalescing groups: -1 on hit rows;
    on miss rows, the index of the earliest near-identical same-tenant
    miss (its *leader* — ``miss_leader[i] == i`` for leaders).  One
    generation per leader serves its whole group.

    ``admit`` is the admission pre-decision taken at plan time from the
    observed neighbour scores (False on hit rows); ``commit`` honors it
    instead of re-deciding.

    ``top_value_ids`` carries the id of each row's best same-tenant
    neighbour *regardless of the hit flag* (-1 when the tenant had no
    candidate): commit compares a generated miss response against the
    neighbour's stored response to label the event a duplicate for the
    feedback loop (DESIGN.md §9).  ``margins`` records how far each
    row's best score sat from its tenant's threshold *at plan time* —
    with learned admission the thresholds drift between refits, so the
    plan is the only place that context exists; consumers (telemetry,
    tests, future cross-host policy sync) read it here instead of
    re-joining scores against a policy table that has since moved.
    """
    request: CacheRequest
    hit: np.ndarray                  # (B,) bool
    scores: np.ndarray               # (B,) best same-tenant score
    value_ids: np.ndarray            # (B,) int64, -1 on miss rows
    responses: List[Optional[str]]   # hit responses, resolved at plan time
    admit: np.ndarray                # (B,) bool admission pre-decision
    miss_leader: np.ndarray          # (B,) int64 coalescing map
    epoch: int = 0                   # backend epoch at plan time
    margins: Optional[np.ndarray] = None       # (B,) thr - score
    top_value_ids: Optional[np.ndarray] = None  # (B,) int64, -1 = none
    plan_wall_s: float = 0.0         # host wall time of plan() (§10)
    embed_version: int = 0           # embedder version at plan time (§11)
    # (B, E) unweighted per-embedder cosines of each row's best
    # same-tenant candidate under the fused ensemble (§13); None off the
    # ensemble path.  Commit feeds them — with the duplicate verdict —
    # to the per-tenant mixture-weight learner.
    panel_scores: Optional[np.ndarray] = None
    expired_masked: int = 0          # stored rows masked out of this
    #                                  plan's view as TTL-expired (§14.2)

    def miss_rows(self) -> np.ndarray:
        return np.nonzero(~self.hit)[0]

    def leader_rows(self) -> List[int]:
        """Miss rows needing a generation, in row order."""
        return [int(i) for i in self.miss_rows()
                if int(self.miss_leader[i]) == int(i)]

    @property
    def n_coalesced(self) -> int:
        """Miss rows served by another row's generation."""
        return int(sum(int(self.miss_leader[i]) != int(i)
                       for i in self.miss_rows()))

    @classmethod
    def for_insert(cls, request: CacheRequest, admit: np.ndarray,
                   scores: Optional[np.ndarray] = None,
                   epoch: int = 0, embed_version: int = 0) -> "CachePlan":
        """Plan equivalent of a legacy ``insert`` call: every row is an
        ungrouped miss, admission as given."""
        n = len(request)
        if scores is None:
            scores = np.zeros(n, np.float32)
        return cls(request=request, hit=np.zeros(n, bool),
                   scores=np.asarray(scores, np.float32),
                   value_ids=np.full(n, -1, np.int64),
                   responses=[None] * n,
                   admit=np.asarray(admit, bool),
                   miss_leader=np.arange(n, dtype=np.int64), epoch=epoch,
                   embed_version=embed_version)


@dataclass(frozen=True)
class MaintenanceReport:
    """What one ``maintenance()`` call did."""
    rebuild_started: bool = False    # a shadow rebuild was kicked off
    rebuild_published: bool = False  # a finished shadow index was swapped
    rebuild_in_flight: bool = False  # a shadow rebuild is still running
    rebuild_wall_s: float = 0.0      # wall time of the published rebuild
    refits_applied: int = 0          # policies republished this call (§9)
    refits_checked: int = 0          # tenants examined (incl. refusals)
    wall_s: float = 0.0              # host wall time of this call (§10)
    refresh_started: bool = False    # embedder refresh kicked off (§11)
    refresh_published: bool = False  # candidate embedder swapped in (§11)
    refresh_rolled_back: bool = False  # candidate failed the eval gate
    refresh_in_flight: bool = False  # train + re-embed still running
    refresh_wall_s: float = 0.0      # wall time of the published refresh
    embed_version: int = 0           # live embedder version after the call
    cold_promoted: int = 0           # re-hot rows promoted cold -> warm (§12)
    cold_route_rebuilt: bool = False  # cold routing re-fit this tick (§12)
    expired_reaped: int = 0          # TTL-expired rows reaped from every
    #                                  tier this tick (§14.2)


@dataclass(frozen=True)
class CommitReceipt:
    """Write-side outcome of one commit."""
    admitted: int                    # rows cached
    skipped: int                     # rows the admission rule dropped
    evicted: int                     # host strings freed by this commit
    rebuild_due: bool = False        # obligation: call maintenance() soon
    demoted_cold: int = 0            # warm-ring evictions captured by the
                                     # cold tier this commit (§12)
    cold_maintenance_due: bool = False  # obligation: pending cold
                                     # promotions / routing refit (§12)
    embed_version: int = 0           # live embedder version at commit (§11)
    stale_version_skipped: int = 0   # rows rejected: plan embedded under an
                                     # older embedder version than is live
    ttl_stamped: int = 0             # admitted rows carrying a finite
                                     # expiry deadline (§14.2)
    maintenance: MaintenanceReport = field(default_factory=MaintenanceReport)
    commit_wall_s: float = 0.0       # host wall time of commit() (§10)
    trace_id: int = 0                # echoed from the request (§10.2)


# ---------------------------------------------------------------------------
# the backend protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class CacheBackend(Protocol):
    """What the serving pipeline requires of a semantic cache.

    Implemented by ``SemanticCache`` (flat) and ``CacheService``
    (tiered, multi-tenant); see DESIGN.md §7 for the lifecycle diagram.
    """

    def capabilities(self) -> CacheCapabilities: ...

    def plan(self, request: CacheRequest, *,
             coalesce: bool = True) -> CachePlan: ...

    def commit(self, plan: CachePlan,
               responses: Sequence[Optional[str]]) -> CommitReceipt: ...

    def maintenance(self, block: bool = False) -> MaintenanceReport: ...

    def stats_snapshot(self) -> object: ...
    # a structured snapshot: a mapping, or an object with ``to_dict()``
    # (CacheService returns its typed ServiceStats; SemanticCache a
    # plain section dict).  The v1 flat-key ``stats()`` view was
    # removed in v2.0 (README migration table).


# ---------------------------------------------------------------------------
# miss coalescing (shared by both backends' plan())
# ---------------------------------------------------------------------------

def ungrouped_misses(hit: np.ndarray) -> np.ndarray:
    """The no-coalescing miss_leader map: every miss leads itself."""
    hit = np.asarray(hit, bool)
    return np.where(hit, -1, np.arange(len(hit), dtype=np.int64))


def coalesce_misses(embeddings: np.ndarray, hit: np.ndarray,
                    tenants: np.ndarray,
                    thresholds: np.ndarray) -> np.ndarray:
    """Group near-identical misses within one batch.

    Returns the ``miss_leader`` map: -1 on hit rows; on miss rows the
    index of the earliest same-tenant miss whose cosine similarity
    reaches the *member's* hit threshold (so serving the leader's
    response to the member is exactly as sound as a cache hit at the
    member's operating point).  Members only attach to leaders, never
    to other members, so groups cannot chain-drift below threshold.
    """
    hit = np.asarray(hit, bool)
    leader = np.full(len(hit), -1, np.int64)
    miss = np.nonzero(~hit)[0]
    if len(miss) == 0:
        return leader
    em = np.asarray(embeddings, np.float32)[miss]
    em = em / np.maximum(np.linalg.norm(em, axis=-1, keepdims=True), 1e-9)
    sims = em @ em.T                     # one matmul; the scan below is
    tnt = np.asarray(tenants)[miss]      # O(misses) with vector inners
    thr = np.asarray(thresholds)[miss]
    is_leader = np.zeros(len(miss), bool)
    for a in range(len(miss)):
        ok = is_leader[:a] & (tnt[:a] == tnt[a]) & (sims[a, :a] >= thr[a])
        if ok.any():
            leader[miss[a]] = miss[int(np.argmax(ok))]   # earliest leader
        else:
            leader[miss[a]] = miss[a]
            is_leader[a] = True
    return leader
