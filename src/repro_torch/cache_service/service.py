"""CacheService — the serving-path facade over the tiered store.

The port of `repro/cache_service/service.py`.  The host half owns
response strings (a dict keyed by value id, garbage-collected from the
eviction reports every device op returns) and the per-tenant policy
table; the device half is `tiers`: a hot exact store, a warm IVF ring
and one cascaded lookup, on the service's ``device`` (the card unless
the caller asks for the CPU).

Lifecycle of an entry:

  insert (admitted miss) -> hot tier -> demotion flush -> warm ring ->
  [ring wraps, tenant evicted or TTL reaped] -> value id reported back
  -> host frees the response string.

The hot tier flushes its ``flush_size`` coldest rows to the warm ring
whenever occupancy crosses ``flush_watermark``; every
``rebuild_every``-th flush re-clusters the warm IVF inline.  Between
rebuilds the warm lookup scans a fixed tail window sized to cover
everything appended since the last rebuild.

Serving surface (DESIGN.md §7): ``plan(CacheRequest) -> CachePlan``
(cascade verdicts, hit responses, admission pre-decision, miss
coalescing), then ``commit(plan, responses) -> CommitReceipt``
(admissions, demotion flush, GC), ``maintenance()`` on the idle tick
(TTL reap, threshold and mixture-weight refits, gauges, health drain).

Learned admission (DESIGN.md §9): every commit labels its miss rows
against their stored neighbours (duplicate <=> the generated response
equals the neighbour's), a per-tenant reservoir accumulates the labeled
scores (`feedback.FeedbackAccumulator`), and ``maintenance()`` refits
each tenant's threshold and admission margin under hysteresis guards.

The ensemble (DESIGN.md §13): with ``EnsembleConfig(embedders=E)``
requests carry (B, E, D) embeddings, row 0 the *pilot*; E row-aligned
key panels ride beside the tiers and one fused cascade pass scores all
of them with per-tenant mixture weights (uniform 1/E by default).  With
learned admission the weights are re-learned per tenant from the
feedback stream, each refit recalibrating the tenant's threshold
against the fused score; ``publish_panel`` swaps one embedder's panels.

Double-buffered rebuild (DESIGN.md §7): with ``background_rebuild``
a flush that would re-cluster inline starts a shadow build of a
snapshot on a host thread instead; lookups keep reading the published
index and ``maintenance()`` swaps the finished shadow in.  Conformal
calibration (§14.3) floors every served threshold at a quantile of the
tenant's recent audited negatives.  The cold tier (§12) catches
warm-ring overwrites in host RAM, answers below-threshold queries the
router deems worth a budgeted fetch, and ``maintenance()`` promotes
re-hot rows back into the warm ring.

The online embedder refresh (DESIGN.md §11): the feedback stream also
pools labeled query *text* pairs, and ``maintenance()`` runs a one-epoch
contrastive fine-tune of a candidate embedder on a host thread, judges
it on a held-out slice, re-embeds both tiers' retained texts and
hot-swaps the new keys and weights in with a versioned publish (or rolls
the candidate back).

The sharded warm tier (DESIGN.md §8): with ``ShardingConfig(mesh=...)``
(a ``DeviceMesh``) the warm ring splits into one ring and local IVF per
rank of the mesh's shard axis, flushes round-robin over the shards, and
lookups merge the shards' local top-k with one tiny collective.  The
service is SPMD: every rank runs the same calls on the same requests,
so the replicated state (hot tier, policies, response strings) stays
equal; what differs per rank (its warm shard) reaches the host only
through collectives, and every decision that depends on a shard —
backlog, occupancy, a finished shadow build or refresh — is reduced
over the ranks before it is taken.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.cache_service import tiers
from repro_torch.cache_service.cold import ColdTier
from repro_torch.cache_service.config import CacheConfig
from repro_torch.cache_service.feedback import (
    FeedbackAccumulator, record_refit,
)
from repro_torch.cache_service.policy import (
    EmbedderRefreshPolicy, PolicyTable, TenantPolicy,
)
from repro_torch.cache_service.protocol import (
    CacheCapabilities, CachePlan, CacheRequest, CommitReceipt,
    MaintenanceReport, coalesce_misses, ungrouped_misses,
)
from repro_torch.core import distrib
from repro_torch.core.calibration import Calibration
from repro_torch.device import resolve_device
from repro_torch.obs import Telemetry
from repro_torch.obs.registry import SCHEMA, tenant_label


@dataclass(frozen=True)
class ServiceStats:
    """Typed, schema-stable ``CacheService`` snapshot (DESIGN.md §10.1);
    every count is read from the telemetry registry."""
    schema: str
    traffic: Dict[str, int]
    admission: Dict[str, int]
    tiers: Dict[str, object]
    rebuild: Dict[str, object]
    learning: Optional[Dict[str, object]]
    health: Optional[Dict[str, object]]
    refresh: Optional[Dict[str, object]] = None

    def to_dict(self) -> Dict[str, object]:
        return {
            "schema": self.schema, "traffic": dict(self.traffic),
            "admission": dict(self.admission), "tiers": dict(self.tiers),
            "rebuild": dict(self.rebuild),
            "learning": dict(self.learning) if self.learning else None,
            "health": dict(self.health) if self.health else None,
            "refresh": dict(self.refresh) if self.refresh else None,
        }


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class CacheService:
    def __init__(self, config: CacheConfig, *, device="cuda"):
        """Build the tiered service from a ``CacheConfig`` on ``device``
        (default the card; raises when CUDA is absent).  The config is
        the only construction surface: the reference's flat-kwargs form
        is not ported (``CacheConfig.from_kwargs`` maps its names).

        Tail invariant: rows demoted into the warm ring stay unindexed
        until the next IVF rebuild and are reachable only through the
        brute-force tail window over the last ``tail`` ring writes, so
        ``tail = flush_size * rebuild_every`` must not exceed
        ``warm_capacity``.  When it does, the window is clamped, flushes
        force rebuilds earlier than ``rebuild_every`` says, and
        construction warns.

        ``fused=True`` routes the cascade through the fused lookup
        kernel (`kernels/cascade_lookup`): the CUDA kernel on a card,
        its plain torch version on the CPU — same results either way.
        ``warm_dtype="int8"`` scans the warm panel from its per-row int8
        quantization and re-scores the selected rows exactly.
        ``warm_block`` is accepted and has no effect: it is a TPU
        VMEM-residency knob, and the CUDA kernel tiles internally.

        ``background_rebuild=True`` double-buffers the IVF rebuild: a
        flush that would re-cluster inline starts a shadow build of a
        snapshot on a host thread (its kernels queue on the device's
        default stream, behind the lookups already issued); lookups keep
        reading the published index and ``maintenance()`` swaps the
        finished shadow in.  A flush that would push the unindexed
        backlog past the tail window first joins the build in flight (or
        re-clusters inline if none runs), so no row is stranded.

        ``cold_capacity > 0`` adds the host-RAM cold tier (DESIGN.md
        §12); ``cold_policy`` tunes its router and implies a cold tier
        of ``4 * warm_capacity`` rows when ``cold_capacity`` is 0.

        ``StalenessConfig`` turns on TTL eviction: admitted rows are
        stamped ``now + ttl``, expired rows are masked out of every
        plan's view of the tiers (cold included) and reaped on
        ``maintenance()``.  All times are relative to the clock's value
        at construction, because float32 deadlines on absolute epoch
        seconds would round to ~256 s steps.

        ``LearningConfig(learned_admission=True)`` (or a ``feedback``
        config) turns on the §9 feedback loop; ``conformal=True`` the
        §14.3 floor, which shares the feedback accumulator.

        ``learned_embedder=True`` closes the paper's training loop at
        serving time (§11): the feedback stream also pools labeled text
        pairs, and ``maintenance()`` periodically runs a one-epoch
        contrastive refresh of a candidate copy of ``embedder_trainer``
        (with ``embedder_tokenizer``; both required) on a host thread —
        grammar-synthesized pairs backfill a thin or one-class pool —
        then re-embeds both tiers' retained texts and publishes the new
        keys and weights between lookups.  Every plan carries the
        embedder version it embedded under; commit rejects admissions
        from an older version.  A candidate that fails the held-out
        eval gate is rolled back without ever becoming visible.
        ``refresh_policy`` tunes the trigger and the gate (it implies
        ``learned_embedder``).  The thread's kernels go to the device's
        default stream, as the shadow rebuild's do.

        ``EnsembleConfig(embedders=E)`` (an int, or a sequence of E
        embedder handles) turns on the §13 ensemble; ``weights`` seeds
        the default mixture.  ``embedders`` excludes
        ``learned_embedder`` (the §11 refresh retrains the single pilot
        embedder), and ``weights`` needs ``embedders``.

        ``ShardingConfig(mesh=...)`` shards the warm tier over the
        mesh's ``shard_axis`` (DESIGN.md §8): ``S`` per-shard rings,
        with capacity, clusters and the tail window split per shard and
        ``flush_size`` snapped to a multiple of ``S``; each rank holds
        its own shard.  Every rank must make the same calls in the same
        order.  A cold tier needs the unsharded warm ring.
        """
        if not isinstance(config, CacheConfig):
            raise TypeError(f"CacheService takes a CacheConfig, got "
                            f"{type(config).__name__}")
        self.device = resolve_device(device)
        cfg = self.config = config
        tc, stc = cfg.tiering, cfg.staleness
        lc, ec = cfg.learning, cfg.ensemble
        dim = cfg.dim
        embedders = ec.embedders
        n_embedders = 0 if embedders is None else embedders \
            if isinstance(embedders, int) else len(embedders)
        if n_embedders < 0 or n_embedders == 0 and embedders is not None:
            raise ValueError(f"embedders must name at least one "
                             f"embedder, got {embedders!r}")
        self.n_embedders = n_embedders
        if n_embedders and (lc.learned_embedder
                            or lc.refresh_policy is not None
                            or lc.embedder_trainer is not None):
            raise ValueError(
                "embedders= and learned_embedder= are mutually "
                "exclusive: the §11 refresh retrains the single pilot "
                "embedder in place; under an ensemble a candidate "
                "embedder is published per panel via publish_panel() "
                "instead (DESIGN.md §13)")
        if ec.weights is not None and not n_embedders:
            raise ValueError("ensemble weights without embedders")
        cold_capacity = tc.cold_capacity
        if tc.cold_policy is not None and cold_capacity <= 0:
            cold_capacity = 4 * tc.warm_capacity
        mesh, shard_axis = cfg.sharding.mesh, cfg.sharding.shard_axis
        sharded = mesh is not None
        shards = distrib.axis_size(mesh, shard_axis) if sharded else 1
        if cold_capacity > 0 and sharded:
            raise ValueError(
                "cold_capacity > 0 requires the unsharded warm tier: "
                "demotion capture reads the single warm ring's int8 "
                "panel (DESIGN.md §12)")
        hot_capacity, warm_capacity = tc.hot_capacity, tc.warm_capacity
        flush_size = tc.flush_size
        if flush_size is None:
            flush_size = max(hot_capacity // 4, 1)
        flush_size = min(flush_size, hot_capacity, warm_capacity)
        if sharded:
            if hot_capacity < shards:
                raise ValueError(
                    f"hot_capacity {hot_capacity} < {shards} shards: one "
                    "demotion flush cannot feed every warm shard")
            # flushes split round-robin over shards: keep them divisible
            flush_size = max(shards, (flush_size // shards) * shards)
            warm_capacity = -(-warm_capacity // shards) * shards
        rebuild_every = max(tc.rebuild_every, 1)
        cap_local = warm_capacity // shards
        flush_local = flush_size // shards
        # every row appended since the last rebuild lies in the tail
        # window (per shard: each flush lands flush_local rows on each)
        if flush_local * rebuild_every > cap_local:
            warnings.warn(
                f"tail window flush_size*rebuild_every ({flush_local}*"
                f"{rebuild_every}={flush_local * rebuild_every} per shard) "
                f"exceeds the per-shard warm capacity {cap_local}; "
                "clamping and forcing IVF rebuilds before the unindexed "
                "backlog outgrows the window (the configured rebuild "
                "cadence will not be honored)", stacklevel=2)
        self.dim = dim
        self.hot_capacity = hot_capacity
        self.warm_capacity = warm_capacity
        self.flush_size = flush_size
        self.flush_watermark = tc.flush_watermark
        self.rebuild_every = rebuild_every
        self.topk = cfg.topk
        self.background_rebuild = bool(tc.background_rebuild)
        self.warm_shards = shards
        self.warm_dtype = tc.warm_dtype
        self.warm_block = tc.warm_block
        self._mesh, self._shard_axis = mesh, shard_axis
        self._group = mesh.get_group(shard_axis) if sharded else None
        self._flush_local = flush_local
        self._kmeans_iters = tc.kmeans_iters
        self._seed = cfg.seed
        self._tail = min(flush_local * rebuild_every, cap_local)
        self._n_probe = tc.n_probe
        self.cold: Optional[ColdTier] = \
            ColdTier(cold_capacity, dim, policy=tc.cold_policy,
                     device=self.device) if cold_capacity > 0 else None
        self.hot = tiers.init_hot(hot_capacity, dim, self.device)
        if sharded:
            # this rank's own (1, …) shard: what `place_warm_sharded`
            # keeps of the stacked state, without building the others
            self.warm = tiers.init_warm_sharded(
                1, cap_local, dim, max(tc.n_clusters // shards, 1),
                tc.bucket, self.device)
        else:
            self.warm = tiers.init_warm(warm_capacity, dim, tc.n_clusters,
                                        tc.bucket, self.device)
        self.policies = PolicyTable(TenantPolicy(cfg.threshold,
                                                 cfg.admission_margin))
        # §13: E row-aligned key panels over the shared tiers; panel 0
        # (the pilot) duplicates the base keys
        self.ens: Optional[tiers.EnsembleState] = None
        if n_embedders:
            self.ens = tiers.init_ensemble(n_embedders, self.hot, self.warm)
            if ec.weights is not None:
                self.policies.set_default_weights(ec.weights)
        self.learned_admission = bool(lc.learned_admission
                                      or lc.feedback is not None)
        learned_embedder = bool(lc.learned_embedder
                                or lc.refresh_policy is not None)
        if learned_embedder and (lc.embedder_trainer is None
                                 or lc.embedder_tokenizer is None):
            raise ValueError(
                "learned_embedder=True needs embedder_trainer and "
                "embedder_tokenizer — the refresh trains the candidate "
                "and re-embeds the corpus through them (DESIGN.md §11)")
        self.trainer = lc.embedder_trainer if learned_embedder else None
        self._embed_tok = lc.embedder_tokenizer if learned_embedder \
            else None
        self._refresh_policy = (lc.refresh_policy
                                or EmbedderRefreshPolicy()) \
            if learned_embedder else None
        # §14.3 conformal hit calibration needs the feedback stream: the
        # §9 admission loop, the §11 refresh and the floor share one
        # accumulator (scores feed the per-tenant reservoirs, texts the
        # pooled pair reservoir)
        self.conformal = bool(lc.conformal)
        self.feedback: Optional[FeedbackAccumulator] = \
            FeedbackAccumulator(lc.feedback) \
            if self.learned_admission or learned_embedder \
            or self.conformal else None
        self.responses: Dict[int, str] = {}
        # raw query text per admitted value id: the neighbour side of
        # the labeled pairs the feedback stream pools, and what a
        # refreshed embedder re-embeds a stored key from (§11)
        self._texts: Dict[int, str] = {}
        self._next_vid = 0
        self._epoch = 0              # bumped by evict_tenant (plan staleness)
        self._embed_version = 0      # bumped by a published refresh (§11)
        self._pairs_at_refresh = 0   # pair-reservoir watermark (§11)
        self._recalibrated_thr: Optional[float] = None
        self._last_rebuild_s = 0.0
        self._rebuild_total_s = 0.0
        self._last_refresh_s = 0.0
        self._refresh_total_s = 0.0
        # host ints that receipts and overlap accounting need even with
        # telemetry disabled
        self._n_plans = 0
        self._n_evictions = 0
        self._n_demoted_cold = 0
        self.default_ttl = stc.default_ttl
        raw_clock = stc.clock if stc.clock is not None else time.time
        t0 = float(raw_clock())
        self._clock = lambda: float(raw_clock()) - t0
        self._ttl_active = stc.default_ttl is not None
        self.telemetry = cfg.telemetry if cfg.telemetry is not None \
            else Telemetry()
        if self.telemetry.health is not None and self.feedback is not None:
            fb_cfg = self.feedback.config
            self.telemetry.health.set_budget_source(
                lambda t: fb_cfg.max_false_hit_rate)
        reg = self.telemetry.registry
        self._stage_h = self.telemetry.stage_histogram()
        self._c_plans = reg.counter(
            "cache_plans_total", "plan() calls").labels()
        self._c_commits = reg.counter(
            "cache_commits_total", "commit() calls").labels()
        self._c_stale = reg.counter(
            "cache_stale_commits_total",
            "commits whose plan predates an epoch bump").labels()
        self._c_rows = reg.counter(
            "cache_lookup_rows_total", "rows planned").labels()
        c_hits = reg.counter("cache_hits_total", "plan-time hits by tier",
                             labels=("tier",))
        self._c_hot_hits = c_hits.labels(tier="hot")
        self._c_warm_hits = c_hits.labels(tier="warm")
        self._c_cold_hits = c_hits.labels(tier="cold")
        self._m_admissions = reg.counter(
            "cache_admissions_total", "commit-time admission decisions",
            labels=("tenant", "decision"))
        self._c_demotions = reg.counter(
            "cache_demotions_total", "rows demoted hot -> warm").labels()
        self._c_evictions = reg.counter(
            "cache_evictions_total", "host response strings freed").labels()
        # §12 eviction split: a warm-ring overwrite either *demotes* (the
        # cold tier captured the row) or *drops* (no cold tier: the
        # string is freed); with a cold tier the final drops happen on
        # cold-ring overwrites instead
        self._c_ev_demoted = reg.counter(
            "cache_evictions_demoted_total",
            "warm-ring overwrites captured into the cold tier").labels()
        self._c_ev_dropped = reg.counter(
            "cache_evictions_dropped_total",
            "warm-ring overwrites freed with no cold tier to catch "
            "them").labels()
        self._c_cold_evictions = reg.counter(
            "cache_cold_evictions_total",
            "cold-ring overwrites — the hierarchy's final drops"
        ).labels()
        self._c_cold_promotions = reg.counter(
            "cache_cold_promotions_total",
            "re-hot rows promoted cold -> warm by maintenance()"
        ).labels()
        self._c_cold_fetches = reg.counter(
            "cache_cold_fetches_total",
            "queries whose cold fetch the router approved").labels()
        self._c_cold_fetched_rows = reg.counter(
            "cache_cold_fetched_rows_total",
            "candidate rows shipped host -> device for the exact "
            "re-score").labels()
        self._c_cold_router_skips = reg.counter(
            "cache_cold_router_skips_total",
            "below-threshold queries whose cold fetch the router "
            "declined as not worth the transfer").labels()
        self._c_rebuilds = reg.counter(
            "cache_rebuilds_total",
            "IVF re-clusters completed (published or inline)").labels()
        self._c_shadow = reg.counter(
            "cache_shadow_rebuilds_total", "shadow builds started").labels()
        self._c_stale_ver = reg.counter(
            "cache_stale_version_commits_total",
            "admissions rejected because the plan embedded under an "
            "older embedder version than is live (§11)").labels()
        c_ref = reg.counter(
            "cache_embedder_refreshes_total",
            "embedder refresh lifecycle events (§11)",
            labels=("outcome",))
        self._c_refresh_started = c_ref.labels(outcome="started")
        self._c_refresh_published = c_ref.labels(outcome="published")
        self._c_refresh_rolled_back = c_ref.labels(outcome="rolled_back")
        self._c_ttl_stamped = reg.counter(
            "cache_ttl_stamped_total",
            "admitted rows stamped with a finite expiry (§14.2)").labels()
        self._c_expired_masked = reg.counter(
            "cache_expired_masked_total",
            "TTL-expired rows masked out of plan-time tier views "
            "(§14.2)").labels()
        self._c_expired_reaped = reg.counter(
            "cache_expired_reaped_total",
            "TTL-expired rows reaped by maintenance() across all "
            "tiers (§14.2)").labels()
        # double-buffer state: the shadow thread re-clusters a snapshot;
        # only _publish_shadow, on the serving thread, swaps it in
        self._shadow_thread: Optional[threading.Thread] = None
        self._shadow_box: Dict[str, object] = {}
        # refresh double-buffer (§11): the thread trains a candidate
        # embedder and re-embeds tier snapshots; _finish_refresh, on the
        # serving thread, publishes or rolls back
        self._refresh_thread: Optional[threading.Thread] = None
        self._refresh_box: Dict[str, object] = {}
        self.fused = bool(tc.fused)

    def set_fused(self, fused: bool) -> None:
        """Select the cascade execution path (four-op vs fused kernel)."""
        self.fused = bool(fused)

    def _lookup(self, hot, warm, q, qt, thr) -> tiers.CascadeResult:
        return tiers.cascade_query(
            hot, warm, q, qt, thr, k=self.topk, n_probe=self._n_probe,
            tail=self._tail, fused=self.fused,
            quantized=self.warm_dtype == "int8", mesh=self._mesh,
            axis=self._shard_axis, warm_block_n=self.warm_block)

    def _ens_lookup(self, hot, warm, q, w, qt, thr) -> tiers.EnsembleResult:
        return tiers.ensemble_cascade_query(
            hot, warm, self.ens, q, w, qt, thr, k=self.topk,
            n_probe=self._n_probe, tail=self._tail, fused=self.fused,
            quantized=self.warm_dtype == "int8", mesh=self._mesh,
            axis=self._shard_axis, warm_block_n=self.warm_block)

    def _over_shards(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                     ) -> int:
        """A count of this rank's warm shard reduced over every shard
        (as is without a mesh)."""
        if self._group is not None:
            x = distrib.all_reduce(self._group, x, op)
        return int(x)

    def _finished(self, thread: threading.Thread) -> bool:
        """``thread`` is done on every rank, so all ranks publish its
        result at the same call."""
        done = int(not thread.is_alive())
        if self._group is None:
            return bool(done)
        return bool(self._over_shards(
            torch.tensor(done, device=self.device),
            dist.ReduceOp.MIN))

    def _t(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    # tenant policy surface
    # ------------------------------------------------------------------
    def set_tenant_policy(self, tenant: int, threshold: float,
                          admission_margin: float = 0.0) -> None:
        self.policies.set(tenant, TenantPolicy(threshold, admission_margin))

    def calibrate_tenant(self, tenant: int, scores, labels,
                         max_false_hit_rate: float = 0.01) -> Calibration:
        """Set this tenant's threshold from its own eval pairs under a
        false-hit budget."""
        return self.policies.calibrate(tenant, scores, labels,
                                       max_false_hit_rate)

    def set_tenant_weights(self, tenant: int, weights) -> None:
        """Pin one tenant's ensemble mixture weights (§13), normalized
        to the simplex; learned refits may still move them later."""
        if self.ens is None:
            raise ValueError("set_tenant_weights needs embedders=")
        self.policies.set_weights(tenant, weights)

    def publish_panel(self, e: int, hot_keys, warm_keys) -> None:
        """Versioned publish of ONE embedder's key panels (DESIGN.md
        §13): ``hot_keys`` (Nh, D) and ``warm_keys`` (Nw, D) are the
        full-capacity panels under the candidate embedder (valid rows
        re-embedded, every other row carrying its current key); a
        sharded warm panel is (S, Nw_local, D) stacked, or this rank's
        (1, Nw_local, D) shard.  Per-slot metadata and the pilot-built
        IVF are untouched.  Publishing the pilot (e=0) swaps the base
        tiers' keys too.  The embedder version bumps either way, so plans
        embedded under the old panel set are rejected at commit."""
        if self.ens is None:
            raise ValueError("publish_panel needs embedders=")
        if not 0 <= int(e) < self.n_embedders:
            raise ValueError(f"panel {e} out of range "
                             f"[0, {self.n_embedders})")
        hk = self._t(hot_keys, torch.float32)
        wk = self._t(warm_keys, torch.float32)
        if self._mesh is not None:
            wk = tiers.local_shard(wk, self._mesh, self._shard_axis)
        self.ens = tiers.publish_panel(self.ens, int(e), hk, wk)
        if int(e) == 0:
            self.hot, self.warm = tiers.publish_reembedded_keys(
                self.hot, self.warm, hk, wk)
        self._embed_version += 1

    # ------------------------------------------------------------------
    # CacheBackend protocol: plan / commit / maintenance / stats
    # ------------------------------------------------------------------
    def capabilities(self) -> CacheCapabilities:
        return CacheCapabilities(tenants=True, fused_lookup=True,
                                 admission=True,
                                 background_rebuild=self.background_rebuild,
                                 tiered=True,
                                 warm_sharded=self._mesh is not None,
                                 warm_dtype=self.warm_dtype,
                                 learned_admission=self.learned_admission,
                                 learned_embedder=self.trainer is not None,
                                 cold_tier=self.cold is not None,
                                 ensemble=self.n_embedders, ttl=True,
                                 conformal=self.conformal)

    def plan(self, request: CacheRequest, *,
             coalesce: bool = True) -> CachePlan:
        """Read side: one cascade over both tiers, the cold fallback,
        LRU touch, response resolution, admission pre-decision, miss
        coalescing."""
        t0 = time.perf_counter()
        qt = request.tenants
        # §14.3: the conformal floor rides every threshold resolution
        thr = self.policies.effective_thresholds(
            qt, self.feedback if self.conformal else None)
        now = float(self._clock()) if self._ttl_active else None
        hot_view, warm_view = self.hot, self.warm
        n_masked = 0
        if now is not None:
            hot_view, warm_view, nm = tiers.mask_expired(
                self.hot, self.warm, now, self._group)
            n_masked = int(nm)
            if n_masked:
                self._c_expired_masked.inc(n_masked)
        panel_scores = None
        if self.ens is not None:
            # §13: one fused pass over all E panels; the pilot slice
            # (row 0) feeds miss coalescing downstream
            emb = np.asarray(request.embeddings)
            if emb.ndim != 3 or emb.shape[1] != self.n_embedders:
                raise ValueError(
                    f"ensemble backend expects (B, {self.n_embedders}, D)"
                    f" embeddings, got {emb.shape}")
            pilot = emb[:, 0]
            weights = self.policies.weights_for(qt, self.n_embedders)
            res = self._ens_lookup(hot_view, warm_view,
                                   self._t(emb, torch.float32),
                                   self._t(weights, torch.float32),
                                   self._t(qt, torch.int32),
                                   self._t(thr, torch.float32))
            panel_scores = _np(res.panel_scores)
        else:
            pilot = np.asarray(request.embeddings)
            res = self._lookup(hot_view, warm_view,
                               self._t(pilot, torch.float32),
                               self._t(qt, torch.int32),
                               self._t(thr, torch.float32))
        self.hot = tiers.hot_touch(self.hot, res.hot_slots, res.hot_hit)
        hit = _np(res.hit)
        scores = _np(res.scores[:, 0])
        vids = _np(res.value_ids[:, 0]).astype(np.int64)
        hot_hit = _np(res.hot_hit)
        self._n_plans += 1
        self._c_plans.inc()
        self._c_rows.inc(len(hit))
        self._c_hot_hits.inc(int(hot_hit.sum()))
        self._c_warm_hits.inc(int((hit & ~hot_hit).sum()))
        if self.cold is not None and bool((~hit).any()):
            # §12 cold fallback: only the below-threshold rows are
            # offered, and the cold tier's router decides which justify
            # a host -> device fetch.  Verdicts merge before everything
            # downstream, so a cold hit is a hit everywhere.
            tc = time.perf_counter()
            qn = np.asarray(pilot, np.float32)
            qn = qn / np.maximum(
                np.linalg.norm(qn, axis=1, keepdims=True), 1e-9)
            cf = self.cold.lookup(qn, np.asarray(qt),
                                  np.asarray(thr, np.float32), ~hit,
                                  now=now)
            self._stage_h.observe(time.perf_counter() - tc,
                                  stage="cold_fetch",
                                  tenant=tenant_label(qt))
            self._c_cold_fetches.inc(int(cf.consulted.sum()))
            self._c_cold_fetched_rows.inc(cf.fetched_rows)
            self._c_cold_router_skips.inc(cf.router_skips)
            chit = cf.consulted & (cf.scores >= np.asarray(thr, np.float32))
            if bool(chit.any()):
                self._c_cold_hits.inc(int(chit.sum()))
                hit = hit | chit
                scores = np.where(chit, cf.scores, scores)
                vids = np.where(chit, cf.value_ids, vids)
        responses = [self.responses.get(int(v)) if h else None
                     for h, v in zip(hit, vids)]
        admit = self.policies.pre_decision(qt, scores, hit)
        if self.feedback is not None:
            self.feedback.observe_plan(hit)
        if self.telemetry.health is not None:
            self.telemetry.health.observe_plan(qt, hit)
        leader = coalesce_misses(pilot, hit, qt, thr) \
            if coalesce else ungrouped_misses(hit)
        wall = time.perf_counter() - t0
        self._stage_h.observe(wall, stage="plan", tenant=tenant_label(qt))
        return CachePlan(
            request=request, hit=hit, scores=scores,
            value_ids=np.where(hit, vids, -1), responses=responses,
            admit=admit, miss_leader=leader, epoch=self._epoch,
            margins=np.asarray(thr, np.float32) - scores,
            top_value_ids=vids, plan_wall_s=wall,
            embed_version=self._embed_version,
            panel_scores=panel_scores, expired_masked=n_masked)

    def commit(self, plan: CachePlan,
               responses: Sequence[Optional[str]]) -> CommitReceipt:
        """Write side: admit planned misses (fresh value ids — a stale
        plan can never resurrect an id freed since plan time), flush if
        over the watermark, GC reported evictions."""
        t0 = time.perf_counter()
        self._c_commits.inc()
        if plan.epoch != self._epoch:
            self._c_stale.inc()
        rows = plan.miss_rows()
        admit = plan.admit[rows]
        n_stale_ver = 0
        if plan.embed_version != self._embed_version and len(rows):
            # the plan embedded under an embedder version that has since
            # been swapped (a refresh or publish_panel): its hits were
            # served consistently, but admitting its rows would plant
            # old-space keys into the new panels — reject them
            n_stale_ver = int(np.asarray(admit, bool).sum())
            admit = np.zeros_like(np.asarray(admit, bool))
            if n_stale_ver:
                self._c_stale_ver.inc(n_stale_ver)
        texts: List[Optional[str]] = [responses[i] for i in rows]
        for pos in np.nonzero(admit)[0]:
            if texts[pos] is None:
                raise ValueError(
                    f"admitted row {int(rows[pos])} has no response")
        if self.feedback is not None:
            self._observe_feedback(plan, rows, admit, texts)
        req_texts = plan.request.texts
        vids = np.full(len(rows), -1, np.int64)
        for pos in np.nonzero(admit)[0]:
            vids[pos] = self._next_vid
            self.responses[self._next_vid] = texts[pos]
            if req_texts is not None:
                self._texts[self._next_vid] = str(req_texts[int(rows[pos])])
            self._next_vid += 1
        n_admit = int(admit.sum())
        row_tenants = plan.request.tenants[rows]
        for tid in np.unique(row_tenants):
            m = row_tenants == tid
            n_a = int(admit[m].sum())
            if n_a:
                self._m_admissions.inc(n_a, tenant=int(tid),
                                       decision="admitted")
            if int(m.sum()) - n_a:
                self._m_admissions.inc(int(m.sum()) - n_a,
                                       tenant=int(tid), decision="skipped")
        evicted_before = self._n_evictions
        demoted_cold_before = self._n_demoted_cold
        n_ttl = 0
        if len(rows):
            if plan.request.ttl is not None:
                ttl_rows = np.asarray(plan.request.ttl, np.float32)[rows]
            else:
                ttl_rows = np.full(
                    len(rows),
                    np.inf if self.default_ttl is None
                    else float(self.default_ttl), np.float32)
            expires = np.full(len(rows), np.inf, np.float32)
            fin = np.isfinite(ttl_rows)
            if fin.any():
                expires[fin] = np.float32(float(self._clock())) \
                    + ttl_rows[fin]
            n_ttl = int((fin & np.asarray(admit, bool)).sum())
            if n_ttl:
                self._ttl_active = True
                self._c_ttl_stamped.inc(n_ttl)
            args = (self._t(plan.request.embeddings[rows], torch.float32),
                    self._t(vids, torch.int32),
                    self._t(plan.request.tenants[rows], torch.int32),
                    self._t(expires, torch.float32))
            if self.ens is not None:
                # (B, E, D) rows: the base insert takes the pilot slice,
                # the mirrored panels take the same slots (§13)
                self.hot, self.ens, evicted = \
                    tiers.ensemble_hot_insert_batch(self.hot, self.ens,
                                                    *args)
            else:
                self.hot, evicted = tiers.hot_insert_batch(self.hot, *args)
            self._gc(evicted)
            self._maybe_flush()
        wall = time.perf_counter() - t0
        self._stage_h.observe(wall, stage="commit",
                              tenant=tenant_label(plan.request.tenants))
        return CommitReceipt(
            admitted=n_admit, skipped=int((~admit).sum()),
            evicted=self._n_evictions - evicted_before,
            # a due policy refit or embedder refresh is a maintenance
            # obligation exactly like a due rebuild: the pipeline
            # discharges all three with one maintenance() call between
            # batches
            rebuild_due=self._rebuild_due()
            or (self.learned_admission and self.feedback.refit_due())
            or self._refresh_thread is not None or self._refresh_due(),
            commit_wall_s=wall, trace_id=plan.request.trace_id,
            embed_version=self._embed_version,
            stale_version_skipped=n_stale_ver, ttl_stamped=n_ttl,
            demoted_cold=self._n_demoted_cold - demoted_cold_before,
            cold_maintenance_due=self.cold is not None
            and self.cold.maintenance_due)

    def maintenance(self, block: bool = False) -> MaintenanceReport:
        """The idle tick (DESIGN.md §10.3): publish a finished shadow
        index and start one if the backlog calls for it, threshold
        refits (§9) and mixture-weight refits (§13) from the feedback
        stream, publish or roll back a finished embedder refresh and
        start one when due (§11), reap TTL-expired rows, drain cold
        promotions and re-fit cold routes (§12), publish gauges, drain
        the health tracker.  ``block=True`` quiesces: it joins a build
        or refresh in flight and never starts one, so the service
        returns with nothing running."""
        t0 = time.perf_counter()
        published = started = False
        wall = 0.0
        if self._shadow_thread is not None and (
                block or self._finished(self._shadow_thread)):
            wall = self._publish_shadow()
            published = True
        if (not block and self.background_rebuild
                and self._shadow_thread is None and self._tail_pressure()):
            self._start_shadow()
            started = True
        # §11: publish (or roll back) a finished candidate, then start
        # one if the pair reservoir says a refresh is due
        r_published = r_started = r_rolled = False
        r_wall = 0.0
        if self.trainer is not None:
            if self._refresh_thread is not None and (
                    block or self._finished(self._refresh_thread)):
                r_wall, r_published, r_rolled = self._finish_refresh()
            if (not block and self._refresh_thread is None
                    and self._refresh_due()):
                self._start_refresh()
                r_started = True
        refits_applied = refits_checked = 0
        if self.feedback is not None and self.learned_admission:
            # republish every tenant policy whose reservoir survives the
            # hysteresis guards — host-only work
            reports = self.policies.refit(self.feedback)
            refits_checked = len(reports)
            refits_applied = sum(r.applied for r in reports)
            for rep in reports:
                record_refit(self.telemetry.registry, rep)
        if self.feedback is not None and self.ens is not None:
            # §13: an applied weight fit republishes the tenant's weights
            # and its fused-score-recalibrated threshold together
            wreps = self.policies.refit_weights(self.feedback,
                                                self.n_embedders)
            refits_checked += len(wreps)
            refits_applied += sum(r.applied for r in wreps)
            wc = self.telemetry.registry.counter(
                "ensemble_weight_refits_total",
                "per-tenant mixture-weight refit decisions by outcome "
                "(§13)", labels=("tenant", "outcome"))
            wg = self.telemetry.registry.gauge(
                "ensemble_weight", "published per-tenant mixture weight",
                labels=("tenant", "embedder"))
            for rep in wreps:
                wc.inc(1, tenant=rep.tenant,
                       outcome="applied" if rep.applied else rep.reason)
                if rep.applied:
                    for e, w in enumerate(rep.new_weights):
                        wg.set(float(w), tenant=rep.tenant, embedder=e)
        expired_reaped = 0
        if self._ttl_active:
            now = float(self._clock())
            self.hot, self.warm, h_ev, w_ev = tiers.reap_expired(
                self.hot, self.warm, now, self._group)
            expired_reaped = self._gc(h_ev) + self._gc(w_ev)
            if self.cold is not None:
                expired_reaped += self._gc(self.cold.reap_expired(now))
            if expired_reaped:
                self._c_expired_reaped.inc(expired_reaped)
        cold_promoted = 0
        cold_route_rebuilt = False
        if self.cold is not None:
            # §12 promotion: re-hot cold rows climb back into the warm
            # ring here, never on the plan path, at most promote_max
            prom = self.cold.take_promotions(self.cold.policy.promote_max)
            if prom is not None:
                self._promote_into_warm(prom)
                cold_promoted = len(prom.value_ids)
                self._c_cold_promotions.inc(cold_promoted)
                if self._backlog() > self._tail:
                    # promotions are ring appends like any flush: the
                    # tail window must keep covering them
                    self._rebuild_inline()
            if self.cold._route_due():
                self.cold.rebuild_routes()
                cold_route_rebuilt = True
        reg = self.telemetry.registry
        reg.gauge("cache_hot_occupancy",
                  "hot-tier occupancy fraction").set(self.hot_occupancy)
        reg.gauge("cache_warm_occupancy",
                  "warm-ring occupancy fraction").set(self.warm_occupancy)
        reg.gauge("cache_live_responses",
                  "host response strings held").set(len(self.responses))
        reg.gauge("cache_warm_backlog_rows",
                  "rows appended since the published index (demotion "
                  "pressure vs the tail window)").set(self._backlog())
        if self.trainer is not None:
            reg.gauge("cache_embed_version",
                      "published embedder version (§11)"
                      ).set(self._embed_version)
        if self.cold is not None:
            reg.gauge("cache_cold_occupancy",
                      "cold-tier occupancy fraction"
                      ).set(self.cold.occupancy)
            reg.gauge("cache_cold_pending_promotions",
                      "re-hot cold rows queued for warm promotion"
                      ).set(self.cold.pending_promotions)
        if self.telemetry.health is not None:
            self.telemetry.health.drain(reg)
        host_wall = time.perf_counter() - t0
        self._stage_h.observe(host_wall, stage="maintenance", tenant="-")
        return MaintenanceReport(
            rebuild_started=started, rebuild_published=published,
            rebuild_in_flight=self._shadow_thread is not None,
            rebuild_wall_s=wall,
            refits_applied=refits_applied, refits_checked=refits_checked,
            wall_s=host_wall,
            refresh_started=r_started, refresh_published=r_published,
            refresh_rolled_back=r_rolled,
            refresh_in_flight=self._refresh_thread is not None,
            refresh_wall_s=r_wall, embed_version=self._embed_version,
            cold_promoted=cold_promoted,
            cold_route_rebuilt=cold_route_rebuilt,
            expired_reaped=expired_reaped)

    def stats_snapshot(self) -> ServiceStats:
        """The typed stats surface (DESIGN.md §10.1): every count read
        back from the telemetry registry."""
        reg = self.telemetry.registry
        traffic = {
            "plans": int(reg.value("cache_plans_total")),
            "commits": int(reg.value("cache_commits_total")),
            "stale_commits": int(reg.value("cache_stale_commits_total")),
            "lookup_rows": int(reg.value("cache_lookup_rows_total")),
            "hot_hits": int(reg.value("cache_hits_total", tier="hot")),
            "warm_hits": int(reg.value("cache_hits_total", tier="warm")),
            "cold_hits": int(reg.value("cache_hits_total", tier="cold")),
        }
        admission = {
            "admitted": int(reg.value("cache_admissions_total",
                                      decision="admitted")),
            "skipped": int(reg.value("cache_admissions_total",
                                     decision="skipped")),
        }
        tiers_d = {
            "hot_occupancy": self.hot_occupancy,
            "warm_occupancy": self.warm_occupancy,
            "demotions": int(reg.value("cache_demotions_total")),
            "evictions": self._n_evictions,
            "evictions_demoted": int(
                reg.value("cache_evictions_demoted_total")),
            "evictions_dropped": int(
                reg.value("cache_evictions_dropped_total")),
            "live_responses": len(self.responses),
            "warm_shards": self.warm_shards,
            "warm_dtype": self.warm_dtype,
        }
        if self.ens is not None:
            tiers_d["ensemble"] = self.n_embedders
        if self.cold is not None:
            tiers_d["cold"] = self.cold.stats()
        if self._ttl_active:
            tiers_d["staleness"] = {
                "default_ttl": self.default_ttl,
                "ttl_stamped": int(reg.value("cache_ttl_stamped_total")),
                "expired_masked": int(
                    reg.value("cache_expired_masked_total")),
                "expired_reaped": int(
                    reg.value("cache_expired_reaped_total")),
            }
        rebuild = {
            "rebuilds": int(reg.value("cache_rebuilds_total")),
            "shadow_started": int(
                reg.value("cache_shadow_rebuilds_total")),
            "in_flight": self._shadow_thread is not None,
            "last_wall_s": self._last_rebuild_s,
            "total_wall_s": self._rebuild_total_s,
        }
        learning = None
        if self.feedback is not None:
            learning = dict(self.feedback.state())
            learning["learned_policies"] = self.policies.learned_state()
            if self.ens is not None:
                learning["ensemble_weights"] = self.policies.weights_state()
            if self.conformal:
                learning["conformal"] = self.feedback.conformal_state()
        refresh = None
        if self.trainer is not None:
            refresh = {
                "embed_version": self._embed_version,
                "refreshes_started": int(reg.value(
                    "cache_embedder_refreshes_total", outcome="started")),
                "refreshes_published": int(reg.value(
                    "cache_embedder_refreshes_total", outcome="published")),
                "refreshes_rolled_back": int(reg.value(
                    "cache_embedder_refreshes_total",
                    outcome="rolled_back")),
                "stale_version_commits": int(reg.value(
                    "cache_stale_version_commits_total")),
                "refresh_in_flight": self._refresh_thread is not None,
                "last_refresh_s": self._last_refresh_s,
                "refresh_total_s": self._refresh_total_s,
                "pairs_held": len(self.feedback.pairs),
                "recalibrated_threshold": self._recalibrated_thr,
            }
        health = self.telemetry.health.snapshot() \
            if self.telemetry.health is not None else None
        return ServiceStats(schema=SCHEMA, traffic=traffic,
                            admission=admission, tiers=tiers_d,
                            rebuild=rebuild, learning=learning,
                            health=health, refresh=refresh)

    def evict_tenant(self, tenant: int) -> int:
        """Drop every entry of one tenant from every tier; frees the
        host strings.  Returns the number of entries evicted."""
        self._epoch += 1
        self.hot, self.warm, h_ev, w_ev = tiers.evict_tenant(
            self.hot, self.warm, int(tenant), self._group)
        n = self._gc(h_ev) + self._gc(w_ev)
        if self.cold is not None:
            # also purges the tenant's queued promotions: an evicted
            # tenant must not resurrect through the drain (§12)
            n += self._gc(self.cold.evict_tenant(int(tenant)))
        return n

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _observe_feedback(self, plan: CachePlan, rows: np.ndarray,
                          admit: np.ndarray,
                          texts: List[Optional[str]]) -> None:
        """Label each committed miss against its stored neighbour and
        feed the per-tenant reservoir (DESIGN.md §9): duplicate <=> the
        generated response equals the best same-tenant neighbour's
        stored response (the plan carried its id).  A row with no
        same-tenant candidate is a definite non-duplicate; a row whose
        neighbour string was GC'd between plan and commit is skipped.
        Runs before commit mints fresh ids.  Under an ensemble the same
        verdict, labeled with the candidate's per-embedder cosines, is
        the mixture-weight learner's event (§13).  With the §11 refresh
        on, every served hit also pools a positive text pair (query,
        the stored neighbour's query) — before the miss rows, in the
        reference's order, since the pair reservoir shares its random
        stream with the score reservoirs."""
        top = plan.top_value_ids
        if top is None:
            return
        tenants = plan.request.tenants
        req_texts = plan.request.texts
        if req_texts is not None and self.trainer is not None:
            for row in np.nonzero(np.asarray(plan.hit, bool))[0]:
                neigh = self._texts.get(int(plan.value_ids[row]))
                if neigh is not None:
                    self.feedback.observe_hit_pair(req_texts[int(row)],
                                                   neigh)
        for pos, row in enumerate(rows):
            text = texts[pos]
            if text is None:
                continue
            vid = int(top[row])
            if vid < 0:
                dup = False
                score = max(float(plan.scores[row]), -1.0)  # NEG sentinel
                neigh_text = None
            else:
                neighbour = self.responses.get(vid)
                if neighbour is None:
                    continue
                dup = text == neighbour
                score = float(plan.scores[row])
                neigh_text = self._texts.get(vid)
            q_text = None if req_texts is None else req_texts[int(row)]
            self.feedback.observe(int(tenants[row]), score, dup,
                                  bool(admit[pos]), text=q_text,
                                  neighbour_text=neigh_text)
            if self.ens is not None and plan.panel_scores is not None \
                    and vid >= 0:
                self.feedback.observe_ensemble(
                    int(tenants[row]), plan.panel_scores[row], dup)
            if self.telemetry.health is not None:
                self.telemetry.health.observe_admission(
                    int(tenants[row]), dup, bool(admit[pos]))

    def _gc(self, evicted) -> int:
        """Free response strings whose ids a device op reported evicted."""
        ids = _np(evicted) if torch.is_tensor(evicted) \
            else np.asarray(evicted)
        n = 0
        for v in ids[ids >= 0]:
            self._texts.pop(int(v), None)
            if self.responses.pop(int(v), None) is not None:
                n += 1
        self._n_evictions += n
        self._c_evictions.inc(n)
        return n

    def _backlog(self) -> int:
        """Rows appended since the published index was built (the worst
        shard's in the sharded tier: each shard has its own ring, so the
        window must cover the deepest one)."""
        return self._over_shards(
            (self.warm.total - self.warm.indexed_total).max(),
            dist.ReduceOp.MAX)

    def _tail_pressure(self) -> bool:
        """One more flush would push the unindexed backlog past the
        tail window."""
        return self._backlog() + self._flush_local > self._tail

    def _rebuild_due(self) -> bool:
        """A maintenance() call now would publish or start a rebuild."""
        if self._shadow_thread is not None:
            return True
        return self.background_rebuild and self._tail_pressure()

    # ------------------------------------------------------------------
    # §11: online embedder refresh (train -> gate -> re-embed -> publish)
    # ------------------------------------------------------------------
    def _refresh_due(self) -> bool:
        """The pair reservoir justifies a refresh attempt: enough pooled
        pairs of both labels, and enough new pair events since the last
        attempt.  With a ``synth_domain`` the class-balance guard is
        waived: the synthetic backfill balances a one-sided pool."""
        if self.trainer is None or self._refresh_thread is not None \
                or self.feedback is None:
            return False
        pol = self._refresh_policy
        pairs = self.feedback.pairs
        if len(pairs) < pol.min_pairs:
            return False
        if pol.synth_domain is None and (pairs.n_pos < pol.min_class
                                         or pairs.n_neg < pol.min_class):
            return False
        return self._pairs_at_refresh == 0 \
            or pairs.seen - self._pairs_at_refresh >= pol.refresh_interval

    def _start_refresh(self) -> None:
        """Start the refresh on a host thread: a one-epoch contrastive
        fit of a *candidate* trainer built from a copy of the live
        weights (fresh Adam state; the live model is never written), the
        eval gate against the live embedder on the held-out slice, then
        the re-embed of a snapshot of both tiers' texts.  Everything the
        thread reads is snapshotted here; what it produces lands in the
        box for ``_finish_refresh``.  The thread's kernels go to the
        device's default stream, behind the lookups already issued, and
        the tier snapshots stay valid because every tier op writes fresh
        tensors."""
        from repro_torch.core.trainer import EmbedderTrainer
        pol = self._refresh_policy
        self._pairs_at_refresh = self.feedback.pairs.seen
        train_ds, eval_ds = self.feedback.pairs.split(pol.eval_frac,
                                                      seed=pol.seed)
        if pol.synth_domain is not None and (
                len(train_ds.labels) < pol.synth_min_pairs
                or _single_class(train_ds) or _single_class(eval_ds)):
            train_ds, eval_ds = _synth_backfill(train_ds, eval_ds, pol)
        snap_hot, snap_warm = self.hot, self.warm
        snap_texts = dict(self._texts)
        baseline, tok = self.trainer, self._embed_tok
        self._refresh_box = box = {}

        def run() -> None:
            t0 = time.perf_counter()
            try:
                cand = EmbedderTrainer(baseline.cfg, baseline.ft,
                                       params=baseline.params,
                                       device=baseline.device)
                box["fit"] = cand.fit(train_ds, tok)
                gate = _eval_gate(cand, baseline, eval_ds, tok, pol)
                box["gate"] = gate
                if gate["pass"]:
                    box["trainer"] = cand
                    box["embeddings"] = _reembed_snapshot(
                        cand, tok, snap_hot, snap_warm, snap_texts)
            except BaseException as e:          # re-raised at publish
                box["error"] = e
            box["wall"] = time.perf_counter() - t0

        self._refresh_thread = threading.Thread(
            target=run, name="embedder-refresh", daemon=True)
        self._refresh_thread.start()
        self._c_refresh_started.inc()

    def _finish_refresh(self) -> Tuple[float, bool, bool]:
        """Join the refresh thread; publish or roll back.

        Publish grafts the shadow re-embeddings onto the *current* tiers
        by value id: a row admitted while the thread ran is re-embedded
        here with the candidate, so the published panel is single-space;
        a row evicted meanwhile has no key to graft and ``valid`` never
        moves, so nothing resurrects.  The panels swap between lookups,
        the live trainer takes the candidate's weights in place
        (``EmbedderTrainer.adopt``: every embed function handed out reads
        the live model, so that copy is the hot swap) and its optimizer
        state, and the version bumps so that plans in flight are
        rejected at commit.  As in the reference, the IVF centroids and
        lists stay in the old space until the next rebuild, and the cold
        tier keeps its old-space rows.  Rollback discards the candidate,
        which was never visible.  Returns (wall_s, published,
        rolled_back)."""
        self._refresh_thread.join()
        self._refresh_thread = None
        box, self._refresh_box = self._refresh_box, {}
        err = box.get("error")
        if err is not None:
            raise RuntimeError("background embedder refresh failed") from err
        wall = float(box.get("wall", 0.0))
        self._last_refresh_s = wall
        gate = box.get("gate", {"pass": False})
        reg = self.telemetry.registry
        g = reg.gauge(
            "cache_refresh_eval",
            "last refresh's eval-gate metrics on the held-out slice "
            "(candidate vs the then-frozen baseline)",
            labels=("embedder", "metric"))
        for side in ("candidate", "baseline"):
            for k, v in (gate.get(side) or {}).items():
                if k in ("precision", "recall", "f1"):
                    g.set(float(v), embedder=side, metric=k)
        if not gate.get("pass"):
            self._c_refresh_rolled_back.inc()
            return wall, False, True
        emb: Dict[int, np.ndarray] = box["embeddings"]
        cand = box["trainer"]
        delta = [(int(v), self._texts[int(v)]) for v in self._live_vids()
                 if int(v) not in emb and int(v) in self._texts]
        if delta:
            de = cand.embed_texts([t for _, t in delta], self._embed_tok)
            emb.update({v: de[i] for i, (v, _) in enumerate(delta)})
        self.hot, self.warm = tiers.publish_reembedded_keys(
            self.hot, self.warm, self._graft(self.hot, emb),
            self._graft(self.warm, emb))
        self.trainer.adopt(cand)
        self._embed_version += 1
        if self._refresh_policy.recalibrate:
            # a threshold means something against one embedder's score
            # distribution only: move every tenant to the candidate's
            # best-F1 point on the gate slice, and drop the §9 score
            # reservoirs (their samples are old-space cosines)
            lo, hi = self._refresh_policy.recalibrate_bounds
            new_thr = float(np.clip(
                gate["candidate"]["f1_threshold"], lo, hi))
            self.policies.recalibrate_all(new_thr)
            self.feedback.reset_scores()
            self._recalibrated_thr = new_thr
            reg.gauge(
                "cache_refresh_recalibrated_threshold",
                "serving threshold adopted at the last embedder "
                "publish (the candidate's held-out best-F1 operating "
                "point, clipped to the policy's recalibrate_bounds)"
            ).set(new_thr)
        self._refresh_total_s += wall
        self._c_refresh_published.inc()
        return wall, True, False

    def _graft(self, state, emb: Dict[int, np.ndarray]) -> torch.Tensor:
        """``state``'s key panel with every valid row whose value id has
        a re-embedding replaced by it; only those rows cross to the
        device."""
        keys = state.keys.clone()
        flat = keys.view(-1, keys.shape[-1])      # either warm form
        vids = _np(state.value_ids).reshape(-1)
        rows = [i for i in np.nonzero(_np(state.valid).reshape(-1))[0]
                if int(vids[i]) in emb]
        if rows:
            flat[torch.as_tensor(rows, device=self.device)] = self._t(
                np.stack([emb[int(vids[i])] for i in rows]), torch.float32)
        return keys

    def _live_vids(self) -> np.ndarray:
        """Value ids currently valid in the hot and warm tiers."""
        h = self.hot.value_ids[self.hot.valid]
        w = self.warm.value_ids[self.warm.valid]
        return np.unique(_np(torch.cat([h, w])))

    def _rebuild(self, warm: tiers.WarmState) -> tiers.WarmState:
        """One IVF re-cluster of ``warm`` (inline or on the shadow
        thread), finished on the device before it returns."""
        rebuild = tiers.warm_rebuild_sharded if self._mesh is not None \
            else tiers.warm_rebuild
        out = rebuild(warm, self._kmeans_iters, self._seed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def _rebuild_inline(self) -> None:
        t0 = time.perf_counter()
        self.warm = self._rebuild(self.warm)
        self._last_rebuild_s = time.perf_counter() - t0
        self._rebuild_total_s += self._last_rebuild_s
        self._c_rebuilds.inc()

    def _start_shadow(self) -> None:
        """Start a shadow re-cluster of a snapshot of the warm tier.  The
        tier ops are functional (they write into fresh tensors), so
        serving keeps building new states while the thread reads the
        snapshot, and the snapshot's tensors live as long as the thread
        holds them.  The thread's kernels go to the device's default
        stream, the serving stream, so they run after every lookup
        issued before them and no tensor crosses streams."""
        snapshot = self.warm
        self._shadow_box = box = {}
        rebuild = self._rebuild

        def run() -> None:
            t0 = time.perf_counter()
            try:
                box["warm"] = rebuild(snapshot)
            except BaseException as e:          # re-raised at publish
                box["error"] = e
            # the build itself, not the idle wait for the publish
            box["wall"] = time.perf_counter() - t0

        self._shadow_thread = threading.Thread(
            target=run, name="warm-ivf-rebuild", daemon=True)
        self._shadow_thread.start()
        self._c_shadow.inc()
        if self.telemetry.health is not None:
            # overlap accounting (§10.3): plans served until the publish
            # ran against the pre-snapshot index
            self.telemetry.health.observe_rebuild_start(self._n_plans)

    def _publish_shadow(self) -> float:
        """Join the shadow thread and swap its index in.

        ``indexed_total`` becomes the snapshot's total, so every row
        appended after the snapshot stays in the tail window and recall
        never dips across the swap.  Returns the build's wall time.
        """
        t0 = time.perf_counter()
        self._shadow_thread.join()
        self._shadow_thread = None
        err = self._shadow_box.get("error")
        if err is not None:
            raise RuntimeError("background IVF rebuild failed") from err
        self.warm = tiers.warm_publish_index(self.warm,
                                             self._shadow_box["warm"])
        # the stall the serve loop felt: join wait + swap
        stall = time.perf_counter() - t0
        wall = float(self._shadow_box["wall"])
        self._last_rebuild_s = wall
        self._rebuild_total_s += wall
        self._c_rebuilds.inc()
        if self.telemetry.health is not None:
            self.telemetry.health.observe_rebuild_publish(self._n_plans,
                                                          stall)
        return wall

    def _capture_and_append(self, dem: tiers.Demoted,
                            panel_keys: Optional[torch.Tensor] = None
                            ) -> None:
        """Land a batch on the warm ring and route its overwrites.

        Without a cold tier a ring overwrite is the end of the line: GC
        the reported value ids and count them dropped.  With one, the
        rows about to be overwritten demote instead (§12): their ring
        positions follow from the pre-append cursor (the arithmetic of
        `tiers.warm_append`, sound because ``dem.mask`` is a True
        prefix), only those rows of the int8 panel are gathered on the
        device and copied to the host into the cold ring before the
        append, and only the cold ring's own overwrites are GC'd.

        Under an ensemble ``panel_keys`` carries the batch's (E, m, D)
        panel rows; ``None`` (the cold-promotion path, which keeps pilot
        keys only) backfills every panel with the pilot row.
        """
        warm_pre = self.warm
        if self.ens is not None and panel_keys is None:
            panel_keys = dem.keys[None].expand(
                (self.n_embedders,) + tuple(dem.keys.shape))
        if self._mesh is not None:
            self.warm, evicted = tiers.warm_append_sharded(
                self.warm, dem, self._mesh, self._shard_axis)
            self._c_ev_dropped.inc(self._gc(evicted))
        elif self.cold is None:
            self.warm, evicted = tiers.warm_append(self.warm, dem)
            self._c_ev_dropped.inc(self._gc(evicted))
        else:
            n = int(dem.mask.sum())
            if n:
                w = self.warm
                pos = (int(w.cursor) + torch.arange(n, device=self.device)
                       ) % w.keys.shape[0]
                pos = pos[w.valid[pos]]
                if len(pos):
                    dropped = self.cold.insert(
                        _np(w.keys_q[pos]), _np(w.scales[pos]),
                        _np(w.value_ids[pos]).astype(np.int64),
                        _np(w.tenants[pos]),
                        expires=_np(w.expires_at[pos]))
                    self._c_ev_demoted.inc(len(pos))
                    self._n_demoted_cold += len(pos)
                    self._c_cold_evictions.inc(self._gc(dropped))
            # the append's own eviction report covers exactly the
            # captured rows: their strings live on behind the cold copies
            self.warm, _ = tiers.warm_append(self.warm, dem)
        if self.ens is not None and self._mesh is not None:
            self.ens = tiers.ensemble_warm_append_sharded(
                self.ens, warm_pre, dem, panel_keys, self._mesh,
                self._shard_axis)
        elif self.ens is not None:
            self.ens = tiers.ensemble_warm_append(self.ens, warm_pre, dem,
                                                  panel_keys)

    def _promote_into_warm(self, prom) -> None:
        """Append a drained cold `Promotion` to the warm ring in
        ``flush_size`` chunks padded with masked rows, as a demotion
        flush.  Ring rows a promotion overwrites demote straight back
        into the cold tier: promotion never becomes a covert drop."""
        m = self.flush_size
        for lo in range(0, len(prom.value_ids), m):
            v = np.asarray(prom.value_ids[lo:lo + m], np.int32)
            pad = m - len(v)
            dem = tiers.Demoted(
                keys=self._t(np.concatenate(
                    [prom.keys[lo:lo + m],
                     np.zeros((pad, self.dim), np.float32)]),
                    torch.float32),
                value_ids=self._t(np.concatenate(
                    [v, np.full(pad, -1, np.int32)]), torch.int32),
                tenants=self._t(np.concatenate(
                    [prom.tenants[lo:lo + m],
                     np.full(pad, -1, np.int32)]), torch.int32),
                mask=self._t(np.concatenate(
                    [np.ones(len(v), bool), np.zeros(pad, bool)]),
                    torch.bool),
                expires=self._t(np.concatenate(
                    [prom.expires[lo:lo + m],
                     np.full(pad, np.inf, np.float32)]), torch.float32))
            self._capture_and_append(dem)

    def _do_flush(self, rebuild: bool) -> None:
        pk = None
        if self.ens is not None:
            # the demoting rows' stacked panel keys, gathered before the
            # demote flips their valid bits: `coldest_slots` is the exact
            # selection `demote_coldest` pops (§13)
            pk = self.ens.hot_keys[:, tiers.coldest_slots(self.hot,
                                                          self.flush_size)]
        self.hot, dem = tiers.demote_coldest(self.hot, self.flush_size)
        self._capture_and_append(dem, pk)
        self._c_demotions.inc(int(dem.mask.sum()))
        # the tail window only covers the last `tail` ring writes; a
        # rebuild is forced before the unindexed backlog outgrows it
        if not self.background_rebuild:
            if rebuild or self._tail_pressure():
                self._rebuild_inline()
            return
        # double-buffered: publish any finished shadow, then make sure
        # the window still covers the backlog before serving resumes
        if self._shadow_thread is not None \
                and self._finished(self._shadow_thread):
            self._publish_shadow()
        if self._backlog() > self._tail:
            if self._shadow_thread is not None:
                self._publish_shadow()          # blocks: join + swap
            if self._backlog() > self._tail:
                self._rebuild_inline()          # snapshot was too old
        if (rebuild or self._tail_pressure()) \
                and self._shadow_thread is None:
            self._start_shadow()

    def _maybe_flush(self) -> None:
        n_valid = int(self.hot.valid.sum())
        if n_valid >= self.flush_watermark * self.hot_capacity:
            self._do_flush(rebuild=False)

    def flush(self, rebuild: bool = True) -> None:
        """Force one demotion flush now.  ``rebuild=False`` still
        rebuilds if skipping would leave rows beyond the tail window.
        With ``background_rebuild`` the re-cluster runs double-buffered
        (shadow build, later publish) instead of inline."""
        self._do_flush(rebuild)

    # ------------------------------------------------------------------
    @property
    def hot_occupancy(self) -> float:
        return int(self.hot.valid.sum()) / self.hot_capacity

    def _warm_rows(self) -> int:
        return self._over_shards(self.warm.valid.sum())

    @property
    def warm_occupancy(self) -> float:
        return self._warm_rows() / self.warm_capacity

    @property
    def occupancy(self) -> float:
        """Drop-in parity with SemanticCache (fraction of total rows)."""
        n = int(self.hot.valid.sum()) + self._warm_rows()
        return n / (self.hot_capacity + self.warm_capacity)

    def __len__(self) -> int:
        n = int(self.hot.valid.sum()) + self._warm_rows()
        return n + len(self.cold) if self.cold is not None else n


# ---------------------------------------------------------------------------
# §11 refresh helpers (module-level: they run on the refresh thread and
# touch only the snapshots they are handed)
# ---------------------------------------------------------------------------

def _eval_gate(cand, baseline, eval_ds, tok,
               pol: EmbedderRefreshPolicy) -> Dict[str, object]:
    """Judge the candidate on the held-out slice: absolute
    precision/recall floors plus no F1 regression against the live
    embedder on the same slice.  A slice without both labels cannot
    support the metrics: fail closed (roll back), never publish
    unjudged."""
    labels = np.asarray(eval_ds.labels)
    if len(labels) == 0 or len(np.unique(labels)) < 2:
        return {"pass": False, "reason": "eval-starved"}
    cand_m = cand.evaluate(eval_ds, tok)
    base_m = baseline.evaluate(eval_ds, tok)
    ok = (cand_m["precision"] >= pol.min_precision
          and cand_m["recall"] >= pol.min_recall
          and cand_m["f1"] >= base_m["f1"] - pol.max_f1_regression)
    return {"pass": bool(ok), "reason": "ok" if ok else "gate-failed",
            "candidate": cand_m, "baseline": base_m}


def _reembed_snapshot(trainer, tok, hot, warm,
                      texts: Dict[int, str]) -> Dict[int, np.ndarray]:
    """Re-embed every snapshot row whose query text is retained: value
    id -> new embedding (the publish grafts them onto the then-current
    tiers by id, so rows evicted since the snapshot are never looked
    up)."""
    vids: set = set()
    for state in (hot, warm):
        vids.update(int(x) for x in _np(state.value_ids[state.valid]))
    todo = [(v, texts[v]) for v in sorted(vids) if v in texts]
    if not todo:
        return {}
    embs = trainer.embed_texts([t for _, t in todo], tok)
    return {v: embs[i] for i, (v, _) in enumerate(todo)}


def _single_class(ds) -> bool:
    labels = np.asarray(ds.labels)
    return len(labels) == 0 or len(np.unique(labels)) < 2


def _synth_backfill(train, eval_ds, pol: EmbedderRefreshPolicy):
    """Top a thin or class-skewed split up with grammar-synthesized
    paraphrase/distinct pairs from ``pol.synth_domain`` (the paper's
    synthetic augmentation, DESIGN.md §6).  The synthetic pool is split
    train/eval with the reservoir's ``eval_frac`` only when the held-out
    slice is class-starved (otherwise the gate judges serving pairs
    alone); the split is deterministic in ``synth_seed``.  Returns the
    augmented ``(train, eval)`` datasets."""
    from repro_torch.core.synth import (
        TemplateGenerator, generate_synthetic_pairs, records_to_dataset,
    )
    from repro_torch.data.corpora import PairDataset, sample_query
    need = max(pol.synth_min_pairs - len(train.labels), 8)
    rng = np.random.default_rng(pol.synth_seed)
    # each seed query yields 2 paraphrase + 2 distinct records
    seeds = [sample_query(rng, pol.synth_domain)
             for _ in range(max(-(-need // 4), 1))]
    synth = records_to_dataset(generate_synthetic_pairs(
        seeds, TemplateGenerator(pol.synth_seed), n_pos=2, n_neg=2))
    perm = np.random.default_rng(pol.synth_seed).permutation(
        len(synth.labels))
    n_eval = int(np.ceil(len(perm) * pol.eval_frac)) \
        if _single_class(eval_ds) else 0
    ev, tr = perm[:n_eval], perm[n_eval:]

    def cat(ds: PairDataset, idx: np.ndarray) -> PairDataset:
        return PairDataset(
            q1=list(ds.q1) + [synth.q1[i] for i in idx],
            q2=list(ds.q2) + [synth.q2[i] for i in idx],
            labels=np.concatenate(
                [np.asarray(ds.labels, np.int32),
                 np.asarray([synth.labels[i] for i in idx], np.int32)]),
            domain=ds.domain)

    return cat(train, tr), cat(eval_ds, ev)
