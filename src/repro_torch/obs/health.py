"""Health / SLO-budget trackers (DESIGN.md §10.3).

The calibrated per-tenant operating point is a *budget* (at most
``max_false_hit_rate`` of novel queries may be served a wrong cached
answer; admissions that duplicate a stored neighbour are waste).  The
registry's counters say what happened since boot; this module tracks
whether each tenant is currently *inside its budget*:

  * per-tenant observed rates, both **EWMA** (drift-sensitive) and
    **windowed** (last ``window`` events, spike-sensitive): plan-time
    hit rate, commit-time duplicate rate, duplicate-*admission*
    (wasted admission) rate;
  * **budget burn**: windowed duplicate-admission rate divided by the
    tenant's false-hit budget — > 1.0 means the tenant is currently
    spending over its calibrated allowance and the feedback loop (§9)
    has not yet caught up;
  * **rebuild overlap accounting**: how many plans were served while a
    shadow IVF rebuild was in flight (the §7.1 overlap window), and
    the distribution of publish stalls (the join+swap on the
    maintenance tick), whose p99 is the number the double-buffer
    exists to keep at lookup scale.

Ingestion (``observe_*``) is a handful of float ops per event and runs
on the hot path; everything that needs a device sync or walks every
tenant (``drain()``) runs at the idle tick — ``CacheService.
maintenance()`` calls it, so the hot path never blocks on host sync.
``drain()`` publishes the current rates as gauges
(``slo_hit_rate``/``slo_dup_admission_rate``/``slo_budget_burn``,
labeled per tenant) into the registry it is given.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class HealthConfig:
    ewma_alpha: float = 0.05      # per-event EWMA step
    window: int = 512             # windowed-rate width (events)
    default_budget: float = 0.01  # false-hit budget when no better source
    stall_keep: int = 128         # publish stalls kept for the p99


class _Rate:
    """One observed rate: EWMA + sliding window over binary events.

    The window holds (positives, total) *batch* tuples with running
    sums, so ingestion is O(1) in the batch size and the windowed rate
    is a division — no per-event list building on the plan hot path.
    Eviction is at batch granularity: the window covers the most
    recent batches whose totals fit inside ``window`` events (always
    at least the latest batch)."""
    __slots__ = ("ewma", "events", "_alpha", "_window_n", "_batches",
                 "_win_pos", "_win_total")

    def __init__(self, alpha: float, window: int):
        self.ewma: Optional[float] = None
        self.events = 0
        self._alpha = alpha
        self._window_n = window
        self._batches: deque = deque()      # (positives, total)
        self._win_pos = 0
        self._win_total = 0

    def observe(self, outcome: bool) -> None:
        self.observe_batch(1 if outcome else 0, 1)

    def observe_batch(self, positives: int, total: int) -> None:
        """``total`` binary events, ``positives`` of them true, in one
        step: the EWMA decays toward the batch mean with the same time
        constant as ``total`` sequential events (order within a batch
        is meaningless anyway)."""
        if total <= 0:
            return
        positives = min(max(positives, 0), total)
        mean = positives / total
        self.ewma = mean if self.ewma is None else \
            mean + (self.ewma - mean) * (1.0 - self._alpha) ** total
        self._batches.append((positives, total))
        self._win_pos += positives
        self._win_total += total
        while self._win_total > self._window_n and len(self._batches) > 1:
            p, t = self._batches.popleft()
            self._win_pos -= p
            self._win_total -= t
        self.events += total

    @property
    def windowed(self) -> float:
        return self._win_pos / self._win_total if self._win_total else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"ewma": self.ewma if self.ewma is not None else 0.0,
                "windowed": self.windowed, "events": self.events}


class TenantHealth:
    __slots__ = ("hit", "duplicate", "wasted_admission")

    def __init__(self, cfg: HealthConfig):
        self.hit = _Rate(cfg.ewma_alpha, cfg.window)
        self.duplicate = _Rate(cfg.ewma_alpha, cfg.window)
        self.wasted_admission = _Rate(cfg.ewma_alpha, cfg.window)


class HealthTracker:
    def __init__(self, config: Optional[HealthConfig] = None,
                 budget_for: Optional[Callable[[int], float]] = None):
        """``budget_for(tenant)`` supplies the tenant's false-hit
        budget (e.g. from the feedback config); absent, the config
        default applies to every tenant."""
        self.config = config or HealthConfig()
        self._budget_for = budget_for
        self._tenants: Dict[int, TenantHealth] = {}
        # rebuild overlap accounting (§7.1): plans served while a
        # shadow build was in flight, and the publish stalls
        self._plans_at_start: Optional[int] = None
        self._overlap_plans_total = 0
        self._last_overlap_plans = 0
        self._publishes = 0
        self._stalls_s: deque = deque(maxlen=self.config.stall_keep)
        self._drain_gauges: Optional[tuple] = None   # cached per registry

    def _tenant(self, t: int) -> TenantHealth:
        th = self._tenants.get(t)
        if th is None:
            th = self._tenants[t] = TenantHealth(self.config)
        return th

    def set_budget_source(self, budget_for:
                          Optional[Callable[[int], float]]) -> None:
        """Late-bind the budget source (the service wires its feedback
        config here once both objects exist)."""
        self._budget_for = budget_for

    def budget(self, tenant: int) -> float:
        if self._budget_for is not None:
            try:
                b = float(self._budget_for(int(tenant)))
                if b > 0:
                    return b
            except Exception:
                pass
        return self.config.default_budget

    # ------------------------------------------------------------------
    # hot-path ingestion
    # ------------------------------------------------------------------
    def observe_plan(self, tenants, hit) -> None:
        """Plan verdicts for one batch, attributed per tenant."""
        t = np.asarray(tenants).reshape(-1)
        h = np.asarray(hit, bool).reshape(-1)
        if t.size == 0:
            return
        if t[0] == t[-1] and (t == t[0]).all():
            # single-tenant batch (the common case): skip the unique/
            # mask pass entirely
            self._tenant(int(t[0])).hit.observe_batch(
                int(h.sum()), int(t.size))
            return
        for tid in np.unique(t):
            m = t == tid
            self._tenant(int(tid)).hit.observe_batch(
                int(h[m].sum()), int(m.sum()))

    def observe_admission(self, tenant: int, duplicate: bool,
                          admitted: bool) -> None:
        """One commit-time miss event (same stream the §9 feedback
        loop labels): duplicate verdict, and — among admitted rows —
        whether the admission was wasted on a duplicate."""
        th = self._tenant(int(tenant))
        th.duplicate.observe(duplicate)
        if admitted:
            th.wasted_admission.observe(duplicate)

    def observe_rebuild_start(self, plans_now: int) -> None:
        self._plans_at_start = int(plans_now)

    def observe_rebuild_publish(self, plans_now: int,
                                stall_s: float) -> None:
        if self._plans_at_start is not None:
            self._last_overlap_plans = int(plans_now) - self._plans_at_start
            self._overlap_plans_total += self._last_overlap_plans
            self._plans_at_start = None
        self._publishes += 1
        self._stalls_s.append(float(stall_s))

    # ------------------------------------------------------------------
    # idle-tick drain
    # ------------------------------------------------------------------
    def stall_p99_s(self) -> float:
        if not self._stalls_s:
            return 0.0
        return float(np.percentile(np.asarray(self._stalls_s), 99))

    def _gauges(self, registry) -> tuple:
        """Resolve (and cache) the drain gauges for this registry —
        drain() runs every maintenance tick, so it must not rebuild
        metric objects or nested snapshot dicts each time."""
        cached = self._drain_gauges
        if cached is not None and cached[0] is registry:
            return cached
        cached = (
            registry,
            registry.gauge("slo_hit_rate",
                           "observed per-tenant hit rate",
                           labels=("tenant", "kind")),
            registry.gauge("slo_dup_admission_rate",
                           "windowed wasted-admission rate",
                           labels=("tenant",)),
            registry.gauge("slo_budget_burn",
                           "windowed wasted-admission rate / false-hit "
                           "budget", labels=("tenant",)),
            registry.gauge("rebuild_overlap_plans",
                           "plans served during the last shadow-rebuild "
                           "overlap").labels(),
            registry.gauge("rebuild_publish_stall_p99_s",
                           "p99 of shadow-index publish stalls").labels(),
        )
        self._drain_gauges = cached
        return cached

    def drain(self, registry=None) -> None:
        """Publish the current health view as registry gauges, straight
        from the raw rates (no snapshot building).  Called from
        ``maintenance()`` — the idle tick — never from plan/commit;
        use ``snapshot()`` for the structured view."""
        if registry is None:
            return
        _, g_hit, g_dup, g_burn, g_overlap, g_stall = \
            self._gauges(registry)
        for t, th in self._tenants.items():
            hit = th.hit
            g_hit.set(hit.ewma if hit.ewma is not None else 0.0,
                      tenant=t, kind="ewma")
            g_hit.set(hit.windowed, tenant=t, kind="window")
            waste = th.wasted_admission.windowed
            g_dup.set(waste, tenant=t)
            budget = self.budget(t)
            g_burn.set(waste / budget if budget > 0 else 0.0, tenant=t)
        g_overlap.set(self._last_overlap_plans)
        g_stall.set(self.stall_p99_s())

    def snapshot(self) -> Dict[str, object]:
        tenants = {}
        for t, th in sorted(self._tenants.items()):
            budget = self.budget(t)
            waste = th.wasted_admission.windowed
            tenants[str(t)] = {
                "hit": th.hit.snapshot(),
                "duplicate": th.duplicate.snapshot(),
                "wasted_admission": th.wasted_admission.snapshot(),
                "budget": budget,
                "budget_burn": waste / budget if budget > 0 else 0.0,
            }
        return {
            "tenants": tenants,
            "rebuild": {
                "publishes": self._publishes,
                "overlap_plans_total": self._overlap_plans_total,
                "last_overlap_plans": self._last_overlap_plans,
                "in_overlap": self._plans_at_start is not None,
                "stall_p99_s": self.stall_p99_s(),
            },
        }


# ---------------------------------------------------------------------------
# the telemetry-overhead budget (shared by the bench row and the tests)
# ---------------------------------------------------------------------------

def check_overhead_budget(on_p50_s: float, off_p50_s: float,
                          max_ratio: float = 1.02,
                          floor_s: float = 100e-6) -> List[str]:
    """Telemetry-on must cost < 2% of the telemetry-off p50.

    ``floor_s`` absorbs timer granularity and scheduler jitter on
    millisecond-scale CPU ticks (100 us is several times the real
    per-batch recording cost of a few tens of microseconds, but far
    below 2% of any realistic accelerator-backed serving tick); the
    ratio is what the budget is about.  Returns a list of violation
    strings (empty = within budget).
    """
    limit = off_p50_s * max_ratio + floor_s
    if on_p50_s <= limit:
        return []
    return [
        f"telemetry overhead over budget: p50 on {on_p50_s * 1e6:.0f}us "
        f"vs off {off_p50_s * 1e6:.0f}us "
        f"(limit {max_ratio:.2f}x + {floor_s * 1e6:.0f}us "
        f"= {limit * 1e6:.0f}us)"]
