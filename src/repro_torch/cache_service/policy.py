"""Per-tenant operating policy: thresholds and admission.

The paper evaluates one global best-F1 threshold; a multi-tenant
deployment runs one *operating point per tenant* (a medical tenant
tolerates far fewer false hits than a chit-chat tenant).  Policies are
plain host-side records resolved to per-query arrays at lookup time —
the device functions only ever see traced (Q,) float thresholds, so a
mixed-tenant batch costs zero recompiles.

Admission: caching every miss fills the store with near-duplicates
(paraphrase clusters collapse onto one representative anyway).  The
score-margin rule skips inserting a miss whose best same-tenant score
already sits within ``admission_margin`` of the hit threshold — the
next paraphrase of that query would have hit the *existing* entry.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.calibration import (
    Calibration, calibrate_for_false_hit_budget,
)


@dataclass(frozen=True)
class TenantPolicy:
    threshold: float = 0.85        # hit operating point
    admission_margin: float = 0.0  # skip insert if score >= thr - margin
    calibration: Optional[Calibration] = None

    def with_threshold(self, threshold: float,
                       calibration: Optional[Calibration] = None
                       ) -> "TenantPolicy":
        """Move the operating point, rescaling the admission margin to
        the new threshold's scale.

        The margin models paraphrase spread: entries whose paraphrases
        would already hit the stored neighbour.  That spread is set by
        the threshold itself — at thr 0.95 paraphrases land within
        ~0.05 of each other, at thr 0.85 within ~0.15 — so a margin
        carried over verbatim after a recalibration is wrong in
        *relative* terms (a 0.2 margin under a looser threshold skips
        admissions for far less similar queries than it was tuned
        for).  Keeping ``margin / (1 - threshold)`` constant preserves
        the band's width in units of the operating point's own
        paraphrase scale.

        Two safety caps keep the rescale from ever disabling
        admission: the ratio itself is capped at 2 (an old threshold
        sitting at ~1.0 would otherwise amplify any margin without
        bound), and the rescaled margin is capped at ``threshold/2``
        so the admission band's bottom stays at or above half the
        operating point — a query with no real similarity to the
        store is always admitted.
        """
        ratio = min(self.admission_margin
                    / max(1.0 - self.threshold, 1e-6), 2.0)
        margin = min(ratio * (1.0 - threshold),
                     0.5 * max(threshold, 0.0))
        return replace(self, threshold=threshold,
                       admission_margin=float(np.clip(margin, 0.0, 1.0)),
                       calibration=calibration if calibration is not None
                       else self.calibration)


@dataclass(frozen=True)
class EmbedderRefreshPolicy:
    """Operating policy of the online embedder refresh (DESIGN.md §11).

    The refresh trigger mirrors the admission-refit hysteresis: no
    training run below ``min_pairs`` pooled labeled pairs or
    ``min_class`` of either label, and at least ``refresh_interval``
    *new* pair events between runs, so the background trainer never
    thrashes.  The eval gate judges the candidate on a held-out
    ``eval_frac`` slice of the pair reservoir: it must clear the
    absolute precision/recall floors *and* not regress the frozen
    embedder's F1 on the same slice by more than
    ``max_f1_regression`` — otherwise the candidate is discarded
    (rollback) and the live embedder keeps serving.

    ``synth_domain`` enables the paper's synthetic augmentation: when
    the training split is thinner than ``synth_min_pairs`` — or either
    split is missing a label class — it is topped up with
    grammar-generated paraphrase/distinct pairs from that domain
    (`core/synth.py`), exactly the dual-labeling pass the paper uses
    to bootstrap thin domains.  It also waives the ``min_class``
    trigger guard: a one-sided pool (a stream where every observed
    neighbour really was a duplicate) is precisely what the backfill
    balances, so it must not block the refresh.

    ``recalibrate`` acknowledges that a serving threshold is only
    meaningful relative to one embedder's score distribution: a
    published candidate scores the same pairs on a different scale, so
    carrying the old scalar across the swap silently moves every
    tenant to an arbitrary point on the new ROC curve.  When enabled,
    publish remaps the default and every per-tenant threshold to the
    candidate's best-F1 operating point on the held-out gate slice
    (margins rescale via ``TenantPolicy.with_threshold``) and drops
    the §9 score reservoirs, whose samples were observed in the old
    embedder's space.
    """
    min_pairs: int = 64          # no refresh below this many pairs
    min_class: int = 8           # ... or this many of either label
    refresh_interval: int = 256  # new pair events between refreshes
    eval_frac: float = 0.25      # held-out slice for the eval gate
    min_precision: float = 0.5   # gate floor: candidate precision
    min_recall: float = 0.5      # gate floor: candidate recall
    max_f1_regression: float = 0.02  # gate: vs frozen F1 on the slice
    synth_domain: Optional[str] = None   # grammar domain for backfill
    synth_min_pairs: int = 256   # top training split up to this size
    synth_seed: int = 0
    seed: int = 0                # split permutation seed
    recalibrate: bool = False    # remap thresholds to the candidate's
                                 # operating point at publish
    # clip band for the adopted threshold: the gate slice's synthetic
    # negatives can be easier than live traffic, in which case its
    # best-F1 point is an over-permissive operating point for a cache
    # — the floor keeps the published version conservative
    recalibrate_bounds: Tuple[float, float] = (0.7, 0.99)


@dataclass(frozen=True)
class ColdRoutingPolicy:
    """Operating policy of the host-RAM cold tier (DESIGN.md §12).

    The router's decision rule — consult the cold tier only when the
    warm/hot verdict missed AND the best cold-centroid similarity
    clears ``threshold - router_margin - route_slack`` — makes the
    host→device fetch conditional on a plausible hit: a coarse
    centroid that far below the operating point bounds every member
    row away from it, so the fetch would be wasted motion.  The slack
    term is *calibrated by the tier at route-fit time* (the observed
    q10 member→centroid spread, `ColdTier.rebuild_routes`), so the
    gate tracks how coarse the clustering actually is;
    ``router_margin`` is the fixed conservatism added on top — raise
    it to fetch more speculatively, at host-scan and PCIe cost.
    ``fetch_budget`` caps the rows any
    single query ships to the device for the exact re-score (the
    approximate int8 host ranking picks which), keeping plan-time cold
    cost O(budget·D) per consulted query regardless of corpus size.

    Routing maintenance is bounded: centroids fit on at most
    ``kmeans_sample`` sampled rows, re-fit every
    ``route_rebuild_every`` inserts (or at first crossing of
    ``min_rows_for_routing`` — below that the corpus is scanned
    unrouted, which is cheaper than maintaining an index for it).
    ``promote_max`` caps how many re-hot rows one maintenance tick
    drains back into the warm ring.
    """
    n_probe: int = 4             # coarse clusters consulted per query
    fetch_budget: int = 32       # device re-score rows per query
    router_margin: float = 0.05  # consult if csim >= thr-margin-slack
    promote_max: int = 64        # promotions drained per idle tick
    n_clusters: int = 64
    kmeans_iters: int = 6
    kmeans_sample: int = 65536   # routing fit sample bound
    route_rebuild_every: int = 8192   # inserts between route re-fits
    min_rows_for_routing: int = 512   # below: brute-force, no index
    seed: int = 0


class PolicyTable:
    """tenant id -> TenantPolicy, with a default for unknown tenants.

    Under a fused multi-embedder ensemble (DESIGN.md §13) the table
    also owns per-tenant **mixture weights**: the (E,) convex weights
    the cascade fuses the per-embedder cosines with.  Like thresholds,
    they resolve to a per-query (Q, E) array at lookup time (uniform
    1/E for tenants with no learned weights) and are re-learned at
    refit time from the feedback stream (`refit_weights`).
    """

    def __init__(self, default: TenantPolicy):
        self.default = default
        self._by_tenant: Dict[int, TenantPolicy] = {}
        self._weights: Dict[int, np.ndarray] = {}        # §13
        self._default_weights: Optional[np.ndarray] = None

    def get(self, tenant: int) -> TenantPolicy:
        return self._by_tenant.get(int(tenant), self.default)

    def set(self, tenant: int, policy: TenantPolicy) -> None:
        self._by_tenant[int(tenant)] = policy

    def recalibrate_all(self, threshold: float) -> None:
        """Move the default and every per-tenant policy to a new
        operating point — the embedder-publish path (§11): the score
        space just changed under every threshold in the table, learned
        or configured, so all of them remap together (margins rescale
        per ``with_threshold``)."""
        self.default = self.default.with_threshold(threshold)
        for t, pol in self._by_tenant.items():
            self._by_tenant[t] = pol.with_threshold(threshold)

    def calibrate(self, tenant: int, scores, labels,
                  max_false_hit_rate: float = 0.01) -> Calibration:
        """Fit this tenant's threshold to a false-hit budget from its
        own scored eval pairs (repro_torch.core.calibration).  The admission
        margin is rescaled to the new threshold's paraphrase scale —
        carrying it over verbatim silently changed the band's relative
        width every time the threshold moved (see
        ``TenantPolicy.with_threshold``)."""
        cal = calibrate_for_false_hit_budget(scores, labels,
                                             max_false_hit_rate)
        cur = self.get(tenant)
        self.set(tenant, cur.with_threshold(cal.threshold, calibration=cal))
        return cal

    def refit(self, feedback) -> List[object]:
        """Online refit from a ``FeedbackAccumulator`` (DESIGN.md §9):
        every tenant whose reservoir says a refit is due gets one
        ``feedback.fit()`` — the accumulator owns the estimators and
        every hysteresis guard; this table only publishes the policies
        that survive them.  Returns the ``RefitReport`` list (applied
        and refused) for the maintenance report and stats."""
        reports = []
        for tenant in feedback.tenants():
            if not feedback.refit_due(tenant):
                continue
            policy, report = feedback.fit(tenant, self.get(tenant))
            if report.applied:
                self.set(tenant, policy)
            reports.append(report)
        return reports

    # ----- §13 ensemble mixture weights --------------------------------
    def set_default_weights(self, weights) -> None:
        """Default mixture for tenants with no learned weights
        (normalized to the simplex; None reverts to uniform 1/E)."""
        if weights is None:
            self._default_weights = None
            return
        w = np.asarray(weights, np.float32)
        if w.ndim != 1 or np.any(w < 0) or w.sum() <= 0:
            raise ValueError(f"ensemble weights must be a non-negative "
                             f"1-D vector with positive sum, got {w!r}")
        self._default_weights = w / w.sum()

    def set_weights(self, tenant: int, weights) -> None:
        w = np.asarray(weights, np.float32)
        if np.any(w < 0) or w.sum() <= 0:
            raise ValueError("tenant mixture weights must be "
                             "non-negative with positive sum")
        self._weights[int(tenant)] = w / w.sum()

    def get_weights(self, tenant: int, n_embedders: int) -> np.ndarray:
        w = self._weights.get(int(tenant), self._default_weights)
        if w is None:
            return np.full(n_embedders, 1.0 / n_embedders, np.float32)
        if len(w) != n_embedders:
            raise ValueError(f"weights of len {len(w)} vs "
                             f"{n_embedders} embedders")
        return w

    def weights_for(self, tenants: np.ndarray,
                    n_embedders: int) -> np.ndarray:
        """Per-query (Q, E) mixture weights — the vectorized resolution
        the cascade consumes, mirroring `thresholds_for`."""
        return np.stack([self.get_weights(t, n_embedders)
                         for t in tenants])

    def refit_weights(self, feedback, n_embedders: int) -> List[object]:
        """Drive `feedback.fit_weights` over every tenant whose
        ensemble reservoir says a refit is due — the §13 twin of
        `refit`.  An applied fit publishes the tenant's weights AND the
        threshold recalibrated against the new fused score, atomically
        from the table's point of view.  Returns the
        ``WeightRefitReport`` list."""
        reports = []
        for tenant in feedback.ensemble_tenants():
            if not feedback.weight_refit_due(tenant):
                continue
            w, policy, report = feedback.fit_weights(
                tenant, self.get_weights(tenant, n_embedders),
                self.get(tenant))
            if report.applied:
                self._weights[int(tenant)] = np.asarray(w, np.float32)
                self.set(tenant, policy)
            reports.append(report)
        return reports

    def weights_state(self) -> Dict[int, List[float]]:
        """Published per-tenant mixtures (the §13 stats view)."""
        return {t: [float(x) for x in w]
                for t, w in sorted(self._weights.items())}

    def learned_state(self) -> Dict[int, Dict[str, float]]:
        """Per-tenant operating points currently published (the
        learned-admission view exposed by ``stats()``)."""
        return {t: {"threshold": p.threshold,
                    "admission_margin": p.admission_margin}
                for t, p in sorted(self._by_tenant.items())}

    # ----- vectorised resolution for a query batch ---------------------
    def thresholds_for(self, tenants: np.ndarray) -> np.ndarray:
        return np.asarray([self.get(t).threshold for t in tenants],
                          np.float32)

    def effective_thresholds(self, tenants: np.ndarray,
                             feedback=None) -> np.ndarray:
        """Per-query serving thresholds with the §14.3 conformal floor
        applied: ``max(policy threshold, conformal floor)`` per tenant.
        The learned/configured threshold still *tightens* freely; the
        floor only ever raises it — under drift the §9 refit can lag
        (or loosen onto a stale reservoir) while the recency-window
        floor tracks the current negative-score distribution, so the
        false-hit budget holds through the transition.  ``feedback``
        None (conformal off, or no accumulator) degrades to
        ``thresholds_for``."""
        thr = self.thresholds_for(tenants)
        if feedback is None:
            return thr
        floors = np.asarray(
            [f if (f := feedback.conformal_floor(t)) is not None
             else -1.0 for t in tenants], np.float32)
        return np.maximum(thr, floors)

    def admit_mask(self, tenants: np.ndarray,
                   scores: Optional[np.ndarray]) -> np.ndarray:
        """Admission decision per miss: True -> cache it."""
        if scores is None:
            return np.ones(len(tenants), bool)
        thr = self.thresholds_for(tenants)
        margin = np.asarray([self.get(t).admission_margin for t in tenants],
                            np.float32)
        return np.asarray(scores, np.float32) < thr - margin

    def pre_decision(self, tenants: np.ndarray, scores: np.ndarray,
                     hit: np.ndarray) -> np.ndarray:
        """Plan-time admission pre-decision (DESIGN.md §7): False on hit
        rows; on miss rows the score-margin rule over the observed
        neighbour scores.  Carried inside the ``CachePlan`` so commit
        honors the decision taken when the scores were observed."""
        return ~np.asarray(hit, bool) & self.admit_mask(tenants, scores)
