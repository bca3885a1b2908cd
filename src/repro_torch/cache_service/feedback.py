"""Online per-tenant admission/threshold learning (DESIGN.md §9).

The port of `repro/cache_service/feedback.py`: numpy only, so the same
event stream gives the same reservoirs, refit decisions and logs on
both sides (the reservoirs draw from one ``default_rng(seed)`` in the
same order).

A static ``TenantPolicy(threshold, admission_margin)`` is fit once from
*offline* pairs.  The serving loop meanwhile observes every signal that
offline fit was a proxy for — plan-time scores, hit/miss verdicts, and (at
commit) whether a generated miss response turned out identical to its
nearest stored neighbour's — and threw them away.  This module closes
the loop:

  * ``FeedbackAccumulator`` ingests the stream: a per-tenant fixed-size
    reservoir (Vitter's algorithm R, uniform over the tenant's whole
    history) of ``(score, duplicate)`` events, where *score* is the
    best same-tenant score the plan observed for a miss row and
    *duplicate* is the commit-time verdict — the generated response
    matched the stored neighbour's response exactly.  A duplicate that
    was nevertheless admitted is a **wasted admission** (the stored
    neighbour would have served its paraphrases).
  * ``fit()`` re-derives the tenant's threshold and admission margin
    from its own reservoir, reusing ``core/calibration.py``'s
    estimators on live data: ``calibrate_for_false_hit_budget`` maps
    the labeled scores to the loosest threshold inside the false-hit
    budget, and ``calibrate_for_precision`` finds the score above
    which observed misses are duplicates with high precision — the
    admission margin is the gap between the two.

Hysteresis — thresholds must never thrash (``PolicyTable.refit`` runs
on every ``maintenance()`` idle tick):

  * **min-samples / class balance**: no fit below ``min_samples``
    events or ``min_class`` events of either verdict.
  * **refit interval**: a tenant is only re-examined after
    ``refit_interval`` *new* events since its last examination.
  * **max-step**: one refit moves the threshold at most ``max_step``;
    drift is tracked over several refits, never jumped.
  * **monotone false-hit-budget guard**: a refit never *loosens* the
    threshold past the budgeted quantile of observed negatives, and a
    loosening that would breach the observed false-hit budget is
    refused outright.
  * **duplicate-support floor**: loosening stops at the score that
    already captures ``dup_coverage`` of observed duplicates — below
    it there is no observed duplicate mass to convert into hits, only
    unobserved false-hit risk (hit rows are never re-labeled online,
    so the region far under the threshold is censored).

Every decision — applied or refused, with the reason — is recorded as
a ``RefitReport`` in ``refit_log`` so the learned state is inspectable
through ``stats()`` and testable under the batcher's idle tick.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cache_service.policy import TenantPolicy
from repro_torch.core.calibration import (
    calibrate_for_false_hit_budget, calibrate_for_precision,
)
from repro_torch.data.corpora import PairDataset


@dataclass(frozen=True)
class FeedbackConfig:
    """Knobs of the online learning loop; defaults are sized for the
    smoke-scale streams this repo serves (hundreds-to-thousands of
    events per tenant)."""
    reservoir: int = 1024        # per-tenant event capacity
    min_samples: int = 64        # no fit below this many events
    min_class: int = 8           # ... or this many of either verdict
    refit_interval: int = 64     # new events between examinations
    max_step: float = 0.02      # max threshold move per refit
    max_false_hit_rate: float = 0.01   # the budget the guard enforces
    dup_precision: float = 0.9   # P(duplicate | score >= cut) target
    dup_coverage: float = 0.95   # loosening floor: keep this dup mass
    max_margin: float = 0.25     # admission band width cap
    refit_log_cap: int = 512     # most recent decisions kept
    pair_reservoir: int = 2048   # pooled labeled text pairs kept (§11)
    # §13 mixture-weight learning (fused multi-embedder ensemble): a
    # closed-form ridge regression of the duplicate verdict on the
    # per-embedder scores, under the same hysteresis discipline as the
    # threshold refits (min_samples / min_class / refit_interval above
    # apply to the ensemble reservoirs too)
    weight_lambda: float = 0.05  # ridge regularizer (units of n events)
    max_weight_step: float = 0.1  # max per-component weight move / refit
    # §14.3 conformal hit calibration: a per-tenant *recency window*
    # (ring, newest-wins — deliberately not a reservoir: under drift
    # the recent negative-score distribution is the one the budget
    # must hold on) of observed negative (non-duplicate) scores.  The
    # split-conformal floor is the ceil((n+1)(1-alpha))-th order
    # statistic of the window: serving only above it bounds the
    # false-hit rate on exchangeable recent negatives by alpha.
    conformal_window: int = 256  # per-tenant recent negatives kept
    conformal_min: int = 64      # no floor below this many samples
    conformal_alpha: Optional[float] = None  # None -> max_false_hit_rate
    seed: int = 0


@dataclass(frozen=True)
class RefitReport:
    """One refit decision for one tenant (applied or refused)."""
    tenant: int
    applied: bool
    reason: str                  # "ok" | "min-samples" | "class-starved"
    #                            | "interval" | "budget-guard" | "no-change"
    old_threshold: float
    new_threshold: float
    old_margin: float
    new_margin: float
    step_clamped: bool = False   # max_step truncated the move
    n_events: int = 0
    n_duplicates: int = 0
    false_hit_rate: float = 0.0  # observed, at the published threshold


@dataclass(frozen=True)
class WeightRefitReport:
    """One mixture-weight refit decision for one tenant (§13)."""
    tenant: int
    applied: bool
    reason: str                  # "ok" | "min-samples" | "class-starved"
    #                            | "interval" | "degenerate" | "no-change"
    old_weights: Tuple[float, ...]
    new_weights: Tuple[float, ...]
    old_threshold: float = 0.0
    new_threshold: float = 0.0   # recalibrated against the fused score
    step_clamped: bool = False   # max_weight_step truncated the move
    n_events: int = 0
    n_duplicates: int = 0


class EnsembleReservoir:
    """Fixed-capacity uniform sample of one tenant's
    ``(per-embedder scores (E,), duplicate)`` events — algorithm R,
    the §13 analogue of `TenantReservoir` with a score *vector* per
    event (the plan's ``panel_scores`` row for a committed miss)."""

    def __init__(self, capacity: int, n_embedders: int,
                 rng: np.random.Generator):
        self.capacity = int(capacity)
        self.scores = np.zeros((self.capacity, int(n_embedders)),
                               np.float32)
        self.labels = np.zeros(self.capacity, np.int8)
        self.fill = 0
        self.seen = 0
        self._rng = rng

    def add(self, scores: np.ndarray, duplicate: bool) -> None:
        self.seen += 1
        if self.fill < self.capacity:
            i = self.fill
            self.fill += 1
        else:
            i = int(self._rng.integers(self.seen))
            if i >= self.capacity:
                return
        self.scores[i] = np.clip(np.asarray(scores, np.float32), -1.0, 1.0)
        self.labels[i] = 1 if duplicate else 0

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.scores[:self.fill], self.labels[:self.fill]


class ConformalWindow:
    """Per-tenant recency ring of observed **negative** scores — the
    calibration set of the §14.3 split-conformal threshold floor.

    A ring, not a reservoir: reservoirs keep every era of a drifting
    stream represented (exactly what §9's estimators want), but the
    conformal guarantee must hold on the *current* score distribution,
    so the window keeps only the newest ``capacity`` negatives and
    ages the old era out as drift feeds new ones in."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.scores = np.zeros(self.capacity, np.float32)
        self.fill = 0
        self._pos = 0
        self.seen = 0

    def add(self, score: float) -> None:
        self.scores[self._pos] = np.clip(score, -1.0, 1.0)
        self._pos = (self._pos + 1) % self.capacity
        self.fill = min(self.fill + 1, self.capacity)
        self.seen += 1

    def floor(self, alpha: float) -> float:
        """The split-conformal threshold floor at miscoverage
        ``alpha``: the ceil((n+1)(1-alpha))-th smallest window score
        (clamped to the max for tiny alpha), nudged by an epsilon so
        a score *equal* to the quantile still counts as a negative.
        Serving hits only at scores >= floor bounds the false-hit
        rate on exchangeable recent negatives by alpha."""
        n = self.fill
        s = np.sort(self.scores[:n])
        rank = min(int(np.ceil((n + 1) * (1.0 - alpha))), n)
        return float(s[rank - 1]) + 1e-6


class TenantReservoir:
    """Fixed-capacity uniform sample of one tenant's (score, duplicate)
    events — algorithm R, so a drifting stream keeps every era
    represented proportionally."""

    def __init__(self, capacity: int, rng: np.random.Generator):
        self.capacity = int(capacity)
        self.scores = np.zeros(self.capacity, np.float32)
        self.labels = np.zeros(self.capacity, np.int8)
        self.fill = 0
        self.seen = 0
        self._rng = rng

    def add(self, score: float, duplicate: bool) -> None:
        self.seen += 1
        if self.fill < self.capacity:
            i = self.fill
            self.fill += 1
        else:
            i = int(self._rng.integers(self.seen))
            if i >= self.capacity:
                return
        self.scores[i] = np.clip(score, -1.0, 1.0)
        self.labels[i] = 1 if duplicate else 0

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.scores[:self.fill], self.labels[:self.fill]


class PairReservoir:
    """Fixed-capacity uniform sample of labeled **text** pairs pooled
    across tenants — the same algorithm-R discipline as
    `TenantReservoir`, but keeping ``(query, stored neighbour,
    duplicate?)`` strings instead of scores.  These are exactly the
    contrastive pairs the paper fine-tunes on; the §11 embedder refresh
    trains on a split of this reservoir and holds the rest out for its
    eval gate."""

    def __init__(self, capacity: int, rng: np.random.Generator):
        self.capacity = int(capacity)
        self.items: List[Tuple[str, str, int]] = []
        self.seen = 0
        self._rng = rng

    def add(self, query: str, neighbour: str, duplicate: bool) -> None:
        self.seen += 1
        item = (str(query), str(neighbour), 1 if duplicate else 0)
        if len(self.items) < self.capacity:
            self.items.append(item)
        else:
            i = int(self._rng.integers(self.seen))
            if i < self.capacity:
                self.items[i] = item

    def __len__(self) -> int:
        return len(self.items)

    @property
    def n_pos(self) -> int:
        return sum(lab for _, _, lab in self.items)

    @property
    def n_neg(self) -> int:
        return len(self.items) - self.n_pos

    def split(self, eval_frac: float = 0.25,
              seed: int = 0) -> Tuple[PairDataset, PairDataset]:
        """Deterministic shuffled (train, eval) split of the current
        sample.  The permutation is keyed on ``seed`` alone, so the
        same reservoir state always yields the same split — the eval
        gate judges every candidate embedder on the same held-out
        slice it was denied at training time."""
        n = len(self.items)
        perm = np.random.default_rng(seed).permutation(n)
        n_eval = int(np.ceil(n * eval_frac)) if n else 0
        ev, tr = perm[:n_eval], perm[n_eval:]

        def ds(idx: np.ndarray) -> PairDataset:
            return PairDataset(
                q1=[self.items[i][0] for i in idx],
                q2=[self.items[i][1] for i in idx],
                labels=np.asarray([self.items[i][2] for i in idx],
                                  np.int32),
                domain="feedback")

        return ds(tr), ds(ev)


class FeedbackAccumulator:
    """The online learning half of the admission policy: ingests the
    serving stream per tenant, answers ``refit_due()`` for the
    maintenance tick, and ``fit()``s one tenant's policy on demand
    (``PolicyTable.refit`` drives it over every due tenant)."""

    def __init__(self, config: Optional[FeedbackConfig] = None):
        self.config = config or FeedbackConfig()
        self._rng = np.random.default_rng(self.config.seed)
        self._res: Dict[int, TenantReservoir] = {}
        self.pairs = PairReservoir(self.config.pair_reservoir, self._rng)
        self._seen_at_fit: Dict[int, int] = {}
        self._ens: Dict[int, EnsembleReservoir] = {}        # §13
        self._ens_seen_at_fit: Dict[int, int] = {}
        self._conf: Dict[int, ConformalWindow] = {}         # §14.3
        self.refit_log: List[RefitReport] = []
        self.weight_refit_log: List[WeightRefitReport] = []
        self.counters = {
            "events": 0, "duplicate_events": 0, "wasted_admissions": 0,
            "plan_hits": 0, "plan_misses": 0, "pair_events": 0,
            "refits_applied": 0, "refits_skipped": 0,
            "ensemble_events": 0, "weight_refits_applied": 0,
            "weight_refits_skipped": 0,
            "hit_audits": 0, "audited_false_hits": 0,
        }

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def observe_plan(self, hit: np.ndarray) -> None:
        """Plan-time verdict counters (hit rows are served uninspected,
        so they only feed observability, never the reservoir)."""
        hit = np.asarray(hit, bool)
        self.counters["plan_hits"] += int(hit.sum())
        self.counters["plan_misses"] += int((~hit).sum())

    def observe(self, tenant: int, score: float, duplicate: bool,
                admitted: bool, text: Optional[str] = None,
                neighbour_text: Optional[str] = None) -> None:
        """One commit-time miss event; a duplicate that was admitted
        anyway counts as a wasted admission.  When the caller also has
        the query/neighbour *texts* in hand (the §11 embedder loop),
        the labeled pair feeds the pooled text reservoir."""
        t = int(tenant)
        res = self._res.get(t)
        if res is None:
            res = self._res[t] = TenantReservoir(self.config.reservoir,
                                                 self._rng)
        res.add(float(score), bool(duplicate))
        self.counters["events"] += 1
        if text is not None and neighbour_text is not None:
            self.pairs.add(text, neighbour_text, duplicate)
            self.counters["pair_events"] += 1
        if duplicate:
            self.counters["duplicate_events"] += 1
            if admitted:
                self.counters["wasted_admissions"] += 1
        else:
            self._conf_add(t, float(score))

    def observe_ensemble(self, tenant: int, panel_scores: np.ndarray,
                         duplicate: bool) -> None:
        """One commit-time miss event on the ensemble path (§13): the
        plan's unweighted per-embedder cosines of the row's best
        same-tenant candidate, labeled with the duplicate verdict.
        Rows with no candidate (all-(-1) panel scores) never reach here
        — a constant row teaches the ridge nothing about mixing."""
        t = int(tenant)
        res = self._ens.get(t)
        if res is None:
            res = self._ens[t] = EnsembleReservoir(
                self.config.reservoir, len(panel_scores), self._rng)
        res.add(panel_scores, bool(duplicate))
        self.counters["ensemble_events"] += 1

    def observe_hit_audit(self, tenant: int, score: float,
                          duplicate: bool) -> None:
        """Post-hoc audit of a *served hit* (§14.3): the response
        equality check ran offline (async audit pipeline, or the bench
        generator's ground truth) and labeled the served answer.  The
        §9 miss stream is censored above the threshold — hit rows are
        served uninspected — so without this channel the conformal
        window can never learn that scores *above* the current
        threshold are producing false hits, which is exactly the drift
        failure mode the floor exists to stop.  A false hit feeds the
        window as a fresh negative (raising the floor); a confirmed
        duplicate is a true hit and feeds nothing."""
        self.counters["hit_audits"] += 1
        if not duplicate:
            self.counters["audited_false_hits"] += 1
            self._conf_add(int(tenant), float(score))

    def _conf_add(self, tenant: int, score: float) -> None:
        win = self._conf.get(tenant)
        if win is None:
            win = self._conf[tenant] = ConformalWindow(
                self.config.conformal_window)
        win.add(score)

    def conformal_floor(self, tenant: int) -> Optional[float]:
        """This tenant's §14.3 split-conformal threshold floor, or
        None while its window holds fewer than ``conformal_min``
        recent negatives (no guarantee worth publishing)."""
        win = self._conf.get(int(tenant))
        if win is None or win.fill < self.config.conformal_min:
            return None
        alpha = self.config.conformal_alpha
        if alpha is None:
            alpha = self.config.max_false_hit_rate
        return win.floor(float(alpha))

    def conformal_state(self) -> Dict[str, object]:
        """The §14.3 stats view: per-tenant window fills and active
        floors, plus the audit counters."""
        return {
            "tenants": {t: {"fill": w.fill, "seen": w.seen,
                            "floor": self.conformal_floor(t)}
                        for t, w in sorted(self._conf.items())},
            "hit_audits": self.counters["hit_audits"],
            "audited_false_hits": self.counters["audited_false_hits"],
        }

    def observe_hit_pair(self, query: str, neighbour: str) -> None:
        """A served hit is the strongest online duplicate evidence: the
        query scored above its tenant's threshold against the stored
        neighbour and was answered from cache.  Hits never feed the
        score reservoirs (§9's estimators rely on commit-time miss
        labels; hit rows are served uninspected) but they are exactly
        the positive contrastive pairs the §11 refresh trains on."""
        self.pairs.add(query, neighbour, True)
        self.counters["pair_events"] += 1

    def reset_scores(self) -> None:
        """Drop every tenant's score reservoir — the embedder-publish
        path (§11): reservoir samples are cosine scores under the
        *previous* embedder version, so any refit over them would
        calibrate the new version's thresholds against a dead score
        space.  The pooled text-pair reservoir survives (texts are
        version-independent training data), and the interval clocks
        reset so §9 re-examines each tenant only after it has seen
        fresh post-swap evidence."""
        self._res.clear()
        self._seen_at_fit.clear()
        # ensemble reservoirs hold per-embedder cosines — every column
        # lives in some embedder version's score space, so a panel swap
        # invalidates them exactly like the scalar reservoirs
        self._ens.clear()
        self._ens_seen_at_fit.clear()
        # conformal windows are score-space too: a floor computed on
        # old-version cosines is meaningless after the swap (§14.3)
        self._conf.clear()

    # ------------------------------------------------------------------
    # refit scheduling
    # ------------------------------------------------------------------
    def tenants(self) -> List[int]:
        return sorted(self._res)

    def refit_due(self, tenant: Optional[int] = None) -> bool:
        """Enough new events since the tenant's last examination (any
        tenant, when ``tenant`` is None) to justify a fit attempt."""
        if tenant is None:
            return any(self.refit_due(t) for t in self._res)
        res = self._res.get(int(tenant))
        if res is None or res.fill < self.config.min_samples:
            return False
        seen_at = self._seen_at_fit.get(int(tenant), 0)
        return res.seen - seen_at >= self.config.refit_interval \
            or seen_at == 0

    def ensemble_tenants(self) -> List[int]:
        return sorted(self._ens)

    def weight_refit_due(self, tenant: Optional[int] = None) -> bool:
        """§13 scheduling twin of `refit_due` over the ensemble
        reservoirs."""
        if tenant is None:
            return any(self.weight_refit_due(t) for t in self._ens)
        res = self._ens.get(int(tenant))
        if res is None or res.fill < self.config.min_samples:
            return False
        seen_at = self._ens_seen_at_fit.get(int(tenant), 0)
        return res.seen - seen_at >= self.config.refit_interval \
            or seen_at == 0

    # ------------------------------------------------------------------
    # the fit itself
    # ------------------------------------------------------------------
    def fit(self, tenant: int,
            policy: TenantPolicy) -> Tuple[TenantPolicy, RefitReport]:
        """Re-derive one tenant's operating point from its reservoir,
        under every hysteresis guard.  Returns the (possibly unchanged)
        policy and the decision record; the caller applies it."""
        t = int(tenant)
        cfg = self.config
        res = self._res.get(t)
        scores, labels = res.arrays() if res is not None \
            else (np.zeros(0, np.float32), np.zeros(0, np.int8))
        n_dup = int(labels.sum())

        def skip(reason: str, fhr: float = 0.0):
            self.counters["refits_skipped"] += 1
            rep = RefitReport(
                tenant=t, applied=False, reason=reason,
                old_threshold=policy.threshold,
                new_threshold=policy.threshold,
                old_margin=policy.admission_margin,
                new_margin=policy.admission_margin,
                n_events=len(scores), n_duplicates=n_dup,
                false_hit_rate=fhr)
            self._log(rep)
            return policy, rep

        if len(scores) < cfg.min_samples:
            return skip("min-samples")
        if not self.refit_due(t):
            return skip("interval")
        # examined now — the interval restarts whether or not a fit
        # applies, so a tenant stuck in a skip state (e.g. too few
        # duplicates) is re-examined every refit_interval new events,
        # not on every maintenance tick
        self._seen_at_fit[t] = res.seen
        if n_dup < cfg.min_class or len(scores) - n_dup < cfg.min_class:
            return skip("class-starved")

        old_thr = float(policy.threshold)
        cal = calibrate_for_false_hit_budget(scores, labels,
                                             cfg.max_false_hit_rate)
        pos = scores[labels == 1]
        neg = scores[labels == 0]
        # duplicate-support floor: loosening below the score that
        # already captures dup_coverage of observed duplicates converts
        # no observed miss into a hit — it only walks into the censored
        # region where false hits would go unnoticed
        floor = float(np.quantile(pos, 1.0 - cfg.dup_coverage))
        target = max(cal.threshold, floor)
        step_clamped = abs(target - old_thr) > cfg.max_step
        new_thr = float(np.clip(target, old_thr - cfg.max_step,
                                old_thr + cfg.max_step))
        fhr = float((neg >= new_thr).mean())
        if new_thr < old_thr and fhr > cfg.max_false_hit_rate:
            # monotone budget guard: never publish a loosening whose
            # observed false-hit rate breaches the budget (a clamped
            # tightening may still be over budget — it moves toward
            # compliance and is allowed)
            return skip("budget-guard", fhr=fhr)

        # admission margin: skip admitting misses above the score at
        # which observed misses are duplicates with dup_precision —
        # their stored neighbour serves the paraphrase cluster already
        dup_cal = calibrate_for_precision(scores, labels,
                                          min_precision=cfg.dup_precision)
        new_margin = float(np.clip(new_thr - dup_cal.threshold, 0.0,
                                   cfg.max_margin))

        if abs(new_thr - old_thr) < 1e-6 \
                and abs(new_margin - policy.admission_margin) < 1e-6:
            return skip("no-change", fhr=fhr)
        self.counters["refits_applied"] += 1
        rep = RefitReport(
            tenant=t, applied=True, reason="ok",
            old_threshold=old_thr, new_threshold=new_thr,
            old_margin=policy.admission_margin, new_margin=new_margin,
            step_clamped=step_clamped, n_events=len(scores),
            n_duplicates=n_dup, false_hit_rate=fhr)
        self._log(rep)
        return replace(policy, threshold=new_thr,
                       admission_margin=new_margin, calibration=cal), rep

    def fit_weights(self, tenant: int, weights: np.ndarray,
                    policy: TenantPolicy
                    ) -> Tuple[np.ndarray, TenantPolicy, WeightRefitReport]:
        """Re-derive one tenant's mixture weights from its ensemble
        reservoir (§13), then recalibrate its threshold against the
        fused score the new weights produce.

        The weight estimate is a closed-form ridge regression of the
        duplicate verdict on the per-embedder scores —
        ``w* = (SᵀS + λ·n·I)⁻¹ Sᵀ y`` — projected to the simplex
        (non-negative, Σw = 1): an embedder whose score separates
        duplicates from distincts for this tenant earns weight, one
        that scores both alike is shrunk toward zero by the
        regularizer.  Hysteresis mirrors `fit()` exactly: min-samples,
        class balance, the refit interval, a per-component
        ``max_weight_step`` clamp, and a no-change floor.

        A weight move changes the score distribution every threshold
        in §9 was calibrated against, so the same reservoir is
        replayed under the *new* fused score and the tenant's
        threshold follows it (``calibrate_for_false_hit_budget`` on
        the fused scores, clamped by ``max_step`` like any refit —
        arxiv 2606.19719's recalibrate-on-swap discipline applied to a
        weight swap).  Returns (weights, policy, report); the caller
        publishes both or neither.
        """
        t = int(tenant)
        cfg = self.config
        res = self._ens.get(t)
        scores, labels = res.arrays() if res is not None \
            else (np.zeros((0, len(weights)), np.float32),
                  np.zeros(0, np.int8))
        n_dup = int(labels.sum())
        weights = np.asarray(weights, np.float64)

        def skip(reason: str):
            self.counters["weight_refits_skipped"] += 1
            rep = WeightRefitReport(
                tenant=t, applied=False, reason=reason,
                old_weights=tuple(float(w) for w in weights),
                new_weights=tuple(float(w) for w in weights),
                old_threshold=policy.threshold,
                new_threshold=policy.threshold,
                n_events=len(scores), n_duplicates=n_dup)
            self._log_weights(rep)
            return np.asarray(weights, np.float32), policy, rep

        if len(scores) < cfg.min_samples:
            return skip("min-samples")
        if not self.weight_refit_due(t):
            return skip("interval")
        self._ens_seen_at_fit[t] = res.seen
        if n_dup < cfg.min_class or len(scores) - n_dup < cfg.min_class:
            return skip("class-starved")

        S = scores.astype(np.float64)
        y = labels.astype(np.float64)
        n, E = S.shape
        lam = cfg.weight_lambda * n
        try:
            w_star = np.linalg.solve(S.T @ S + lam * np.eye(E), S.T @ y)
        except np.linalg.LinAlgError:
            return skip("degenerate")
        w_star = np.maximum(w_star, 0.0)
        if w_star.sum() <= 0.0:
            # the verdict anti-correlates with every panel's score —
            # no mixture of similarities explains it; keep serving
            return skip("degenerate")
        w_star = w_star / w_star.sum()
        step = np.clip(w_star - weights, -cfg.max_weight_step,
                       cfg.max_weight_step)
        step_clamped = bool(np.any(np.abs(w_star - weights)
                                   > cfg.max_weight_step + 1e-12))
        new_w = np.maximum(weights + step, 0.0)
        new_w = new_w / new_w.sum()

        # fused-score threshold recalibration under the new weights
        old_thr = float(policy.threshold)
        fused = (S @ new_w).astype(np.float32)
        cal = calibrate_for_false_hit_budget(fused, labels,
                                             cfg.max_false_hit_rate)
        new_thr = float(np.clip(cal.threshold, old_thr - cfg.max_step,
                                old_thr + cfg.max_step))

        if float(np.abs(new_w - weights).max()) < 1e-6 \
                and abs(new_thr - old_thr) < 1e-6:
            return skip("no-change")
        self.counters["weight_refits_applied"] += 1
        rep = WeightRefitReport(
            tenant=t, applied=True, reason="ok",
            old_weights=tuple(float(w) for w in weights),
            new_weights=tuple(float(w) for w in new_w),
            old_threshold=old_thr, new_threshold=new_thr,
            step_clamped=step_clamped, n_events=n, n_duplicates=n_dup)
        self._log_weights(rep)
        new_policy = policy.with_threshold(new_thr, calibration=cal) \
            if abs(new_thr - old_thr) >= 1e-6 else policy
        return new_w.astype(np.float32), new_policy, rep

    def _log(self, rep: RefitReport) -> None:
        """Bounded decision log: a tenant stuck in a skip reason (e.g.
        class-starved) is re-examined every maintenance tick, so the
        log keeps only the most recent decisions."""
        self.refit_log.append(rep)
        if len(self.refit_log) > self.config.refit_log_cap:
            del self.refit_log[:-self.config.refit_log_cap]

    def _log_weights(self, rep: WeightRefitReport) -> None:
        self.weight_refit_log.append(rep)
        if len(self.weight_refit_log) > self.config.refit_log_cap:
            del self.weight_refit_log[:-self.config.refit_log_cap]

    # ------------------------------------------------------------------
    def state(self) -> Dict[str, object]:
        """Flat snapshot for the backend's ``stats()``."""
        return {
            "feedback_events": self.counters["events"],
            "duplicate_events": self.counters["duplicate_events"],
            "wasted_admissions": self.counters["wasted_admissions"],
            "refits_applied": self.counters["refits_applied"],
            "refits_skipped": self.counters["refits_skipped"],
            "feedback_tenants": len(self._res),
            "pair_events": self.counters["pair_events"],
            "pairs_held": len(self.pairs),
            "ensemble_events": self.counters["ensemble_events"],
            "weight_refits_applied":
                self.counters["weight_refits_applied"],
            "weight_refits_skipped":
                self.counters["weight_refits_skipped"],
            "hit_audits": self.counters["hit_audits"],
            "audited_false_hits": self.counters["audited_false_hits"],
        }


def record_refit(registry, report: RefitReport) -> None:
    """Publish one refit decision as structured registry events
    (DESIGN.md §10.1): a per-(tenant, outcome) counter — outcome is
    ``applied`` or the skip reason, so budget-guard refusals are
    directly alertable — plus, for applied refits, the tenant's
    published operating point as gauges.  ``CacheService.maintenance``
    calls this for every report its refit pass produced."""
    registry.counter(
        "admission_refits_total",
        "per-tenant refit decisions by outcome (applied | skip reason)",
        labels=("tenant", "outcome"),
    ).inc(1, tenant=report.tenant,
          outcome="applied" if report.applied else report.reason)
    if report.applied:
        registry.gauge(
            "admission_threshold", "published per-tenant hit threshold",
            labels=("tenant",)).set(report.new_threshold,
                                    tenant=report.tenant)
        registry.gauge(
            "admission_margin", "published per-tenant admission margin",
            labels=("tenant",)).set(report.new_margin,
                                    tenant=report.tenant)
        registry.gauge(
            "admission_observed_false_hit_rate",
            "observed false-hit rate at the published threshold",
            labels=("tenant",)).set(report.false_hit_rate,
                                    tenant=report.tenant)
