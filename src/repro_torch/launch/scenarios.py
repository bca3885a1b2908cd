"""Seeded serving-scenario traces (DESIGN.md §14.1): the port of the
reference's ``benchmarks/scenarios.py``, kept in the package so that
``launch.serve --scenario`` needs nothing outside it.  The generators
make the same draws in the same order from the same seeds, so a given
``(name, seed, dim, smoke)`` gives the reference's trace bit for bit.

Each generator composes one production failure mode into a
reproducible trace: a list of ``Step``s, each one batch of embedded
queries with ground truth attached.  `launch.replay` replays a trace
through a real ``CacheService`` under a *logical clock*
(``StalenessConfig.clock``), so arrival times, TTL expiry and
maintenance cadence are exactly the trace's — no wall-clock flake.

Ground-truth model
------------------
Every query row belongs to a **group** — the unit of answer identity.
A novel row opens a fresh group; a repeat/paraphrase row carries the
group of the entry it rephrases (``group[i]``).  The replay commits
every admitted miss with the response ``f"ans-g{gid}"``, so scoring
is pure string equality:

  * true hit   — served response == the row's own group answer;
  * false hit  — served response is some *other* group's answer
    (cross-group, cross-tenant, or an adversarial ``must_miss`` row
    that is geometrically close to a stored entry but semantically
    distinct — its own fresh group by construction);
  * stale serve — a hit on a group whose latest insert's TTL deadline
    has passed at arrival time (tracked by the replay; none may
    occur).

Scenarios (``SCENARIOS`` registry):

  * ``diurnal``      — sinusoidal arrival rate: batch sizes swell to
    ~3x base at peak; p99 must hold through the peak, not the mean.
  * ``zipf_tenants`` — tenant of each row drawn Zipf(a): one hot
    tenant dominates, a long tail of barely-seen tenants rides along.
  * ``drift``        — two-phase topic drift for the §14.3 conformal
    contrast: phase 1 is calibration traffic (duplicates ~0.95,
    negatives ~0.55 — a per-tenant learned threshold calibrated on it
    lands well below the default), phase 2 drifts the negative band up
    to 0.78–0.82, squarely above the learned threshold.  The fixed
    learned threshold serves them all as false hits; the conformal
    floor (a recency quantile of audited negatives) climbs past the
    band within a few batches.
  * ``bursty``       — Poisson-thinned trickle punctuated by large
    burst batches after idle gaps.
  * ``adversarial``  — paraphrase-shaped near-duplicates: cone
    rotations ``v = cos(θ)·u + sin(θ)·w`` of stored entries at cosine
    just *below* the serving threshold, labeled must-miss (distinct
    answers).  Any execution path that rounds them up to a hit
    (quantization, fused scoring) blows the false-hit budget.
  * ``ttl_churn``    — every insert carries a finite TTL; repeats
    arrive both before expiry (must hit) and after (must miss, then
    re-insert).  Small hot tier so live-but-doomed entries demote
    through warm into cold while their deadline runs — expiry has to
    hold in every tier.
  * ``cold_tenants`` — cache-hostile: many tenants, ~all-novel
    queries.  Hit rate ~0 by design; the scenario scores the miss
    path's p99 and the false-hit budget on pure-novelty traffic.

Generators take ``(seed, dim, smoke)`` and must be deterministic in
them.  Nothing here imports the service — traces are plain numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _rotate(u, cos_t, rng):
    """Cone rotation: a unit vector at exactly ``cos_t`` cosine to
    ``u`` along a random orthogonal direction."""
    w = rng.standard_normal(u.shape).astype(np.float32)
    w = w - (w @ u) * u
    w = w / max(float(np.linalg.norm(w)), 1e-9)
    return (cos_t * u + np.sqrt(max(1.0 - cos_t * cos_t, 0.0)) * w
            ).astype(np.float32)


@dataclass
class Step:
    """One arrival batch of the trace."""
    t: float                      # logical arrival time (seconds)
    embs: np.ndarray              # (B, D) float32 unit rows
    tenants: np.ndarray           # (B,) int32
    group: np.ndarray             # (B,) int64 answer-group id
    must_miss: np.ndarray         # (B,) bool — a hit here is false
    ttl: Optional[np.ndarray] = None   # (B,) float32 seconds, or None


@dataclass
class ScenarioTrace:
    name: str
    seed: int
    dim: int
    steps: List[Step]
    false_hit_budget: float       # per-scenario (and per-tenant) budget
    threshold: float = 0.85       # serving threshold the trace targets
    # per-tenant calibration pairs (scores, labels) the replay feeds
    # calibrate_tenant() before replay — only the drift scenario sets it
    calibration: Dict[int, tuple] = field(default_factory=dict)
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def n_queries(self) -> int:
        return sum(len(s.tenants) for s in self.steps)


class _GroupSpace:
    """Allocates answer groups and remembers each group's base
    embedding + tenant so repeats can be synthesized later."""

    def __init__(self, rng, dim):
        self.rng = rng
        self.dim = dim
        self.base: List[np.ndarray] = []
        self.tenant: List[int] = []

    def novel(self, tenant) -> int:
        self.base.append(_unit(
            self.rng.standard_normal(self.dim).astype(np.float32)))
        self.tenant.append(int(tenant))
        return len(self.base) - 1

    def paraphrase(self, gid, lo=0.93, hi=0.98):
        cos_t = float(self.rng.uniform(lo, hi))
        return _rotate(self.base[gid], cos_t, self.rng)

    def of_tenant(self, tenant) -> List[int]:
        return [g for g, t in enumerate(self.tenant) if t == int(tenant)]


def _mix_step(gs, rng, t, batch, tenants_of_row, repeat_frac,
              ttl=None) -> Step:
    """Generic batch: ``repeat_frac`` of rows paraphrase an existing
    same-tenant group, the rest open novel groups."""
    embs, groups, mm = [], [], []
    for tenant in tenants_of_row:
        pool = gs.of_tenant(tenant)
        if pool and rng.random() < repeat_frac:
            gid = int(pool[rng.integers(len(pool))])
            embs.append(gs.paraphrase(gid))
        else:
            gid = gs.novel(tenant)
            embs.append(gs.base[gid])
        groups.append(gid)
        mm.append(False)
    ttl_col = None
    if ttl is not None:
        ttl_col = np.full(batch, float(ttl), np.float32)
    return Step(t=t, embs=np.stack(embs),
                tenants=np.asarray(tenants_of_row, np.int32),
                group=np.asarray(groups, np.int64),
                must_miss=np.asarray(mm, bool), ttl=ttl_col)


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------

def make_diurnal(seed=0, dim=64, smoke=False) -> ScenarioTrace:
    rng = np.random.default_rng(seed + 101)
    gs = _GroupSpace(rng, dim)
    n_steps = 24 if smoke else 96
    base_b, amp = 8, 2.0
    steps, t = [], 0.0
    for i in range(n_steps):
        phase = 2.0 * np.pi * i / max(n_steps / 2, 1)
        b = max(2, int(round(base_b * (1.0 + amp * max(
            np.sin(phase), 0.0)))))
        tenants = rng.integers(0, 4, b)
        steps.append(_mix_step(gs, rng, t, b, tenants, repeat_frac=0.45))
        t += 1.0
    return ScenarioTrace("diurnal", seed, dim, steps,
                         false_hit_budget=0.02,
                         meta={"base_batch": base_b, "amp": amp})


def make_zipf_tenants(seed=0, dim=64, smoke=False) -> ScenarioTrace:
    rng = np.random.default_rng(seed + 202)
    gs = _GroupSpace(rng, dim)
    n_steps = 20 if smoke else 80
    n_tenants = 32
    steps, t = [], 0.0
    for _ in range(n_steps):
        b = 8
        tenants = np.minimum(rng.zipf(1.6, b) - 1, n_tenants - 1)
        steps.append(_mix_step(gs, rng, t, b, tenants, repeat_frac=0.5))
        t += 1.0
    return ScenarioTrace("zipf_tenants", seed, dim, steps,
                         false_hit_budget=0.02,
                         meta={"n_tenants": n_tenants, "zipf_a": 1.6})


def make_drift(seed=0, dim=64, smoke=False) -> ScenarioTrace:
    """Two tenants, two phases.  Phase 1 also yields the calibration
    pairs: duplicate scores ~N(0.95, .01), negatives ~N(0.55, .05) —
    a budgeted per-tenant calibration lands the learned threshold
    around ~0.7.  Phase 2 shifts the negative band to 0.78–0.82:
    below the default 0.85, above the learned threshold."""
    rng = np.random.default_rng(seed + 303)
    gs = _GroupSpace(rng, dim)
    tenants = (0, 1)
    p1 = 12 if smoke else 30
    p2 = 20 if smoke else 60
    steps, t = [], 0.0
    # phase 1: seed each tenant's bases, mild paraphrase traffic
    for _ in range(p1):
        row_t = np.asarray([tenants[i % 2] for i in range(8)], np.int32)
        steps.append(_mix_step(gs, rng, t, 8, row_t, repeat_frac=0.4))
        t += 1.0
    # calibration pairs per tenant (scores only — the geometry above is
    # what they summarize; calibrate_tenant takes raw pairs)
    calibration = {}
    for tn in tenants:
        dup = rng.normal(0.95, 0.01, 300)
        neg = rng.normal(0.55, 0.05, 300)
        scores = np.concatenate([dup, neg]).astype(np.float32)
        labels = np.concatenate([np.ones(300), np.zeros(300)]
                                ).astype(np.int32)
        calibration[tn] = (scores, labels)
    # phase 2: drifted near-threshold distractors (must-miss, own
    # groups) interleaved with true paraphrases that must keep hitting
    drift_start = t
    for _ in range(p2):
        embs, groups, mm, row_t = [], [], [], []
        for i in range(10):
            tn = tenants[i % 2]
            pool = gs.of_tenant(tn)
            if i % 5 == 4 and pool:          # 20%: true paraphrase
                gid = int(pool[rng.integers(len(pool))])
                embs.append(gs.paraphrase(gid))
                groups.append(gid)
                mm.append(False)
            else:                            # 80%: drifted distractor
                anchor = int(pool[rng.integers(len(pool))])
                cos_t = float(rng.uniform(0.78, 0.82))
                gid = gs.novel(tn)
                # distinct answer, but parked deliberately close to a
                # stored entry — the drifted topic crowding the band
                gs.base[gid] = _rotate(gs.base[anchor], cos_t, rng)
                embs.append(gs.base[gid])
                groups.append(gid)
                mm.append(True)
            row_t.append(tn)
        steps.append(Step(t=t, embs=np.stack(embs),
                          tenants=np.asarray(row_t, np.int32),
                          group=np.asarray(groups, np.int64),
                          must_miss=np.asarray(mm, bool)))
        t += 1.0
    return ScenarioTrace("drift", seed, dim, steps,
                         false_hit_budget=0.15,
                         calibration=calibration,
                         meta={"phase2_start_t": drift_start,
                               "distractor_cos": [0.78, 0.82],
                               "max_false_hit_rate": 0.02})


def make_bursty(seed=0, dim=64, smoke=False) -> ScenarioTrace:
    rng = np.random.default_rng(seed + 404)
    gs = _GroupSpace(rng, dim)
    n_steps = 16 if smoke else 60
    steps, t = [], 0.0
    for i in range(n_steps):
        if rng.random() < 0.15:              # burst after an idle gap
            t += float(rng.uniform(4.0, 8.0))
            b = 48
        else:
            t += 1.0
            b = 4
        tenants = rng.integers(0, 4, b)
        steps.append(_mix_step(gs, rng, t, b, tenants, repeat_frac=0.4))
    return ScenarioTrace("bursty", seed, dim, steps,
                         false_hit_budget=0.02,
                         meta={"burst_batch": 48, "trickle_batch": 4})


def make_adversarial(seed=0, dim=64, smoke=False) -> ScenarioTrace:
    """Stored entries first; then paraphrase-shaped near-duplicates at
    cosine 0.80–0.835 — below the 0.85 threshold, inside the band an
    over-eager scorer would round up.  All must-miss."""
    rng = np.random.default_rng(seed + 505)
    gs = _GroupSpace(rng, dim)
    warm_steps = 6 if smoke else 15
    atk_steps = 12 if smoke else 40
    steps, t = [], 0.0
    for _ in range(warm_steps):
        tenants = rng.integers(0, 2, 8)
        steps.append(_mix_step(gs, rng, t, 8, tenants, repeat_frac=0.2))
        t += 1.0
    for _ in range(atk_steps):
        embs, groups, mm, row_t = [], [], [], []
        for i in range(8):
            tn = int(rng.integers(0, 2))
            pool = gs.of_tenant(tn)
            if i % 4 == 3 and pool:          # keep some true repeats in
                gid = int(pool[rng.integers(len(pool))])
                embs.append(gs.paraphrase(gid))
                groups.append(gid)
                mm.append(False)
            else:
                anchor = int(pool[rng.integers(len(pool))])
                cos_t = float(rng.uniform(0.80, 0.835))
                gid = gs.novel(tn)
                gs.base[gid] = _rotate(gs.base[anchor], cos_t, rng)
                embs.append(gs.base[gid])
                groups.append(gid)
                mm.append(True)
            row_t.append(tn)
        steps.append(Step(t=t, embs=np.stack(embs),
                          tenants=np.asarray(row_t, np.int32),
                          group=np.asarray(groups, np.int64),
                          must_miss=np.asarray(mm, bool)))
        t += 1.0
    return ScenarioTrace("adversarial", seed, dim, steps,
                         false_hit_budget=0.01,
                         meta={"attack_cos": [0.80, 0.835]})


def make_ttl_churn(seed=0, dim=64, smoke=False) -> ScenarioTrace:
    """Every insert carries ttl=TTL logical seconds.  Each group is
    revisited twice: once inside its deadline (must hit) and once
    after (must miss — the replay flags any post-deadline serve as a
    stale serve and hard-asserts zero)."""
    rng = np.random.default_rng(seed + 606)
    gs = _GroupSpace(rng, dim)
    TTL = 12.0
    n_waves = 6 if smoke else 20
    steps, t = [], 0.0
    for _ in range(n_waves):
        # wave: 8 novel inserts with a finite TTL
        tenants = rng.integers(0, 3, 8)
        steps.append(_mix_step(gs, rng, t, 8, tenants, repeat_frac=0.0,
                               ttl=TTL))
        fresh = list(range(len(gs.base) - 8, len(gs.base)))
        # +4s: repeat them inside the deadline (expect hits)
        t += 4.0
        embs = np.stack([gs.paraphrase(g) for g in fresh])
        steps.append(Step(t=t, embs=embs,
                          tenants=np.asarray([gs.tenant[g] for g in fresh],
                                             np.int32),
                          group=np.asarray(fresh, np.int64),
                          must_miss=np.zeros(8, bool), ttl=None))
        # +10s (14s after insert > TTL): repeat again — expired, any
        # serve is stale; the re-miss re-inserts with a fresh deadline
        t += 10.0
        embs = np.stack([gs.paraphrase(g) for g in fresh])
        steps.append(Step(t=t, embs=embs,
                          tenants=np.asarray([gs.tenant[g] for g in fresh],
                                             np.int32),
                          group=np.asarray(fresh, np.int64),
                          must_miss=np.zeros(8, bool),
                          ttl=np.full(8, TTL, np.float32)))
        t += 2.0
    return ScenarioTrace("ttl_churn", seed, dim, steps,
                         false_hit_budget=0.02,
                         meta={"ttl_s": TTL})


def make_cold_tenants(seed=0, dim=64, smoke=False) -> ScenarioTrace:
    rng = np.random.default_rng(seed + 707)
    gs = _GroupSpace(rng, dim)
    n_steps = 16 if smoke else 64
    n_tenants = 48
    steps, t = [], 0.0
    for _ in range(n_steps):
        b = 8
        tenants = rng.integers(0, n_tenants, b)
        steps.append(_mix_step(gs, rng, t, b, tenants, repeat_frac=0.02))
        t += 1.0
    return ScenarioTrace("cold_tenants", seed, dim, steps,
                         false_hit_budget=0.01,
                         meta={"n_tenants": n_tenants})


SCENARIOS = {
    "diurnal": make_diurnal,
    "zipf_tenants": make_zipf_tenants,
    "drift": make_drift,
    "bursty": make_bursty,
    "adversarial": make_adversarial,
    "ttl_churn": make_ttl_churn,
    "cold_tenants": make_cold_tenants,
}


def build(name: str, seed: int = 0, dim: int = 64,
          smoke: bool = False) -> ScenarioTrace:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name](seed=seed, dim=dim, smoke=smoke)
