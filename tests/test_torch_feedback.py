"""Port parity for the online learning loop (DESIGN.md §9, §13): the
port's ``FeedbackAccumulator`` and the reference's fed the same event
stream give the same reservoirs and the same threshold and
mixture-weight refit decisions; learned admission through both services
on the reference's drifting stream (`tests/test_admission_learning.py`)
gives the same refit log and operating points; the port still refuses,
naming the slice, what it does not run.

Inputs are numpy from a seed.  Tolerances: thresholds, margins and
weights ``atol 1e-6``; reservoirs, counters and decisions exactly.
The event streams keep the duplicate and distinct score populations
apart, so no verdict sits on a float tie.
"""
import numpy as np
import pytest

from repro.cache_service import (
    CacheConfig as JCacheConfig, CacheRequest as JCacheRequest,
    CacheService as JCacheService, FeedbackAccumulator as JAccumulator,
    FeedbackConfig as JFeedbackConfig, LearningConfig as JLearningConfig,
    TenantPolicy as JTenantPolicy, TieringConfig as JTieringConfig,
)
from repro_torch.cache_service import (
    CacheConfig, CacheRequest, CacheService, FeedbackAccumulator,
    FeedbackConfig, LearningConfig, TenantPolicy, TieringConfig,
)
from repro_torch.core import ivf as port_ivf

ATOL = 1e-6
DIM = 64


def _assert_report(a, b):
    for name in type(a).__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, float) or (isinstance(x, tuple) and x
                                    and isinstance(x[0], float)):
            np.testing.assert_allclose(y, x, rtol=0, atol=ATOL,
                                       err_msg=name)
        else:
            assert x == y, name


def _stream(seed, n=900, E=3):
    """Per-tenant (score, duplicate, admitted, panel scores, texts)
    events: duplicates around 0.88, distincts around 0.35; panel 1
    separates them, panels 0 and 2 mostly do not."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        dup = bool(rng.random() < 0.45)
        score = float(np.clip(rng.normal(0.88 if dup else 0.35,
                                         0.015 if dup else 0.1), -1, 1))
        panels = rng.normal(0.5, 0.2, E)
        panels[1] = rng.normal(0.9 if dup else 0.2, 0.05)
        yield (i % 2, score, dup, bool(rng.random() < 0.7),
               np.clip(panels, -1, 1).astype(np.float32),
               (f"q{i}", f"n{i}") if i % 3 else (None, None))


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulators_agree_on_one_stream(seed):
    """Streams longer than the reservoirs, so every algorithm-R draw of
    the shared generator (tenant, ensemble and pair reservoirs alike)
    must come in the same order on both sides."""
    kw = dict(reservoir=96, min_samples=48, min_class=8, refit_interval=40,
              max_step=0.03, pair_reservoir=64, max_weight_step=0.2,
              seed=seed)
    ja, pa = JAccumulator(JFeedbackConfig(**kw)), \
        FeedbackAccumulator(FeedbackConfig(**kw))
    jpol = {t: JTenantPolicy(0.9, 0.02) for t in (0, 1)}
    ppol = {t: TenantPolicy(0.9, 0.02) for t in (0, 1)}
    jw = {t: np.full(3, 1 / 3, np.float32) for t in (0, 1)}
    pw = dict(jw)
    n_applied = 0
    for i, (t, s, dup, adm, panels, (q, nb)) in enumerate(_stream(seed)):
        for acc in (ja, pa):
            acc.observe(t, s, dup, adm, text=q, neighbour_text=nb)
            acc.observe_ensemble(t, panels, dup)
        if i % 50 == 49:
            for t2 in (0, 1):
                jp2, jrep = ja.fit(t2, jpol[t2])
                pp2, prep = pa.fit(t2, ppol[t2])
                _assert_report(jrep, prep)
                jpol[t2], ppol[t2] = jp2, pp2
                jw2, jp3, jwrep = ja.fit_weights(t2, jw[t2], jpol[t2])
                pw2, pp3, pwrep = pa.fit_weights(t2, pw[t2], ppol[t2])
                _assert_report(jwrep, pwrep)
                np.testing.assert_allclose(pw2, jw2, rtol=0, atol=ATOL)
                jw[t2], pw[t2], jpol[t2], ppol[t2] = jw2, pw2, jp3, pp3
                n_applied += prep.applied + pwrep.applied
    for t in (0, 1):
        for a, b in ((ja._res[t], pa._res[t]), (ja._ens[t], pa._ens[t])):
            np.testing.assert_array_equal(b.scores, a.scores)
            np.testing.assert_array_equal(b.labels, a.labels)
            assert (a.fill, a.seen) == (b.fill, b.seen)
    assert ja.pairs.items == pa.pairs.items
    assert ja.counters == pa.counters and ja.state() == pa.state()
    assert n_applied >= 2


def _reference_first_seed(valid, seed):
    """The reference kmeans' first seed row (``jax.random.choice``)."""
    import jax
    import jax.numpy as jnp
    v = jnp.asarray(valid.cpu().numpy())
    p = v.astype(jnp.float32)
    p = jnp.where(p.sum() > 0, p, jnp.ones_like(p))
    return int(jax.random.choice(jax.random.PRNGKey(seed), v.shape[0],
                                 p=p / p.sum()))


def _drift(mods):
    """`tests/test_admission_learning._serve_drift` over one service
    (``mods`` picks the reference's or the port's classes)."""
    Cfg, Tier, Learn, Fb, Req, Svc, extra = mods
    stream_rng = np.random.default_rng(7)
    intents = stream_rng.standard_normal((48, DIM)).astype(np.float32)
    intents /= np.linalg.norm(intents, axis=1, keepdims=True)
    svc = Svc(Cfg(
        dim=DIM, threshold=0.95, admission_margin=0.02,
        tiering=Tier(hot_capacity=256, warm_capacity=1024, n_clusters=16,
                     bucket=128, n_probe=4, flush_size=64, kmeans_iters=2),
        learning=Learn(learned_admission=True, feedback=Fb(
            min_samples=48, refit_interval=32, max_step=0.03, seed=0))),
        **extra)
    plans, maint = [], []
    for b in range(21):
        noise = 0.06 if b >= 7 else 0.02
        ids = stream_rng.integers(0, len(intents), 32)
        embs = intents[ids] + noise * stream_rng.standard_normal(
            (32, DIM)).astype(np.float32)
        embs /= np.linalg.norm(embs, axis=1, keepdims=True)
        plan = svc.plan(Req.build(embs))
        svc.commit(plan, [f"ans{i}" for i in ids])
        m = svc.maintenance()
        plans.append(plan)
        maint.append((m.refits_applied, m.refits_checked))
    return svc, plans, maint


def test_learned_admission_refits_match_reference(monkeypatch):
    """The reference's drifting stream (paraphrase noise triples after a
    third of the batches) through both services with learned admission:
    the same verdicts batch by batch, the same refit log, the same
    learned operating point — which moved off the configured 0.95."""
    monkeypatch.setattr(port_ivf, "first_seed", _reference_first_seed)
    ref, rplans, rm = _drift((JCacheConfig, JTieringConfig,
                                    JLearningConfig, JFeedbackConfig,
                                    JCacheRequest, JCacheService, {}))
    port, pplans, pm = _drift((CacheConfig, TieringConfig,
                                     LearningConfig, FeedbackConfig,
                                     CacheRequest, CacheService,
                                     {"device": "cpu"}))
    assert rm == pm
    for a, b in zip(rplans, pplans):
        for name in ("hit", "admit", "value_ids", "miss_leader"):
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name), err_msg=name)
    la, lb = ref.feedback.refit_log, port.feedback.refit_log
    assert len(la) == len(lb) and sum(r.applied for r in lb) >= 1
    for a, b in zip(la, lb):
        _assert_report(a, b)
    sa, sb = ref.stats_snapshot().learning, port.stats_snapshot().learning
    assert sa["learned_policies"].keys() == sb["learned_policies"].keys()
    for t, pol in sa["learned_policies"].items():
        for key, v in pol.items():
            assert abs(sb["learned_policies"][t][key] - v) <= ATOL, key
    assert sb["learned_policies"][0]["threshold"] < 0.95
    for key in ("feedback_events", "duplicate_events", "wasted_admissions",
                "refits_applied", "refits_skipped"):
        assert sa[key] == sb[key], key
    assert port.capabilities().learned_admission
    for rep in lb:
        if rep.applied:
            assert abs(rep.new_threshold - rep.old_threshold) <= 0.03 + ATOL


def test_unported_learning_fields_still_refused():
    """No learning field is refused by the config: the embedder
    refresh's fields are accepted, and the service holds them to the
    reference's rule (a refresh needs its trainer and tokenizer).  A
    ``DeviceMesh`` is accepted for the sharded warm tier, and a cold
    tier beside it refused, as in the reference.  Conformal calibration,
    the background rebuild and the cold tier are accepted, as are the
    learning and ensemble fields."""
    from repro_torch.cache_service import (
        CacheConfig, CacheService, EmbedderRefreshPolicy, EnsembleConfig,
        ShardingConfig,
    )
    from test_torch_ranks import one_rank_mesh
    with one_rank_mesh() as mesh:
        ShardingConfig(mesh=mesh)
        with pytest.raises(ValueError, match="unsharded warm tier"):
            CacheService(CacheConfig(
                dim=8, sharding=ShardingConfig(mesh=mesh),
                tiering=TieringConfig(cold_capacity=64)), device="cpu")
    for learning in (LearningConfig(refresh_policy=EmbedderRefreshPolicy()),
                     LearningConfig(learned_embedder=True,
                                    embedder_trainer=object())):
        with pytest.raises(ValueError, match="embedder_tokenizer"):
            CacheService(CacheConfig(dim=8, learning=learning),
                         device="cpu")
    LearningConfig(learned_admission=True, feedback=FeedbackConfig(),
                   conformal=True)
    TieringConfig(background_rebuild=True, cold_capacity=64)
    EnsembleConfig(embedders=3, weights=[1.0, 1.0, 1.0])
