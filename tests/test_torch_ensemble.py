"""Port parity for the fused multi-embedder ensemble (DESIGN.md §13):
the port's plain ``ensemble_lookup`` against the reference's oracle and
its Pallas kernel in interpret mode, the E=1 identity with the single
cascade, the ensemble half of the tiers from carried reference states
(mirrored insert, mirrored warm append, ``publish_panel``,
``ensemble_cascade_query`` four-op and fused with ``panel_scores``),
the service round trip (`tests/test_ensemble_cascade.py`'s cases run
through both services), and the baseline embedders.

Inputs are numpy from a seed, at the reference tests' sizes (E=3, D=16,
capacities of tens of rows).  Tolerances: scores ``atol 1e-5`` (float32
sums in another order), mixture weights and thresholds ``atol 1e-6``,
encoder embeddings ``atol 1e-4`` (fp32 encoder, another summation
order); ids, slots, flags, counters and the numpy baselines exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_service import (
    CacheConfig as JCacheConfig, CacheRequest as JCacheRequest,
    CacheService as JCacheService, EnsembleConfig as JEnsembleConfig,
    FeedbackConfig as JFeedbackConfig, LearningConfig as JLearningConfig,
    TieringConfig as JTieringConfig,
)
from repro.cache_service import tiers as jtiers
from repro.kernels.cascade_lookup import kernel as jkernel
from repro.kernels.cascade_lookup import ref as jref
from repro_torch.cache_service import (
    CacheConfig, CacheRequest, CacheService, EnsembleConfig, FeedbackConfig,
    LearningConfig, TieringConfig,
)
from repro_torch.cache_service import tiers
from repro_torch.core import ivf as port_ivf
from repro_torch.kernels.cascade_lookup import ops as pops

E, D = 3, 16
NH, CAP, NK, BUCKET = 24, 64, 4, 20
SCORE_ATOL = 1e-5
W_ATOL = 1e-6
NAMES = ("scores", "value_ids", "warm_slots", "hot_slots", "hot_hit", "hit")
_jref = jax.jit(jref.ensemble_lookup,
                static_argnames=("k", "n_probe", "tail", "quantized"))


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _assert_tuple(a, b):
    for name, x, y in zip(NAMES, a, b):
        x = np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.shape == y.shape, name
        if name == "scores":
            np.testing.assert_allclose(y, x, rtol=0, atol=SCORE_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(y, x.astype(y.dtype),
                                          err_msg=name)


def _reference_first_seed(valid, seed):
    """The reference kmeans' first seed row (``jax.random.choice``)."""
    v = jnp.asarray(valid.cpu().numpy())
    p = v.astype(jnp.float32)
    p = jnp.where(p.sum() > 0, p, jnp.ones_like(p))
    return int(jax.random.choice(jax.random.PRNGKey(seed), v.shape[0],
                                 p=p / p.sum()))


@pytest.fixture
def same_kmeans_seed(monkeypatch):
    monkeypatch.setattr(port_ivf, "first_seed", _reference_first_seed)


# ---------------------------------------------------------------------------
# kernel layer
# ---------------------------------------------------------------------------

def _kernel_fixture(rng, e=E, n_q=9, nh=40, cap=96, n_k=6, bucket=24):
    """`tests/test_ensemble_cascade._kernel_fixture` over numpy."""
    q = _unit(rng.normal(size=(e, n_q, D))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(n_q, e)).astype(np.float32)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    qt = rng.integers(0, 3, n_q).astype(np.int32)
    thr = rng.uniform(0.1, 0.5, n_q).astype(np.float32)
    hk = _unit(rng.normal(size=(e, nh, D))).astype(np.float32)
    hv = rng.random(nh) < 0.8
    ht = rng.integers(0, 3, nh).astype(np.int32)
    hvid = np.arange(nh, dtype=np.int32)
    wk = _unit(rng.normal(size=(e, cap, D))).astype(np.float32)
    wv = rng.random(cap) < 0.85
    wt = rng.integers(0, 3, cap).astype(np.int32)
    wvid = 1000 + np.arange(cap, dtype=np.int32)
    wseq = rng.permutation(cap).astype(np.int32) + 1
    cent = _unit(rng.normal(size=(n_k, D))).astype(np.float32)
    members = np.full((n_k, bucket), -1, np.int32)
    for i, s in enumerate(rng.permutation(cap)):
        c, col = i % n_k, i // n_k
        if col < bucket:
            members[c, col] = s
    scales = (np.abs(wk).max(-1) / 127.0).astype(np.float32)
    wkq = np.clip(np.round(wk / scales[..., None]), -127, 127) \
        .astype(np.int8)
    args = (qt, thr, hk, hv, ht, hvid, wk, wv, wt, wvid, wseq, cent,
            members, np.int32(37), np.int32(cap - 20))
    return q, w, args, wkq, scales


def _port_args(args):
    return tuple(_t(a) for a in args)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_plain_ensemble_matches_reference_oracle_and_pallas(k, quantized):
    """The port's plain version (what the wrapper runs for CPU tensors)
    against the reference's jnp oracle and its Pallas kernel run in
    interpret mode: partial probes, tail window, invalid slots, mixed
    tenants."""
    rng = np.random.default_rng(11 + k + 10 * quantized)
    q, w, args, wkq, scales = _kernel_fixture(rng)
    kw = dict(k=k, n_probe=4, tail=12, quantized=quantized)
    jargs = tuple(jnp.asarray(a) for a in args)
    want = _jref(jnp.asarray(q), jnp.asarray(w), *jargs,
                 warm_keys_q=jnp.asarray(wkq),
                 warm_scales=jnp.asarray(scales), **kw)
    pallas = jkernel.cascade_lookup_ensemble(
        jnp.asarray(q), jnp.asarray(w), *jargs,
        warm_keys_q=jnp.asarray(wkq), warm_scales=jnp.asarray(scales),
        interpret=True, **kw)
    got = pops.ensemble_lookup(_t(q), _t(w), *_port_args(args),
                               warm_keys_q=_t(wkq), warm_scales=_t(scales),
                               **kw)
    _assert_tuple(want, got)
    _assert_tuple(pallas, got)
    assert np.asarray(want[5]).any() and not np.asarray(want[5]).all()


def test_e1_equals_the_single_cascade():
    """E=1 with weight 1.0 is the single cascade (the fused score is the
    one cosine times 1.0)."""
    rng = np.random.default_rng(5)
    q, _, args, wkq, scales = _kernel_fixture(rng, e=1)
    qt, thr, hk, hv, ht, hvid, wk, wv, wt, wvid, wseq, cent, members, \
        cur, idx = _port_args(args)
    for quantized in (False, True):
        kw = dict(k=2, n_probe=4, tail=12, quantized=quantized)
        single = pops.cascade_lookup(
            _t(q[0]), qt, thr, hk[0], hv, ht, hvid, wk[0], wv, wt, wvid,
            wseq, cent, members, cur, idx, warm_keys_q=_t(wkq[0]),
            warm_scales=_t(scales[0]), **kw)
        ens = pops.ensemble_lookup(
            _t(q), torch.ones(q.shape[1], 1), qt, thr, hk, hv, ht, hvid, wk,
            wv, wt, wvid, wseq, cent, members, cur, idx,
            warm_keys_q=_t(wkq), warm_scales=_t(scales), **kw)
        for name, a, b in zip(NAMES, single, ens):
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# tiers layer, from carried reference states
# ---------------------------------------------------------------------------

def _corr_panels(rng, n):
    """Latent-factor correlated (n, E, D) panels: the E embedders see
    the same latent through their own projections plus noise."""
    z = rng.normal(size=(n, 8))
    A = rng.normal(size=(E, 8, D))
    out = np.einsum("nz,ezd->ned", z, A) + 0.3 * rng.normal(size=(n, E, D))
    return _unit(out).astype(np.float32)


_jquery = jax.jit(jtiers.ensemble_cascade_query,
                  static_argnames=("k", "n_probe", "tail", "quantized"))


def _queries(rng, hot, warm, ens, n_new=3):
    """Paraphrase-like copies of live hot and warm rows (all E panels,
    under the row's tenant) plus fresh rows: (Q, E, D), (Q,)."""
    h = torch.nonzero(hot.valid).squeeze(1)[:4].numpy()
    w = torch.nonzero(warm.valid).squeeze(1)[:4].numpy()
    src = np.concatenate([ens.hot_keys[:, h].numpy(),
                          ens.warm_keys[:, w].numpy()], 1).transpose(1, 0, 2)
    q = np.concatenate([src + 0.05 * rng.normal(size=src.shape),
                        _corr_panels(rng, n_new)])
    qt = np.concatenate([hot.tenants[h].numpy(), warm.tenants[w].numpy(),
                         np.arange(n_new) % 3]).astype(np.int32)
    return _unit(q).astype(np.float32), qt


def _carry(hot, warm, ens):
    return (tiers.hot_from_reference(hot), tiers.warm_from_reference(warm),
            tiers.ensemble_from_reference(ens))


def _assert_state(ref, port, exact_keys=False):
    for name in type(port)._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(port, name).numpy()
        if b.dtype.kind == "f" and not exact_keys:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6,
                                       err_msg=name)
        elif b.dtype == np.int8:      # a one-ulp key may round one code
            assert np.abs(b.astype(int) - a).max() <= 1, name
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype),
                                          err_msg=name)


def _mutate_both(rng):
    """The reference fixture's mirrored mutation path (insert batch ->
    coldest slots -> demote -> mirrored append -> rebuild), run on the
    reference and, from the carried pre-states, on the port."""
    jhot, jwarm = jtiers.init_hot(NH, D), jtiers.init_warm(CAP, D, NK,
                                                           BUCKET)
    jens = jtiers.init_ensemble(E, jhot, jwarm)
    hot, warm, ens = _carry(jhot, jwarm, jens)
    n1 = 40
    embs = _corr_panels(rng, n1)
    vids = np.arange(n1, dtype=np.int32)
    vids[5] = -1                              # one admission skip
    tens = (np.arange(n1) % 3).astype(np.int32)
    jhot, jens, jev = jtiers.ensemble_hot_insert_batch(
        jhot, jens, jnp.asarray(embs), jnp.asarray(vids), jnp.asarray(tens))
    hot, ens, ev = tiers.ensemble_hot_insert_batch(
        hot, ens, _t(embs), _t(vids), _t(tens))
    np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
    _assert_state(jhot, hot)
    _assert_state(jens, ens)
    m = 8
    jpk = jens.hot_keys[:, jtiers.coldest_slots(jhot, m)]
    pk = ens.hot_keys[:, tiers.coldest_slots(hot, m)]
    jhot, jdem = jtiers.demote_coldest(jhot, m)
    hot, dem = tiers.demote_coldest(hot, m)
    jens = jtiers.ensemble_warm_append(jens, jwarm, jdem, jpk)
    ens = tiers.ensemble_warm_append(ens, warm, dem, pk)
    jwarm, _ = jtiers.warm_append(jwarm, jdem)
    warm, _ = tiers.warm_append(warm, dem)
    _assert_state(jens, ens)
    # the pilot panel mirrors the base tiers bit for bit
    assert torch.equal(ens.hot_keys[0], hot.keys)
    assert torch.equal(ens.warm_keys[0], warm.keys)
    assert torch.equal(ens.warm_keys_q[0], warm.keys_q)
    assert torch.equal(ens.warm_scales[0], warm.scales)
    jwarm = jtiers.warm_rebuild(jwarm, iters=4)
    return (jhot, jwarm, jens), (hot, tiers.warm_from_reference(jwarm), ens)


@pytest.mark.parametrize("quantized", [False, True])
def test_tiers_ensemble_query_matches_reference(quantized):
    rng = np.random.default_rng(21)
    (jhot, jwarm, jens), (hot, warm, ens) = _mutate_both(rng)
    qp, qt = _queries(rng, hot, warm, ens)
    Q = len(qt)
    w = rng.uniform(0.1, 1.0, size=(Q, E)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    thr = np.full(Q, 0.8, np.float32)
    want = _jquery(jhot, jwarm, jens, jnp.asarray(qp), jnp.asarray(w),
                   jnp.asarray(qt), jnp.asarray(thr), k=2, n_probe=2,
                   tail=8, quantized=quantized)
    for fused in (False, True):
        got = tiers.ensemble_cascade_query(
            hot, warm, ens, _t(qp), _t(w), _t(qt), _t(thr), k=2, n_probe=2,
            tail=8, fused=fused, quantized=quantized)
        for name in tiers.EnsembleResult._fields:
            a, b = np.asarray(getattr(want, name)), \
                getattr(got, name).numpy()
            if b.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=0, atol=SCORE_ATOL,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(b, a.astype(b.dtype),
                                              err_msg=name)
    has = got.value_ids[:, 0] >= 0
    assert has.any() and got.hit.any() and not got.hit.all()
    # the fused top-1 is the weighted sum of the reported panel cosines
    fused_top = (got.panel_scores * _t(w)).sum(1)
    torch.testing.assert_close(fused_top[has], got.scores[has, 0], rtol=0,
                               atol=2e-6)


def test_tiers_e1_matches_cascade_query():
    rng = np.random.default_rng(22)
    _, (hot, warm, _) = _mutate_both(rng)
    ens1 = tiers.init_ensemble(1, hot, warm)
    qp, qt = _queries(rng, hot, warm, tiers.init_ensemble(E, hot, warm))
    Q = len(qt)
    qt = _t(qt)
    thr = torch.full((Q,), 0.8)
    r1 = tiers.ensemble_cascade_query(hot, warm, ens1, _t(qp[:, :1]),
                                      torch.ones(Q, 1), qt, thr, k=2,
                                      n_probe=2, tail=8, fused=True)
    rb = tiers.cascade_query(hot, warm, _t(qp[:, 0]), qt, thr, k=2,
                             n_probe=2, tail=8, fused=True)
    for name in tiers.CascadeResult._fields:
        assert torch.equal(getattr(r1, name), getattr(rb, name)), name


def test_publish_panel_matches_reference():
    rng = np.random.default_rng(23)
    (jhot, jwarm, jens), (hot, warm, ens) = _mutate_both(rng)
    new_hot = rng.normal(size=(NH, D)).astype(np.float32)
    new_warm = rng.normal(size=(CAP, D)).astype(np.float32)
    jens2 = jtiers.publish_panel(jens, 2, jnp.asarray(new_hot),
                                 jnp.asarray(new_warm))
    ens2 = tiers.publish_panel(ens, 2, _t(new_hot), _t(new_warm))
    _assert_state(jens2, ens2)
    for name in ("hot_keys", "warm_keys", "warm_keys_q", "warm_scales"):
        for e in (0, 1):                      # only panel 2 moved
            assert torch.equal(getattr(ens2, name)[e],
                               getattr(ens, name)[e]), name
    jh, jw = jtiers.publish_reembedded_keys(jhot, jwarm,
                                            jnp.asarray(new_hot),
                                            jnp.asarray(new_warm))
    h, w = tiers.publish_reembedded_keys(hot, warm, _t(new_hot),
                                         _t(new_warm))
    _assert_state(jh, h)
    _assert_state(jw, w)


# ---------------------------------------------------------------------------
# service layer: the same stream through both services
# ---------------------------------------------------------------------------

def _panels(rng, n, noise=(0.9, 0.05, 0.9)):
    """Embedder 1 is informative; 0 and 2 are mostly noise."""
    z = _unit(rng.normal(size=(n, D)))
    return np.stack([_unit(z + s * rng.normal(size=(n, D)))
                     for s in noise], 1).astype(np.float32)


def _tiering(mod, fused):
    return mod(hot_capacity=32, warm_capacity=256, n_clusters=4, bucket=64,
               n_probe=4, flush_watermark=0.75, flush_size=8, fused=fused)


def _svc_pair(fused=True, feedback=None, weights=None):
    def cfg(C, T, L, En, F):
        return C(dim=D, threshold=0.80, tiering=_tiering(T, fused),
                 learning=L(learned_admission=feedback is not None,
                            feedback=None if feedback is None
                            else F(**feedback)),
                 ensemble=En(embedders=E, weights=weights))
    ref = JCacheService(cfg(JCacheConfig, JTieringConfig, JLearningConfig,
                            JEnsembleConfig, JFeedbackConfig))
    port = CacheService(cfg(CacheConfig, TieringConfig, LearningConfig,
                            EnsembleConfig, FeedbackConfig), device="cpu")
    return ref, port


def _step(ref, port, embs, texts, responses, tenant=0):
    """One plan + commit on both services; asserts equal verdicts."""
    pa = ref.plan(JCacheRequest.build(embs, tenant, texts=texts))
    pb = port.plan(CacheRequest.build(embs, tenant, texts=texts))
    for name in ("hit", "value_ids", "admit", "miss_leader",
                 "top_value_ids"):
        np.testing.assert_array_equal(getattr(pb, name),
                                      getattr(pa, name), err_msg=name)
    np.testing.assert_allclose(pb.scores, pa.scores, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(pb.panel_scores, pa.panel_scores, rtol=0,
                               atol=SCORE_ATOL)
    ra, rb = ref.commit(pa, responses), port.commit(pb, responses)
    assert (ra.admitted, ra.skipped, ra.evicted, ra.rebuild_due,
            ra.stale_version_skipped) == (rb.admitted, rb.skipped,
                                          rb.evicted, rb.rebuild_due,
                                          rb.stale_version_skipped)
    return pb


@pytest.mark.parametrize("fused", [False, True])
def test_service_plan_commit_flush_keep_panels_aligned(fused,
                                                       same_kmeans_seed):
    rng = np.random.default_rng(31)
    ref, port = _svc_pair(fused)
    assert port.capabilities().ensemble == E
    base = _panels(rng, 12)
    plan = _step(ref, port, base, [f"q{i}" for i in range(12)],
                 [f"r{i}" for i in range(12)])
    assert not plan.hit.any() and plan.panel_scores.shape == (12, E)
    assert torch.equal(port.ens.hot_keys[0], port.hot.keys)
    plan2 = _step(ref, port, base, None, [None] * 12)
    assert plan2.hit.all()
    with pytest.raises(ValueError):
        port.plan(CacheRequest.build(base[:, 0]))  # rank-2 under ensemble
    for i in range(6):
        b = _panels(rng, 8)
        _step(ref, port, b, [f"f{i}-{j}" for j in range(8)],
              [f"fr{i}-{j}" for j in range(8)])
    ref.flush()
    port.flush()
    _assert_state(ref.ens, port.ens)
    _assert_state(ref.warm, port.warm)
    assert torch.equal(port.ens.warm_keys[0], port.warm.keys)
    assert torch.equal(port.ens.warm_keys_q[0], port.warm.keys_q)
    st = port.stats_snapshot()
    assert st.tiers["ensemble"] == E and st.tiers["demotions"] > 0
    assert st.rebuild["rebuilds"] == ref.stats_snapshot().rebuild["rebuilds"]


def test_service_learns_mixture_weights_from_feedback(same_kmeans_seed):
    """Only embedder 1 separates duplicates from impostors; the same
    stream through both services gives the same weight refit log, the
    same published weights and thresholds, and upweights embedder 1."""
    rng = np.random.default_rng(32)
    ref, port = _svc_pair(feedback=dict(
        min_samples=24, min_class=4, refit_interval=10, reservoir=256,
        max_weight_step=0.5, seed=3))
    corp = _panels(rng, 16)
    _step(ref, port, corp, [f"c{i}" for i in range(16)],
          [f"ans{i}" for i in range(16)])
    for step in range(30):
        i = step % 16
        # a true duplicate whose noisy panels drag the uniform fused
        # score under the threshold (embedder 1 stays confident), and
        # an impostor that panels 0 and 2 cannot tell apart
        near = corp[i:i + 1].copy()
        for e, s in ((0, 0.4), (2, 0.4)):
            near[:, e] = _unit(s * corp[i:i + 1, e]
                               + rng.normal(size=(1, D)))
        near[:, 1] = _unit(corp[i:i + 1, 1] + 0.05 * rng.normal(size=(1, D)))
        imp = corp[i:i + 1].copy()
        imp[:, 1] = _unit(rng.normal(size=(1, D)))
        batch = np.concatenate([_unit(near), imp]).astype(np.float32)
        _step(ref, port, batch, [f"d{step}", f"i{step}"],
              [f"ans{i}", f"other{step}"])
    ma, mb = ref.maintenance(block=True), port.maintenance(block=True)
    assert (ma.refits_applied, ma.refits_checked) \
        == (mb.refits_applied, mb.refits_checked)
    la, lb = ref.feedback.weight_refit_log, port.feedback.weight_refit_log
    assert len(la) == len(lb) and any(r.applied for r in lb)
    for a, b in zip(la, lb):
        assert (a.tenant, a.applied, a.reason, a.step_clamped, a.n_events,
                a.n_duplicates) == (b.tenant, b.applied, b.reason,
                                    b.step_clamped, b.n_events,
                                    b.n_duplicates)
        np.testing.assert_allclose(b.new_weights, a.new_weights, rtol=0,
                                   atol=W_ATOL)
        assert abs(a.new_threshold - b.new_threshold) <= W_ATOL
    wa, wb = ref.policies.weights_state(), port.policies.weights_state()
    assert wa.keys() == wb.keys()
    np.testing.assert_allclose(wb[0], wa[0], rtol=0, atol=W_ATOL)
    assert abs(ref.policies.get(0).threshold
               - port.policies.get(0).threshold) <= W_ATOL
    assert wb[0][1] > 1.0 / E           # the informative embedder gains
    sa, sb = ref.stats_snapshot().learning, port.stats_snapshot().learning
    for key in ("feedback_events", "duplicate_events", "ensemble_events",
                "weight_refits_applied", "weight_refits_skipped",
                "refits_applied", "pair_events"):
        assert sa[key] == sb[key], key
    assert "ensemble_weights" in sb


def test_service_tenant_weight_override():
    _, port = _svc_pair(weights=[1.0, 1.0, 2.0])
    port.set_tenant_weights(5, [0.2, 0.6, 0.2])
    wq = port.policies.weights_for(np.array([5, 99], np.int32), E)
    np.testing.assert_allclose(wq[0], [0.2, 0.6, 0.2], atol=W_ATOL)
    np.testing.assert_allclose(wq[1], [0.25, 0.25, 0.5], atol=W_ATOL)


def test_service_publish_panel_versioning(same_kmeans_seed):
    """``publish_panel`` bumps the embed version, so a plan issued
    against the old panels is skipped at commit; a panel-0 publish swaps
    the base tiers too — the same on both services."""
    rng = np.random.default_rng(33)
    ref, port = _svc_pair()
    base = _panels(rng, 12)
    _step(ref, port, base, [f"q{i}" for i in range(12)],
          [f"r{i}" for i in range(12)])
    stale = _panels(rng, 2)
    pa = ref.plan(JCacheRequest.build(stale, texts=["s0", "s1"]))
    pb = port.plan(CacheRequest.build(stale, texts=["s0", "s1"]))
    nh, nw = port.hot.keys.shape[0], port.warm.keys.shape[0]
    for e in (2, 0):
        hk = rng.normal(size=(nh, D)).astype(np.float32)
        wk = rng.normal(size=(nw, D)).astype(np.float32)
        ref.publish_panel(e, hk, wk)
        port.publish_panel(e, hk, wk)
    ra, rb = ref.commit(pa, ["x", "y"]), port.commit(pb, ["x", "y"])
    assert rb.stale_version_skipped == ra.stale_version_skipped == 2
    assert rb.admitted == ra.admitted == 0
    assert torch.equal(port.ens.hot_keys[0], port.hot.keys)
    assert torch.equal(port.ens.warm_keys[0], port.warm.keys)
    _assert_state(ref.ens, port.ens)
    with pytest.raises(ValueError, match="range"):
        port.publish_panel(E, np.zeros((nh, D)), np.zeros((nw, D)))


def test_service_constructor_guards():
    with pytest.raises(ValueError):
        CacheService(CacheConfig(dim=D, learning=LearningConfig(
            learned_embedder=True), ensemble=EnsembleConfig(embedders=E)),
            device="cpu")
    with pytest.raises(ValueError, match="without embedders"):
        CacheService(CacheConfig(dim=D, ensemble=EnsembleConfig(
            weights=[0.5, 0.5])), device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        CacheService(CacheConfig(dim=D, ensemble=EnsembleConfig(
            embedders=())), device="cpu")
    svc = CacheService(CacheConfig(dim=D), device="cpu")
    with pytest.raises(ValueError, match="embedders"):
        svc.set_tenant_weights(0, [1.0])
    assert svc.capabilities().ensemble == 0


# ---------------------------------------------------------------------------
# baseline embedders
# ---------------------------------------------------------------------------

TEXTS = ["what are the symptoms of diabetes", "How do I reset my password?",
         "", "side effects of ibuprofen in children", "a", "x y z " * 20]


def test_numpy_baselines_equal_the_reference():
    from repro.core import embedders as jemb
    from repro_torch.core import embedders as pemb
    for make in (lambda m: m.HashNgramEmbedder(dim=64),
                 lambda m: m.RandomProjectionEmbedder(dim=32, vocab=512,
                                                      seed=101)):
        np.testing.assert_array_equal(make(pemb).embed(TEXTS),
                                      make(jemb).embed(TEXTS))


def test_encoder_embedder_matches_reference():
    """Carried weights at the reduced config; 70 texts pad the second
    64-row chunk with ``""`` on both sides."""
    from repro.configs import get_config as jget
    from repro.core.embedders import EncoderEmbedder as JEncoderEmbedder
    from repro.models import init_lm, split
    from repro_torch.configs import get_config
    from repro_torch.core import EncoderEmbedder
    from repro_torch.models import state_dict_from_reference
    jcfg = jget("modernbert-149m").reduced(n_layers=2)
    cfg = get_config("modernbert-149m").reduced(n_layers=2)
    params, _ = split(init_lm(jcfg, jax.random.PRNGKey(4)))
    texts = (TEXTS * 12)[:70]
    want = JEncoderEmbedder(jcfg, params=params).embed(texts)
    port = EncoderEmbedder(cfg, params=state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, params), cfg), device="cpu")
    got = port.embed(texts)
    assert got.shape == want.shape == (70, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert port.name.endswith("(untuned)")
