"""Port parity for the sharded warm tier (DESIGN.md §8) at the tiers
level: the stacked (S, …) oracle against the reference's on the fixtures
of `tests/test_sharded_cascade.py` and `tests/test_ensemble_cascade.py`
— the cascade fused / four-op x fp32 / int8, the fused ensemble, one
shard equal to the plain cascade, the full-probe sharded lookup equal to
the unsharded one — the sharded mutations (round-robin append, per-shard
rebuild, the elementwise ops over the shard axis, the ensemble's
mirrored append and panel publish), and the mesh form on 2 gloo ranks
against both.

Inputs are numpy from a seed; states are built with the reference's
functions (its k-means included) and carried across.  Tolerances:
scores and keys ``atol 1e-5`` (float32 sums in another order); ids,
slots, flags, lists and ring counters exactly; the mesh form equals the
port's own stacked oracle bit for bit (the same plain code on the same
inputs; the merge only selects); requantized int8 codes within one code
and scales within 2 ulps (XLA divides by 127 as a multiply by the
reciprocal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_service import tiers as jt
from repro.core import ivf as jivf
from repro_torch.cache_service import tiers as pt
from test_torch_ranks import numpy_of, sharded_tiers_ranks, spawn

SCORE_ATOL = 1e-5
_STATIC = ("k", "n_probe", "tail", "fused", "use_kernel", "quantized",
           "mesh", "axis", "warm_block_n")
_jcascade = jax.jit(jt.cascade_query, static_argnames=_STATIC)
_jensemble = jax.jit(jt.ensemble_cascade_query, static_argnames=_STATIC)
_jkmeans = jax.jit(jivf.kmeans, static_argnums=(2, 3, 4))
_jlists = jax.jit(jivf.build_lists, static_argnums=(3,))
# eager JAX dispatches every primitive on its own: jit the fixtures' ops
_jappend = jax.jit(jt.warm_append)
_jrebuild = jax.jit(jt.warm_rebuild, static_argnames=("iters", "seed"))
_jinsert = jax.jit(jt.ensemble_hot_insert_batch)
_jappend_s = jax.jit(jt.warm_append_sharded)
_jrebuild_s = jax.jit(jt.warm_rebuild_sharded,
                      static_argnames=("iters", "seed"))
CONFIGS = ((False, False), (True, False), (False, True), (True, True))


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _hot(rng, Nh=40, D=16, n_tenants=3):
    return jt.init_hot(Nh, D)._replace(
        keys=jnp.asarray(_unit(rng.standard_normal((Nh, D))), jnp.float32),
        valid=jnp.asarray(rng.random(Nh) > 0.3),
        tenants=jnp.asarray(rng.integers(0, n_tenants, Nh), jnp.int32),
        value_ids=jnp.asarray(rng.integers(0, 1000, Nh), jnp.int32),
        expires_at=jnp.asarray(np.where(rng.random(Nh) < 0.3,
                                        rng.uniform(1, 9, Nh), np.inf),
                               jnp.float32))


def _warm_shard(rng, cap, D, K, bucket, n_tenants=3, unindexed=6,
                vid_base=1000):
    """The reference fixture (`test_sharded_cascade._warm_shard`), with
    finite TTL deadlines on some rows."""
    wk = jnp.asarray(_unit(rng.standard_normal((cap, D))), jnp.float32)
    wv = jnp.asarray(rng.random(cap) > 0.2)
    cent = _jkmeans(wk, wv, K, 4, 0)
    members, sizes = _jlists(wk, wv, cent, bucket)
    w = jt.init_warm(cap, D, K, bucket)._replace(
        keys=wk, valid=wv,
        tenants=jnp.asarray(rng.integers(0, n_tenants, cap), jnp.int32),
        value_ids=jnp.asarray(vid_base + rng.permutation(1000)[:cap],
                              jnp.int32),
        write_seq=jnp.asarray(rng.permutation(cap) + 1, jnp.int32),
        cursor=jnp.asarray(int(rng.integers(0, cap)), jnp.int32),
        total=jnp.asarray(cap, jnp.int32), centroids=cent, members=members,
        sizes=sizes, indexed_total=jnp.asarray(cap - unindexed, jnp.int32),
        expires_at=jnp.asarray(np.where(rng.random(cap) < 0.3,
                                        rng.uniform(1, 9, cap), np.inf),
                               jnp.float32))
    return jt.requantize(w)


def _swarm(rng, S, cap=32, D=16, K=4, bucket=8):
    return jt.stack_warm([_warm_shard(rng, cap, D, K, bucket,
                                      vid_base=1000 + 1000 * s)
                          for s in range(S)])


def _queries(rng, n_q, D, n_tenants=3):
    q = jnp.asarray(_unit(rng.standard_normal((n_q, D))), jnp.float32)
    qt = jnp.asarray(rng.integers(0, n_tenants, n_q), jnp.int32)
    thr = jnp.asarray(rng.uniform(0.2, 0.9, n_q), jnp.float32)
    return q, qt, thr


def _port(cls, state):
    return cls(**{f: torch.as_tensor(np.array(getattr(state, f)))
                  for f in cls._fields})


def _t(*xs):
    return tuple(torch.as_tensor(np.array(x)) for x in xs)


def _close(ref: dict, port: dict, what=""):
    """Float leaves within SCORE_ATOL, int8 within one code, the rest
    exactly (float scales within 2 ulps)."""
    for name, a in ref.items():
        a, b = np.asarray(a), np.asarray(port[name])
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if name in ("scales", "warm_scales"):
            np.testing.assert_allclose(b, a, rtol=3e-7, atol=0,
                                       err_msg=f"{what}{name}")
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=SCORE_ATOL,
                                       err_msg=f"{what}{name}")
        elif a.dtype == np.int8:
            assert np.abs(b.astype(int) - a).max() <= 1, (what, name)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype),
                                          err_msg=f"{what}{name}")


# ---------------------------------------------------------------------------
# the stacked oracle against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused,quantized", CONFIGS)
def test_stacked_oracle_one_shard_is_the_plain_cascade(fused, quantized):
    """One shard IS the single-device cascade: the stacked schedule at
    S=1 equals the plain path (and the reference's)."""
    rng = np.random.default_rng(0)
    hot = _hot(rng)
    warm = _warm_shard(rng, 64, 16, 8, 16)
    q, qt, thr = _queries(rng, 9, 16)
    kw = dict(k=2, n_probe=4, tail=10, fused=fused, quantized=quantized)
    ref = _jcascade(hot, warm, q, qt, thr, **kw)
    hp, wp = _port(pt.HotState, hot), _port(pt.WarmState, warm)
    plain = pt.cascade_query(hp, wp, *_t(q, qt, thr), **kw)
    stacked = pt.cascade_query(
        hp, pt.WarmState(*(x[None] for x in wp)), *_t(q, qt, thr), **kw)
    _close(numpy_of(ref), numpy_of(stacked), "stacked vs reference ")
    _close(numpy_of(plain), numpy_of(stacked), "stacked vs plain ")


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("fused,quantized", CONFIGS)
def test_stacked_oracle_matches_reference(S, fused, quantized):
    """Partial probes, per-shard tail windows, invalid slots and mixed
    tenants through the reference's `_cascade_sharded_oracle` and the
    port's."""
    rng = np.random.default_rng(S)
    hot, swarm = _hot(rng), _swarm(rng, S)
    q, qt, thr = _queries(rng, 9, 16)
    kw = dict(k=2, n_probe=2, tail=5, fused=fused, quantized=quantized)
    ref = _jcascade(hot, swarm, q, qt, thr, **kw)
    got = pt.cascade_query(_port(pt.HotState, hot),
                           _port(pt.WarmState, swarm), *_t(q, qt, thr), **kw)
    _close(numpy_of(ref), numpy_of(got))
    assert np.asarray(ref.hit).any() and not np.asarray(ref.hit).all()


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_full_probe_equals_unsharded(S):
    """The acceptance parity of the reference: the fused sharded cascade
    reproduces the single-tier four-op path when both sides probe all
    their clusters over the same rows (contiguous blocks per shard,
    everything indexed)."""
    rng = np.random.default_rng(10 + S)
    D, cap, k = 16, 32, 2
    hot = _hot(rng, D=D)
    keys = _unit(rng.standard_normal((S * cap, D))).astype(np.float32)
    valid = rng.random(S * cap) > 0.2
    tenants = rng.integers(0, 3, S * cap).astype(np.int32)
    vids = np.arange(1000, 1000 + S * cap, dtype=np.int32)

    def warm(sl, K, seed):
        n = sl.stop - sl.start
        wk, wv = jnp.asarray(keys[sl]), jnp.asarray(valid[sl])
        cent = _jkmeans(wk, wv, K, 4, seed)
        members, sizes = _jlists(wk, wv, cent, n)
        return jt.requantize(jt.init_warm(n, D, K, n)._replace(
            keys=wk, valid=wv, tenants=jnp.asarray(tenants[sl]),
            value_ids=jnp.asarray(vids[sl]),
            write_seq=jnp.arange(1, n + 1, dtype=jnp.int32),
            cursor=jnp.zeros((), jnp.int32), total=jnp.asarray(n, jnp.int32),
            centroids=cent, members=members, sizes=sizes,
            indexed_total=jnp.asarray(n, jnp.int32)))

    q, qt, thr = _queries(rng, 16, D)
    single = _jcascade(hot, warm(slice(0, S * cap), 8, 0), q, qt, thr, k=k,
                       n_probe=8, tail=0)
    swarm = jt.stack_warm([warm(slice(s * cap, (s + 1) * cap), 2, s)
                           for s in range(S)])
    got = pt.cascade_query(_port(pt.HotState, hot),
                           _port(pt.WarmState, swarm), *_t(q, qt, thr), k=k,
                           n_probe=2, tail=0, fused=True)
    _close(numpy_of(single), numpy_of(got))


def test_sharded_mutations_match_reference():
    """Round-robin append (row j to shard j % S, evictions in shard-major
    order), the per-shard rebuild (each shard's k-means seed row from
    the reference's own draw), and the elementwise ops over the shard
    axis: requantize, the index publish, the re-embedded key publish,
    tenant eviction, the TTL mask and reap."""
    rng = np.random.default_rng(5)
    S, m = 2, 12
    hot, swarm = _hot(rng), _swarm(rng, S)
    dem = jt.Demoted(
        keys=jnp.asarray(rng.standard_normal((m, 16)), jnp.float32),
        value_ids=jnp.asarray(5000 + np.arange(m), jnp.int32),
        tenants=jnp.asarray(rng.integers(0, 3, m), jnp.int32),
        mask=jnp.asarray(np.arange(m) < 9),
        expires=jnp.asarray(rng.uniform(1, 20, m), jnp.float32))
    ja, ev_a = _jappend_s(swarm, dem)
    hp, wp = _port(pt.HotState, hot), _port(pt.WarmState, swarm)
    pa, ev_b = pt.warm_append_sharded(
        wp, pt.Demoted(*_t(*dem)))
    np.testing.assert_array_equal(ev_b.numpy(), np.asarray(ev_a))
    _close(numpy_of(ja), numpy_of(pa), "append ")
    with pytest.raises(ValueError, match="divisible"):
        pt.warm_append_sharded(wp, pt.Demoted(*_t(*(x[:5] for x in dem))))

    firsts = []
    for s in range(S):
        p = jnp.asarray(ja.valid[s]).astype(jnp.float32)
        p = jnp.where(p.sum() > 0, p, jnp.ones_like(p))
        firsts.append(int(jax.random.choice(jax.random.PRNGKey(3),
                                            p.shape[0], p=p / p.sum())))
    jr = _jrebuild_s(ja, iters=4, seed=3)
    pr = pt.warm_rebuild_sharded(pa, 4, 3, first=firsts)
    _close(numpy_of(jr), numpy_of(pr), "rebuild ")
    _close(numpy_of(jt.warm_publish_index(ja, jr)),
           numpy_of(pt.warm_publish_index(pa, pr)), "publish index ")

    keys = _unit(rng.standard_normal(tuple(swarm.keys.shape)))
    hkeys = _unit(rng.standard_normal(tuple(hot.keys.shape)))
    jh, jw = jt.publish_reembedded_keys(hot, swarm, jnp.asarray(hkeys),
                                        jnp.asarray(keys))
    ph, pw = pt.publish_reembedded_keys(hp, wp, *_t(hkeys, keys))
    _close(numpy_of(jh), numpy_of(ph), "publish keys hot ")
    _close(numpy_of(jw), numpy_of(pw), "publish keys warm ")
    _close(numpy_of(jt.requantize(jw._replace(keys_q=jw.keys_q * 0))),
           numpy_of(pt.requantize(pw._replace(keys_q=pw.keys_q * 0))),
           "requantize ")

    for now in (4.0, 7.5):
        jh2, jw2, na = jt.mask_expired(hot, swarm, now)
        ph2, pw2, nb = pt.mask_expired(hp, wp, now)
        assert int(na) == int(nb) > 0
        _close(numpy_of(jw2), numpy_of(pw2), "mask ")
    for name, jop, pop, arg in (
            ("evict", jt.evict_tenant, pt.evict_tenant, 1),
            ("reap", jt.reap_expired, pt.reap_expired, 5.0)):
        jh2, jw2, ha, wa = jop(hot, swarm, jnp.asarray(arg))
        ph2, pw2, hb, wb = pop(hp, wp, arg)
        assert wb.shape == (S, swarm.keys.shape[1])
        np.testing.assert_array_equal(wb.numpy(), np.asarray(wa),
                                      err_msg=name)
        np.testing.assert_array_equal(hb.numpy(), np.asarray(ha))
        _close(numpy_of(jw2), numpy_of(pw2), name + " ")
        assert (wb.numpy() >= 0).any()

    init = pt.init_warm_sharded(S, 32, 16, 4, 8)
    _close(numpy_of(jt.init_warm_sharded(S, 32, 16, 4, 8)), numpy_of(init),
           "init ")


# ---------------------------------------------------------------------------
# the sharded ensemble
# ---------------------------------------------------------------------------

E, D = 3, 16
NH, CAP, NK, BUCKET = 24, 64, 4, 20
Q = 11


def _corr_panels(rng, n, e=E, d=D):
    z = rng.normal(size=(n, 8))
    A = rng.normal(size=(e, 8, d))
    out = np.einsum("nz,ezd->ned", z, A) + 0.3 * rng.normal(size=(n, e, d))
    return _unit(out).astype(np.float32)


def _weights(rng, n_q, e=E):
    w = rng.uniform(0.1, 1.0, size=(n_q, e)).astype(np.float32)
    return w / w.sum(1, keepdims=True)


def _ens_fixture(rng, S):
    """The reference's `_tiers_fixture` + `_sharded_fixture`: a populated
    hot tier with aligned panels (insert -> demote -> mirrored append)
    and S warm shards of 48 rows each, rebuilt."""
    hot = jt.init_hot(NH, D)
    ens = jt.init_ensemble(E, hot, jt.init_warm(CAP, D, NK, BUCKET))
    embs = _corr_panels(rng, 40)
    vids = np.arange(40, dtype=np.int32)
    vids[5] = -1
    hot, ens, _ = _jinsert(
        hot, ens, jnp.asarray(embs), jnp.asarray(vids),
        jnp.asarray((np.arange(40) % 3).astype(np.int32)))
    hot, _ = jt.demote_coldest(hot, 8)
    per_warm, per_panels = [], []
    for si in range(S):
        kp = _corr_panels(rng, 48)
        wme, _ = _jappend(jt.init_warm(CAP, D, NK, BUCKET), jt.Demoted(
            keys=jnp.asarray(kp[:, 0]),
            value_ids=jnp.asarray(2000 + 100 * si
                                  + np.arange(48, dtype=np.int32)),
            tenants=jnp.asarray((np.arange(48) % 3).astype(np.int32)),
            mask=jnp.ones(48, bool)))
        pw = jnp.zeros((E, CAP, D), jnp.float32)
        for e in range(E):
            pw = pw.at[e, :48].set(jt._unit(jnp.asarray(kp[:, e])))
        per_panels.append(pw)
        per_warm.append(_jrebuild(wme, iters=4))
    wk = jnp.stack(per_panels)
    q8, sc = jt.quantize_rows(wk)
    return hot, jt.stack_warm(per_warm), jt.EnsembleState(
        hot_keys=ens.hot_keys, warm_keys=wk, warm_keys_q=q8, warm_scales=sc)


def _ens_query(rng):
    return (_corr_panels(rng, Q), _weights(rng, Q),
            (np.arange(Q) % 3).astype(np.int32))


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_ensemble_matches_reference(S, quantized):
    """The reference's `_ensemble_sharded_oracle` and the port's, with
    ``panel_scores`` (the winner's keys gathered across shards)."""
    rng = np.random.default_rng(20 + S)
    hot, swarm, ens = _ens_fixture(rng, S)
    qp, w, qt = _ens_query(rng)
    thr = np.full((Q,), 0.8, np.float32)
    kw = dict(k=2, n_probe=2, tail=8, quantized=quantized)
    ref = _jensemble(hot, swarm, ens, *(jnp.asarray(x)
                                        for x in (qp, w, qt, thr)), **kw)
    for fused in (False, True):
        got = pt.ensemble_cascade_query(
            _port(pt.HotState, hot), _port(pt.WarmState, swarm),
            _port(pt.EnsembleState, ens), *_t(qp, w, qt, thr), fused=fused,
            **kw)
        _close(numpy_of(ref), numpy_of(got), f"fused={fused} ")
    assert (np.asarray(ref.value_ids[:, 0]) >= 0).all()


def test_sharded_ensemble_mutations_match_reference():
    """The panels over a stacked warm tier: `init_ensemble` gives
    (S, E, cap, D), the mirrored round-robin append lands each panel row
    beside its base row, and `publish_panel` swaps one panel on every
    shard."""
    rng = np.random.default_rng(30)
    S, m = 2, 8
    hot, swarm, ens = _ens_fixture(rng, S)
    hp, wp, ep = (_port(pt.HotState, hot), _port(pt.WarmState, swarm),
                  _port(pt.EnsembleState, ens))
    _close(numpy_of(jt.init_ensemble(E, hot, swarm)),
           numpy_of(pt.init_ensemble(E, hp, wp)), "init ")
    pk = _corr_panels(rng, m).transpose(1, 0, 2)             # (E, m, D)
    dem = jt.Demoted(keys=jnp.asarray(pk[0]),
                     value_ids=jnp.asarray(7000 + np.arange(m), jnp.int32),
                     tenants=jnp.zeros(m, jnp.int32),
                     mask=jnp.asarray(np.arange(m) < 7))
    ja = jt.ensemble_warm_append_sharded(ens, swarm, dem, jnp.asarray(pk))
    pa = pt.ensemble_warm_append_sharded(ep, wp, pt.Demoted(*_t(*dem[:4])),
                                         torch.as_tensor(pk))
    _close(numpy_of(ja), numpy_of(pa), "append ")
    new_h = _unit(rng.normal(size=(NH, D))).astype(np.float32)
    new_w = _unit(rng.normal(size=(S, CAP, D))).astype(np.float32)
    _close(numpy_of(jt.publish_panel(ens, 2, jnp.asarray(new_h),
                                     jnp.asarray(new_w))),
           numpy_of(pt.publish_panel(ep, 2, *_t(new_h, new_w))), "publish ")


# ---------------------------------------------------------------------------
# the mesh form: 2 gloo ranks
# ---------------------------------------------------------------------------

def test_mesh_matches_stacked_oracle_and_reference(tmp_path):
    """Each rank's `_cascade_sharded` (fused / four-op x fp32 / int8) and
    `_ensemble_sharded` (fp32 / int8) equal the stacked oracle bit for
    bit (checked on the ranks) and the reference's oracle within the
    score tolerance (here); the sharded mutations on a rank equal its
    slice of the stacked ones, with every rank reporting every shard's
    evictions."""
    rng = np.random.default_rng(40)
    hot, swarm = _hot(rng), _swarm(rng, 2)
    q, qt, thr = _queries(rng, 9, 16)
    ehot, eswarm, ens = _ens_fixture(rng, 2)
    qp, w, eqt = _ens_query(rng)
    m = 8
    dem = dict(keys=rng.standard_normal((m, 16)).astype(np.float32),
               value_ids=(6000 + np.arange(m)).astype(np.int32),
               tenants=rng.integers(0, 3, m).astype(np.int32),
               mask=np.arange(m) < 7,
               expires=rng.uniform(1, 20, m).astype(np.float32))
    payload = dict(
        hot=numpy_of(hot), swarm=numpy_of(swarm), q=np.asarray(q),
        qt=np.asarray(qt), thr=np.asarray(thr), configs=CONFIGS,
        ens=numpy_of(ens), ens_hot=numpy_of(ehot),
        ens_swarm=numpy_of(eswarm), qp=qp, w=w, eqt=eqt, dem=dem,
        panel_keys=_corr_panels(rng, m).transpose(1, 0, 2).copy(), now=5.0)
    ranks = spawn(2, sharded_tiers_ranks, (payload,), tmp_path)
    for fused, quant in CONFIGS:
        ref = numpy_of(_jcascade(hot, swarm, q, qt, thr, k=2, n_probe=2,
                                 tail=5, fused=fused, quantized=quant))
        for r in ranks:
            _close(ref, r[("cascade", fused, quant)],
                   f"cascade fused={fused} int8={quant} ")
    ethr = jnp.full((Q,), 0.8, jnp.float32)
    for quant in (False, True):
        ref = numpy_of(_jensemble(ehot, eswarm, ens, jnp.asarray(qp),
                                  jnp.asarray(w), jnp.asarray(eqt), ethr,
                                  k=2, n_probe=2, tail=8, quantized=quant))
        for r in ranks:
            _close(ref, r[("ensemble", quant)], f"ensemble int8={quant} ")
    jdem = jt.Demoted(**{f: jnp.asarray(v) for f, v in dem.items()})
    _, ev = _jappend_s(swarm, jdem)
    ev_evict = jt.evict_tenant(hot, swarm, jnp.asarray(1))[3]
    ev_reap = jt.reap_expired(hot, swarm, 5.0)[3]
    for r in ranks:
        np.testing.assert_array_equal(r["evicted_append"], np.asarray(ev))
        np.testing.assert_array_equal(r["evict"], np.asarray(ev_evict))
        np.testing.assert_array_equal(r["reap"], np.asarray(ev_reap))
