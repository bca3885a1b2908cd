"""Port parity for the IVF build and the tier mutations: the same numpy
inputs through the reference's functions and the port's, with the whole
tier state compared after every call.

The reference's k-means draws its first seed with ``jax.random.choice``,
which torch cannot reproduce; the port takes that index as ``first=``
(and otherwise draws it from numpy), so each test hands both sides the
reference's index.  Tolerances: centroids and keys ``atol 1e-5`` (float32
sums in another order); ids, lists, slots, clocks, ring counters and
masks exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_service import tiers as jt
from repro.core import ivf as jivf
from repro_torch.cache_service import tiers as pt
from repro_torch.core import ivf as pivf

ATOL = 1e-5
_jinsert = jax.jit(jt.hot_insert_batch)
_jappend = jax.jit(jt.warm_append)
_jrebuild = jax.jit(jt.warm_rebuild, static_argnums=(1, 2))
_jdemote = jax.jit(jt.demote_coldest, static_argnums=(1,))
_jtouch = jax.jit(jt.hot_touch)


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _first(valid, seed):
    """The reference kmeans' first seed row (its own draw)."""
    p = jnp.asarray(valid).astype(jnp.float32)
    p = jnp.where(p.sum() > 0, p, jnp.ones_like(p))
    return int(jax.random.choice(jax.random.PRNGKey(seed), p.shape[0],
                                 p=p / p.sum()))


def _assert_state(js, ps):
    for name in type(ps)._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ps, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def _rows(rng, n, d, k=6):
    """Clustered unit rows (k centres), so k-means has structure."""
    cen = _unit(rng.standard_normal((k, d)))
    return _unit(cen[rng.integers(k, size=n)]
                 + 0.2 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("valid_frac", [0.7, 0.0])
def test_kmeans_and_lists_match_reference(valid_frac):
    rng = np.random.default_rng(0)
    keys = _rows(rng, 200, 16)
    valid = rng.random(200) < valid_frac
    first = _first(valid, 3)
    ca = jivf.kmeans(jnp.asarray(keys), jnp.asarray(valid), 8, 4, 3)
    cb = pivf.kmeans(torch.as_tensor(keys), torch.as_tensor(valid), 8, 4, 3,
                     first=first)
    np.testing.assert_allclose(cb.numpy(), np.asarray(ca), rtol=0,
                               atol=ATOL)
    for bucket in (8, 64):                    # overflow dropped / all fit
        ma, sa = jivf.build_lists(jnp.asarray(keys), jnp.asarray(valid), ca,
                                  bucket)
        mb, sb = pivf.build_lists(torch.as_tensor(keys),
                                  torch.as_tensor(valid),
                                  torch.as_tensor(np.array(ca)), bucket)
        np.testing.assert_array_equal(mb.numpy(), np.asarray(ma))
        np.testing.assert_array_equal(sb.numpy(), np.asarray(sa))
    ia = jivf.build_ivf(jnp.asarray(keys), jnp.asarray(valid),
                        jnp.arange(200), n_clusters=8, bucket=32,
                        kmeans_iters=4, seed=3)
    ib = pivf.build_ivf(torch.as_tensor(keys), torch.as_tensor(valid),
                        torch.arange(200), n_clusters=8, bucket=32,
                        kmeans_iters=4, seed=3, first=first)
    _assert_state(ia, ib)


def test_numpy_first_seed_picks_a_valid_row():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 40]] = True
    picks = {pivf.first_seed(valid, s) for s in range(20)}
    assert picks <= {3, 17, 40} and len(picks) > 1
    assert pivf.first_seed(valid, 5) == pivf.first_seed(valid, 5)


def test_hot_insert_touch_demote_match_reference():
    """Sequential insert semantics (free slots first, then LRU with
    insertion-order ties), admission skips, overwrite reports, batches
    larger than the tier, LRU touch and coldest-first demotion."""
    rng = np.random.default_rng(1)
    cap, d = 16, 8
    js, ps = jt.init_hot(cap, d), pt.init_hot(cap, d)
    vid = 0
    for step, m in enumerate((5, 9, 7, 20, 3)):
        embs = rng.standard_normal((m, d)).astype(np.float32)
        vids = np.arange(vid, vid + m, dtype=np.int32)
        vids[rng.random(m) < 0.2] = -1        # admission skips
        vid += m
        ten = rng.integers(0, 3, m).astype(np.int32)
        exp = np.where(rng.random(m) < 0.5, np.inf,
                       rng.uniform(1, 9, m)).astype(np.float32)
        js, ea = _jinsert(js, jnp.asarray(embs), jnp.asarray(vids),
                          jnp.asarray(ten), jnp.asarray(exp))
        ps, eb = pt.hot_insert_batch(ps, torch.as_tensor(embs),
                                     torch.as_tensor(vids),
                                     torch.as_tensor(ten),
                                     torch.as_tensor(exp))
        np.testing.assert_array_equal(eb.numpy(), np.asarray(ea))
        _assert_state(js, ps)
        slots = rng.integers(0, cap, 6).astype(np.int32)
        hit = rng.random(6) < 0.6
        js = _jtouch(js, jnp.asarray(slots), jnp.asarray(hit))
        ps = pt.hot_touch(ps, torch.as_tensor(slots), torch.as_tensor(hit))
        _assert_state(js, ps)
        if step % 2:
            js, da = _jdemote(js, 5)
            ps, db = pt.demote_coldest(ps, 5)
            _assert_state(js, ps)
            _assert_state(da, db)
    js, ea = jt.hot_insert(js, jnp.ones(d), jnp.asarray(99), jnp.asarray(2))
    ps, eb = pt.hot_insert(ps, torch.ones(d), 99, 2)
    assert int(eb) == int(ea)
    _assert_state(js, ps)


def test_warm_append_rebuild_match_reference():
    """Ring appends (padding rows, wrap-around with overwrite reports,
    int8 panel and TTL column kept in step), an inline rebuild, and the
    tier-wide masks: evict_tenant, mask_expired, reap_expired."""
    rng = np.random.default_rng(2)
    cap, d, K, bucket = 48, 16, 4, 24
    js, ps = jt.init_warm(cap, d, K, bucket), pt.init_warm(cap, d, K, bucket)
    vid = 0
    for step in range(9):
        m = 10
        mask = np.ones(m, bool)
        mask[7 + step % 3:] = False           # True-prefix, as demotions
        dem = dict(keys=_rows(rng, m, d), value_ids=np.arange(
            vid, vid + m, dtype=np.int32), tenants=rng.integers(
            0, 3, m).astype(np.int32), mask=mask,
            expires=rng.uniform(1, 9, m).astype(np.float32))
        vid += m
        js, ea = _jappend(js, jt.Demoted(**{k: jnp.asarray(v)
                                            for k, v in dem.items()}))
        ps, eb = pt.warm_append(ps, pt.Demoted(**{k: torch.as_tensor(v)
                                                  for k, v in dem.items()}))
        np.testing.assert_array_equal(eb.numpy(), np.asarray(ea))
        _assert_state(js, ps)
        if step % 4 == 3:
            first = _first(np.asarray(js.valid), 0)
            js = _jrebuild(js, 4, 0)
            ps = pt.warm_rebuild(ps, 4, 0, first=first)
            _assert_state(js, ps)
    assert int(ps.total) > cap                # the ring wrapped
    hot_j, hot_p = jt.init_hot(8, d), pt.init_hot(8, d)
    for now in (3.0, 6.5):
        hj, wj, na = jt.mask_expired(hot_j, js, now)
        hp, wp, nb = pt.mask_expired(hot_p, ps, now)
        assert int(na) == int(nb)
        _assert_state(wj, wp)
    _assert_state(js, ps)                     # masking left state as is
    hj, wj, ha, wa = jt.reap_expired(hot_j, js, 5.0)
    hp, wp, hb, wb = pt.reap_expired(hot_p, ps, 5.0)
    np.testing.assert_array_equal(wb.numpy(), np.asarray(wa))
    _assert_state(wj, wp)
    hj, wj, ha, wa = jt.evict_tenant(hj, wj, jnp.asarray(1, jnp.int32))
    hp, wp, hb, wb = pt.evict_tenant(hp, wp, 1)
    np.testing.assert_array_equal(wb.numpy(), np.asarray(wa))
    _assert_state(wj, wp)


def test_quantize_rows_matches_reference():
    rng = np.random.default_rng(3)
    x = _rows(rng, 64, 32)
    x[0] = 0.0                                # all-zero row: floor scale
    qa, sa = jt.quantize_rows(jnp.asarray(x))
    qb, sb = pt.quantize_rows(torch.as_tensor(x))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(qa))
    np.testing.assert_allclose(sb.numpy(), np.asarray(sa), rtol=1e-6)
