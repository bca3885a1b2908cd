"""Port parity for the fused cascade lookup: the port's plain torch
version (`repro_torch.kernels.cascade_lookup.ref`, what the wrapper runs
for CPU tensors) against the reference's jnp oracle on the fixtures of
`tests/test_cascade_kernel.py` — random tier states, an empty warm
tier, all-invalid tiers — fp32 and int8, k in {1, 4}, a ring whose
cursor sits below the tail window, and the tie-order traps; plus one
small case through the reference's Pallas kernel in interpret mode, and
the tiers-level ``cascade_query`` on both sides.

Inputs are numpy from a seed.  Tolerances: scores ``atol 1e-5`` (the
reference's own kernel and oracle differ by ~1 float32 ulp); ids, slots
and flags exactly (random unit keys keep top-k gaps far above 1e-4; the
tie fixtures use dyadic keys whose scores are exact in any order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_service import tiers as jtiers
from repro.core import ivf as jivf
from repro.kernels.cascade_lookup import ops as jops
from repro.kernels.cascade_lookup import ref as jref
from repro_torch.cache_service import tiers
from repro_torch.kernels.cascade_lookup import kernel as pkernel
from repro_torch.kernels.cascade_lookup import ops as pops

SCORE_ATOL = 1e-5
NAMES = ("scores", "value_ids", "warm_slots", "hot_slots", "hot_hit", "hit")
# jitted once per shape: eager JAX compiles every primitive separately
_jref = jax.jit(jref.cascade_lookup,
                static_argnames=("k", "n_probe", "tail", "quantized"))
_jkmeans = jax.jit(jivf.kmeans, static_argnums=(2, 3, 4))
_jlists = jax.jit(jivf.build_lists, static_argnums=(3,))


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _random_states(rng, Nh=50, Nw=128, D=16, K=8, bucket=16, n_tenants=3,
                   unindexed=20, cursor=None):
    """The reference fixture (`test_cascade_kernel._random_states`) over
    numpy inputs: random invalid slots, mixed tenants, a window of
    `unindexed` rows written after the last rebuild."""
    hot = jtiers.init_hot(Nh, D)._replace(
        keys=jnp.asarray(_unit(rng.standard_normal((Nh, D))), jnp.float32),
        valid=jnp.asarray(rng.random(Nh) > 0.3),
        tenants=jnp.asarray(rng.integers(0, n_tenants, Nh), jnp.int32),
        value_ids=jnp.asarray(rng.integers(0, 1000, Nh), jnp.int32))
    wk = jnp.asarray(_unit(rng.standard_normal((Nw, D))), jnp.float32)
    wv = jnp.asarray(rng.random(Nw) > 0.2)
    cent = _jkmeans(wk, wv, K, 4, 0)
    members, sizes = _jlists(wk, wv, cent, bucket)
    cur = int(rng.integers(0, Nw)) if cursor is None else cursor
    warm = jtiers.init_warm(Nw, D, K, bucket)._replace(
        keys=wk, valid=wv,
        tenants=jnp.asarray(rng.integers(0, n_tenants, Nw), jnp.int32),
        value_ids=jnp.asarray(rng.integers(1000, 2000, Nw), jnp.int32),
        write_seq=jnp.asarray(rng.permutation(Nw) + 1, jnp.int32),
        cursor=jnp.asarray(cur, jnp.int32), total=jnp.asarray(Nw, jnp.int32),
        centroids=cent, members=members, sizes=sizes,
        indexed_total=jnp.asarray(Nw - unindexed, jnp.int32))
    return hot, jtiers.requantize(warm)


def _queries(rng, n_q, D, n_tenants=3):
    return (_unit(rng.standard_normal((n_q, D))).astype(np.float32),
            rng.integers(0, n_tenants, n_q).astype(np.int32),
            rng.uniform(0.2, 0.9, n_q).astype(np.float32))


def _flat(hot, warm):
    return (hot.keys, hot.valid, hot.tenants, hot.value_ids,
            warm.keys, warm.valid, warm.tenants, warm.value_ids,
            warm.write_seq, warm.centroids, warm.members, warm.cursor,
            warm.indexed_total, warm.keys_q, warm.scales)


def _both(hot, warm, q, qt, thr, **kw):
    """(reference oracle, port plain version) on the same inputs."""
    a = _jref(jnp.asarray(q), jnp.asarray(qt), jnp.asarray(thr),
              *_flat(hot, warm), **kw)
    ph = tiers.hot_from_reference(hot)
    pw = tiers.warm_from_reference(warm)
    b = pops.cascade_lookup(torch.as_tensor(q), torch.as_tensor(qt),
                            torch.as_tensor(thr), *_flat(ph, pw), **kw)
    return a, b


def _assert_match(a, b):
    for name, x, y in zip(NAMES, a, b):
        x, y = np.asarray(x), y.numpy()
        assert x.shape == y.shape, name
        if name == "scores":
            np.testing.assert_allclose(y, x, rtol=0, atol=SCORE_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(y, x.astype(y.dtype), err_msg=name)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k,n_probe,tail", [
    (1, 2, 0), (1, 4, 10), (4, 4, 10), (4, 8, 5), (1, 8, 24)])
def test_plain_cascade_matches_reference_oracle(k, n_probe, tail,
                                                quantized):
    rng = np.random.default_rng(7 + k + n_probe + tail)
    hot, warm = _random_states(rng)
    q, qt, thr = _queries(rng, 9, 16)
    a, b = _both(hot, warm, q, qt, thr, k=k, n_probe=n_probe, tail=tail,
                 quantized=quantized)
    _assert_match(a, b)
    assert np.asarray(a[5]).any() or k == 4     # some rows hit


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_ring_cursor_below_tail(k, quantized):
    """cursor < tail: the tail window wraps past slot 0 to the ring's
    end — a floor-mod in the reference, not C's truncating %."""
    rng = np.random.default_rng(11)
    hot, warm = _random_states(rng, Nw=64, K=4, unindexed=12, cursor=3)
    # the 12 newest writes end just before the cursor: slots 2,1,0,63,...
    seq = np.asarray(warm.write_seq).copy()
    order = [(3 - 1 - i) % 64 for i in range(64)]
    for age, slot in enumerate(order):
        seq[slot] = 64 - age
    warm = warm._replace(write_seq=jnp.asarray(seq, jnp.int32),
                         indexed_total=jnp.asarray(52, jnp.int32))
    q, qt, thr = _queries(rng, 8, 16)
    # queries close to wrapped tail rows, so the tail actually serves
    q[:4] = _unit(np.asarray(warm.keys)[[1, 63, 60, 55]]
                  + 0.05 * rng.standard_normal((4, 16))).astype(np.float32)
    qt[:4] = np.asarray(warm.tenants)[[1, 63, 60, 55]]
    a, b = _both(hot, warm, q, qt, thr, k=k, n_probe=2, tail=16,
                 quantized=quantized)
    _assert_match(a, b)
    wslots = np.asarray(a[2])
    assert np.isin(wslots, [63, 60, 55]).any()


def test_empty_warm_tier():
    """Fresh service: zero centroids, every inverted list empty."""
    rng = np.random.default_rng(3)
    hot, _ = _random_states(rng)
    warm = jtiers.init_warm(64, 16, 4, 8)
    q, qt, thr = _queries(rng, 5, 16)
    for k in (1, 2):
        _assert_match(*_both(hot, warm, q, qt, thr, k=k, n_probe=4,
                             tail=4))


def test_all_invalid_never_hits():
    rng = np.random.default_rng(4)
    hot = jtiers.init_hot(32, 16)
    warm = jtiers.init_warm(64, 16, 4, 8)
    q, qt, _ = _queries(rng, 4, 16)
    thr = np.zeros(4, np.float32)
    a, b = _both(hot, warm, q, qt, thr, k=4, n_probe=2, tail=4)
    _assert_match(a, b)
    s, vids, wslots, hslots, hot_hit, hit = b
    assert float(s.max()) < -1e20 and not hit.any() and not hot_hit.any()
    assert int(vids.max()) == -1 and int(wslots.max()) == -1
    assert (hslots == 0).all()          # lowest index among masked rows


def test_tie_order_traps():
    """Dyadic keys make scores exact in any summation order, so ties are
    real: lowest hot row first, lowest flat warm position first, hot
    before warm in the merge; a query with no live hot row reports hot
    slot 0."""
    D = 8
    e = np.zeros(D, np.float32)
    a_key = e.copy(); a_key[:4] = 0.5                   # score 1.0
    b_key = e.copy(); b_key[:3] = 0.5; b_key[3] = -0.5  # score 0.5
    hot = jtiers.init_hot(8, D)
    hk = np.stack([b_key, a_key, b_key, a_key, a_key, e, e, e])
    hot = hot._replace(keys=jnp.asarray(hk),
                       valid=jnp.asarray([1, 1, 1, 1, 0, 0, 0, 0], bool),
                       tenants=jnp.asarray([0, 0, 0, 0, 0, 0, 0, 0],
                                           jnp.int32),
                       value_ids=jnp.arange(8, dtype=jnp.int32))
    cap, K, bucket = 16, 2, 8
    wk = np.stack([a_key if i % 3 == 0 else b_key for i in range(cap)])
    members = np.full((K, bucket), -1, np.int32)
    members[0, :4] = [9, 3, 6, 0]
    members[1, :3] = [12, 1, 4]
    cent = np.stack([a_key, b_key])
    warm = jtiers.init_warm(cap, D, K, bucket)._replace(
        keys=jnp.asarray(wk), valid=jnp.ones(cap, bool),
        tenants=jnp.zeros(cap, jnp.int32),
        value_ids=jnp.arange(100, 100 + cap, dtype=jnp.int32),
        write_seq=jnp.arange(1, cap + 1, dtype=jnp.int32),
        cursor=jnp.asarray(0, jnp.int32), total=jnp.asarray(cap, jnp.int32),
        centroids=jnp.asarray(cent), members=jnp.asarray(members),
        indexed_total=jnp.asarray(cap - 3, jnp.int32))
    warm = jtiers.requantize(warm)
    q = np.stack([a_key, a_key]).astype(np.float32)
    qt = np.asarray([0, 1], np.int32)         # tenant 1 has no hot rows
    thr = np.asarray([0.9, 0.9], np.float32)
    for quantized in (False, True):
        a, b = _both(hot, warm, q, qt, thr, k=4, n_probe=2, tail=3,
                     quantized=quantized)
        _assert_match(a, b)
    s, vids, wslots, hslots, hot_hit, hit = (x.numpy() for x in b)
    # row 0: hot rows 1 and 3 tie at 1.0 and precede warm 9, 3
    assert vids[0].tolist() == [1, 3, 109, 103]
    assert wslots[0].tolist() == [-1, -1, 9, 3]
    assert hot_hit[0] and hslots[0] == 1
    # row 1: no live hot row for tenant 1 -> hot slot 0, warm empty too
    assert hslots[1] == 0 and not hit[1] and vids[1].max() == -1


def test_plain_cascade_matches_reference_kernel_interpret():
    """One small case through the reference's Pallas kernel (interpret
    mode): the port's plain version agrees with it too."""
    rng = np.random.default_rng(5)
    hot, warm = _random_states(rng, Nh=24, Nw=48, K=4, bucket=16,
                               unindexed=8)
    q, qt, thr = _queries(rng, 4, 16)
    kw = dict(k=2, n_probe=2, tail=8)
    a = jops.cascade_lookup(jnp.asarray(q), jnp.asarray(qt),
                            jnp.asarray(thr), *_flat(hot, warm)[:13],
                            use_kernel=True, **kw)
    ph, pw = tiers.hot_from_reference(hot), tiers.warm_from_reference(warm)
    b = pops.cascade_lookup(torch.as_tensor(q), torch.as_tensor(qt),
                            torch.as_tensor(thr), *_flat(ph, pw), **kw)
    _assert_match(a, b)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_cascade_query_matches_reference(fused, quantized):
    """tiers-level: the port's cascade_query (four-op or fused, fp32 or
    int8 with the exact re-score) against the reference's."""
    rng = np.random.default_rng(9)
    hot, warm = _random_states(rng)
    q, qt, thr = _queries(rng, 12, 16)
    kw = dict(k=2, n_probe=4, tail=10, fused=fused, quantized=quantized)
    a = jtiers.cascade_query(hot, warm, jnp.asarray(q), jnp.asarray(qt),
                             jnp.asarray(thr), **kw)
    b = tiers.cascade_query(tiers.hot_from_reference(hot),
                            tiers.warm_from_reference(warm),
                            torch.as_tensor(q), torch.as_tensor(qt),
                            torch.as_tensor(thr), **kw)
    for name in jtiers.CascadeResult._fields:
        x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
        if name == "scores":
            np.testing.assert_allclose(y, x, rtol=0, atol=SCORE_ATOL)
        else:
            np.testing.assert_array_equal(y, x.astype(y.dtype),
                                          err_msg=name)


def test_wrapper_never_falls_back():
    """A tensor on neither the CPU nor a card is refused, and the
    wrapper does not count a launch it did not make."""
    rng = np.random.default_rng(1)
    hot, warm = _random_states(rng)
    q, qt, thr = _queries(rng, 3, 16)
    ph, pw = tiers.hot_from_reference(hot), tiers.warm_from_reference(warm)
    before = pkernel.COUNTS["cascade_lookup"]
    meta = [t.to("meta") for t in _flat(ph, pw)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        pops.cascade_lookup(torch.as_tensor(q).to("meta"),
                            torch.as_tensor(qt).to("meta"),
                            torch.as_tensor(thr).to("meta"), *meta, k=1)
    # the CPU path is the plain version and launches nothing
    pops.cascade_lookup(torch.as_tensor(q), torch.as_tensor(qt),
                        torch.as_tensor(thr), *_flat(ph, pw), k=1)
    assert pkernel.COUNTS["cascade_lookup"] == before
