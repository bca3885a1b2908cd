"""Port parity for the shared distributed top-k schedule
(`core/distrib.py`), `store.query_sharded`, `data.shard_batch` and the
mesh builders (`launch/mesh.py`), on the CPU.

The merge helpers are held to the reference's `merge_stacked_topk` on
the tie-heavy, duplicate-value-id candidates of
`tests/test_sharded_cascade.py` (the deterministic grid it falls back
to without hypothesis), exactly; `merge_local_topk` runs on 4 gloo
ranks (W = 4 over the world, W = 2 over the ``model`` groups of a
(2, 2) mesh) and must equal the stacked form bit for bit.
`query_sharded` mirrors `tests/test_perf_levers.py`: scores ``atol
1e-5`` against the reference's (float32 sums in another order), value
ids, slots and hits exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import distrib as jdistrib
from repro.core import store as jstore
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch.core import distrib
from repro_torch.core import store
from repro_torch.launch import mesh as pmesh
from test_torch_ranks import distrib_ranks, one_rank_mesh, spawn

# (S, Q, k, seed): the reference's fallback grid
MERGE_CASES = [(1, 1, 1, 0), (2, 3, 2, 1), (3, 5, 3, 2), (8, 2, 4, 3),
               (4, 7, 2, 4), (5, 4, 1, 5)]


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _tied_candidates(S, Q, k, seed):
    """The reference's fixture: scores on a coarse grid (ties within and
    across shards), value ids from a pool smaller than the candidates
    (duplicates across shards), and each candidate's shard."""
    r = np.random.default_rng(seed)
    s = r.integers(0, 4, (S, Q, k)).astype(np.float32) / 2.0
    vids = r.integers(0, max(2, S * k // 2), (S, Q, k)).astype(np.int32)
    shard = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None, None],
                            (S, Q, k)).copy()
    return s, vids, shard


def _reference_merge(k, *xs):
    return [np.asarray(x) for x in jdistrib.merge_stacked_topk(
        k, *(jnp.asarray(x) for x in xs))]


@pytest.mark.parametrize("S,Q,k,seed", MERGE_CASES)
def test_merge_stacked_topk_matches_reference(S, Q, k, seed):
    """Winners, ties and every payload column equal the reference's: the
    first k of a stable descending sort over the shard-major concat."""
    s, vids, shard = _tied_candidates(S, Q, k, seed)
    got = [x.numpy() for x in distrib.merge_stacked_topk(
        k, *(torch.as_tensor(x) for x in (s, vids, shard)))]
    for a, b in zip(_reference_merge(k, s, vids, shard), got):
        np.testing.assert_array_equal(b, a)
    flat_s = np.moveaxis(s, 0, 1).reshape(Q, S * k)
    flat_v = np.moveaxis(vids, 0, 1).reshape(Q, S * k)
    for row in range(Q):
        order = np.argsort(-flat_s[row], kind="stable")[:k]
        np.testing.assert_array_equal(got[0][row], flat_s[row][order])
        np.testing.assert_array_equal(got[1][row], flat_v[row][order])


def test_merge_ties_resolve_to_earliest_shard():
    S, Q, k = 3, 2, 2
    pay = torch.arange(S * Q * k, dtype=torch.int32).reshape(S, Q, k)
    sm, pm = distrib.merge_stacked_topk(k, torch.ones(S, Q, k), pay)
    assert torch.equal(pm, pay[0]) and float(sm.min()) == 1.0


def _store(rng, cap=128, n=50, d=16):
    st = jstore.insert_batch(jstore.init_store(capacity=cap, dim=d),
                             jnp.asarray(_unit(rng.standard_normal((n, d))),
                                         jnp.float32), jnp.arange(n))
    q = _unit(rng.standard_normal((8, d))).astype(np.float32)
    return st, q


def _port_store(st):
    return store.StoreState(**{f: torch.as_tensor(np.array(getattr(st, f)))
                               for f in store.StoreState._fields})


def _assert_query(ref, got: dict):
    np.testing.assert_allclose(got["scores"], np.asarray(ref.scores),
                               rtol=0, atol=1e-5)
    for f in ("slots", "value_ids", "hit"):
        np.testing.assert_array_equal(
            got[f], np.asarray(getattr(ref, f)).astype(got[f].dtype),
            err_msg=f)


def test_query_sharded_matches_reference():
    """On a one-rank mesh, as the reference's own test on one device: the
    sharded lookup equals the reference's `query_sharded` and `query`."""
    rng = np.random.default_rng(11)
    st, q = _store(rng)
    jmesh = jmake_host_mesh(1, 1)
    with jmesh:
        ref = jax.jit(lambda s, qq: jstore.query_sharded(
            s, qq, threshold=0.8, k=2, mesh=jmesh))(st, jnp.asarray(q))
    plain = jstore.query(st, jnp.asarray(q), threshold=0.8, k=2)
    with one_rank_mesh() as mesh:
        res = store.query_sharded(_port_store(st), torch.as_tensor(q), 0.8,
                                  2, mesh)
    got = {f: getattr(res, f).numpy() for f in res._fields}
    _assert_query(ref, got)
    _assert_query(plain, got)


def test_mesh_builders_clamp_and_refuse():
    """Each axis clamps to the world size (the reference clamps to the
    device count); the production layout needs 256 or 512 ranks; the
    builders refuse a card that is absent."""
    with one_rank_mesh():
        assert tuple(pmesh.make_host_mesh(4, 4, device="cpu").shape) == (1, 1)
        assert tuple(pmesh.make_cache_mesh(device="cpu").shape) == (1, 1)
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="256|512"):
                pmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not dist.is_initialized()


def test_distrib_on_four_ranks(tmp_path):
    """4 gloo ranks: the collective merge at W = 4 and W = 2 equals the
    reference's stacked merge (ties and duplicate ids included);
    `query_sharded` with the corpus over 2 and 4 ranks (queries over the
    other axis) equals the reference's plain `query`; `shard_batch`
    leaves each ``data`` rank its block of rows, replicated over
    ``model``."""
    k = 3
    s, vids, shard = _tied_candidates(4, 5, k, seed=9)
    s2, vids2, _ = _tied_candidates(4, 5, k, seed=10)
    s2, vids2 = s2.reshape(2, 2, 5, k), vids2.reshape(2, 2, 5, k)
    st, q = _store(np.random.default_rng(12), cap=128, n=100)
    batch = {"tok1": np.arange(24, dtype=np.int32).reshape(6, 4),
             "label": np.arange(6, dtype=np.int32) % 2}
    payload = dict(k=k, s=s, vids=vids, shard=shard, s2=s2, vids2=vids2,
                   store={f: np.asarray(getattr(st, f))
                          for f in store.StoreState._fields},
                   q=q, batch=batch)
    ranks = spawn(4, distrib_ranks, (payload,), tmp_path)
    want4 = _reference_merge(k, s, vids, shard)
    ref = jstore.query(st, jnp.asarray(q), threshold=0.8, k=2)
    from torch.distributed.tensor import Replicate, Shard
    for r in ranks:
        for a, b in zip(want4, r["w4"]):
            np.testing.assert_array_equal(b, a)
        d, m = r["coord"]
        for a, b in zip(_reference_merge(k, s2[d], vids2[d]), r["w2"]):
            np.testing.assert_array_equal(b, a)
        _assert_query(ref, r["2x2"])
        _assert_query(ref, r["1x4"])
        for key, v in batch.items():
            placements, local, shape = r["batch"][key]
            assert tuple(placements) == (Shard(0), Replicate())
            assert shape == v.shape
            np.testing.assert_array_equal(local, v[3 * d:3 * d + 3])
    assert {r["coord"] for r in ranks} == {(0, 0), (0, 1), (1, 0), (1, 1)}
