"""Port parity for the paper's flat cache: the cosine top-k lookup, the
vector store (insert / LRU / touch / TTL / query) and ``SemanticCache``
plan/commit, against the JAX reference on the same seeded numpy inputs.

The cosine top-k's plain version is held to the reference's plain
version (``lax.top_k``: each index once, lowest index first among ties)
in every case, masked rows included, and to its Pallas kernel
(interpret mode) where every query has at least k valid rows — with
fewer, the Pallas kernel may repeat a masked index, which the port does
not reproduce.  On the CPU the port's ``ops`` run the plain version; the
CUDA kernel is held against it on the card.

Tolerances: indices, slots, value ids, clocks, flags exactly; scores
``atol 1e-5`` (sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_service.protocol import CacheRequest as JCacheRequest
from repro.core import SemanticCache as JSemanticCache
from repro.core import store as jstore
from repro.kernels.cosine_topk import kernel as jkernel
from repro.kernels.cosine_topk import ref as jref
from repro_torch.cache_service.protocol import CacheRequest
from repro_torch.core import SemanticCache, store
from repro_torch.data import HashTokenizer
from repro_torch.kernels.cosine_topk import ops, ref
from repro_torch.serving import CachedLLMService

SCORE_ATOL = 1e-5


def _unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                           1e-9)).astype(np.float32)


def _panel(rng, Q, N, D, n_valid=None, invalid=0.25):
    q = _unit(rng.standard_normal((Q, D)))
    keys = _unit(rng.standard_normal((N, D)))
    if n_valid is None:
        valid = rng.random(N) >= invalid
    else:
        valid = np.zeros(N, bool)
        valid[rng.permutation(N)[:n_valid]] = True
    return q, keys, valid


def _port_topk(q, keys, valid, k):
    s, i = ops.cosine_topk(torch.tensor(q), torch.tensor(keys),
                           torch.tensor(valid), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("case", ["quarter_invalid", "all_invalid",
                                  "fewer_valid_than_k"])
def test_cosine_topk_matches_reference(k, case):
    rng = np.random.default_rng(10 * k + len(case))
    n_valid = {"quarter_invalid": None, "all_invalid": 0,
               "fewer_valid_than_k": k - 1}[case]
    q, keys, valid = _panel(rng, 7, 150, 24, n_valid)
    q[:3] = _unit(keys[:3] + 0.05 * rng.standard_normal((3, 24)))
    ws, wi = jref.cosine_topk(jnp.asarray(q), jnp.asarray(keys),
                              jnp.asarray(valid), k)
    s, i = _port_topk(q, keys, valid, k)
    np.testing.assert_array_equal(i, np.asarray(wi))
    np.testing.assert_allclose(s, np.asarray(ws), rtol=0, atol=SCORE_ATOL)
    for row in i:                                    # each index once
        assert len(set(row.tolist())) == k


@pytest.mark.parametrize("k,block_n", [(1, 64), (4, 32)])
def test_cosine_topk_matches_pallas_kernel(k, block_n):
    """Every query has >= k valid rows; N=200 is no multiple of the
    block."""
    rng = np.random.default_rng(k)
    q, keys, valid = _panel(rng, 5, 200, 16)
    wk_s, wk_i = jkernel.cosine_topk(jnp.asarray(q), jnp.asarray(keys),
                                     jnp.asarray(valid), k,
                                     block_n=block_n, interpret=True)
    s, i = _port_topk(q, keys, valid, k)
    np.testing.assert_array_equal(i, np.asarray(wk_i))
    np.testing.assert_allclose(s, np.asarray(wk_s), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_topk_dtypes_match_pallas_kernel(dtype):
    """The reference's dtype case (Q=4, N=128, D=64, k=2, block 64): q
    and keys in float32 or bfloat16, multiplied in float32 on both sides.
    Scores ``atol 2e-2``, the reference test's own bound; indices are not
    compared, since bf16 rounding can reorder near-ties."""
    rng = np.random.default_rng(42)
    q = jnp.asarray(_unit(rng.standard_normal((4, 64))), dtype)
    keys = jnp.asarray(_unit(rng.standard_normal((128, 64))), dtype)
    valid = np.ones(128, bool)
    ws, _ = jkernel.cosine_topk(q, keys, jnp.asarray(valid), 2, block_n=64,
                                interpret=True)

    def port(a):          # bf16 -> float32 -> bf16 is exact
        return torch.tensor(np.asarray(a, np.float32)).to(
            getattr(torch, dtype))

    s, i = ops.cosine_topk(port(q), port(keys), torch.tensor(valid), 2)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=0,
                               atol=2e-2)


def test_cosine_topk_plain_version_only_for_cpu_tensors(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(ref, "cosine_topk", forbidden)
    q = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.cosine_topk(q, torch.zeros(8, 4, device="meta"),
                        torch.zeros(8, dtype=torch.bool, device="meta"), 1)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _assert_same_state(port, ref_state):
    for name in ("valid", "last_used", "inserted_at", "value_ids",
                 "clock"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref_state, name)),
                                      err_msg=name)
    np.testing.assert_allclose(port.keys.numpy(), np.asarray(ref_state.keys),
                               rtol=0, atol=1e-6)


def test_store_operations_match_reference():
    """insert_batch with a batch larger than the free slots (it evicts
    rows of its own batch), larger than the capacity, single inserts,
    touch with duplicate hit slots and misses, TTL eviction, queries."""
    rng = np.random.default_rng(3)
    cap, D = 8, 12
    js, ps = jstore.init_store(cap, D), store.init_store(cap, D)

    def both(jfn, pfn, *args):
        nonlocal js, ps
        js = jfn(js, *(jnp.asarray(a) for a in args))
        ps = pfn(ps, *(torch.tensor(a) for a in args))
        _assert_same_state(ps, js)

    emb = rng.standard_normal((40, D)).astype(np.float32) * 3
    both(jstore.insert_batch, store.insert_batch, emb[:5],
         np.arange(5, dtype=np.int32))
    both(jstore.insert_batch, store.insert_batch, emb[5:11],   # 3 free
         np.arange(5, 11, dtype=np.int32))
    # hits on slots 2 and 4 (slot 2 twice), misses elsewhere
    slots = np.asarray([2, 4, 2, 7, 0], np.int32)
    hit = np.asarray([True, True, True, False, False])
    both(jstore.touch, store.touch, slots, hit)
    both(jstore.insert, store.insert, emb[11], np.int32(11))
    both(jstore.insert_batch, store.insert_batch, emb[12:31],  # > cap
         np.arange(12, 31, dtype=np.int32))
    js = jstore.evict_older_than(js, 4)
    ps = store.evict_older_than(ps, 4)
    _assert_same_state(ps, js)
    assert float(store.occupancy(ps)) == float(jstore.occupancy(js))
    both(jstore.insert_batch, store.insert_batch, emb[31:33],
         np.arange(31, 33, dtype=np.int32))
    q = np.concatenate([emb[[30, 29, 31]] + 0.01,
                        rng.standard_normal((2, D))]).astype(np.float32)
    for k in (1, 3):
        jr = jstore.query(js, jnp.asarray(q), threshold=0.9, k=k)
        pr = store.query(ps, torch.tensor(q), threshold=0.9, k=k)
        for name in ("slots", "value_ids", "hit"):
            np.testing.assert_array_equal(getattr(pr, name).numpy(),
                                          np.asarray(getattr(jr, name)))
        np.testing.assert_allclose(pr.scores.numpy(), np.asarray(jr.scores),
                                   rtol=0, atol=SCORE_ATOL)
    assert pr.hit[:3].all() and not pr.hit[3:].any()


def test_store_query_takes_an_injected_topk():
    st = store.insert_batch(store.init_store(4, 3), torch.eye(3),
                            torch.arange(3))
    calls = []

    def topk(q, keys, valid, k):
        calls.append(k)
        return ref.cosine_topk(q, keys, valid, k)

    res = store.query(st, torch.eye(3)[:2] * 5, 0.99, k=2, topk_fn=topk)
    assert calls == [2] and res.hit.tolist() == [True, True]
    assert res.value_ids[:, 0].tolist() == [0, 1]


# ---------------------------------------------------------------------------
# SemanticCache
# ---------------------------------------------------------------------------

def _stream(rng, n_batches=6, B=8, D=16, pool=20):
    base = _unit(rng.standard_normal((pool, D)))
    out = []
    for _ in range(n_batches):
        pick = rng.integers(0, pool, B)
        noise = 0.02 * rng.standard_normal((B, D))
        out.append(_unit(base[pick] + noise))
    return out


@pytest.mark.parametrize("ttl", [None, 20])
def test_semantic_cache_plan_commit_matches_reference(ttl):
    """A short stream through plan + commit on both sides, a capacity
    small enough to evict: the same hits, scores, value ids, responses,
    coalescing groups and counters."""
    rng = np.random.default_rng(5)
    jc = JSemanticCache(capacity=12, dim=16, threshold=0.9, ttl=ttl)
    pc = SemanticCache(capacity=12, dim=16, threshold=0.9, ttl=ttl,
                       device="cpu")
    n = 0
    for embs in _stream(rng):
        jp = jc.plan(JCacheRequest.build(embs))
        pp = pc.plan(CacheRequest.build(embs))
        np.testing.assert_array_equal(pp.hit, jp.hit)
        np.testing.assert_array_equal(pp.value_ids, jp.value_ids)
        np.testing.assert_array_equal(pp.top_value_ids, jp.top_value_ids)
        np.testing.assert_array_equal(pp.miss_leader, jp.miss_leader)
        np.testing.assert_array_equal(pp.admit, jp.admit)
        np.testing.assert_allclose(pp.scores, jp.scores, rtol=0,
                                   atol=SCORE_ATOL)
        assert pp.responses == jp.responses
        resp = [None if h else f"r{n + i}" for i, h in enumerate(jp.hit)]
        n += len(resp)
        jrec = jc.commit(jp, resp)
        prec = pc.commit(pp, resp)
        assert (prec.admitted, prec.skipped) == (jrec.admitted, jrec.skipped)
        _assert_same_state(pc.state, jc.state)
    assert pc.stats_snapshot() == jc.stats_snapshot()
    assert len(pc) == len(jc) and pc.occupancy == jc.occupancy
    assert pc.stats_snapshot()["hits"] > 0
    pc.maintenance()
    assert pc.telemetry.registry.value("cache_occupancy") == pc.occupancy


def test_semantic_cache_serves_through_the_pipeline():
    """``CachedLLMService`` takes the flat backend unchanged: repeats hit
    with the answer of their first occurrence, a repeat inside one batch
    is coalesced under its leader (and, admit-all, cached too), a second
    tenant is refused."""
    rng = np.random.default_rng(6)
    texts = [f"query {i}" for i in range(4)]
    table = {t: _unit(rng.standard_normal(16)) for t in texts}
    cache = SemanticCache(capacity=32, dim=16, threshold=0.9,
                          device="cpu")
    svc = CachedLLMService(lambda ts: np.stack([table[t] for t in ts]),
                           cache, None, HashTokenizer(64))
    first = svc.handle(texts[:2] + texts[:1])
    assert [r.cache_hit for r in first] == [False, False, False]
    assert first[2].response == "answer(query 0)"      # coalesced miss
    again = svc.handle(texts)
    assert [r.cache_hit for r in again] == [True, True, False, False]
    assert again[1].response == "answer(query 1)"
    st = svc.stats()
    assert st["hits"] == 2 and st["backend"]["inserts"] == 3 + 2
    with pytest.raises(ValueError, match="tenant"):
        svc.handle(texts[:1], tenant=1)
