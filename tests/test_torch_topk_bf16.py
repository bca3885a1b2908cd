"""The cosine top-k over every dtype pair the reference takes (q and keys
each float32 or bfloat16), against the JAX reference on the same seeded
numpy inputs, and the pieces of the bf16-key tensor-core kernel that run
in plain Python: its argument check, the float32 queries' three-term bf16
split (mirrored in ``ref.split_terms``) and its launch geometry.

On the CPU the port's ``ops`` run the plain version; the CUDA kernels
are held against it on the card (``tests/test_torch_cuda_kernels.py``).

Tolerances: indices, slots, value ids and hits exactly; scores ``atol
1e-5`` (float32 sums in another order).  Both sides multiply the same
values (a bf16 value widened to float32 is exact, and so is its product
with another), so unlike the reference's own dtype test (``atol 2e-2``,
against float32 inputs) nothing here is rounded on one side only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.kernels.cosine_topk import kernel as jkernel
from repro.kernels.cosine_topk import ref as jref
from repro_torch.core import store
from repro_torch.kernels.cosine_topk import kernel, ops, ref
from test_torch_cuda_kernels import THIRD_TERM_ATOL, third_term_panel

SCORE_ATOL = 1e-5
MAX_K = 16                 # the kernels' cosine_topk_max_k()
PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "bfloat16"), ("bfloat16", "float32")]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _as(x, dtype):
    """(jnp array, torch tensor) of the float32 numpy ``x`` in ``dtype``:
    the same values on both sides (bf16 rounded once, by JAX)."""
    j = jnp.asarray(x, dtype)
    return j, torch.tensor(np.asarray(j, np.float32)).to(getattr(torch,
                                                                 dtype))


def _panel(seed, Q=33, N=300, D=64):
    rng = np.random.default_rng(seed)
    keys = _unit(rng.standard_normal((N, D)))
    q = _unit(rng.standard_normal((Q, D)))
    q[:8] = _unit(keys[-8:] + 0.05 * rng.standard_normal((8, D)))
    valid = rng.random(N) >= 0.25
    return q, keys, valid


# ---------------------------------------------------------------------------
# (a) every dtype pair against the reference's Pallas kernel and plain
# version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("q_dtype,k_dtype", PAIRS,
                         ids=[f"{a}-{b}" for a, b in PAIRS])
def test_every_dtype_pair_matches_the_reference(q_dtype, k_dtype, k):
    """Q=33, N=300 (no multiple of the Pallas block of 64), D=64, a
    quarter of the rows invalid; every query has at least k valid rows,
    so the Pallas kernel's masked-argmax order is the plain version's."""
    q, keys, valid = _panel(10 * k + len(q_dtype + k_dtype))
    jq, tq = _as(q, q_dtype)
    jk, tk = _as(keys, k_dtype)
    pk_s, pk_i = jkernel.cosine_topk(jq, jk, jnp.asarray(valid), k,
                                     block_n=64, interpret=True)
    pr_s, pr_i = jref.cosine_topk(jq, jk, jnp.asarray(valid), k)
    s, i = ops.cosine_topk(tq, tk, torch.tensor(valid), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    for ws, wi in ((pk_s, pk_i), (pr_s, pr_i)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=0,
                                   atol=SCORE_ATOL)


# ---------------------------------------------------------------------------
# (b) a bf16-key store through store.query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_bf16_key_store_query_matches_the_reference(k):
    """The store keeps bf16 keys; `store.query` normalises q in float32
    and hands it with those keys to the top-k (float32 q x bf16 keys:
    the mixed path on the card)."""
    rng = np.random.default_rng(5 + k)
    N, D, Q = 200, 64, 24
    keys = _unit(rng.standard_normal((N, D)))
    valid = rng.random(N) >= 0.2
    vids = rng.permutation(10_000)[:N].astype(np.int32)
    q = 3.0 * keys[rng.integers(0, N, Q)] + 0.02 * rng.standard_normal(
        (Q, D)).astype(np.float32)
    q[-6:] = rng.standard_normal((6, D))        # far from every key
    clocks = np.arange(N, dtype=np.int32)
    jkeys, tkeys = _as(keys, "bfloat16")
    jst = jstore.StoreState(
        keys=jkeys, valid=jnp.asarray(valid), last_used=jnp.asarray(clocks),
        inserted_at=jnp.asarray(clocks), value_ids=jnp.asarray(vids),
        clock=jnp.asarray(N, jnp.int32))
    tst = store.StoreState(
        keys=tkeys, valid=torch.tensor(valid),
        last_used=torch.tensor(clocks), inserted_at=torch.tensor(clocks),
        value_ids=torch.tensor(vids), clock=torch.tensor(N, dtype=torch.int32))
    want = jstore.query(jst, jnp.asarray(q), 0.99, k)
    got = store.query(tst, torch.tensor(q), 0.99, k)
    np.testing.assert_array_equal(got.slots.numpy(), np.asarray(want.slots))
    np.testing.assert_array_equal(got.value_ids.numpy(),
                                  np.asarray(want.value_ids))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=SCORE_ATOL)
    assert 0 < int(got.hit.sum()) < Q


# ---------------------------------------------------------------------------
# (c) the argument check the card runs before a launch
# ---------------------------------------------------------------------------

def _args(q_dtype=torch.float32, k_dtype=torch.float32, Q=3, N=20, D=16):
    return (torch.zeros(Q, D, dtype=q_dtype), torch.zeros(N, D,
                                                          dtype=k_dtype),
            torch.ones(N, dtype=torch.bool))


@pytest.mark.parametrize("q_dtype,k_dtype", PAIRS,
                         ids=[f"{a}-{b}" for a, b in PAIRS])
def test_check_args_accepts_every_pair(q_dtype, k_dtype):
    q, keys, valid = _args(getattr(torch, q_dtype), getattr(torch, k_dtype))
    for k in (1, MAX_K):
        ops.check_args(q, keys, valid, k, MAX_K)


@pytest.mark.parametrize("case,match", [
    ("q float16", "q has dtype"), ("keys float16", "keys has dtype"),
    ("q float64", "q has dtype"), ("keys float64", "keys has dtype"),
    ("q 1-d", "2-d"), ("keys 3-d", "2-d"), ("D differs", "keys has shape"),
    ("valid short", "valid has shape"), ("valid int", "valid has dtype"),
    ("k 0", "k=0"), ("k past max", "k=17"), ("k past N", "k=5 exceeds"),
    ("keys strided", "not contiguous"),
])
def test_check_args_refuses(case, match):
    q, keys, valid = _args(torch.float32, torch.bfloat16)
    k = 1
    if case.endswith(("float16", "float64")):
        dt = getattr(torch, case.split()[1])
        q, keys = (q.to(dt), keys) if case[0] == "q" else (q, keys.to(dt))
    elif case == "q 1-d":
        q = q[0]
    elif case == "keys 3-d":
        keys = keys[None]
    elif case == "D differs":
        keys = keys[:, :-1].contiguous()
    elif case == "valid short":
        valid = valid[:-1]
    elif case == "valid int":
        valid = valid.int()
    elif case.startswith("k "):
        k = {"k 0": 0, "k past max": MAX_K + 1, "k past N": 5}[case]
        if case == "k past N":
            keys, valid = keys[:4], valid[:4]
    elif case == "keys strided":
        keys = torch.cat([keys, keys], 1)[:, ::2]
    with pytest.raises(ValueError, match=match):
        ops.check_args(q, keys, valid, k, MAX_K)


def test_vector_loads_need_alignment_and_width():
    keys = torch.zeros(40 * 65 + 8, dtype=torch.bfloat16)
    aligned = keys[:2560].view(40, 64)
    assert kernel.mma_vector_loads(aligned) == (aligned.data_ptr() % 16 == 0)
    assert not kernel.mma_vector_loads(keys[1:2561].view(40, 64))
    assert not kernel.mma_vector_loads(keys[:2600].view(40, 65))


# ---------------------------------------------------------------------------
# (d) the float32 queries' bf16 terms
# ---------------------------------------------------------------------------

def test_three_bf16_terms_hold_a_float32_query():
    """hi + mid + lo = q within 2^-24 |q| elementwise; the three-term
    score (float64 sums of exact products) within 1e-7 of the float64
    score, and two terms' error, up to ~2^-17 of the products, beside
    it."""
    rng = np.random.default_rng(3)
    q = torch.tensor(_unit(rng.standard_normal((33, 64))))
    q[0, :4] = torch.tensor([1.0, -2.0 ** -30, 65504.0, 0.0])
    keys = torch.tensor(_unit(rng.standard_normal((300, 64)))).bfloat16()
    terms = ref.split_terms(q)
    assert len(terms) == 3 and all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    assert bool(((total - q.double()).abs()
                 <= 2.0 ** -24 * q.double().abs()).all())
    kd = keys.double().T
    exact = q.double()[1:] @ kd
    err3 = float((sum(t.double()[1:] for t in terms) @ kd - exact).abs()
                 .max())
    err2 = float((sum(t.double()[1:] for t in terms[:2]) @ kd - exact)
                 .abs().max())
    err1 = float((terms[0].double()[1:] @ kd - exact).abs().max())
    assert err3 <= 1e-7, err3
    assert err3 < err2 <= 2.0 ** -16, (err3, err2)
    assert err2 < err1, (err2, err1)
    assert all(torch.equal(a, b)
               for a, b in zip(ref.split_terms(q, 2), terms[:2]))


def test_third_term_panel_needs_three_terms():
    """The card test's inputs (`third_term_panel`): the split is exact,
    two terms miss each query's top score by more than
    ``THIRD_TERM_ATOL``, three by nothing, and the port's top-k on them
    (the plain version here) gives the reference's indices and scores,
    each query's own hi row first."""
    q, keys, rows = third_term_panel()
    terms = ref.split_terms(q)
    assert torch.equal(sum(t.double() for t in terms), q.double())
    kd = keys.double()[rows]
    exact = (q.double() * kd).sum(-1)
    two = (sum(t.double() for t in terms[:2]) * kd).sum(-1)
    three = (sum(t.double() for t in terms) * kd).sum(-1)
    assert float((two - exact).abs().min()) > THIRD_TERM_ATOL
    assert float((three - exact).abs().max()) == 0.0
    valid = np.ones(keys.shape[0], bool)
    s, i = ops.cosine_topk(q, keys, torch.tensor(valid), 4)
    js, ji = jref.cosine_topk(jnp.asarray(q.numpy()),
                              jnp.asarray(keys.float().numpy(), jnp.bfloat16),
                              jnp.asarray(valid), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_ATOL)
    assert i[:, 0].tolist() == rows.tolist()
    assert float((s[:, 0].double() - exact).abs().max()) <= THIRD_TERM_ATOL


def test_bf16_query_is_its_own_single_term():
    q = torch.tensor(_unit(np.random.default_rng(4).standard_normal(
        (5, 32)))).bfloat16()
    hi, mid, lo = ref.split_terms(q)
    assert torch.equal(hi, q)
    assert not mid.any() and not lo.any()


# ---------------------------------------------------------------------------
# (e) the bf16-key kernel's launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Q,N", [(64, 4096), (64, 65536), (1024, 2 ** 20),
                                 (33, 4099), (1, 1), (130, 31), (64, 5),
                                 (1000, 10 ** 6)])
@pytest.mark.parametrize("n_sm", [132, 8])
@pytest.mark.parametrize("q_tile,k_tile", [(32, 256), (16, 256), (32, 128)])
def test_mma_splits_cover_n(Q, N, n_sm, q_tile, k_tile):
    per_sm = 1                                  # the kernel's launch bounds
    S, rows = kernel.mma_splits(Q, N, n_sm, q_tile, k_tile, per_sm)
    assert rows % k_tile == 0
    assert k_tile <= rows <= kernel.MMA_SPLIT_TILES * k_tile
    assert (S - 1) * rows < N <= S * rows       # every split non-empty
    q_tiles, key_tiles = -(-Q // q_tile), -(-N // k_tile)
    # one wave fills the card, unless N has too few key tiles
    assert q_tiles * S >= min(per_sm * n_sm,
                              q_tiles * key_tiles) // 2


def test_mma_splits_at_the_main_shapes():
    """32-query tiles and 256-row key tiles on 132 SMs, one block an SM:
    the flat cache's 4096 rows one tile a block (32 blocks); 65536 rows
    four tiles a block (128 blocks); the cache program's 2^20 rows at
    most 16 (256 splits of 4096 rows: 8192 blocks, 62 waves)."""
    assert kernel.mma_splits(64, 4096, 132, 32, 256, 1) == (16, 256)
    assert kernel.mma_splits(64, 65536, 132, 32, 256, 1) == (64, 1024)
    assert kernel.mma_splits(1024, 2 ** 20, 132, 32, 256, 1) == (256, 4096)
