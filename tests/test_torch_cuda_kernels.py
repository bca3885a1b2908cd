"""The CUDA cascade kernel against its plain torch version, on the card.

Only torch and the port are imported (the card's machine has no JAX), so
``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda_kernels.py`` runs there (``tests/conftest.py``
imports JAX); elsewhere every case skips.  The cases cover what the
serving-shape check in ``chip_smoke.py`` does not: a width that is not a
multiple of 4 (the kernel's scalar loads), k up to the kernel's maximum,
a ring whose cursor sits below the tail window, exact ties (dyadic keys:
lowest hot row, lowest warm position, hot before warm), an empty warm
tier, all-invalid tiers, a zero-row batch, and the refusals.

Tolerances: scores ``atol 1e-5`` (fp32 sums in another order); ids,
slots and flags exactly.
"""
import pytest
import torch

from repro_torch.cache_service import tiers
from repro_torch.kernels.cascade_lookup import kernel, ops, ref

SCORE_ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the H100)")
    return torch.device("cuda")


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def _states(dev, g, Nh=300, cap=512, D=64, K=8, bucket=96, flush=64,
            unindexed=40, tenants=3):
    def ten(n):
        return torch.randint(0, tenants, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    hot = tiers.init_hot(Nh, D, dev)
    hot, _ = tiers.hot_insert_batch(
        hot, torch.randn(Nh, D, generator=g, device=dev),
        torch.arange(Nh, device=dev, dtype=torch.int32), ten(Nh))
    hot = hot._replace(valid=hot.valid & (torch.rand(
        Nh, generator=g, device=dev) > 0.3))
    warm = tiers.init_warm(cap, D, K, bucket, dev)
    vid = 1000

    def append(warm, n):
        nonlocal vid
        dem = tiers.Demoted(
            torch.randn(n, D, generator=g, device=dev),
            torch.arange(vid, vid + n, device=dev, dtype=torch.int32),
            ten(n), torch.ones(n, dtype=torch.bool, device=dev))
        vid += n
        return tiers.warm_append(warm, dem)[0]

    for _ in range((cap + cap // 3) // flush):
        warm = append(warm, flush)
    warm = tiers.warm_rebuild(warm, 4, 0)
    warm = append(warm, unindexed)
    warm = warm._replace(valid=warm.valid & (torch.rand(
        cap, generator=g, device=dev) > 0.2))
    return hot, tiers.requantize(warm)


def _queries(dev, g, Q, D, tenants=3):
    return (_unit(torch.randn(Q, D, generator=g, device=dev)),
            torch.randint(0, tenants, (Q,), generator=g, device=dev,
                          dtype=torch.int32),
            0.3 * torch.rand(Q, generator=g, device=dev))


def _args(hot, warm, q, qt, thr):
    return (q, qt, thr, hot.keys, hot.valid, hot.tenants, hot.value_ids,
            warm.keys, warm.valid, warm.tenants, warm.value_ids,
            warm.write_seq, warm.centroids, warm.members, warm.cursor,
            warm.indexed_total, warm.keys_q, warm.scales)


def _check(args, **kw):
    before = kernel.COUNTS["cascade_lookup"]
    a = ref.cascade_lookup(*args, **kw)
    b = ops.cascade_lookup(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.COUNTS["cascade_lookup"] == before + (args[0].shape[0] > 0)
    for name, x, y in zip(("scores", "value_ids", "warm_slots",
                           "hot_slots", "hot_hit", "hit"), a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if name == "scores":
            torch.testing.assert_close(y, x, rtol=0, atol=SCORE_ATOL)
        else:
            assert torch.equal(x, y), name
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 37])
@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_kernel_matches_plain_version(dev, D, k, quantized):
    g = torch.Generator(device=dev).manual_seed(D * 100 + k)
    hot, warm = _states(dev, g, D=D)
    q, qt, thr = _queries(dev, g, 17, D)
    out = _check(_args(hot, warm, q, qt, thr), k=k, n_probe=4, tail=48,
                 quantized=quantized)
    assert out[5].any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_ring_cursor_below_tail(dev, k):
    g = torch.Generator(device=dev).manual_seed(7)
    hot, warm = _states(dev, g, cap=128, flush=16, unindexed=0)
    warm = warm._replace(cursor=torch.tensor(3, dtype=torch.int32,
                                             device=dev))
    seq = torch.zeros(128, dtype=torch.int32, device=dev)
    for age in range(128):                  # slot 2 newest, then 1, 0, 127..
        seq[(3 - 1 - age) % 128] = 128 - age
    warm = warm._replace(write_seq=seq, indexed_total=torch.tensor(
        116, dtype=torch.int32, device=dev))
    src = torch.tensor([1, 127, 124, 120], device=dev)
    q, qt, thr = _queries(dev, g, 8, 64)
    q[:4] = _unit(warm.keys[src] + 0.05 * torch.randn(4, 64, generator=g,
                                                      device=dev))
    qt[:4] = warm.tenants[src]
    warm = warm._replace(valid=warm.valid.clone())
    warm.valid[src] = True
    out = _check(_args(hot, warm, q, qt, thr), k=k, n_probe=2, tail=20)
    assert torch.isin(out[2], src[1:].to(torch.int32)).any()


@pytest.mark.cuda
def test_exact_ties_and_masked_rows(dev):
    D = 8
    a_key = torch.zeros(D, device=dev)
    a_key[:4] = 0.5                                   # score 1.0
    b_key = a_key.clone()
    b_key[3] = -0.5                                   # score 0.5
    hot = tiers.init_hot(8, D, dev)._replace(
        keys=torch.stack([b_key, a_key, b_key, a_key, a_key] + [a_key * 0]
                         * 3),
        valid=torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.bool,
                           device=dev),
        tenants=torch.zeros(8, dtype=torch.int32, device=dev),
        value_ids=torch.arange(8, dtype=torch.int32, device=dev))
    cap = 16
    members = torch.full((2, 8), -1, dtype=torch.int32, device=dev)
    members[0, :4] = torch.tensor([9, 3, 6, 0], dtype=torch.int32)
    members[1, :3] = torch.tensor([12, 1, 4], dtype=torch.int32)
    warm = tiers.init_warm(cap, D, 2, 8, dev)._replace(
        keys=torch.stack([a_key if i % 3 == 0 else b_key
                          for i in range(cap)]),
        valid=torch.ones(cap, dtype=torch.bool, device=dev),
        tenants=torch.zeros(cap, dtype=torch.int32, device=dev),
        value_ids=torch.arange(100, 100 + cap, dtype=torch.int32,
                               device=dev),
        write_seq=torch.arange(1, cap + 1, dtype=torch.int32, device=dev),
        total=torch.tensor(cap, dtype=torch.int32, device=dev),
        centroids=torch.stack([a_key, b_key]), members=members,
        indexed_total=torch.tensor(cap - 3, dtype=torch.int32, device=dev))
    warm = tiers.requantize(warm)
    q = torch.stack([a_key, a_key])
    qt = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    thr = torch.full((2,), 0.9, device=dev)
    for quantized in (False, True):
        s, vids, wslots, hslots, hot_hit, hit = _check(
            _args(hot, warm, q, qt, thr), k=4, n_probe=2, tail=3,
            quantized=quantized)
        assert vids[0].tolist() == [1, 3, 109, 103]
        assert wslots[0].tolist() == [-1, -1, 9, 3]
        assert bool(hot_hit[0]) and int(hslots[0]) == 1
        assert int(hslots[1]) == 0 and not bool(hit[1])


@pytest.mark.cuda
def test_empty_and_invalid_tiers(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    hot, _ = _states(dev, g)
    empty = tiers.init_warm(64, 64, 4, 8, dev)
    q, qt, thr = _queries(dev, g, 5, 64)
    _check(_args(hot, empty, q, qt, thr), k=2, n_probe=4, tail=4)
    dead = tiers.init_hot(32, 64, dev)
    s, vids, _, hslots, hot_hit, hit = _check(
        _args(dead, empty, q, qt, torch.zeros(5, device=dev)), k=4,
        n_probe=2, tail=4)
    assert float(s.max()) < -1e20 and not hit.any() and not hot_hit.any()
    assert int(vids.max()) == -1 and int(hslots.max()) == 0
    _check(_args(hot, empty, q[:0], qt[:0], thr[:0]), k=1, n_probe=2,
           tail=4)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_scores_are_fp32_exact(dev, quantized):
    """Scores against a float64 recomputation of the same dot products:
    TF32 or bf16 anywhere in the kernel would miss by ~1e-3."""
    g = torch.Generator(device=dev).manual_seed(5)
    hot, warm = _states(dev, g, D=256)
    q, qt, thr = _queries(dev, g, 24, 256)
    s, vids, wslots, hslots, _, _ = _check(_args(hot, warm, q, qt, thr),
                                           k=4, n_probe=4, tail=48,
                                           quantized=quantized)
    live = s > -1e29
    rows = torch.where(wslots >= 0, wslots, 0).long()
    if quantized:          # warm rows scored from int8 times the scale
        wkey = warm.keys_q[rows].double() * warm.scales[rows, None].double()
    else:
        wkey = warm.keys[rows].double()
    w_exact = torch.einsum("qd,qkd->qk", q.double(), wkey)
    hot_row = {int(v): i for i, v in enumerate(hot.value_ids.tolist())}
    h_idx = torch.tensor([[hot_row.get(int(v), 0) for v in r]
                          for r in vids.tolist()], device=dev)
    h_exact = torch.einsum("qd,qkd->qk", q.double(),
                           hot.keys[h_idx].double())
    exact = torch.where(wslots >= 0, w_exact, h_exact)
    torch.testing.assert_close(s[live].double(), exact[live], rtol=0,
                               atol=1e-6)
    assert live.sum() > 24


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    hot, warm = _states(dev, g)
    q, qt, thr = _queries(dev, g, 3, 64)
    args = _args(hot, warm, q, qt, thr)
    with pytest.raises(ValueError, match="k="):
        ops.cascade_lookup(*args, k=kernel.max_k() + 1)
    with pytest.raises(ValueError, match="dtype"):
        ops.cascade_lookup(q.double(), *args[1:], k=1)
    with pytest.raises(ValueError, match="contiguous"):
        bad = torch.cat([q, q], 1)[:, ::2]
        ops.cascade_lookup(bad, *args[1:], k=1)
    with pytest.raises(ValueError, match="on cpu"):
        ops.cascade_lookup(q, qt.cpu(), *args[2:], k=1)
