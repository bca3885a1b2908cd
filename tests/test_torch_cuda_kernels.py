"""The port's CUDA kernels against their plain torch versions, on the card.

Only torch and the port are imported (the card's machine has no JAX), so
``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda_kernels.py`` runs there (``tests/conftest.py``
imports JAX); elsewhere every case skips.  The cases cover what the
serving- and training-shape checks in ``chip_smoke.py`` do not.

* cascade lookup: a width that is not a multiple of 4 (the kernel's
  scalar loads), k up to the kernel's maximum, a ring whose cursor sits
  below the tail window, exact ties (dyadic keys: lowest hot row, lowest
  warm position, hot before warm), an empty warm tier, all-invalid
  tiers, a zero-row batch, and the refusals;
* the ensemble cascade (E stacked key panels, weighted fused score):
  E in {1, 3}, fp32 and int8, k in {1, 4}; E=1 equal to the single
  cascade bit for bit, also over several 16-query tiles; an empty warm
  tier, an all-invalid hot tier, a zero-row batch; D=2048 at E=8; the
  refusals and a launch the kernel refuses;
* the cascade's partition over CTAs: exact duplicates of one key in
  different hot chunks, bucket chunks and the tail (ties keep the plain
  version's order across CTAs), buckets probed by more than one
  16-query tile of queries, Q not a multiple of the tile;
* cosine top-k: odd widths, k up to the maximum, ties (lowest index
  first), all-invalid and fewer-valid-than-k panels, an empty batch, a
  float64 recomputation and the refusals; Q, N and D ragged across the
  register-tiled kernel's query tiles, key tiles and D chunks, and a
  split of N with no valid row; over bf16 keys (the tensor-core kernel)
  with float32 or bf16 q: the same cases, every k, D wider than the
  staged queries' slab, element-wise copies (odd D, misaligned views),
  the float32 split held to a float64 recomputation, also on inputs
  whose third bf16 term moves a score by ~4e-6 (``THIRD_TERM_ATOL``),
  and bf16 q with float32 keys through the float32 kernel;
* contrastive forward and backward: mixed and one-class batches, B = 1,
  zero rows (the clamped denominator), large B, float64 recomputations
  and the refusals; for the cooperative forward, a ragged last CTA
  (B = 4097), more pairs than the co-resident grid holds at one row per
  warp, the one-class sentinels across CTAs, CUDA-graph replays equal
  to eager calls bit for bit, two streams in flight at once, and exact
  zero gradients for pairs that are not hard (their rows never read);
* flash attention: float32 and bf16, head widths 32, 64, 96 and 128,
  ragged sequences, Sq < Skv, causal, bidirectional and sliding-window
  masks, MHA, GQA and MQA, strided (B, S, H, hd) views read in place,
  the ``scale`` argument and the refusals; for the bf16 tensor-core
  kernel, Sq of 1, 17, 33 and 100 (2- and 4-warp blocks, ragged 16-row
  warp tiles), Skv off the 64-row K/V tiles, and misaligned views
  refused (float32 takes them); for both float32 kernels (3xTF32), Sq
  of 1, 16, 17, 32, 33 and 100, Skv off the key tiles, GQA, MQA and
  windows, |logits| near 50, and misaligned views through their 4-byte
  copies; the bf16-accumulate mode
  (``attn_f32=False``), dense and chunked (a chunk of one tile, a chunk
  off the tile, a window across chunks, bidirectional chunks, a ragged
  last chunk), every case through both routes of the bf16 and the
  float32 kernels (one walk and two walks), and the routes' edges (the
  longest one walk, two walks over an odd tile count, the reference's
  1024-key chunks whole,
  with a ragged last chunk and with a window starting mid-chunk),
  against its plain version in that mode: max |diff| within 2^-6 max|v|
  and mean |diff| within a quarter of the plain version's own
  True-vs-False gap (`chip_smoke.py`'s bounds);
* decode attention: the same dtypes and widths, ragged cache lengths,
  random, ring-buffer and fully masked validity, MHA, GQA and MQA, 128
  query heads on one KV head, and the refusals (misaligned caches);
  split-L edges with the wrapper made to split a short cache (a ragged
  last split, a split whose every slot is masked, a fully masked row,
  G = 1, 5 and 32 at hd 96 and 128), and one split against many.

Tolerances: scores ``atol 1e-5`` (fp32 sums in another order); ids,
slots and flags exactly; contrastive components ``rtol 1e-5``, their
extrema ``atol 1e-6``, gradients ``atol 1e-6`` against torch autograd of
the plain version; attention outputs ``atol 2e-5, rtol 1e-4`` in float32
(the reference's kernel tests) and ``atol 3e-2`` in bf16 (the reference's
bf16 tolerance: both versions accumulate in float32; the kernel also
rounds the softmax weights to bf16 before P V, within 2^-9 of each,
which ``tests/test_torch_attention.py`` shows stays inside it).
"""
import numpy as np
import pytest
import torch

from repro_torch.cache_service import tiers
from repro_torch.core import losses
from repro_torch.kernels.cascade_lookup import kernel, ops, ref
from repro_torch.kernels.contrastive import kernel as cl_kernel
from repro_torch.kernels.contrastive import ops as cl_ops
from repro_torch.kernels.contrastive import ref as cl_ref
from repro_torch.kernels.cosine_topk import kernel as ct_kernel
from repro_torch.kernels.cosine_topk import ops as ct_ops
from repro_torch.kernels.cosine_topk import ref as ct_ref
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

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


# ---------------------------------------------------------------------------
# ensemble cascade lookup (E stacked key panels)
# ---------------------------------------------------------------------------

def _ensemble(dev, g, hot, warm, q, E):
    """E panels over the tiers (panel 0 the base keys, the others
    random unit rows), E query rows per query and simplex weights."""
    def more(x):
        return [_unit(torch.randn(x.shape, generator=g, device=dev))
                for _ in range(E - 1)]

    ens = tiers.make_ensemble(torch.stack([hot.keys] + more(hot.keys)),
                              torch.stack([warm.keys] + more(warm.keys)))
    qe = torch.stack([q] + more(q)).contiguous()
    w = torch.rand(q.shape[0], E, generator=g, device=dev) + 0.1
    return ens, qe, w / w.sum(1, keepdim=True)


def _ens_args(hot, warm, ens, qe, w, qt, thr):
    return (qe, w, qt, thr, ens.hot_keys, hot.valid, hot.tenants,
            hot.value_ids, ens.warm_keys, warm.valid, warm.tenants,
            warm.value_ids, warm.write_seq, warm.centroids, warm.members,
            warm.cursor, warm.indexed_total, ens.warm_keys_q,
            ens.warm_scales)


def _ens_check(args, **kw):
    before = kernel.COUNTS["cascade_lookup_ensemble"]
    a = ref.ensemble_lookup(*args, **kw)
    b = ops.ensemble_lookup(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.COUNTS["cascade_lookup_ensemble"] \
        == before + (args[0].shape[1] > 0)
    for name, x, y in zip(("scores", "value_ids", "warm_slots",
                           "hot_slots", "hot_hit", "hit"), a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if name == "scores":
            torch.testing.assert_close(y, x, rtol=0, atol=SCORE_ATOL)
        else:
            assert torch.equal(x, y), name
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("quantized", [False, True])
def test_ensemble_kernel_matches_plain_version(dev, E, k, quantized):
    g = torch.Generator(device=dev).manual_seed(10 * E + k)
    hot, warm = _states(dev, g)
    q, qt, thr = _queries(dev, g, 17, 64)
    # half the queries copy live rows on every panel, so some hit
    ens, qe, w = _ensemble(dev, g, hot, warm, q, E)
    src = torch.nonzero(warm.valid).squeeze(1)[:8]
    qe[:, :8] = _unit(ens.warm_keys[:, src] + 0.02 * torch.randn(
        E, 8, 64, generator=g, device=dev))
    qt[:8] = warm.tenants[src]
    out = _ens_check(_ens_args(hot, warm, ens, qe, w, qt, thr), k=k,
                     n_probe=4, tail=48, quantized=quantized)
    assert out[5].any()


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_ensemble_e1_equals_the_single_kernel(dev, quantized):
    """E=1 at weight 1.0 launches the same arithmetic as the single
    cascade: every output equal, scores bit for bit."""
    g = torch.Generator(device=dev).manual_seed(12)
    hot, warm = _states(dev, g)
    q, qt, thr = _queries(dev, g, 17, 64)
    ens = tiers.init_ensemble(1, hot, warm)      # the base keys, same bits
    kw = dict(k=4, n_probe=4, tail=48, quantized=quantized)
    one = torch.ones(17, 1, device=dev)
    a = ops.cascade_lookup(*_args(hot, warm, q, qt, thr), **kw)
    b = ops.ensemble_lookup(*_ens_args(hot, warm, ens, q[None], one, qt,
                                       thr), **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_ensemble_empty_and_invalid_tiers(dev):
    g = torch.Generator(device=dev).manual_seed(13)
    hot, _ = _states(dev, g)
    empty = tiers.init_warm(64, 64, 4, 8, dev)
    q, qt, thr = _queries(dev, g, 5, 64)
    ens, qe, w = _ensemble(dev, g, hot, empty, q, 3)
    _ens_check(_ens_args(hot, empty, ens, qe, w, qt, thr), k=2, n_probe=4,
               tail=4)
    dead = tiers.init_hot(32, 64, dev)
    ens, qe, w = _ensemble(dev, g, dead, empty, q, 3)
    s, vids, _, hslots, hot_hit, hit = _ens_check(
        _ens_args(dead, empty, ens, qe, w, qt, torch.zeros(5, device=dev)),
        k=4, n_probe=2, tail=4, quantized=True)
    assert float(s.max()) < -1e20 and not hit.any() and not hot_hit.any()
    assert int(vids.max()) == -1 and int(hslots.max()) == 0
    _ens_check(_ens_args(dead, empty, ens, qe[:, :0], w[:0], qt[:0],
                         thr[:0]), k=1, n_probe=2, tail=4)


@pytest.mark.cuda
def test_ensemble_refusals_and_refused_launch(dev, monkeypatch):
    """The wrapper refuses what the kernel does not take; a launch the
    kernel refuses (here: a partition with other tiles than its own)
    raises and is not counted."""
    g = torch.Generator(device=dev).manual_seed(14)
    hot, warm = _states(dev, g)
    q, qt, thr = _queries(dev, g, 3, 64)
    ens, qe, w = _ensemble(dev, g, hot, warm, q, 3)
    args = _ens_args(hot, warm, ens, qe, w, qt, thr)
    with pytest.raises(ValueError, match="E="):
        ops.ensemble_lookup(torch.cat([qe] * 3), *args[1:], k=1)
    with pytest.raises(ValueError, match="weights"):
        ops.ensemble_lookup(qe, w[:, :2].contiguous(), *args[2:], k=1)
    with pytest.raises(ValueError, match="hot_keys"):
        ops.ensemble_lookup(*args[:4], hot.keys, *args[5:], k=1)
    # the widest panels at the most panels: the scoring kernel stages D
    # in chunks, so its shared memory no longer grows with D or E
    D, E = 2048, 8
    big_hot = tiers.init_hot(8, D, dev)
    big_warm = tiers.init_warm(16, D, 2, 4, dev)
    big_q = _unit(torch.randn(2, D, generator=g, device=dev))
    ens, qe, w = _ensemble(dev, g, big_hot, big_warm, big_q, E)
    args = _ens_args(big_hot, big_warm, ens, qe, w, qt[:2], thr[:2])
    _ens_check(args, k=1, n_probe=2, tail=4)
    # a launch geometry the kernel does not take is refused on the card
    monkeypatch.setattr(kernel, "ROW_TILE", 32)
    before = kernel.COUNTS["cascade_lookup_ensemble"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.ensemble_lookup(*args, k=1, n_probe=2, tail=4)
    assert kernel.COUNTS["cascade_lookup_ensemble"] == before


def _dyadic(dev, g, n, D):
    """Rows of multiples of 1/4 in [-1/2, 1/2]: every dot product of two
    of them is exact in float32 whatever the order of the sum, so equal
    rows tie exactly on both sides."""
    return torch.randint(-2, 3, (n, D), generator=g, device=dev).float() / 4


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_ties_across_cta_boundaries(dev, quantized):
    """One key X duplicated in three hot chunks (rows 5, 70, 150) and in
    four warm bucket chunks of two probed buckets plus the tail: the
    duplicates fall into different scoring CTAs and must still come out
    in the plain version's order (hot rows ascending, then warm flat
    positions ascending), with every other row scoring below X . X."""
    g = torch.Generator(device=dev).manual_seed(21)
    D, Nh, cap, bucket = 64, 200, 512, 256
    x = torch.full((D,), 0.5, device=dev)         # X . X = 16 > any other
    hot_keys = _dyadic(dev, g, Nh, D)
    hot_keys[[5, 70, 150]] = x
    hot = tiers.init_hot(Nh, D, dev)._replace(
        keys=hot_keys, valid=torch.ones(Nh, dtype=torch.bool, device=dev),
        tenants=torch.zeros(Nh, dtype=torch.int32, device=dev),
        value_ids=torch.arange(Nh, dtype=torch.int32, device=dev))
    keys = _dyadic(dev, g, cap, D)
    keys[[3, 100, 300, 450, 505]] = x             # 505: in the tail
    members = torch.arange(cap, dtype=torch.int32,
                           device=dev).reshape(2, bucket)
    warm = tiers.init_warm(cap, D, 2, bucket, dev)._replace(
        keys=keys, valid=torch.ones(cap, dtype=torch.bool, device=dev),
        tenants=torch.zeros(cap, dtype=torch.int32, device=dev),
        value_ids=torch.arange(1000, 1000 + cap, dtype=torch.int32,
                               device=dev),
        write_seq=torch.arange(1, cap + 1, dtype=torch.int32, device=dev),
        total=torch.tensor(cap, dtype=torch.int32, device=dev),
        cursor=torch.tensor(0, dtype=torch.int32, device=dev),
        centroids=torch.stack([x, -x]), members=members,
        indexed_total=torch.tensor(cap - 10, dtype=torch.int32,
                                   device=dev))
    warm = tiers.requantize(warm)
    q = torch.stack([x, x, hot_keys[0]])
    qt = torch.zeros(3, dtype=torch.int32, device=dev)
    qt[1] = 1                                      # no row of its tenant
    thr = torch.full((3,), 0.5, device=dev)
    s, vids, wslots, hslots, hot_hit, hit = _check(
        _args(hot, warm, q, qt, thr), k=8, n_probe=2, tail=12,
        quantized=quantized)
    assert vids[0, :3].tolist() == [5, 70, 150]
    assert int(hslots[0]) == 5 and bool(hot_hit[0])
    if not quantized:     # int8 rows of X are exact too, but rescaled
        assert wslots[0, 3:7].tolist() == [3, 100, 300, 450]
        assert vids[0, 7].item() == 1505          # the tail copy last
    assert not hit[1] and int(hslots[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [33, 40])
@pytest.mark.parametrize("quantized", [False, True])
def test_bucket_overlap_between_queries(dev, Q, quantized):
    """Four clusters, three probed per query: every bucket is probed by
    most of the Q queries, more than one 16-query tile of them, with Q
    not a multiple of the tile; single and E=3 forms against their plain
    versions."""
    g = torch.Generator(device=dev).manual_seed(30 + Q)
    hot, warm = _states(dev, g, K=4, bucket=160, cap=512)
    q, qt, thr = _queries(dev, g, Q, 64)
    src = torch.nonzero(warm.valid).squeeze(1)[:Q // 2]
    q[:Q // 2] = _unit(warm.keys[src] + 0.02 * torch.randn(
        Q // 2, 64, generator=g, device=dev))
    qt[:Q // 2] = warm.tenants[src]
    out = _check(_args(hot, warm, q, qt, thr), k=4, n_probe=3, tail=48,
                 quantized=quantized)
    assert out[5].any() and (out[2] >= 0).any()
    probes = torch.topk(q @ warm.centroids.T, 3).indices
    per_bucket = torch.bincount(probes.flatten(), minlength=4)
    assert int(per_bucket.max()) > kernel.QUERY_TILE
    ens, qe, w = _ensemble(dev, g, hot, warm, q, 3)
    _ens_check(_ens_args(hot, warm, ens, qe, w, qt, thr), k=4, n_probe=3,
               tail=48, quantized=quantized)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_ensemble_e1_equals_the_single_form_over_query_tiles(dev,
                                                             quantized):
    """E=1 at weight 1 through three 16-query tiles (Q = 33): every
    output equal to the single form's, scores bit for bit."""
    g = torch.Generator(device=dev).manual_seed(31)
    hot, warm = _states(dev, g, bucket=160)
    q, qt, thr = _queries(dev, g, 33, 64)
    ens = tiers.init_ensemble(1, hot, warm)
    kw = dict(k=3, n_probe=4, tail=48, quantized=quantized)
    a = ops.cascade_lookup(*_args(hot, warm, q, qt, thr), **kw)
    b = ops.ensemble_lookup(*_ens_args(hot, warm, ens, q[None],
                                       torch.ones(33, 1, device=dev), qt,
                                       thr), **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# cosine top-k
# ---------------------------------------------------------------------------

def _topk_check(q, keys, valid, k):
    before = ct_kernel.COUNTS["cosine_topk"]
    a = ct_ref.cosine_topk(q, keys, valid, k)
    b = ct_ops.cosine_topk(q, keys, valid, k)
    torch.cuda.synchronize()
    assert ct_kernel.COUNTS["cosine_topk"] == before + 1
    assert b[0].shape == a[0].shape == (q.shape[0], k)
    assert b[0].dtype == torch.float32 and b[1].dtype == torch.int32
    torch.testing.assert_close(b[0], a[0], rtol=0, atol=SCORE_ATOL)
    assert torch.equal(b[1], a[1])
    return b


def _panel(dev, g, Q, N, D, invalid=0.25):
    q = _unit(torch.randn(Q, D, generator=g, device=dev))
    keys = _unit(torch.randn(N, D, generator=g, device=dev))
    valid = torch.rand(N, generator=g, device=dev) >= invalid
    return q, keys, valid


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 37, 768])
@pytest.mark.parametrize("k", [1, 3, 4, 16])
def test_cosine_topk_matches_plain_version(dev, D, k):
    g = torch.Generator(device=dev).manual_seed(D * 10 + k)
    q, keys, valid = _panel(dev, g, 19, 3001, D)
    # near-copies of stored rows, so the top scores are far from ties
    q[:6] = _unit(keys[:6] + 0.05 * torch.randn(6, D, generator=g,
                                                 device=dev))
    s, i = _topk_check(q, keys, valid, k)
    assert (i[:6, 0] == torch.arange(6, device=dev, dtype=torch.int32))[
        valid[:6]].all()


@pytest.mark.cuda
def test_cosine_topk_ties_lowest_index_first(dev):
    D = 8
    a_key = torch.zeros(D, device=dev)
    a_key[:4] = 0.5
    b_key = a_key.clone()
    b_key[3] = -0.5
    keys = torch.stack([b_key, a_key, b_key, a_key, a_key, b_key, a_key])
    valid = torch.tensor([1, 1, 1, 0, 1, 1, 1], dtype=torch.bool,
                         device=dev)
    s, i = _topk_check(a_key[None].repeat(3, 1), keys, valid, 5)
    assert i[0].tolist() == [1, 4, 6, 0, 2]
    assert s[0].tolist() == [1.0, 1.0, 1.0, 0.5, 0.5]


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [0, 2])
def test_cosine_topk_fewer_valid_rows_than_k(dev, n_valid):
    """Masked rows fill the list with -1e30, lowest index first, each
    index once (the reference's plain version, lax.top_k)."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, keys, _ = _panel(dev, g, 5, 40, 16)
    valid = torch.zeros(40, dtype=torch.bool, device=dev)
    valid[[7, 30][:n_valid]] = True
    s, i = _topk_check(q, keys, valid, 4)
    masked = [r for r in range(40) if not bool(valid[r])][:4 - n_valid]
    for row in i.tolist():
        assert sorted(row[:n_valid]) == [7, 30][:n_valid]
        assert row[n_valid:] == masked
    assert (s[:, n_valid:] == ct_ref.NEG_INF).all()


@pytest.mark.cuda
def test_cosine_topk_empty_batch_and_small_panels(dev):
    g = torch.Generator(device=dev).manual_seed(12)
    q, keys, valid = _panel(dev, g, 3, 5, 24)
    before = ct_kernel.COUNTS["cosine_topk"]
    s, i = ct_ops.cosine_topk(q[:0], keys, valid, 2)
    assert s.shape == (0, 2) and i.shape == (0, 2)
    assert ct_kernel.COUNTS["cosine_topk"] == before
    _topk_check(q, keys, valid, 5)              # k == N
    _topk_check(q, keys[:1], valid[:1], 1)


@pytest.mark.cuda
def test_cosine_topk_scores_are_fp32_exact(dev):
    """Scores against a float64 recomputation: TF32 or bf16 anywhere
    would miss by ~1e-3."""
    g = torch.Generator(device=dev).manual_seed(13)
    q, keys, valid = _panel(dev, g, 33, 5000, 768)
    s, i = _topk_check(q, keys, valid, 4)
    exact = torch.einsum("qd,qkd->qk", q.double(),
                         keys[i.long()].double())
    torch.testing.assert_close(s.double(), exact, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,D", [
    (1, 31, 768),        # one query, less than one key tile
    (33, 4099, 768),     # a ragged query tile and key tile
    (65, 97, 37),        # two query tiles, D neither % 4 nor one chunk
    (130, 2050, 64),     # three query tiles, D one full chunk
    (64, 65536, 100),    # many key tiles a split, D % 64 != 0
])
def test_cosine_topk_ragged_across_tiles(dev, Q, N, D):
    g = torch.Generator(device=dev).manual_seed(Q + N + D)
    q, keys, valid = _panel(dev, g, Q, N, D)
    n = min(4, Q)                       # near-copies of the last rows
    q[:n] = _unit(keys[-n:] + 0.05 * torch.randn(n, D, generator=g,
                                                  device=dev))
    _topk_check(q, keys, valid, ct_kernel.max_k())
    _topk_check(q, keys, valid, 1)


@pytest.mark.cuda
def test_cosine_topk_split_with_no_valid_row(dev):
    """One split's rows are all invalid, and queries copy some of them:
    those rows score -1e30 and never beat a valid one."""
    g = torch.Generator(device=dev).manual_seed(15)
    Q, N, D = 64, 4096, 768
    q, keys, _ = _panel(dev, g, Q, N, D)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    qt, per_sm = ct_kernel.query_tile(), ct_kernel.blocks_per_sm(4)
    S, rows = ct_kernel.splits(Q, N, n_sm, qt,
                               ct_kernel.key_tile(Q, N, n_sm, qt, per_sm),
                               per_sm)
    assert S > 2
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    valid[rows:2 * rows] = False
    q[:8] = keys[rows:rows + 8]
    s, i = _topk_check(q, keys, valid, 4)
    assert not ((i >= rows) & (i < 2 * rows)).any()
    assert (s > -1.0).all()


@pytest.mark.cuda
def test_cosine_topk_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(14)
    q, keys, valid = _panel(dev, g, 3, 20, 16)
    with pytest.raises(ValueError, match="k="):
        ct_ops.cosine_topk(q, keys, valid, ct_kernel.max_k() + 1)
    with pytest.raises(ValueError, match="k=5"):
        ct_ops.cosine_topk(q, keys[:4], valid[:4], 5)
    with pytest.raises(ValueError, match="dtype"):
        ct_ops.cosine_topk(q, keys.half(), valid, 1)
    with pytest.raises(ValueError, match="dtype"):
        ct_ops.cosine_topk(q.double(), keys.bfloat16(), valid, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ct_ops.cosine_topk(q, torch.cat([keys, keys], 1)[:, ::2], valid, 1)
    with pytest.raises(ValueError, match="on cpu"):
        ct_ops.cosine_topk(q, keys, valid.cpu(), 1)
    with pytest.raises(ValueError, match="shape"):
        ct_ops.cosine_topk(q, keys, valid[:-1], 1)


# ---------------------------------------------------------------------------
# cosine top-k over bf16 keys (the tensor-core kernel) and mixed dtypes
# ---------------------------------------------------------------------------

def _mixed_check(q, keys, valid, k, count="cosine_topk_bf16"):
    """`_topk_check` for any dtype pair: the launch counted under the
    kernel the pair takes (bf16 keys: the tensor-core kernel; float32
    keys: the float32 kernel)."""
    before = dict(ct_kernel.COUNTS)
    a = ct_ref.cosine_topk(q, keys, valid, k)
    b = ct_ops.cosine_topk(q, keys, valid, k)
    torch.cuda.synchronize()
    assert ct_kernel.COUNTS[count] == before[count] + 1
    assert sum(ct_kernel.COUNTS.values()) == sum(before.values()) + 1
    assert b[0].shape == a[0].shape == (q.shape[0], k)
    assert b[0].dtype == torch.float32 and b[1].dtype == torch.int32
    torch.testing.assert_close(b[0], a[0], rtol=0, atol=SCORE_ATOL)
    assert torch.equal(b[1], a[1])
    return b


def _bf16_panel(dev, g, Q, N, D, q_dtype, invalid=0.25):
    q, keys, valid = _panel(dev, g, Q, N, D, invalid)
    n = min(4, Q, N)                    # near-copies of the last rows
    q[:n] = _unit(keys[-n:] + 0.05 * torch.randn(n, D, generator=g,
                                                  device=dev))
    return q.to(q_dtype), keys.bfloat16(), valid


Q_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=["f32q", "bf16q"])
@pytest.mark.parametrize("Q,N,D", [
    (1, 31, 768),        # one query, less than one key tile
    (33, 4099, 768),     # a ragged query tile and key tile
    (65, 97, 37),        # three query tiles, D odd (element copies)
    (17, 300, 64),       # D one stage of four k-steps
    (64, 65536, 100),    # many key tiles and splits, D % 8 != 0
    (70, 2050, 200),     # D % 8 == 0, off a stage of 64 columns
])
def test_cosine_topk_bf16_keys_ragged_across_tiles(dev, q_dtype, Q, N, D):
    g = torch.Generator(device=dev).manual_seed(Q + N + D)
    q, keys, valid = _bf16_panel(dev, g, Q, N, D, q_dtype)
    for k in (1, 4, ct_kernel.max_k()):
        _mixed_check(q, keys, valid, k)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=["f32q", "bf16q"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16])
def test_cosine_topk_bf16_keys_every_k(dev, q_dtype, k):
    g = torch.Generator(device=dev).manual_seed(40 + k)
    q, keys, valid = _bf16_panel(dev, g, 19, 3001, 768, q_dtype)
    _mixed_check(q, keys, valid, k)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=["f32q", "bf16q"])
@pytest.mark.parametrize("D", [2000, 3000])
def test_cosine_topk_bf16_keys_wider_than_a_slab(dev, q_dtype, D):
    """Past the staged queries' room (float32 q past D 768 at k <= 4,
    bf16 q past 2432) the kernel stages q in slabs, again for every key
    tile."""
    g = torch.Generator(device=dev).manual_seed(D)
    q, keys, valid = _bf16_panel(dev, g, 40, 700, D, q_dtype)
    for k in (1, 16):
        _mixed_check(q, keys, valid, k)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=["f32q", "bf16q"])
def test_cosine_topk_bf16_keys_ties_lowest_index_first(dev, q_dtype):
    D = 8
    a_key = torch.zeros(D, device=dev)
    a_key[:4] = 0.5
    b_key = a_key.clone()
    b_key[3] = -0.5
    keys = torch.stack([b_key, a_key, b_key, a_key, a_key, b_key, a_key])
    valid = torch.tensor([1, 1, 1, 0, 1, 1, 1], dtype=torch.bool,
                         device=dev)
    q = a_key[None].repeat(3, 1).to(q_dtype)
    s, i = _mixed_check(q, keys.bfloat16(), valid, 5)
    assert i[0].tolist() == [1, 4, 6, 0, 2]
    assert s[0].tolist() == [1.0, 1.0, 1.0, 0.5, 0.5]
    # ties across key tiles and splits: one key repeated over 3000 rows
    keys = a_key[None].repeat(3000, 1).bfloat16()
    valid = torch.ones(3000, dtype=torch.bool, device=dev)
    valid[:7] = False
    s, i = _mixed_check(q, keys, valid, 16)
    assert i[0].tolist() == list(range(7, 23))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=["f32q", "bf16q"])
@pytest.mark.parametrize("n_valid", [0, 2])
def test_cosine_topk_bf16_keys_fewer_valid_rows_than_k(dev, q_dtype,
                                                       n_valid):
    g = torch.Generator(device=dev).manual_seed(11)
    q, keys, _ = _panel(dev, g, 5, 40, 16)
    valid = torch.zeros(40, dtype=torch.bool, device=dev)
    valid[[7, 30][:n_valid]] = True
    s, i = _mixed_check(q.to(q_dtype), keys.bfloat16(), valid, 4)
    masked = [r for r in range(40) if not bool(valid[r])][:4 - n_valid]
    for row in i.tolist():
        assert sorted(row[:n_valid]) == [7, 30][:n_valid]
        assert row[n_valid:] == masked
    assert (s[:, n_valid:] == ct_ref.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=["f32q", "bf16q"])
def test_cosine_topk_bf16_keys_all_invalid_and_empty(dev, q_dtype):
    g = torch.Generator(device=dev).manual_seed(12)
    q, keys, _ = _bf16_panel(dev, g, 64, 256, 768, q_dtype)
    none = torch.zeros(256, dtype=torch.bool, device=dev)
    s, i = _mixed_check(q, keys, none, 4)
    assert (i == torch.arange(4, device=dev, dtype=torch.int32)).all()
    before = dict(ct_kernel.COUNTS)
    s, i = ct_ops.cosine_topk(q[:0], keys, none, 2)
    assert s.shape == (0, 2) and i.shape == (0, 2)
    assert ct_kernel.COUNTS == before
    _mixed_check(q[:3], keys[:5], none[:5], 5)      # k == N
    _mixed_check(q[:3], keys[:1], none[:1] | True, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=["f32q", "bf16q"])
@pytest.mark.parametrize("offset", [1, 4])
def test_cosine_topk_bf16_keys_misaligned_views(dev, q_dtype, offset):
    """Keys off their 16-byte alignment (by 2 or 8 bytes) and q by one
    element: the keys are copied element by element; q is read as it
    lies."""
    g = torch.Generator(device=dev).manual_seed(20 + offset)
    Q, N, D = 21, 1500, 768
    q, keys, valid = _bf16_panel(dev, g, Q, N, D, q_dtype)
    keys = torch.cat([keys.new_zeros(offset), keys.reshape(-1)])[
        offset:].reshape(N, D)
    q = torch.cat([q.new_zeros(1), q.reshape(-1)])[1:].reshape(Q, D)
    assert keys.data_ptr() % 16 and q.data_ptr() % 16
    assert not ct_kernel.mma_vector_loads(keys)
    _mixed_check(q, keys, valid, 4)


@pytest.mark.cuda
def test_cosine_topk_float32_q_is_split_in_three_terms(dev):
    """Scores of float32 q against bf16 keys: a float64 recomputation of
    q against the bf16 values within 1e-6 (float32 accuracy: one bf16
    term alone misses by ~1e-3; two by ~5e-7 on these random values, the
    next test's inputs by ~4e-6), and the split's float64 sum within 1e-7
    of it."""
    g = torch.Generator(device=dev).manual_seed(13)
    q, keys, valid = _bf16_panel(dev, g, 33, 5000, 768, torch.float32)
    s, i = _mixed_check(q, keys, valid, 4)
    kd = keys[i.long()].double()
    exact = torch.einsum("qd,qkd->qk", q.double(), kd)
    torch.testing.assert_close(s.double(), exact, rtol=0, atol=1e-6)
    three = sum(torch.einsum("qd,qkd->qk", t.double(), kd)
                for t in ct_ref.split_terms(q))
    torch.testing.assert_close(three, exact, rtol=0, atol=1e-7)


THIRD_TERM_ATOL = 1.5e-6   # three terms: ~5e-7 here; two: ~4e-6


def third_term_panel(Q=8, N=4096, D=768, seed=18):
    """float32 q whose third bf16 term is as large as it gets, each value
    hi + mid + lo with mid = 0.75 half an ulp of hi and lo = 0.75 half an
    ulp of mid, all of hi's sign (the three terms exact), and bf16 keys,
    random unit rows but for row j (N // Q) + 3, which is query j's hi:
    every lo term meets a key of its own sign, so a split into two terms
    misses that score by ~2^-18 (~4e-6), where three miss by float32's
    rounding only.  Returns (q (Q, D) float32, keys (N, D) bf16, rows),
    on the CPU, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Q, D))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    hi = torch.tensor(x, dtype=torch.float32).bfloat16().double().numpy()
    hi[hi == 0] = 2.0 ** -12
    e, sgn = np.floor(np.log2(np.abs(hi))), np.sign(hi)
    q = hi + sgn * 0.75 * 2.0 ** (e - 8) + sgn * 0.75 * 2.0 ** (e - 17)
    keys = rng.standard_normal((N, D))
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    rows = np.arange(Q) * (N // Q) + 3
    keys[rows] = hi
    return (torch.tensor(q, dtype=torch.float32),
            torch.tensor(keys, dtype=torch.float32).bfloat16(), rows)


def third_term_error(dev) -> float:
    """The largest |score - float64 score| of the kernel's top-4 on
    `third_term_panel`, once its indices equal the plain version's."""
    q, keys, _ = third_term_panel()
    q, keys = q.to(dev), keys.to(dev)
    valid = torch.ones(keys.shape[0], dtype=torch.bool, device=dev)
    s, i = ct_ops.cosine_topk(q, keys, valid, 4)
    want = ct_ref.cosine_topk(q, keys, valid, 4)
    torch.cuda.synchronize()
    assert torch.equal(i, want[1])
    exact = torch.einsum("qd,qkd->qk", q.double(), keys[i.long()].double())
    return float((s.double() - exact).abs().max())


@pytest.mark.cuda
def test_cosine_topk_float32_q_third_term_matters(dev):
    """On `third_term_panel` the kernel's top-1 is each query's own hi
    row, and its scores are within ``THIRD_TERM_ATOL`` of float64: a
    kernel built with two terms misses it (by ~4e-6)."""
    q, keys, rows = third_term_panel()
    valid = torch.ones(keys.shape[0], dtype=torch.bool, device=dev)
    s, i = _mixed_check(q.to(dev), keys.to(dev), valid, 4)
    assert i[:, 0].tolist() == rows.tolist()
    assert third_term_error(dev) <= THIRD_TERM_ATOL


@pytest.mark.cuda
def test_cosine_topk_bf16_q_with_float32_keys_is_widened(dev):
    """bf16 q with float32 keys: q widened on the device (exact) into the
    float32 kernel."""
    g = torch.Generator(device=dev).manual_seed(16)
    q, keys, valid = _panel(dev, g, 33, 4099, 768)
    q[:4] = _unit(keys[-4:] + 0.05 * torch.randn(4, 768, generator=g,
                                                  device=dev))
    for k in (1, ct_kernel.max_k()):
        _mixed_check(q.bfloat16(), keys, valid, k, count="cosine_topk")


@pytest.mark.cuda
def test_cosine_topk_bf16_keys_split_with_no_valid_row(dev):
    g = torch.Generator(device=dev).manual_seed(17)
    Q, N, D = 64, 65536, 768
    q, keys, valid = _bf16_panel(dev, g, Q, N, D, torch.float32, 0.0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    S, rows = ct_kernel.mma_splits(Q, N, n_sm, ct_kernel.mma_query_tile(4),
                                   ct_kernel.mma_key_tile(),
                                   ct_kernel.mma_blocks_per_sm())
    assert S > 2
    valid[rows:2 * rows] = False
    q[:8] = keys[rows:rows + 8].float()
    s, i = _mixed_check(q, keys, valid, 4)
    assert not ((i >= rows) & (i < 2 * rows)).any()
    assert (s > -1.0).all()


# ---------------------------------------------------------------------------
# contrastive forward and backward
# ---------------------------------------------------------------------------

def _pairs(dev, g, B, D, labels="mixed"):
    e1 = torch.randn(B, D, generator=g, device=dev)
    e2 = 0.6 * e1 + torch.randn(B, D, generator=g, device=dev)
    if labels == "mixed":
        lab = (torch.rand(B, generator=g, device=dev) < 0.5).int()
        lab[0] = 0
        lab[-1] = 1
    else:
        lab = torch.full((B,), int(labels == "pos"), dtype=torch.int32,
                         device=dev)
    return e1, e2, lab


def _contrastive_check(e1, e2, lab, margin=0.5, grad_rtol=0.0):
    """Components, loss and gradients of the kernels against the plain
    versions on the same CUDA tensors."""
    before = dict(cl_kernel.COUNTS)
    want = cl_ref.contrastive_components(e1, e2, lab, margin)
    got = cl_ops.contrastive_components(e1, e2, lab, margin)
    torch.testing.assert_close(torch.stack(got[:2]), torch.stack(want[:2]),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.stack(got[2:]), torch.stack(want[2:]),
                               rtol=0, atol=1e-6)
    a1, a2 = e1.clone().requires_grad_(), e2.clone().requires_grad_()
    plain = losses.online_contrastive_loss(a1, a2, lab, margin)
    p1, p2 = torch.autograd.grad(plain, (a1, a2))
    b1, b2 = e1.clone().requires_grad_(), e2.clone().requires_grad_()
    loss = cl_ops.online_contrastive_loss(b1, b2, lab, margin)
    k1, k2 = torch.autograd.grad(loss, (b1, b2))
    torch.cuda.synchronize()
    assert cl_kernel.COUNTS["contrastive_components"] == \
        before["contrastive_components"] + 2
    assert cl_kernel.COUNTS["contrastive_backward"] == \
        before["contrastive_backward"] + 1
    torch.testing.assert_close(loss, plain, rtol=1e-5, atol=0)
    torch.testing.assert_close(k1, p1, rtol=grad_rtol, atol=1e-6)
    torch.testing.assert_close(k2, p2, rtol=grad_rtol, atol=1e-6)
    return got, loss, k1, k2


@pytest.mark.cuda
@pytest.mark.parametrize("B,D", [(1, 8), (16, 768), (37, 37), (300, 64),
                                 (4096, 768), (4097, 768), (4097, 37)])
@pytest.mark.parametrize("labels", ["mixed", "pos", "neg"])
def test_contrastive_matches_plain_version(dev, B, D, labels):
    if B == 1 and labels == "mixed":
        labels = "pos"
    g = torch.Generator(device=dev).manual_seed(B + D)
    _contrastive_check(*_pairs(dev, g, B, D, labels))


@pytest.mark.cuda
def test_contrastive_one_class_components_keep_the_sentinels(dev):
    g = torch.Generator(device=dev).manual_seed(21)
    e1, e2, lab = _pairs(dev, g, 12, 32, "pos")
    got, loss, _, _ = _contrastive_check(e1, e2, lab)
    assert float(got[0]) == 0.0 and float(got[2]) == 1e9
    assert float(loss.detach()) > 0         # the fallback: every pair
    e1, e2, lab = _pairs(dev, g, 12, 32, "neg")
    got, _, _, _ = _contrastive_check(e1, e2, lab)
    assert float(got[1]) == 0.0 and float(got[3]) == -1e9


@pytest.mark.cuda
def test_contrastive_zero_rows_take_the_clamped_branch(dev):
    """|e1||e2| < 1e-9 clamps the denominator: d = 1 - <e1,e2>/1e-9 and
    dd/de1 = -e2/1e-9 (gradients of order 1e9, compared relatively)."""
    g = torch.Generator(device=dev).manual_seed(22)
    e1, e2, lab = _pairs(dev, g, 6, 16)
    e1[1] = 0.0                              # one zero row
    e1[2] = 0.0
    e2[2] = 0.0                              # both zero
    e1[3] *= 1e-6                            # tiny product
    e2[3] *= 1e-5
    _contrastive_check(e1, e2, lab, grad_rtol=1e-5)


def _online_loss_f64(e1, e2, lab, margin):
    """`core.losses.online_contrastive_loss` kept in float64."""
    num = (e1 * e2).sum(-1)
    den = e1.norm(dim=-1) * e2.norm(dim=-1)
    d = 1 - num / den.clamp_min(1e-9)
    pos, neg = lab == 1, lab == 0
    min_neg = torch.where(neg, d, 1e9).min()
    max_pos = torch.where(pos, d, -1e9).max()
    hp = pos & torch.where(neg.any(), d > min_neg, True)
    hn = neg & torch.where(pos.any(), d < max_pos, True)
    return ((d.square() * hp).sum()
            + ((margin - d).clamp_min(0).square() * hn).sum()) / len(d)


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["mixed", "pos"])
def test_contrastive_is_fp32_exact(dev, labels):
    """Loss and gradients against a float64 recomputation of the same
    masks (taken from the float64 distances; random inputs, no ties)."""
    g = torch.Generator(device=dev).manual_seed(23)
    e1, e2, lab = _pairs(dev, g, 64, 768, labels)
    b1, b2 = e1.clone().requires_grad_(), e2.clone().requires_grad_()
    loss = cl_ops.online_contrastive_loss(b1, b2, lab, 0.5)
    k1, k2 = torch.autograd.grad(loss, (b1, b2))
    d1, d2 = e1.double().requires_grad_(), e2.double().requires_grad_()
    exact = _online_loss_f64(d1, d2, lab, 0.5)
    x1, x2 = torch.autograd.grad(exact, (d1, d2))
    assert abs(float(loss.detach()) - float(exact.detach())) <= \
        1e-6 * max(1.0, float(exact.detach()))
    torch.testing.assert_close(k1.double(), x1, rtol=0, atol=1e-6)
    torch.testing.assert_close(k2.double(), x2, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_contrastive_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(24)
    e1, e2, lab = _pairs(dev, g, 4, 8)
    with pytest.raises(ValueError, match="empty"):
        cl_ops.online_contrastive_loss(e1[:0], e2[:0], lab[:0])
    with pytest.raises(ValueError, match="must both be"):
        cl_ops.online_contrastive_loss(e1, e2[:, :4], lab)
    with pytest.raises(ValueError, match="integer"):
        cl_ops.contrastive_components(e1, e2, lab.float())
    with pytest.raises(ValueError, match="labels"):
        cl_ops.contrastive_components(e1, e2, lab[:3])
    with pytest.raises(ValueError, match="on cpu"):
        cl_ops.contrastive_components(e1, e2, lab.cpu())


def _coresident_rows(dev):
    """Pairs the forward's co-resident grid covers at one row per warp."""
    n_sm, ctas = cl_kernel._device_limits(dev.index or 0)
    return n_sm * ctas * cl_kernel.WARPS


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["mixed", "neg"])
def test_contrastive_above_the_coresident_rows(dev, labels):
    """More pairs than the capped grid holds at one row per warp: warps
    take several rows each, on both sides of the grid barrier."""
    B = 2 * _coresident_rows(dev) + 5
    n_sm, ctas = cl_kernel._device_limits(dev.index or 0)
    grid, rows_per_warp = cl_kernel.geometry(B, n_sm, ctas)
    assert grid == n_sm * ctas and rows_per_warp == 3
    g = torch.Generator(device=dev).manual_seed(25)
    _contrastive_check(*_pairs(dev, g, B, 64, labels))


@pytest.mark.cuda
def test_contrastive_one_class_sentinels_across_ctas(dev):
    """A one-class batch on a grid of many CTAs keeps the +-1e9
    sentinels, as one CTA does."""
    g = torch.Generator(device=dev).manual_seed(26)
    for labels, zero, sentinel, value in (("pos", 0, 2, 1e9),
                                          ("neg", 1, 3, -1e9)):
        e1, e2, lab = _pairs(dev, g, 4097, 64, labels)
        got, _, _, _ = _contrastive_check(e1, e2, lab)
        assert float(got[zero]) == 0.0 and float(got[sentinel]) == value


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 4097])
def test_contrastive_graph_replays_equal_eager_calls(dev, B):
    """Twenty calls replayed from a CUDA graph give the components, the
    loss and the gradients of twenty eager calls, bit for bit (every sum
    runs in a fixed order)."""
    g = torch.Generator(device=dev).manual_seed(27)
    batches = [_pairs(dev, g, B, 768) for _ in range(20)]
    up = torch.full((), 0.75, device=dev)

    def calls():
        out = []
        for e1, e2, lab in batches:
            comps, loss, saved = cl_kernel.forward(e1, e2, lab, 0.5)
            out.append((comps, loss, *cl_kernel.backward(e1, e2, saved, up)))
        return out

    eager = [[t.clone() for t in ts] for ts in calls()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = calls()
    graph.replay()
    torch.cuda.synchronize()
    for want, got in zip(eager, replayed):
        for w, x in zip(want, got):
            assert torch.equal(w, x)


@pytest.mark.cuda
def test_contrastive_two_streams_in_flight(dev):
    """Calls on two streams at once each give their own batch's answer
    (every call has its own buffer of partials)."""
    g = torch.Generator(device=dev).manual_seed(28)
    batches = [_pairs(dev, g, 4097, 768, labels)
               for labels in ("mixed", "pos")]
    want = [torch.stack(cl_ref.contrastive_components(*b)) for b in batches]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(10):
        for i, (s, b) in enumerate(zip(streams, batches)):
            with torch.cuda.stream(s):
                got[i].append(cl_kernel.forward(*b, 0.5)[0])
    torch.cuda.synchronize()
    for w, outs in zip(want, got):
        for comps in outs:
            torch.testing.assert_close(comps[:2], w[:2], rtol=1e-5,
                                       atol=1e-6)
            torch.testing.assert_close(comps[2:], w[2:], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [768, 37])
def test_contrastive_pairs_that_are_not_hard_get_exact_zeros(dev, D):
    """A pair with coefficient 0 (here duplicates with e2 = e1, below
    min_neg, and distinct pairs with e2 = -e1, above max_pos) gets
    gradients of exactly 0, written without reading its rows: its rows
    hold NaN in the backward, which any read would carry into the
    gradient."""
    g = torch.Generator(device=dev).manual_seed(29)
    e1, e2, lab = _pairs(dev, g, 64, D)
    e2[:8], lab[:8] = e1[:8], 1
    e2[8:16], lab[8:16] = -e1[8:16], 0
    d = losses.cosine_distance(e1, e2)
    pos, neg = lab == 1, lab == 0
    hp = pos & (d > torch.where(neg, d, 1e9).min())
    hn = neg & (d < torch.where(pos, d, -1e9).max())
    zero = (2 * d * hp - 2 * (0.5 - d).clamp_min(0) * hn) == 0
    assert bool(zero[:16].all()) and int(zero.sum()) < 64
    _, _, saved = cl_kernel.forward(e1, e2, lab, 0.5)
    assert bool((saved[zero] == 0).all())
    assert bool((saved[~zero, 3] != 0).all())
    x1, x2 = e1.clone(), e2.clone()
    x1[zero] = float("nan")
    x2[zero] = float("nan")
    k1, k2 = cl_kernel.backward(x1, x2, saved, torch.ones((), device=dev))
    a1, a2 = e1.clone().requires_grad_(), e2.clone().requires_grad_()
    p1, p2 = torch.autograd.grad(
        losses.online_contrastive_loss(a1, a2, lab, 0.5), (a1, a2))
    torch.cuda.synchronize()
    assert bool((k1[zero] == 0).all()) and bool((k2[zero] == 0).all())
    torch.testing.assert_close(k1, p1, rtol=0, atol=1e-6)
    torch.testing.assert_close(k2, p2, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# flash attention and decode attention
# ---------------------------------------------------------------------------

ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
            torch.bfloat16: dict(atol=3e-2, rtol=0)}


def _flash_check(q, k, v, **kw):
    """q: (B, Sq, H, hd) and k, v: (B, Skv, KV, hd), model layout."""
    before = fa_kernel.COUNTS["flash_attention"]
    want = fa_ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), **kw).transpose(1, 2)
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.COUNTS["flash_attention"] == before + 1
    assert got.shape == want.shape and got.dtype == q.dtype
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[q.dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,causal,window", [
    (2, 4, 2, 100, 100, True, 0),       # GQA, ragged sequence
    (1, 4, 4, 64, 64, False, 0),        # bidirectional (encoder)
    (1, 4, 2, 200, 200, True, 48),      # sliding window
    (1, 2, 1, 130, 130, True, 0),       # MQA, ragged
    (2, 4, 4, 70, 70, False, 20),       # bidirectional window
    (1, 8, 2, 33, 80, True, 0),         # fewer queries than keys
])
def test_flash_attention_matches_plain_version(dev, dtype, hd, B, H, KV,
                                               Sq, Skv, causal, window):
    g = torch.Generator(device=dev).manual_seed(hd * 7 + Sq)
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=g, device=dev).to(dtype)
    _flash_check(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_strided_views_and_takes_a_scale(dev, dtype):
    """q, k, v as slices of one (B, S, 3, H, hd) projection: no copy is
    made, and ``scale`` replaces hd ** -0.5."""
    g = torch.Generator(device=dev).manual_seed(11)
    qkv = torch.randn(2, 77, 3, 4, 96, generator=g, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    _flash_check(q, k, v, causal=True, window=0)
    _flash_check(q * 96 ** -0.5, k, v, causal=True, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,causal,window", [
    (2, 4, 4, 1, 1, True, 0),           # one row: a 2-warp block
    (3, 4, 2, 17, 17, True, 0),         # a ragged 16-row warp tile
    (1, 8, 2, 33, 97, True, 0),         # 4 warps; Skv off the 64-row tile
    (1, 4, 1, 100, 100, True, 40),      # MQA, a window across tiles
    (2, 4, 4, 17, 130, False, 0),       # bidirectional, Sq < Skv
    (1, 6, 2, 33, 33, False, 9),        # bidirectional window
])
def test_flash_attention_bf16_tensor_core_edges(dev, hd, B, H, KV, Sq, Skv,
                                                causal, window):
    g = torch.Generator(device=dev).manual_seed(hd * 13 + Sq + Skv)
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, Skv, KV, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Skv, KV, hd, generator=g, device=dev).bfloat16()
    _flash_check(q, k, v, causal=causal, window=window)
    _flash_check(q, k, v, causal=causal, window=window, scale=0.3)


@pytest.mark.cuda
def test_flash_attention_bf16_refuses_misaligned_views(dev):
    """bf16 rows are copied 16 bytes at a time: a view whose strides or
    base pointer break that is refused, never sent to another kernel;
    the float32 kernel takes the same views."""
    g = torch.Generator(device=dev).manual_seed(16)
    wide = torch.randn(1, 8, 2, 66, generator=g, device=dev)
    flat = torch.randn(1 + 8 * 2 * 64, generator=g, device=dev)
    for x in (wide[..., :64], flat[1:].view(1, 8, 2, 64)):
        xb = _bf16_view(x)
        before = fa_kernel.COUNTS["flash_attention"]
        with pytest.raises(ValueError, match="aligned"):
            fa_ops.flash_attention(xb, xb, xb)
        assert fa_kernel.COUNTS["flash_attention"] == before
        _flash_check(x, x, x, causal=True)


def _acc_bf16_inputs(dev, dtype, B, H, KV, Sq, Skv, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, Skv, KV, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, Skv, KV, hd, generator=g, device=dev).to(dtype))


def _acc_bf16_check(q, k, v, **kw):
    """The bf16-accumulate mode against its plain version in that mode:
    max |diff| <= 2^-6 max|v|, mean |diff| <= 1/4 of the plain version's
    True-vs-False gap (`chip_smoke.py`'s bounds); one launch."""
    t = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = fa_ref.flash_attention(*t, acc_dtype=torch.bfloat16,
                                  **kw).transpose(1, 2).float()
    want32 = fa_ref.flash_attention(*t, **kw).transpose(1, 2).float()
    before = fa_kernel.COUNTS["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, acc_bf16=True, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.COUNTS["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.isfinite(got).all()
    err = (got.float() - want).abs()
    gap = float((want32 - want).abs().mean())
    assert float(err.max()) <= 2.0 ** -6 * float(v.float().abs().max())
    assert float(err.mean()) <= 0.25 * gap, (float(err.mean()), gap)


ACC_BF16_CASES = [
    (2, 4, 2, 100, 100, True, 0, 0),      # dense, GQA, ragged
    (1, 4, 4, 64, 64, False, 0, 0),       # dense, bidirectional
    (1, 4, 2, 200, 200, True, 48, 0),     # dense, sliding window
    (1, 8, 2, 33, 80, True, 0, 0),        # dense, fewer queries than keys
    (1, 4, 2, 300, 300, True, 0, 64),     # a chunk of one tile
    (1, 4, 2, 300, 300, True, 0, 100),    # chunks off the tiles, ragged
    (1, 4, 1, 300, 300, True, 70, 100),   # a window across chunks
    (2, 4, 4, 130, 130, False, 0, 48),    # bidirectional chunks
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,causal,window,kv_chunk",
                         ACC_BF16_CASES)
def test_flash_attention_acc_bf16_matches_plain_version(
        dev, dtype, hd, B, H, KV, Sq, Skv, causal, window, kv_chunk):
    q, k, v = _acc_bf16_inputs(dev, dtype, B, H, KV, Sq, Skv, hd,
                               hd * 5 + Sq + kv_chunk)
    _acc_bf16_check(q, k, v, causal=causal, window=window,
                    kv_chunk=kv_chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["one walk", "two walks"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,causal,window,kv_chunk",
                         ACC_BF16_CASES)
def test_flash_attention_acc_bf16_both_routes(
        dev, monkeypatch, route, hd, B, H, KV, Sq, Skv, causal, window,
        kv_chunk):
    """Each dense shape through both routes of the bf16 kernel, whichever
    `acc_bf16_route` picks: one walk keeping every tile a block walks, and
    two walks.  A chunked launch has two walks only: one walk forced on it
    is refused, with nothing launched."""
    w = fa_kernel.warps(Sq)
    need = fa_kernel.tiles_per_chunk(Sq, Skv, 16 * w, causal, window,
                                     kv_chunk)
    cap = need if route == "one walk" else 0
    r = fa_kernel.Route(w, fa_kernel.acc_bf16_smem(hd, w, kv_chunk > 0, cap),
                        cap)
    assert r.route == route and r.smem <= fa_kernel.SMEM_LIMIT
    monkeypatch.setattr(fa_kernel, "acc_bf16_route", lambda *a: r)
    q, k, v = _acc_bf16_inputs(dev, torch.bfloat16, B, H, KV, Sq, Skv, hd,
                               hd * 7 + Sq + kv_chunk)
    if kv_chunk and cap:
        before = fa_kernel.COUNTS["flash_attention"]
        with pytest.raises(RuntimeError, match="launch failed"):
            fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                   acc_bf16=True, kv_chunk=kv_chunk)
        assert fa_kernel.COUNTS["flash_attention"] == before
        return
    _acc_bf16_check(q, k, v, causal=causal, window=window,
                    kv_chunk=kv_chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,window,route", [
    # the longest one walk: the last 64-row block reaches 192 keys, the
    # buffer's ONE_WALK_TILES tiles
    (2, 4, 4, 192, 128, 0, "one walk"),
    # two walks over 5 tiles: the paired statistics step lacks a second
    (1, 4, 2, 300, 96, 0, "two walks"),
    # the reference's 1024-key chunks: whole chunks at hd 128, a ragged
    # last chunk of 77 keys, a window starting mid-chunk
    (1, 2, 2, 3072, 128, 0, "two walks"),
    (1, 2, 2, 4096 + 77, 96, 0, "two walks"),
    (1, 2, 1, 4096, 96, 1500, "two walks"),
])
def test_flash_attention_acc_bf16_route_edges(dev, B, H, KV, S, hd, window,
                                              route):
    chunk = fa_ref.kv_chunk_for(S, S)
    assert fa_kernel.acc_bf16_route(S, S, hd, True, window,
                                    chunk).route == route
    q, k, v = _acc_bf16_inputs(dev, torch.bfloat16, B, H, KV, S, S, hd,
                               S + hd + window)
    _acc_bf16_check(q, k, v, causal=True, window=window)


F32_EDGES = [
    (2, 4, 4, 1, 1, True, 0),           # one row: a 2-warp block
    (3, 4, 2, 16, 16, True, 0),         # one whole 16-row warp tile
    (3, 4, 2, 17, 17, True, 0),         # a ragged 16-row warp tile
    (2, 8, 8, 32, 32, True, 0),         # the largest 2-warp block
    (1, 8, 2, 33, 97, True, 0),         # 4 warps; Skv off the key tiles
    (1, 4, 1, 100, 100, True, 40),      # MQA, a window across tiles
    (2, 4, 4, 17, 130, False, 0),       # bidirectional, Sq < Skv
    (1, 6, 2, 33, 33, False, 9),        # bidirectional window
    (1, 8, 2, 100, 163, True, 0),       # GQA, 4 warps, Skv off the tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("acc_bf16", [False, True],
                         ids=["f32_acc", "acc_bf16"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,causal,window", F32_EDGES)
def test_flash_attention_f32_tensor_core_edges(dev, acc_bf16, hd, B, H, KV,
                                               Sq, Skv, causal, window):
    """Both float32 kernels (3xTF32) at Sq of 1, 16, 17, 32, 33 and 100
    (2- and 4-warp blocks, whole and ragged 16-row warp tiles), Skv off
    the key tiles, GQA, MQA and windows; the float32-accumulate kernel
    within ``ATTN_TOL``, the bf16-accumulate one within its bounds."""
    g = torch.Generator(device=dev).manual_seed(hd * 17 + Sq + Skv)
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev)
    k = torch.randn(B, Skv, KV, hd, generator=g, device=dev)
    v = torch.randn(B, Skv, KV, hd, generator=g, device=dev)
    for scale in (None, 0.3):
        kw = dict(causal=causal, window=window, scale=scale)
        if acc_bf16:
            _acc_bf16_check(q, k, v, kv_chunk=0, **kw)
        else:
            _flash_check(q, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("acc_bf16", [False, True],
                         ids=["f32_acc", "acc_bf16"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_f32_logits_near_50(dev, acc_bf16, hd):
    """|logits| up to ~50, where the split's small halves matter: one TF32
    product would move the logits by ~2^-11 of 50, 3xTF32 by ~2^-22."""
    g = torch.Generator(device=dev).manual_seed(50 + hd)
    q = 3.5 * torch.randn(2, 100, 4, hd, generator=g, device=dev)
    k = 3.5 * torch.randn(2, 100, 2, hd, generator=g, device=dev)
    v = torch.randn(2, 100, 2, hd, generator=g, device=dev)
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, :, :2], k) * hd ** -0.5
    assert 35 < float(s.abs().max()) < 90
    if acc_bf16:
        _acc_bf16_check(q, k, v, causal=True, window=0, kv_chunk=0)
        _acc_bf16_check(q, k, v, causal=True, window=0, kv_chunk=32)
    else:
        _flash_check(q, k, v, causal=True, window=0)


@pytest.mark.cuda
@pytest.mark.parametrize("acc_bf16", [False, True],
                         ids=["f32_acc", "acc_bf16"])
def test_flash_attention_f32_reads_misaligned_views(dev, acc_bf16):
    """float32 views whose base pointer or (b, s, h) strides are not
    16-byte aligned go through the kernels' 4-byte copies: the host picks
    them from the tensors (`aligned16`), and the results match."""
    g = torch.Generator(device=dev).manual_seed(61)
    wide = torch.randn(1, 70, 2, 66, generator=g, device=dev)
    flat = torch.randn(1 + 70 * 2 * 64, generator=g, device=dev)
    good = torch.randn(1, 70, 2, 64, generator=g, device=dev)
    for x in (wide[..., :64], flat[1:].view(1, 70, 2, 64)):
        assert not fa_kernel.aligned16(x)
        for q, k, v in ((x, x, x), (x, good, good), (good, good, x)):
            if acc_bf16:
                _acc_bf16_check(q, k, v, causal=True, window=0, kv_chunk=0)
                _acc_bf16_check(q, k, v, causal=True, window=0,
                                kv_chunk=16)
            else:
                _flash_check(q, k, v, causal=True, window=0)
    assert fa_kernel.aligned16(good)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["one walk", "two walks"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,causal,window,kv_chunk",
                         ACC_BF16_CASES)
def test_flash_attention_f32_acc_bf16_both_routes(
        dev, monkeypatch, route, hd, B, H, KV, Sq, Skv, causal, window,
        kv_chunk):
    """The float32 bf16-accumulate kernel through both routes at each
    dense shape (one walk keeping every tile a block walks, and two
    walks); a chunked launch has two walks only, and one walk forced on
    it is refused with nothing launched."""
    w = fa_kernel.warps(Sq)
    need = fa_kernel.tiles_per_chunk(Sq, Skv, 16 * w, causal, window,
                                     kv_chunk)
    cap = need if route == "one walk" else 0
    r = fa_kernel.Route(w, fa_kernel.f32_acc_bf16_smem(hd, w, cap), cap)
    assert r.route == route and r.smem <= fa_kernel.SMEM_LIMIT
    monkeypatch.setattr(fa_kernel, "acc_bf16_route", lambda *a: r)
    q, k, v = _acc_bf16_inputs(dev, torch.float32, B, H, KV, Sq, Skv, hd,
                               hd * 11 + Sq + kv_chunk)
    if kv_chunk and cap:
        before = fa_kernel.COUNTS["flash_attention"]
        with pytest.raises(RuntimeError, match="launch failed"):
            fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                   acc_bf16=True, kv_chunk=kv_chunk)
        assert fa_kernel.COUNTS["flash_attention"] == before
        return
    _acc_bf16_check(q, k, v, causal=causal, window=window,
                    kv_chunk=kv_chunk)


def _bf16_view(x):
    """A bf16 tensor with ``x``'s strides and element offset (a view of a
    bf16 copy of ``x``'s storage)."""
    base = torch.empty(x.untyped_storage().nbytes() // x.element_size(),
                       dtype=torch.bfloat16, device=x.device)
    return base.as_strided(x.shape, x.stride(), x.storage_offset())


@pytest.mark.cuda
def test_flash_attention_refuses_what_the_kernel_does_not_take(dev):
    q = torch.randn(1, 8, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="no key"):
        fa_ops.flash_attention(q, q[:, :4], q[:, :4], window=4)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(torch.randn(1, 8, 3, 32, device=dev), q, q)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.randn(1, 8, 2, 64, device=dev)[..., ::2]
        fa_ops.flash_attention(x, x, x)


def _decode_check(q, k, v, valid, **kw):
    """q: (B, H, hd); k, v: (B, L, KV, hd); valid: (B, L)."""
    before = da_kernel.COUNTS["decode_attention"]
    want = da_ref.decode_attention(q, k, v, valid, **kw)
    got = da_ops.decode_attention(q[:, None], k, v, valid, **kw)[:, 0]
    torch.cuda.synchronize()
    assert da_kernel.COUNTS["decode_attention"] == before + 1
    assert got.shape == want.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[q.dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("B,H,KV,L", [
    (2, 4, 2, 300),          # GQA, ragged L
    (1, 8, 1, 1000),         # MQA, long cache
    (3, 4, 4, 128),          # MHA
    (2, 40, 8, 77),          # G = 5, ragged
    (1, 32, 1, 64),          # MQA, G = 32
])
def test_decode_attention_matches_plain_version(dev, dtype, hd, B, H, KV, L):
    g = torch.Generator(device=dev).manual_seed(hd * 13 + L)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, L, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, L, KV, hd, generator=g, device=dev).to(dtype)
    valid = torch.rand(B, L, generator=g, device=dev) > 0.2
    _decode_check(q, k, v, valid)
    # a ring buffer holding the last W positions of a longer sequence
    cur, W = L + 37, min(L, 50)
    pos = torch.full((B, L), -1, device=dev)
    tail = torch.arange(cur - min(L, cur) + 1, cur + 1, device=dev)
    pos[:, tail % L] = tail
    ring = (pos >= 0) & (pos <= cur) & ((cur - pos) < W)
    _decode_check(q, k, v, ring, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_fully_masked_row_follows_plain_version(dev, dtype):
    """A row with no valid slot averages v over all L slots, as the
    reference's plain version (not its Pallas kernel, which also
    averages its padding)."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(2, 4, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 100, 2, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 100, 2, 64, generator=g, device=dev).to(dtype)
    valid = torch.ones(2, 100, dtype=torch.bool, device=dev)
    valid[1] = False
    _decode_check(q, k, v, valid)


@pytest.mark.cuda
def test_decode_attention_refuses_what_the_kernel_does_not_take(dev):
    k = torch.randn(1, 16, 2, 48, device=dev)
    valid = torch.ones(1, 16, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        da_ops.decode_attention(torch.randn(1, 1, 4, 48, device=dev), k, k,
                                valid)
    # any group width: 128 query heads on one KV head (8 mma tiles)
    k = torch.randn(1, 16, 1, 128, device=dev)
    q = torch.randn(1, 128, 128, device=dev)
    _decode_check(q, k, k, valid)
    _decode_check(q.bfloat16(), k.bfloat16(), k.bfloat16(), valid)
    with pytest.raises(ValueError, match="aligned"):
        kb = torch.randn(1 * 16 * 128 + 1, device=dev)[1:].view(1, 16, 1,
                                                                 128)
        da_ops.decode_attention(q[:, None, :4].contiguous(), kb, kb, valid)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da_ops.decode_attention(torch.randn(1, 1, 4, 128, device=dev).half(),
                                k.half(), k.half(), valid)
    with pytest.raises(ValueError, match="dtype"):
        da_ops.decode_attention(torch.randn(1, 1, 4, 128, device=dev), k, k,
                                valid.int())


@pytest.fixture
def many_sms(monkeypatch):
    """Make the decode wrapper see a card of 10,000 SMs, so that it cuts
    even a short cache into one-tile (64-row) splits and merges them."""
    monkeypatch.setattr(da_kernel, "_sm_count", lambda index: 10_000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [96, 128])
@pytest.mark.parametrize("H,KV", [(8, 8), (10, 2), (32, 1)])   # G 1, 5, 32
def test_decode_attention_split_edges(dev, many_sms, dtype, hd, H, KV):
    """Split-L flash-decoding at its edges: a ragged last split (L = 1000
    is 15 full 64-row splits and one of 40), a split whose every slot is
    masked, and a row whose every slot is masked (it averages v over all
    L slots in every split and in the merge), at G = 1 (row kernel), 5
    and 32 (the mma kernel in bf16)."""
    B, L = 3, 1000
    S, rows = da_kernel.splits(
        B, da_kernel.units(H, KV, da_kernel.uses_mma(dtype, H // KV)), L,
        da_kernel._sm_count(0))
    assert (S, rows) == (16, 64)
    g = torch.Generator(device=dev).manual_seed(hd + H)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, L, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, L, KV, hd, generator=g, device=dev).to(dtype)
    valid = torch.rand(B, L, generator=g, device=dev) > 0.3
    valid[0, 128:192] = False              # split 2 of row 0: all masked
    valid[0, 960:] = True                  # the ragged split, all live
    valid[1] = False                       # row 1: nothing valid
    valid[2, :960] = False                 # row 2: only the last split
    _decode_check(q, k, v, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_splits_agree_with_one_pass(dev, monkeypatch,
                                                     dtype):
    """The same call with the cache in one split and in 8 (merged) gives
    the same output within the attention tolerance."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(2, 40, 128, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 512, 8, 128, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 512, 8, 128, generator=g, device=dev).to(dtype)
    valid = torch.rand(2, 512, generator=g, device=dev) > 0.5
    outs = []
    for n_sm in (1, 10_000):
        monkeypatch.setattr(da_kernel, "_sm_count", lambda index: n_sm)
        outs.append(da_ops.decode_attention(q[:, None], k, v,
                                            valid)[:, 0].float())
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[1], outs[0], **ATTN_TOL[dtype])
