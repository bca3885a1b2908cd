"""``attn_f32=False`` on the port's serving attention against the
reference: the flash kernel's plain version in its bf16-accumulate mode
(`kernels/flash_attention/ref.py`) against the reference model's
``gqa_attention(acc_dtype=bfloat16)``, dense and chunked; the port's
``Attention.prefill`` / ``forward`` / ``decode`` against ``apply_prefill``
/ ``apply_full`` / ``apply_decode``; and a reduced Phi-3-mini ``LM``'s
prefill and decode logits.  Tiny heads (H = 2, KV = 1, hd = 32), weights
carried across from the reference's ``init_lm``, inputs from numpy.

The bounds.  Both sides round to bf16 at the same places (the weights,
v, the PV sums and, chunked, the carried accumulator); they differ only
where float32 sums taken in another order, or an ``exp`` a few float32
ulps apart, land on the other side of a bf16 rounding boundary.  Such a
flip moves a weight by one bf16 ulp (2^-8 relative) or an output by one
ulp of its magnitude, and an attention output is a convex combination
of v's rows, so |o| <= max|v| and one flipped output is off by at most
2^-8 max|v|; the chunked accumulator can carry one flip per chunk into
the next (each wiped to 2^-8 relative by the next rounding), so a few
ulps at most: max |diff| <= 2^-6 max|v| (after the output projection,
max|v| is taken as the reference output's own max, its scale).  Flips
are rare (at most a fraction of a percent of entries), while turning
the flag on rounds every weight and, in float32, every v: so the mean
|diff| must stay under a quarter of the mean |ref(True) - ref(False)|
on the same inputs, which a port that ignored the flag (or rounded
elsewhere) fails.  Decode has no bf16 mode in the reference
(``apply_decode`` passes no ``acc_dtype``), so there the port's decode
is bit-equal across the flag instead, and so is the reference's.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import init_lm, split
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import LM, state_dict_from_reference
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players

H, KV, HD = 2, 1, 32
MAX_REL = 2.0 ** -6
MEAN_SHARE = 0.25
# `test_torch_decoder.py`'s float32 logit tolerance
TOL = {"float32": dict(atol=2e-4, rtol=1e-3)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _check(got, want, want_f32, scale, what):
    """max |got - want| <= 2^-6 scale; mean |got - want| <= 1/4 mean
    |want_f32 - want| (the flag's own effect on the reference)."""
    got, want, want_f32 = _np(got), _np(want), _np(want_f32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want)
    gap = float(np.abs(want_f32 - want).mean())
    assert gap > 0, f"{what}: the flag changed nothing in the reference"
    assert float(err.max()) <= MAX_REL * scale, \
        (what, float(err.max()), scale)
    assert float(err.mean()) <= MEAN_SHARE * gap, \
        (what, float(err.mean()), gap)


def _qkv(seed, S, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, n, HD)).astype(np.float32)
            for n in (H, KV, KV)]


def _jref(q, k, v, dtype, causal, window, acc):
    jd = jnp.dtype(dtype)
    pos = jnp.arange(q.shape[1])
    return jattn.gqa_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        q_pos=pos, kv_pos=pos, causal=causal, window=window,
        acc_dtype=acc)


# (name, S, causal, window): dense up to 2048 keys, chunked above (a
# ragged last chunk of 1 and of 52 keys)
REF_CASES = (("dense 32", 32, True, 0),
             ("dense 77", 77, True, 0),
             ("dense window S > 2W", 77, True, 16),
             ("dense bidirectional", 77, False, 0),
             ("chunked 2049", 2049, True, 0),
             ("chunked 2100", 2100, True, 0),
             ("chunked 2100 window", 2100, True, 700))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_plain_flash_bf16_matches_reference_gqa_attention(case, dtype):
    """(i) ``ref.flash_attention(acc_dtype=bf16)`` with the reference's
    branch (`kv_chunk_for`) against ``gqa_attention(acc_dtype=bf16)``.
    The plain version is handed q scaled by the port's own `q_scale` in
    q's dtype and ``scale=1``, as the model calls it."""
    _, S, causal, window = case
    q, k, v = _qkv(7, S, dtype)
    want = _jref(q, k, v, dtype, causal, window, jnp.bfloat16)
    want32 = _jref(q, k, v, dtype, causal, window, jnp.float32)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    assert flash_ref.kv_chunk_for(S, S) == (1024 if S > 2048 else 0)
    got = flash_ops.flash_attention(tq * pattn.q_scale(HD, td), tk, tv,
                                    causal=causal, window=window, scale=1.0,
                                    acc_bf16=True)
    assert got.dtype == td
    _check(got, want, want32, float(np.abs(_np(tv)).max()), case[0])


@pytest.mark.parametrize("hd", [64, 96, 128])
def test_bf16_q_is_scaled_as_the_reference_scales_it(hd):
    """The reference multiplies bf16 q by the weakly typed ``hd ** -0.5``,
    which takes q's dtype (rounded to bf16 first); the port's `q_scale`,
    as ``Attention`` and `gqa_attention` apply it, gives the same bf16
    values bit for bit at every published head width (the float32 scale
    differs at hd 96 and 128), and leaves float32 q as before."""
    x = np.random.default_rng(hd).standard_normal(4096).astype(np.float32)
    want = np.asarray((jnp.asarray(x, jnp.bfloat16) * hd ** -0.5)
                      .astype(jnp.float32))
    t = torch.from_numpy(x)
    got = (t.bfloat16() * pattn.q_scale(hd, torch.bfloat16)).float()
    np.testing.assert_array_equal(got.numpy(), want)
    unrounded = (t.bfloat16() * hd ** -0.5).float().numpy()
    assert (unrounded != want).any() == (hd != 64)
    np.testing.assert_array_equal(
        (t * pattn.q_scale(hd, torch.float32)).numpy(),
        (t * hd ** -0.5).numpy())


def test_plain_flash_float32_chunked_is_the_dense_function():
    """In float32 the chunked branch is the dense function (sums in
    another order): the flag-less plain version above 2048 keys keeps
    today's results within the kernels' float32 ``ATTN_TOL``."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 2100, "float32"))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    dense = flash_ref.flash_attention(*args, kv_chunk=0)
    chunked = flash_ref.flash_attention(*args)
    torch.testing.assert_close(chunked, dense, atol=2e-5, rtol=1e-4)


def test_bf16_products_round_once_on_the_cpu():
    """The plain version's bf16 products are bf16 einsums.  Measured
    here on the CPU, for XLA's einsum (the reference) and torch's (the
    port): each equals float32 sums of the bf16 operands rounded once to
    bf16, up to the order of the float32 sum — at most 0.1 % of entries
    differ, by one bf16 ulp."""
    rng = np.random.default_rng(0)
    p = rng.random((2, 1, 2, 77, 1024)).astype(np.float32)
    v = rng.standard_normal((2, 1, 1024, 32)).astype(np.float32)
    tp, tv = torch.from_numpy(p).bfloat16(), torch.from_numpy(v).bfloat16()
    once = torch.einsum("bkgqs,bksh->bkgqh", tp.float(), tv.float())
    once = _np(once.bfloat16())
    xla = _np(jnp.einsum("bkgqs,bksh->bkgqh", jnp.asarray(p, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16)).astype(jnp.float32))
    port = _np(torch.einsum("bkgqs,bksh->bkgqh", tp, tv))
    for name, got in (("xla", xla), ("torch", port)):
        off = got != once
        assert off.mean() <= 1e-3, (name, off.mean())
        ulp = 2.0 ** (np.floor(np.log2(np.abs(once[off]))) - 7)
        assert (np.abs(got - once)[off] <= ulp).all(), name


def _cfg(get, **kw):
    return get("phi3-mini-3.8b").reduced(n_heads=H, n_kv_heads=KV,
                                         head_dim=HD, **kw)


def _lm():
    jcfg = _cfg(jget_config, dtype="float32")
    pcfg = _cfg(get_config, dtype="float32")
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
    return jcfg, pv, lm.eval()


@pytest.fixture(scope="module")
def layer0():
    """Layer 0 of the reduced float32 Phi-3-mini: the reference's
    attention parameters, its config, and the port's module."""
    jcfg, pv, lm = _lm()
    p = jax.tree_util.tree_map(lambda a: a[0],
                               pv["layers"]["pos0"]["mixer"])
    return jcfg, p, lm.layers[0].attn, pv, lm


@contextlib.contextmanager
def _configured(jcfg, attn, **kw):
    """The reference's config and the port's module with ``kw`` set
    (``attn_f32``, ``sliding_window``), restored after."""
    saved = attn.cfg
    attn.cfg = saved.replace(**kw)
    try:
        yield jcfg.replace(**kw)
    finally:
        attn.cfg = saved


def _rope(attn, pos):
    return players.rope_frequencies(attn.cfg, torch.as_tensor(pos))


# (name, S, window): dense, the local-window branch (S > 2W: 3 query
# chunks of 32), chunked
LAYER_CASES = (("dense", 77, 0), ("window", 77, 32), ("chunked", 2100, 0))


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_attention_prefill_and_forward_match_reference(case, layer0):
    """(ii) layer 0's ``prefill`` against ``apply_prefill`` and
    ``forward`` (``forward_lm``'s path) against ``apply_full``, both at
    ``attn_f32=False``, float32 activations; the cache written by prefill
    within `test_torch_decoder.py`'s float32 tolerance of the
    reference's."""
    _, S, W = case
    jcfg, p, attn = layer0[:3]
    x = np.random.default_rng(5).standard_normal(
        (1, S, jcfg.d_model)).astype(np.float32) * 0.5
    pos = np.arange(S, dtype=np.int32)
    jx, jpos, tx = jnp.asarray(x), jnp.asarray(pos), torch.from_numpy(x)
    with _configured(jcfg, attn, sliding_window=W) as off:
        cache = jattn.init_cache(off, 1, S)
        want32, _ = jattn.apply_prefill(p, off, jx, jpos, cache)
        full32 = jattn.apply_full(p, off, jx, jpos)
    with _configured(jcfg, attn, sliding_window=W, attn_f32=False) as on:
        want, jcache = jattn.apply_prefill(p, on, jx, jpos, cache)
        full_want = jattn.apply_full(p, on, jx, jpos)
        pcache = pattn.init_cache(attn.cfg, 1, S, "cpu")
        with torch.no_grad():
            got = attn.prefill(tx, torch.from_numpy(pos), *_rope(attn, pos),
                               pcache)
            full = attn(tx, *_rope(attn, pos))
    _check(got, want, want32, float(np.abs(_np(want)).max()),
           f"prefill {case[0]}")
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(pcache[n]), _np(jcache[n]),
                                   **TOL["float32"])
    _check(full, full_want, full32, float(np.abs(_np(full_want)).max()),
           f"forward {case[0]}")


@pytest.mark.parametrize("W", [0, 32])
def test_decode_is_float32_under_either_flag(W, layer0):
    """(ii, iii) layer 0's ``decode`` after the 77-token prefill of (ii):
    equal to ``apply_decode`` at ``attn_f32=False`` within the float32
    tolerance of `test_torch_decoder.py`, bit-equal to the port's own
    decode at ``attn_f32=True``; the reference's ``apply_decode`` is
    equal across the flag too (it passes no ``acc_dtype``)."""
    jcfg, p, attn = layer0[:3]
    S, L = 77, 80
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, S, jcfg.d_model)).astype(np.float32) * 0.5
    xd = rng.standard_normal((1, 1, jcfg.d_model)).astype(np.float32) * 0.5
    pos = np.arange(S, dtype=np.int32)
    outs = {}
    for flag in (True, False):
        with _configured(jcfg, attn, sliding_window=W, attn_f32=flag) as jc:
            cache = jattn.init_cache(jc, 1, L)
            _, cache = jattn.apply_prefill(p, jc, jnp.asarray(x),
                                           jnp.asarray(pos), cache)
            jy, _ = jattn.apply_decode(p, jc, jnp.asarray(xd), S, cache)
            pc = pattn.init_cache(attn.cfg, 1, L, "cpu")
            with torch.no_grad():
                attn.prefill(torch.from_numpy(x), torch.from_numpy(pos),
                             *_rope(attn, pos), pc)
                written = {n: t.clone() for n, t in pc.items()}
                y = attn.decode(torch.from_numpy(xd), S,
                                *_rope(attn, [S]), pc)
        outs[flag] = (_np(jy), y, written)
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    # decode reads the cache prefill wrote, which the flag leaves alone
    for n in ("k", "v", "pos"):
        assert torch.equal(outs[True][2][n], outs[False][2][n]), n
    assert torch.equal(outs[True][1], outs[False][1])
    np.testing.assert_allclose(_np(outs[False][1]), outs[False][0],
                               **TOL["float32"])


def test_lm_prefill_and_decode_logits_match_reference(layer0):
    """(iv) reduced Phi-3-mini (2 layers, H = 2, KV = 1, hd = 32, float32
    activations) at ``attn_f32=False``: prefill logits under the bounds
    above, then 4 teacher-forced decode steps (float32 attention on both
    sides) within `test_torch_decoder.py`'s float32 tolerance.  Not in
    bf16 activations: there the model's other bf16 roundings (norms,
    projections, RoPE) already put the port's logits about
    as far from the reference's at ``attn_f32=True`` as the flag moves
    the reference's own, so no logit can show the flag; the plain flash
    version's bf16 case is held under the tight bounds in (i)."""
    jcfg, _, _, pv, lm = layer0
    on = jcfg.replace(attn_f32=False)
    toks = np.random.default_rng(1).integers(
        0, on.vocab_size, (2, 14)).astype(np.int32)
    want32, _ = jprefill(pv, jcfg, jnp.asarray(toks[:, :10]), 14)
    want, jstate = jprefill(pv, on, jnp.asarray(toks[:, :10]), 14)
    saved = [blk.attn.cfg for blk in lm.layers]
    for blk in lm.layers:
        blk.attn.cfg = blk.attn.cfg.replace(attn_f32=False)
    try:
        with torch.no_grad():
            got, state = lm.prefill(toks[:, :10], 14)
            _check(got, want, want32, float(np.abs(_np(want)).max()),
                   "lm prefill")
            for t in range(10, 14):
                want, jstate = jdecode_step(pv, on, jstate,
                                            jnp.asarray(toks[:, t:t + 1]))
                got, state = lm.decode_step(state, torch.from_numpy(
                    toks[:, t:t + 1]))
                np.testing.assert_allclose(_np(got), _np(want),
                                           **TOL["float32"])
    finally:
        for blk, cfg in zip(lm.layers, saved):
            blk.attn.cfg = cfg
