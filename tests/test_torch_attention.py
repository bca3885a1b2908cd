"""Port parity for the two attention kernels' plain versions and the
decoder's use of them.

* ``flash_attention`` and ``decode_attention`` (the plain torch versions
  the port runs on the CPU, and holds its CUDA kernels to on the card)
  against the reference's Pallas kernels in interpret mode and against
  its plain versions, at every parameter row of the reference's own
  kernel tests, float32 at ``atol 2e-5, rtol 1e-4`` (the reference's
  tolerance), and a bf16 case at ``atol 3e-2`` (likewise).
* The ``scale=`` path — q scaled in bf16 first, the kernel's scale 1 —
  against the model path's ``gqa_attention`` in bf16, prefill and
  decode; both round where the reference's model rounds, so they agree
  to bf16's last place (``atol 1e-2, rtol 1e-2``: one bf16 step is
  2^-7 of the value).
* The bf16 flash kernel's numerics in plain torch (q, k, v in bf16,
  float32 scores and sums, the softmax weights rounded to bf16 before
  P V, as its tensor cores take them) against the float32-weight plain
  version, at ``chip_smoke.py``'s flash shapes scaled down: within its
  ``ATTN_TOL["bfloat16"]`` (each weight moves by at most 2^-9 of itself,
  so an output by at most ~2^-9 max|v|).
* A fully masked decode row against the reference's plain version (a
  mean over all slots), not its Pallas kernel (which also weighs in its
  padding).
* The decode mask the port builds from its cache against the mask the
  reference's ``_mask_logits`` applies, on caches both filled by their
  own prefill and decode steps, with a ring buffer and a window.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.decode_attention import kernel as jda_kernel
from repro.kernels.decode_attention import ref as jda_ref
from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import decode_step as jdecode_step
from repro.models import init_lm, split
from repro.models import prefill as jprefill
from repro.models.attention import _mask_logits, gqa_attention
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import LM, state_dict_from_reference
from repro_torch.models.attention import decode_mask, q_scale

F32 = dict(atol=2e-5, rtol=1e-4)
BF16_LAST = dict(atol=1e-2, rtol=1e-2)
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("B,H,KV,Sq,hd,causal,window,bq,bkv", [
    (2, 4, 2, 128, 64, True, 0, 64, 64),
    (1, 4, 4, 100, 32, True, 0, 32, 32),     # ragged seq -> padding
    (2, 8, 2, 64, 32, False, 0, 32, 32),     # encoder (bidirectional)
    (1, 4, 2, 128, 32, True, 48, 32, 32),    # sliding window
    (1, 2, 1, 96, 128, True, 0, 48, 24),     # MQA + uneven blocks
])
def test_flash_attention_matches_reference(B, H, KV, Sq, hd, causal, window,
                                           bq, bkv):
    rng = np.random.default_rng(Sq + hd)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sq, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sq, hd)).astype(np.float32)
    want_ref = jfa_ref.flash_attention(q, k, v, causal=causal, window=window)
    want_kernel = jfa_kernel.flash_attention(
        q, k, v, causal=causal, window=window, block_q=bq, block_kv=bkv,
        interpret=True)
    got = fa_ref.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **F32)
    # the dispatch takes the model layout (B, S, H, hd) and, for CPU
    # tensors, runs the plain version
    via_ops = fa_ops.flash_attention(
        _t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
        causal=causal, window=window)
    torch.testing.assert_close(via_ops.transpose(1, 2), got, rtol=0, atol=0)


def test_flash_attention_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want_ref = jfa_ref.flash_attention(jq, jk, jv, causal=True)
    want_kernel = jfa_kernel.flash_attention(jq, jk, jv, causal=True,
                                             block_q=32, block_kv=32,
                                             interpret=True)
    got = fa_ref.flash_attention(*(_t(x).to(torch.bfloat16)
                                   for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=3e-2)


def _flash_bf16_weights(q, k, v, *, causal, window, scale):
    """What the bf16 tensor-core kernel computes, in plain torch: q, k, v
    (B, H|KV, S, hd) as bf16, float32 scores times ``scale``, weights
    exp(s - row max) rounded to bf16 for P V, float32 row sums."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qg = q.bfloat16().float().reshape(B, KV, H // KV, Sq, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.bfloat16().float()) * scale
    ok = fa_ref.position_mask(Sq, Skv, causal=causal, window=window)
    s = torch.where(ok, s, fa_ref.NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgqs,bksh->bkgqh", e.bfloat16().float(),
                     v.bfloat16().float()) / e.sum(-1, keepdim=True)
    return o.reshape(B, H, Sq, hd).bfloat16()


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (2, 4, 4, 32, 96, True, 0),      # Phi-3-mini prefill (B=8, H=32)
    (1, 4, 4, 256, 96, True, 0),     # long prefill (S=2048)
    (1, 5, 1, 256, 128, True, 64),   # GQA window (H=40, KV=8, S=1024, W=256)
    (4, 3, 3, 32, 64, False, 0),     # bidirectional (B=64, H=12)
    (1, 4, 4, 77, 96, True, 0),      # ragged (B=3, S=77, H=32)
])
def test_bf16_softmax_weights_stay_within_the_bf16_tolerance(
        B, H, KV, S, hd, causal, window):
    rng = np.random.default_rng(S + hd + H)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((B, H, S, hd), (B, KV, S, hd),
                                     (B, KV, S, hd)))
    kw = dict(causal=causal, window=window)
    want = fa_ref.flash_attention(q, k, v, **kw)
    got = _flash_bf16_weights(q, k, v, scale=hd ** -0.5, **kw)
    tol = chip_smoke.ATTN_TOL["bfloat16"]
    err = (got.float() - want.float()).abs()
    assert (err <= tol["atol"] + tol["rtol"] * want.float().abs()).all(), \
        float(err.max())
    assert float(err.max()) > 0         # the rounding is there to see


@pytest.mark.parametrize("B,H,KV,L,hd,bl", [
    (2, 4, 2, 300, 64, 128),
    (1, 8, 1, 1000, 32, 256),   # MQA long cache
    (3, 4, 4, 128, 128, 64),
])
def test_decode_attention_matches_reference(B, H, KV, L, hd, bl):
    rng = np.random.default_rng(L + hd)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    valid = rng.random((B, L)) > 0.2
    want_ref = jda_ref.decode_attention(q, k, v, valid)
    want_kernel = jda_kernel.decode_attention(q, k, v, valid, block_l=bl,
                                              interpret=True)
    got = da_ref.decode_attention(_t(q), _t(k), _t(v),
                                  torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **F32)
    via_ops = da_ops.decode_attention(_t(q)[:, None], _t(k), _t(v),
                                      torch.as_tensor(valid))
    torch.testing.assert_close(via_ops[:, 0], got, rtol=0, atol=0)


def test_decode_attention_fully_masked_row_follows_plain_reference():
    """No valid slot: the reference's plain version averages v over all
    L slots (softmax of equal -1e30 logits); the port's follows it."""
    rng = np.random.default_rng(2)
    B, H, KV, L, hd = 2, 4, 2, 40, 32
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    valid = np.ones((B, L), bool)
    valid[1] = False
    want = np.asarray(jda_ref.decode_attention(q, k, v, valid))
    got = da_ref.decode_attention(_t(q), _t(k), _t(v),
                                  torch.as_tensor(valid)).numpy()
    np.testing.assert_allclose(got, want, **F32)
    mean_v = np.repeat(v[1].mean(0), H // KV, axis=0)
    np.testing.assert_allclose(got[1], mean_v, **F32)


def test_scale_argument_follows_the_model_path_in_bf16():
    """The decoder scales q in bf16 (`q_scale`) and passes ``scale=1.0``:
    the result is the reference model's ``gqa_attention`` (prefill: causal
    over implicit positions; decode: one query against a masked cache)."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 24, 4, 2, 96
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    pos = jnp.arange(S)
    want = gqa_attention(jq, jk, jv, q_pos=pos, kv_pos=pos, causal=True,
                         window=0)
    got = fa_ops.flash_attention(tq * q_scale(hd, tq.dtype), tk, tv,
                                 causal=True, scale=1.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_LAST)
    valid = rng.random((B, S)) > 0.3
    valid[:, 0] = True
    want = gqa_attention(jq[:, -1:], jk, jv, q_pos=jnp.asarray([S - 1]),
                         kv_pos=jnp.broadcast_to(pos[None], (B, S)),
                         causal=True, window=0,
                         kv_valid=jnp.asarray(valid), chunked=False)
    got = da_ops.decode_attention(tq[:, -1:] * q_scale(hd, tq.dtype), tk,
                                  tv, torch.as_tensor(valid), scale=1.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_LAST)


@pytest.mark.parametrize("window,prompt,cache_len", [
    (8, 10, 14),     # prompt longer than the window: ring buffer
    (0, 5, 12),      # full attention, cache larger than the prompt
    (4, 3, 12),      # window wider than the prompt, wraps while decoding
])
def test_decode_mask_matches_reference(window, prompt, cache_len):
    """Both sides fill their caches with their own prefill and decode
    steps from the same weights and tokens; after every step the port's
    slot positions equal the reference's and its mask equals the one
    ``_mask_logits`` applies to the reference's decode logits."""
    jcfg = jget_config("phi3-mini-3.8b").reduced(sliding_window=window)
    pcfg = get_config("phi3-mini-3.8b").reduced(sliding_window=window)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
    toks = np.random.default_rng(4).integers(
        0, pcfg.vocab_size, (2, prompt + 6)).astype(np.int32)
    _, js = jax.jit(jprefill, static_argnums=(1, 3))(
        pv, jcfg, toks[:, :prompt], cache_len)
    _, ps = lm.prefill(torch.as_tensor(toks[:, :prompt]), cache_len)
    step = jax.jit(jdecode_step, static_argnums=1)
    for t in range(prompt, prompt + 6):
        _, js = step(pv, jcfg, js, toks[:, t:t + 1])
        _, ps = lm.decode_step(ps, torch.as_tensor(toks[:, t:t + 1]))
        jpos = np.asarray(js["layers"]["pos0"]["pos"][0])
        ppos = ps["layers"][0]["pos"]
        np.testing.assert_array_equal(ppos.numpy(), jpos)
        # the mask the reference applied at this step (position t)
        scores = jnp.zeros((2, 1, 1, 1, jpos.shape[1]))
        jmask = np.asarray(_mask_logits(
            scores, jnp.asarray([t]), jnp.asarray(jpos), causal=True,
            window=window, kv_valid=jnp.asarray(jpos >= 0)))[:, 0, 0, 0] == 0
        np.testing.assert_array_equal(decode_mask(ppos, t, window).numpy(),
                                      jmask)
