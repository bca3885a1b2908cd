"""Dispatch for flash attention (model layout in and out).

Tensors on the CPU go to the plain torch version (`ref.py`); tensors on
a card go to the hand-written CUDA kernel (`kernel.py`) or raise — there
is no fallback from the card.  The kernel takes float32 or bfloat16,
head widths 32, 64, 96 and 128, and any layout whose head axis is
contiguous: the (B, S, H, hd) tensors are read in place.  bfloat16
tensors also need 16-byte aligned base pointers and (b, s, h) strides
(its kernels copy rows with 16-byte ``cp.async`` only); the model's
separate q, k and v projections are.  float32 tensors take any such
view (their kernels copy 4 bytes at a time where 16 do not fit).  It
refuses a window that leaves some query row with no key in reach (Sq >=
Skv + W), where the plain version averages v over every key.  ``acc_bf16`` is the config's
``attn_f32=False`` (bf16 weights and PV sums, `ref.flash_attention`
with ``acc_dtype=torch.bfloat16``) and ``kv_chunk`` the reference's
branch (0 dense, else the chunk width; ``None``: `ref.kv_chunk_for`); in
float32 the kernel's one online softmax computes either branch.  The
kernel has no backward:
on a card it refuses inputs that require grad while autograd records
(`refuse_autograd`); the CPU path stays the differentiable plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, acc_bf16: bool = False,
                    kv_chunk: Optional[int] = None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd); see
    `ref.flash_attention` for the masks, ``scale`` and the branches."""
    dev = q.device
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    if kv_chunk is None:
        kv_chunk = _ref.kv_chunk_for(q.shape[1], k.shape[1])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if dev.type == "cpu":
        return _ref.flash_attention(
            qt, kt, vt, causal=causal, window=window, scale=scale,
            acc_dtype=torch.bfloat16 if acc_bf16 else torch.float32,
            kv_chunk=kv_chunk).transpose(1, 2)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, "
                         f"got {dev}")
    refuse_autograd("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Sq, H, hd), k and "
                         f"v {tuple(k.shape)}/{tuple(v.shape)} (B, Skv, KV, "
                         "hd)")
    B, Sq, H, _ = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _kernel.DTYPES:
        raise ValueError(f"flash_attention kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if hd not in _kernel.HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{_kernel.HEAD_DIMS}, got {hd}")
    if KV == 0 or H % KV or Skv == 0:
        raise ValueError(f"need Skv >= 1 and H={H} a multiple of KV={KV}")
    if kv_chunk < 0:
        raise ValueError(f"kv_chunk must be 0 (dense) or a width, got "
                         f"{kv_chunk}")
    if window > 0 and Sq >= Skv + window:
        raise ValueError(f"window {window} leaves query rows past "
                         f"{Skv + window - 1} with no key (Sq={Sq}, "
                         f"Skv={Skv})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{q.dtype} on {dev}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head axis is not contiguous")
        es = t.element_size()
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % _kernel.ALIGN
                or any(st * es % _kernel.ALIGN for st, n in
                       zip(t.stride()[:3], t.shape[:3]) if n > 1)):
            raise ValueError(
                f"{name} (bfloat16) is not {_kernel.ALIGN}-byte aligned: "
                f"base pointer {t.data_ptr()} and strides "
                f"{tuple(t.stride()[:3])} (elements) must be multiples of "
                f"{_kernel.ALIGN} bytes")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    _kernel.launch(qt, kt, vt, out.transpose(1, 2), causal=causal,
                   window=window, scale=scale, acc_bf16=acc_bf16,
                   kv_chunk=kv_chunk)
    return out
