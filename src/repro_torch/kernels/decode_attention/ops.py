"""Dispatch for single-token decode attention (model layout in and out).

Tensors on the CPU go to the plain torch version (`ref.py`); tensors on
a card go to the hand-written CUDA kernel (`kernel.py`) or raise — there
is no fallback from the card.  The kernel takes float32 or bfloat16,
head widths 32, 64, 96 and 128, any number of query heads per KV head,
and 16-byte aligned q, k and v (the decoder's caches and projections
are whole allocations).  The kernel has no backward: on a card it
refuses inputs that require grad while autograd records
(`refuse_autograd`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_tensor, refuse_autograd
from repro_torch.kernels.decode_attention import kernel as _kernel
from repro_torch.kernels.decode_attention import ref as _ref


def decode_attention(q, k, v, kv_valid, *, scale=None):
    """q: (B, 1, H, hd) one step (model layout); k, v: (B, L, KV, hd);
    kv_valid: (B, L) bool.  Returns (B, 1, H, hd); see
    `ref.decode_attention` for ``scale``."""
    dev = q.device
    q3 = q[:, 0]
    hd = q3.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    if dev.type == "cpu":
        return _ref.decode_attention(q3, k, v, kv_valid, scale=scale)[:, None]
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, "
                         f"got {dev}")
    refuse_autograd("decode_attention", q, k, v)
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, 1, H, hd) and k "
                         f"{tuple(k.shape)} (B, L, KV, hd)")
    B, H = q3.shape[:2]
    L, KV = k.shape[1], k.shape[2]
    if q.dtype not in _kernel.DTYPES:
        raise ValueError(f"decode_attention kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if hd not in _kernel.HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{_kernel.HEAD_DIMS}, got {hd}")
    if KV == 0 or H % KV or L == 0:
        raise ValueError(f"need L >= 1 and H={H} a multiple of KV={KV}")
    for name, t, dt, shape in (("q", q3, q.dtype, (B, H, hd)),
                               ("k", k, q.dtype, (B, L, KV, hd)),
                               ("v", v, q.dtype, (B, L, KV, hd)),
                               ("kv_valid", kv_valid, torch.bool, (B, L))):
        check_tensor(name, t, dt, shape, dev)
    for name, t in (("q", q3), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned: the kernel "
                             "copies cache rows in 16-byte chunks")
    return _kernel.launch(q3, k, v, kv_valid, scale)[:, None]
