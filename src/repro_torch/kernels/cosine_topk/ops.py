"""Dispatch for the cosine top-k lookup of the flat store.

Tensors on the CPU go to the plain torch version (`ref.py`); tensors on
a card go to the hand-written CUDA kernel (`kernel.py`) or raise — there
is no fallback from the card.  Both return the same pair, so
`core.store.query` is agnostic.  q and keys are both float32 (the
store's keys) or both bfloat16 (the reference kernel's bf16 panels);
the arithmetic is float32 either way, as the Pallas kernel converts on
load.  Any alignment is taken: the kernel moves 16 bytes (float32) or 8
bytes (bf16) a copy when D is a multiple of 4 and both base pointers are
aligned to that width, and one element a copy otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_tensor
from repro_torch.kernels.cosine_topk import kernel as _kernel
from repro_torch.kernels.cosine_topk import ref as _ref


def cosine_topk(q, keys, valid, k: int = 1):
    """q: (Q, D); keys: (N, D); valid: (N,) bool -> ((Q, k) scores,
    (Q, k) int32 indices); see `ref.cosine_topk`."""
    dev = q.device
    if dev.type == "cpu":
        return _ref.cosine_topk(q, keys, valid, k)
    if dev.type != "cuda":
        raise ValueError(f"cosine_topk runs on cpu or cuda tensors, got "
                         f"{dev}")
    if q.dim() != 2 or keys.dim() != 2:
        raise ValueError(f"q {tuple(q.shape)} and keys {tuple(keys.shape)} "
                         "must be 2-d")
    Q, D = q.shape
    N = keys.shape[0]
    if not 1 <= k <= _kernel.max_k():
        raise ValueError(f"k={k} outside the kernel's 1..{_kernel.max_k()}")
    if k > N:
        raise ValueError(f"k={k} exceeds the {N} key rows")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes float32 "
                         "or bfloat16")
    for name, t, dt, shape in (("q", q, q.dtype, (Q, D)),
                               ("keys", keys, q.dtype, (N, D)),
                               ("valid", valid, torch.bool, (N,))):
        check_tensor(name, t, dt, shape, dev)
    return _kernel.launch(q, keys, valid, k)
