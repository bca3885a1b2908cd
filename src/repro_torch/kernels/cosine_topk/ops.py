"""Dispatch for the cosine top-k lookup of the flat store.

Tensors on the CPU go to the plain torch version (`ref.py`); tensors on
a card go to a hand-written CUDA kernel (`kernel.py`) or raise — there
is no fallback from the card.  Both return the same pair, so
`core.store.query` is agnostic.  q and keys are each float32 or
bfloat16, in any combination, as the Pallas kernel takes them (it widens
both on load); the function is float32 sums of the products of their
values:

- float32 keys: the float32 FMA kernel (bf16 q is widened first, which
  is exact);
- bfloat16 keys: the bf16 tensor-core kernel, q bf16 as it is or float32
  split into three bf16 terms in the kernel (`ref.split_terms`) — what
  `store.query` passes for a bf16 store.

Any alignment is taken: the kernels copy 16 bytes at a time where D and
the base pointers allow it, and one element at a time otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_tensor
from repro_torch.kernels.cosine_topk import kernel as _kernel
from repro_torch.kernels.cosine_topk import ref as _ref

DTYPES = (torch.float32, torch.bfloat16)


def check_args(q, keys, valid, k: int, max_k: int) -> None:
    """Raise ValueError unless the kernels take these arguments: q (Q, D)
    and keys (N, D), each float32 or bfloat16, valid (N,) bool, all
    contiguous on q's device, and 1 <= k <= min(max_k, N).  Launches
    nothing, so it runs on CPU tensors too."""
    dev = q.device
    if q.dim() != 2 or keys.dim() != 2:
        raise ValueError(f"q {tuple(q.shape)} and keys {tuple(keys.shape)} "
                         "must be 2-d")
    Q, D = q.shape
    N = keys.shape[0]
    if not 1 <= k <= max_k:
        raise ValueError(f"k={k} outside the kernel's 1..{max_k}")
    if k > N:
        raise ValueError(f"k={k} exceeds the {N} key rows")
    for name, t in (("q", q), ("keys", keys)):
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernels take "
                             "float32 or bfloat16")
    for name, t, dt, shape in (("q", q, q.dtype, (Q, D)),
                               ("keys", keys, keys.dtype, (N, D)),
                               ("valid", valid, torch.bool, (N,))):
        check_tensor(name, t, dt, shape, dev)


def cosine_topk(q, keys, valid, k: int = 1):
    """q: (Q, D); keys: (N, D); valid: (N,) bool -> ((Q, k) scores,
    (Q, k) int32 indices); see `ref.cosine_topk`."""
    dev = q.device
    if dev.type == "cpu":
        return _ref.cosine_topk(q, keys, valid, k)
    if dev.type != "cuda":
        raise ValueError(f"cosine_topk runs on cpu or cuda tensors, got "
                         f"{dev}")
    check_args(q, keys, valid, k, _kernel.max_k())
    if keys.dtype == torch.bfloat16:
        return _kernel.launch_bf16(q, keys, valid, k)
    return _kernel.launch(q.float(), keys, valid, k)
