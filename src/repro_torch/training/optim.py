"""Adam/AdamW with global-norm clipping, as (init_fn, update_fn) pairs
over a dict of tensors — the port of `repro/training/optim.py`.

The arithmetic is the reference's, step for step: the clip scale is
``min(1, max_norm / max(norm, 1e-9))`` (not torch's
``max_norm / (norm + 1e-6)``), the moments update in float32 as
``b1 * m + (1 - b1) * g``, the bias corrections ``1 - b ** t`` are taken
in float32, eps sits outside the square root (``mhat / (sqrt(vhat) +
eps)``), and ``state_dtype`` stores the moments in another type (bf16
halves their memory).  Tensor lists go through the ``torch._foreach_*``
multi-tensor ops, so one update is a few launches, not a few per
parameter.

The clip of the paper's recipe (max_grad_norm 0.5, §3.2) is part of the
catastrophic-forgetting control, which is why it lives here.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: int
    m: Tensors
    v: Tensors


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d)."""
    leaves = [t.float() for t in tree.values()]
    if not leaves:
        return torch.zeros(())
    norms = torch._foreach_norm(leaves)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tree: Tensors, max_norm: float):
    """(tree scaled so its global norm is at most ``max_norm``, raw
    norm).  The scale stays on the tensors' device: no host sync."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    names = list(tree)
    scaled = torch._foreach_mul([tree[n] for n in names], scale)
    return dict(zip(names, scaled)), norm


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: Optional[float] = None,
          state_dtype: Optional[torch.dtype] = None):
    """Returns (init_fn, update_fn).

    ``update_fn(grads, state, params) -> (updates, new_state, metrics)``;
    apply with `apply_updates`.  ``lr`` is a float or ``step -> lr``.
    """
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init_fn(params: Tensors) -> AdamState:
        def zeros():
            return {n: torch.zeros_like(p, dtype=state_dtype or p.dtype)
                    for n, p in params.items()}
        return AdamState(step=0, m=zeros(), v=zeros())

    def update_fn(grads: Tensors, state: AdamState, params: Tensors):
        metrics = {}
        if max_grad_norm is not None:
            grads, raw_norm = clip_by_global_norm(grads, max_grad_norm)
            metrics["grad_norm"] = raw_norm
        names = list(params)
        step = state.step + 1
        t = torch.tensor(step, dtype=torch.float32)
        lr_t = torch.tensor(lr_fn(step), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)

        def f32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
            return [x.float() for x in ts]

        g = f32([grads[n] for n in names])
        m = torch._foreach_add(
            torch._foreach_mul(f32([state.m[n] for n in names]), b1),
            torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_add(
            torch._foreach_mul(f32([state.v[n] for n in names]), b2),
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        mhat = torch._foreach_div(m, bc1)
        vhat = torch._foreach_div(v, bc2)
        u = torch._foreach_div(
            mhat, torch._foreach_add(torch._foreach_sqrt(vhat), eps))
        if weight_decay:
            u = torch._foreach_add(
                u, torch._foreach_mul(f32([params[n] for n in names]),
                                      weight_decay))
        upd = torch._foreach_mul(u, -float(lr_t))
        updates = {n: x.to(params[n].dtype) for n, x in zip(names, upd)}
        new_m = {n: x.to(state.m[n].dtype) for n, x in zip(names, m)}
        new_v = {n: x.to(state.v[n].dtype) for n, x in zip(names, v)}
        metrics["lr"] = lr_t
        return updates, AdamState(step=step, m=new_m, v=new_v), metrics

    return init_fn, update_fn


def adam(lr, **kw):
    return adamw(lr, weight_decay=0.0, **kw)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``p += u`` for every leaf, in place (the reference returns new
    arrays; the port updates the model's parameters where they are)."""
    names = list(params)
    torch._foreach_add_([params[n] for n in names],
                        [updates[n].to(params[n].dtype) for n in names])
