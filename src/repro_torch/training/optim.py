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

``update_fn.in_place(grads, state, params)`` is the same update applied
where the tensors are: the grads scaled in place, each parameter's
moments updated in place and its update added before the next parameter
is touched, so its temporaries are a few tensors of one parameter's size
(``update_fn`` builds each intermediate for the whole tree: at
Phi-3-mini's 3.72 B float32 parameters that is 14.9 GB a list, beside
59.6 GB of parameters, grads and moments).  Both run one helper's
``_foreach`` ops, ``update_fn`` on the whole tree's lists and
``in_place`` on one-parameter lists, so their numbers are equal bit for
bit on either device; ``make_train_step`` applies updates through
``in_place``.
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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Tensors, max_norm: float):
    """(tree scaled so its global norm is at most ``max_norm``, raw
    norm).  The scale stays on the tensors' device: no host sync."""
    norm = global_norm(tree)
    names = list(tree)
    scaled = torch._foreach_mul([tree[n] for n in names],
                                _clip_scale(norm, max_norm))
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

    def scalars(step: int):
        """(lr, bias corrections 1 - b ** step) in float32."""
        t = torch.tensor(step, dtype=torch.float32)
        lr_t = torch.as_tensor(lr_fn(step), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        return lr_t, bc1, bc2

    def adam_update(g, m, v, p, bc1, bc2, neg_lr):
        """The AdamW arithmetic on float32 lists: ``m`` and ``v`` are
        updated in place; returns the updates (float32, times -lr)."""
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        del gg
        u = torch._foreach_div(m, bc1)
        d = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(d)
        torch._foreach_add_(d, eps)
        torch._foreach_div_(u, d)
        del d
        if weight_decay:
            torch._foreach_add_(
                u, torch._foreach_mul([x.float() for x in p], weight_decay))
        torch._foreach_mul_(u, neg_lr)
        return u

    def update_fn(grads: Tensors, state: AdamState, params: Tensors):
        metrics = {}
        if max_grad_norm is not None:
            grads, raw_norm = clip_by_global_norm(grads, max_grad_norm)
            metrics["grad_norm"] = raw_norm
        names = list(params)
        step = state.step + 1
        lr_t, bc1, bc2 = scalars(step)

        def f32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
            return [x.to(torch.float32, copy=True) for x in ts]

        m = f32([state.m[n] for n in names])
        v = f32([state.v[n] for n in names])
        upd = adam_update([grads[n].float() for n in names], m, v,
                          [params[n] for n in names], bc1, bc2,
                          -float(lr_t))
        updates = {n: x.to(params[n].dtype) for n, x in zip(names, upd)}
        new_m = {n: x.to(state.m[n].dtype) for n, x in zip(names, m)}
        new_v = {n: x.to(state.v[n].dtype) for n, x in zip(names, v)}
        metrics["lr"] = lr_t
        return updates, AdamState(step=step, m=new_m, v=new_v), metrics

    @torch.no_grad()
    def in_place(grads: Tensors, state: AdamState, params: Tensors):
        """``update_fn`` + `apply_updates` in place: scales ``grads``,
        updates ``state.m`` / ``state.v`` and ``params`` where they are.
        Returns (the state, advanced a step; metrics)."""
        metrics = {}
        names = list(params)
        if max_grad_norm is not None:
            norm = global_norm(grads)
            torch._foreach_mul_([grads[n] for n in names],
                                _clip_scale(norm, max_grad_norm))
            metrics["grad_norm"] = norm
        step = state.step + 1
        lr_t, bc1, bc2 = scalars(step)
        for n in names:
            p, m, v = params[n], state.m[n], state.v[n]
            m32, v32 = [m.float()], [v.float()]    # m, v themselves in fp32
            u = adam_update([grads[n].float()], m32, v32, [p], bc1, bc2,
                            -float(lr_t))
            p.add_(u[0].to(p.dtype))
            if m32[0] is not m:
                m.copy_(m32[0])
            if v32[0] is not v:
                v.copy_(v32[0])
        metrics["lr"] = lr_t
        return AdamState(step=step, m=state.m, v=state.v), metrics

    update_fn.in_place = in_place
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
