"""Dispatch for the online-contrastive loss.

Tensors on the CPU go to the plain torch versions (`ref.py`,
`core.losses`); tensors on a card go to the hand-written CUDA kernels
(`kernel.py`) or raise — there is no fallback from the card.

``online_contrastive_loss`` on CUDA tensors is a
``torch.autograd.Function``: the forward kernel computes the loss and
saves each pair's gradient scalars (zero for a pair that is not hard),
and the backward kernel turns the upstream gradient into dL/de1 and
dL/de2.  It is the training loss of `core.trainer` (the reference
trains through the jnp formulation and keeps its kernel forward-only;
the port routes training through the kernel, with the same value and
gradients).
"""
from __future__ import annotations

import torch

from repro_torch.core import losses as _losses
from repro_torch.kernels.contrastive import kernel as _kernel
from repro_torch.kernels.contrastive import ref as _ref


def _checked(e1, e2, labels):
    """float32 contiguous e1/e2 and int32 labels on one CUDA device."""
    if e1.device.type != "cuda":
        raise ValueError(f"contrastive kernels run on cpu or cuda tensors, "
                         f"got {e1.device}")
    if e1.dim() != 2 or e1.shape != e2.shape:
        raise ValueError(f"e1 {tuple(e1.shape)} and e2 {tuple(e2.shape)} "
                         "must both be (B, D)")
    B = e1.shape[0]
    if B == 0 or e1.shape[1] == 0:
        raise ValueError("empty batch: the loss is undefined for B == 0")
    if tuple(labels.shape) != (B,):
        raise ValueError(f"labels {tuple(labels.shape)}, expected ({B},)")
    for name, t in (("e2", e2), ("labels", labels)):
        if t.device != e1.device:
            raise ValueError(f"{name} on {t.device}, expected {e1.device}")
    if not (e1.dtype.is_floating_point and e2.dtype.is_floating_point):
        raise ValueError(f"e1/e2 must be floating point, got {e1.dtype}/"
                         f"{e2.dtype}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise ValueError(f"labels must be an integer tensor, got "
                         f"{labels.dtype}")
    return _as(e1, torch.float32), _as(e2, torch.float32), \
        _as(labels, torch.int32)


def _as(t, dtype):
    """``t`` as a contiguous ``dtype`` tensor, itself when it is one
    (the no-op conversions cost host time on every call)."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def contrastive_components(e1, e2, labels, margin: float = 0.5):
    """(pos_loss, neg_loss, min_neg, max_pos), 0-d float32 each — the TPU
    kernel's components: hard-pair masks against the batch statistics,
    no one-class fallback."""
    if e1.device.type == "cpu":
        return _ref.contrastive_components(e1, e2, labels, margin)
    comps, _, _ = _kernel.forward(*_checked(e1, e2, labels), margin)
    return tuple(comps.unbind())


class _OnlineContrastive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e1, e2, labels, margin):
        a, b, lab = _checked(e1, e2, labels)
        _, loss, saved = _kernel.forward(a, b, lab, margin)
        ctx.save_for_backward(a, b, saved)
        return loss

    @staticmethod
    def backward(ctx, upstream):
        a, b, saved = ctx.saved_tensors
        up = upstream.float().contiguous()
        g1, g2 = _kernel.backward(a, b, saved, up)
        return g1, g2, None, None


def online_contrastive_loss(e1, e2, labels, margin: float = 0.5):
    """Scalar loss identical to `core.losses.online_contrastive_loss`
    (hard pairs, fallback to every pair of a class when the other class
    is absent, divided by B), differentiable in e1 and e2."""
    if e1.device.type == "cpu":
        return _losses.online_contrastive_loss(e1, e2, labels, margin)
    return _OnlineContrastive.apply(e1, e2, labels, float(margin))
