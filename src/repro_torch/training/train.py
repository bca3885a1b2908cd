"""The LM training step, the port of `repro/training/train.py`.

``make_train_step(model, update_fn)`` returns ``train_step(opt_state,
batch) -> (opt_state, metrics)``: ``LM.lm_loss`` and its gradients by
autograd (into each parameter's ``.grad``, cleared at the start of the
step and left there after it), then the optimizer's update, applied to
the model's parameters in place through the update function's
``in_place`` variant (``adamw``'s), so the step holds no whole-tree
temporaries.  Metrics are 0-d tensors (``loss``, ``nll``, ``aux``, and
the optimizer's ``grad_norm`` and ``lr``); the step reads none of them
back to the host.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.model import LM


def make_train_step(model: LM, update_fn: Callable):
    """batch: {"tokens": (B, S) int, ["frontend_embeds": (B, F, d)]}."""
    params = dict(model.named_parameters())

    def train_step(opt_state, batch: Dict):
        for p in params.values():
            p.grad = None
        loss, parts = model.lm_loss(batch["tokens"],
                                    batch.get("frontend_embeds"))
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        opt_state, opt_metrics = update_fn.in_place(grads, opt_state,
                                                    params)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()},
                   **opt_metrics}
        return opt_state, metrics

    return train_step


def make_eval_step(model: LM):
    @torch.no_grad()
    def eval_step(batch: Dict):
        loss, parts = model.lm_loss(batch["tokens"],
                                    batch.get("frontend_embeds"))
        return {"loss": loss, **parts}
    return eval_step
