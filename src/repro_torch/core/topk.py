"""Top-k with the reference's tie order, shared by the IVF index, the
tiers and the kernels' plain versions."""
from __future__ import annotations

import torch


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index — the order
    of ``jax.lax.top_k`` (``torch.topk`` promises none)."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]
