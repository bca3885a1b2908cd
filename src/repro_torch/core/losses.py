"""Contrastive objectives for duplicate-query embedding fine-tuning —
the port of `repro/core/losses.py`, in plain torch with autograd.

``online_contrastive_loss`` is the paper's training objective
(sentence-transformers' OnlineContrastiveLoss): within each batch only
the *hard* pairs contribute — duplicate pairs whose cosine distance
exceeds the smallest negative distance, and distinct pairs whose
distance is below the largest positive distance.  As in the reference
it is written with static-shape masked reductions (no boolean
indexing), falls back to every pair of a class when the other class is
absent, and divides by the batch size.  It is the contrastive kernel's
plain version for training: `kernels.contrastive.ops` routes CUDA
tensors through the kernel and CPU tensors here.
"""
from __future__ import annotations

import torch

BIG = 1e9


def cosine_distance(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity, in float32.  e1, e2: (B, D)."""
    e1 = e1.float()
    e2 = e2.float()
    num = (e1 * e2).sum(dim=-1)
    den = torch.linalg.vector_norm(e1, dim=-1) \
        * torch.linalg.vector_norm(e2, dim=-1)
    return 1.0 - num / torch.clamp(den, min=1e-9)


def contrastive_loss(e1, e2, labels, margin: float = 0.5) -> torch.Tensor:
    """Classic (non-online) contrastive loss — every pair contributes."""
    d = cosine_distance(e1, e2)
    lab = labels.float()
    pos = lab * d.square()
    neg = (1.0 - lab) * torch.clamp(margin - d, min=0.0).square()
    return 0.5 * (pos + neg).mean()


def online_contrastive_loss(e1, e2, labels,
                            margin: float = 0.5) -> torch.Tensor:
    """Hard-pair-mined contrastive loss (static-shape formulation).

    e1, e2: (B, D) embeddings of the two queries of each pair; labels:
    (B,) 1 = duplicate, 0 = distinct.
    """
    d = cosine_distance(e1, e2)                          # (B,)
    is_pos = labels.bool()
    is_neg = ~is_pos
    any_pos = is_pos.any()
    any_neg = is_neg.any()
    min_neg = torch.where(is_neg, d, BIG).min()          # no gradient:
    max_pos = torch.where(is_pos, d, -BIG).max()         # they only select
    hard_pos = is_pos & torch.where(any_neg, d > min_neg, True)
    hard_neg = is_neg & torch.where(any_pos, d < max_pos, True)
    pos_loss = (d.square() * hard_pos.float()).sum()
    neg_loss = (torch.clamp(margin - d, min=0.0).square()
                * hard_neg.float()).sum()
    return (pos_loss + neg_loss) / d.shape[0]


@torch.no_grad()
def hard_pair_fractions(e1, e2, labels, margin: float = 0.5) -> dict:
    """Diagnostics: the fraction of each class that is 'hard'."""
    d = cosine_distance(e1, e2)
    is_pos = labels.bool()
    is_neg = ~is_pos
    min_neg = torch.where(is_neg, d, BIG).min()
    max_pos = torch.where(is_pos, d, -BIG).max()
    hp = (is_pos & (d > min_neg)).sum() / torch.clamp(is_pos.sum(), min=1)
    hn = (is_neg & (d < max_pos)).sum() / torch.clamp(is_neg.sum(), min=1)
    return {"hard_pos_frac": hp, "hard_neg_frac": hn}
