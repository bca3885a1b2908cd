"""Plain torch version of the contrastive-components kernel — the port
of `repro/kernels/contrastive/ref.py`.

Returns the components (pos_loss_sum, neg_loss_sum, min_neg, max_pos)
with the TPU kernel's hard-pair masks and no one-class fallback; `ops`
assembles the training loss from them.  Labels are cast to bool
(nonzero is a duplicate), as the reference does; the CUDA kernel reads
1 as a duplicate and 0 as a distinct pair, which agrees on {0, 1}.
"""
from __future__ import annotations

import torch

from repro_torch.core.losses import BIG, cosine_distance


def contrastive_components(e1, e2, labels, margin: float = 0.5):
    d = cosine_distance(e1, e2)
    is_pos = labels.bool()
    is_neg = ~is_pos
    min_neg = torch.where(is_neg, d, BIG).min()
    max_pos = torch.where(is_pos, d, -BIG).max()
    hard_pos = is_pos & (d > min_neg)
    hard_neg = is_neg & (d < max_pos)
    pos_loss = (d.square() * hard_pos).sum()
    neg_loss = (torch.clamp(margin - d, min=0.0).square() * hard_neg).sum()
    return pos_loss, neg_loss, min_neg, max_pos
