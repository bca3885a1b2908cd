"""Plain torch version of the cosine top-k lookup — the port of
`repro/kernels/cosine_topk/ref.py`.

Invalid rows score -1e30 and the k best come out in the order of
``jax.lax.top_k``: score descending, lowest index first among ties,
each index once (``torch.sort(stable=True)``; ``torch.topk`` promises no
order among ties).
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk_stable

NEG_INF = -1e30


def cosine_topk(q, keys, valid, k: int = 1):
    """q: (Q, D) unit-norm queries; keys: (N, D) unit-norm rows (each
    float32 or bfloat16, multiplied in float32 as the Pallas kernel does);
    valid: (N,) bool.  Returns (scores (Q, k) float32 desc, indices (Q, k)
    int32)."""
    scores = q.float() @ keys.float().T                    # (Q, N)
    scores = torch.where(valid[None, :], scores, NEG_INF)
    s, i = topk_stable(scores, k)
    return s, i.to(torch.int32)


def split_terms(q, terms: int = 3):
    """float32 q as ``terms`` bf16 tensors whose sum is q: hi = bf16(q),
    mid = bf16(q - hi), lo = bf16(q - hi - mid) (each subtraction exact,
    rounding to nearest even).  Three leave ~2^-24 |q|, two ~2^-17: the
    bf16-key kernel's split of float32 queries, each term's product with
    a bf16 key exact in float32."""
    out, r = [], q.float()
    for _ in range(terms):
        t = r.bfloat16()
        out.append(t)
        r = r - t.float()
    return out
