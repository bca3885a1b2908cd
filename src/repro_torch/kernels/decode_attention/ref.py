"""Plain torch version of single-token GQA decode attention — the port
of `repro/kernels/decode_attention/ref.py`.

``scale`` (default ``hd ** -0.5``) multiplies q after its cast to
float32, as the reference's kernel and plain version do; the decoder
scales q in its compute dtype itself and passes ``scale=1.0`` (see
`repro_torch.models.attention`).  Masked slots score -1e30, so a row
whose every slot is masked averages v over all L slots, as the
reference's plain version does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(q, k, v, kv_valid, *, scale=None):
    """q: (B, H, hd) one query token; k, v: (B, L, KV, hd) cache;
    kv_valid: (B, L) bool.  Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgh,blkh->bkgl", qg, k.float())
    s = torch.where(kv_valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkh->bkgh", w, v.float())
    return o.reshape(B, H, hd).to(q.dtype)
