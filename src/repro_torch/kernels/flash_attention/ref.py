"""Plain torch version of blocked flash attention: dense masked softmax
attention, GQA-aware — the port of
`repro/kernels/flash_attention/ref.py`.

Positions are implicit (query row i is position i, key row j position
j).  ``scale`` (default ``hd ** -0.5``) multiplies q after its cast to
float32, as the reference's kernel and plain version do; the decoder
scales q in its compute dtype itself and passes ``scale=1.0`` (see
`repro_torch.models.attention`).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def position_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                  device=None) -> torch.Tensor:
    """(Sq, Skv) bool: which key positions each query position sees."""
    row = torch.arange(Sq, device=device)[:, None]
    col = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= col <= row
    if window > 0:
        ok &= (row - col) < window
        if not causal:
            ok &= (col - row) < window
    return ok


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd).  Returns (B, H, Sq,
    hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, G, Sq, hd).float() * scale
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float())
    ok = position_mask(Sq, Skv, causal=causal, window=window,
                       device=q.device)
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", w, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)
