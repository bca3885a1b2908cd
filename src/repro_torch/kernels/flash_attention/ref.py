"""Plain torch version of blocked flash attention: masked softmax
attention, GQA-aware — the port of `repro/kernels/flash_attention/ref.py`
with the reference model's branch rule and accumulate dtypes
(`repro/models/attention.py` ``gqa_attention``).

Positions are implicit (query row i is position i, key row j position
j).  ``scale`` (default ``hd ** -0.5``) multiplies q after its cast to
float32, as the reference's kernel and plain version do; the decoder
scales q in its compute dtype itself and passes ``scale=1.0`` (see
`repro_torch.models.attention`).

The logits, their row max and the softmax denominator are float32.
``acc_dtype`` is the dtype of the weights and the PV sum (bfloat16 is
the config's ``attn_f32=False``), and ``kv_chunk`` picks the branch:

* 0, dense: ``w = softmax(s)`` rounded once to ``acc_dtype``, then
  ``w @ v`` in ``acc_dtype`` (one rounding of a float32 sum);
* C > 0, chunked: an online softmax over C-key chunks aligned to key 0,
  ``p = exp(s - m_new)`` in ``acc_dtype``, the denominator summed in
  float32 from the rounded ``p``, ``acc = acc * alpha + p @ v`` with
  every term and the sum in ``acc_dtype``, and ``acc / l`` at the end.

In float32 both branches compute one function; in bfloat16 they round
at different places, so the caller passes the reference's choice
(`kv_chunk_for`; ``None`` applies it without the dry-run's widening).
A bfloat16 product is a bfloat16 ``einsum`` (float32 sums, one rounding
of the result, on the CPU and on the card), so P is never widened to a
float32 copy, and ``exp`` writes the rounded P directly.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
CHUNK_THRESHOLD = 2048
KV_CHUNK = 1024


def kv_chunk_for(Sq: int, Skv: int, unroll: bool = False) -> int:
    """The reference's branch: 0 (dense) up to ``CHUNK_THRESHOLD`` keys or
    for a single query, else the chunk width — ``KV_CHUNK``, widened to
    ``ceil(Skv / 32)`` under ``unroll`` (the config's ``unroll_inner``)."""
    if Skv <= CHUNK_THRESHOLD or Sq <= 1:
        return 0
    return max(KV_CHUNK, -(-Skv // 32)) if unroll else KV_CHUNK


def position_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                  device=None, k0: int = 0) -> torch.Tensor:
    """(Sq, Skv) bool: which of the keys at positions k0 .. k0 + Skv - 1
    each query position sees."""
    row = torch.arange(Sq, device=device)[:, None]
    col = torch.arange(k0, k0 + Skv, device=device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= col <= row
    if window > 0:
        ok &= (row - col) < window
        if not causal:
            ok &= (col - row) < window
    return ok


def _exp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """exp in float32, rounded once to ``dtype`` as it is written (an
    ``out=`` write has no gradient: under autograd, a separate cast)."""
    if x.dtype == dtype:
        return torch.exp(x)
    if x.requires_grad and torch.is_grad_enabled():
        return torch.exp(x).to(dtype)
    return torch.exp(x, out=torch.empty_like(x, dtype=dtype))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, acc_dtype: torch.dtype = torch.float32,
                    kv_chunk: Optional[int] = None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd).  Returns (B, H, Sq,
    hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    if kv_chunk is None:
        kv_chunk = kv_chunk_for(Sq, Skv)
    qg = q.reshape(B, KV, G, Sq, hd).float() * scale
    if kv_chunk == 0:
        s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float())
        ok = position_mask(Sq, Skv, causal=causal, window=window,
                           device=q.device)
        s = torch.where(ok, s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(acc_dtype)
        o = torch.einsum("bkgqs,bksh->bkgqh", w, v.to(acc_dtype))
        return o.reshape(B, H, Sq, hd).to(q.dtype)

    m = l = acc = None
    for k0 in range(0, Skv, kv_chunk):
        k1 = min(k0 + kv_chunk, Skv)
        s = torch.einsum("bkgqh,bksh->bkgqs", qg, k[:, :, k0:k1].float())
        ok = position_mask(Sq, k1 - k0, causal=causal, window=window,
                           device=q.device, k0=k0)
        s = torch.where(ok, s, NEG_INF)
        m_new = s.amax(dim=-1)
        if m is not None:
            m_new = torch.maximum(m, m_new)
        p = _exp(s - m_new[..., None], acc_dtype)
        pv = torch.einsum("bkgqs,bksh->bkgqh", p,
                          v[:, :, k0:k1].to(acc_dtype))
        if m is None:             # the first chunk: l and acc start at 0
            l, acc = p.sum(dim=-1, dtype=torch.float32), pv
        else:
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, dtype=torch.float32)
            acc = acc * alpha[..., None].to(acc_dtype) + pv
        m = m_new
    o = acc.float() / l[..., None].clamp_min(1e-30)
    return o.reshape(B, H, Sq, hd).to(q.dtype)
