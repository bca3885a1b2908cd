"""GQA/MQA attention: the training and encoder full sequence
(``forward_full``), the decoder's serving full sequence (``forward_lm``)
and prefill (with its KV-cache build), and single-token decode against a
(possibly ring-buffer) KV cache.

Order of operations follows the reference (`repro/models/attention.py`
``gqa_attention``, ``apply_full``, ``apply_prefill``, ``apply_decode``):
q is scaled by ``head_dim ** -0.5`` *in the compute dtype*, the scale
itself first rounded to that dtype as the reference's weakly typed
Python float is (`q_scale`: bf16 at hd 96 and 128), the logits,
their max and the softmax denominator run in float32, and the softmax
weights and the PV sum are float32 or, under ``attn_f32=False``, bf16
on every full-sequence path (dense up to ``CHUNK_THRESHOLD`` keys, above
it ``KV_CHUNK``-key chunks of an online softmax, each branch rounding
where the reference's does); the output is cast back.  Decode stays
float32 whatever ``attn_f32`` says, as the reference's ``apply_decode``
(it passes no ``acc_dtype``).  RoPE is applied to k before the cache
write, so decode needs no position recompute; the ring buffer stores
each slot's absolute position for masking.

* Training (``Attention.forward_full``, the reference's ``apply_full``,
  which ``LM.lm_loss`` runs) and the encoder's non-causal path are plain
  torch under autograd, as the reference leaves them to XLA: the masked
  `gqa_attention`, dense up to ``CHUNK_THRESHOLD`` keys and above it an
  online softmax over ``KV_CHUNK``-key chunks, and for a causal window
  shorter than half the sequence `local_window_attention`.  Neither side
  has a kernel with a backward; the serving kernels below refuse inputs
  that require grad.
* Causal or windowed attention over a sequence at serving time (prefill,
  ``forward_lm``) goes through `kernels.flash_attention.ops.flash_attention`
  with implicit positions — on a card the hand-written CUDA kernel — with
  the reference's branch (`kv_chunk_for`): in float32 the dense,
  chunked and local-window branches compute one function, and under
  ``attn_f32=False`` the kernel's bf16-accumulate mode rounds as the
  branch the reference takes (``local_window_attention``'s calls are
  dense).
* Decode builds one (B, L) mask ``(pos >= 0) & (pos <= cur) &
  (cur - pos < W)`` and goes through
  `kernels.decode_attention.ops.decode_attention`.

Both kernels cast q to float32 and then multiply by their ``scale``
argument (the reference's kernels do the same with ``hd ** -0.5``); the
decoder has already scaled q in the compute dtype by the rounded scale,
as the reference's model path does, and passes ``scale=1.0``.  In bf16
the two orders round differently at hd = 96 and 128, so the choice keeps
the model path's numbers.

Caches are updated in place (the reference returns new arrays): a
decode step writes one slot per layer instead of copying the cache.
"""
from __future__ import annotations

import struct
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.param import Initializer

CHUNK_THRESHOLD = 2048
KV_CHUNK = 1024
NEG_INF = -1e30


def q_scale(hd: int, dtype: torch.dtype) -> float:
    """``hd ** -0.5`` as the reference multiplies q by it: a weakly typed
    Python float takes q's dtype, so for bf16 q it is rounded to bf16 first
    (to nearest even; exact at hd 64, not at 96 or 128).  A Python float,
    so that fake and distributed tensors take it as they take a literal."""
    scale = hd ** -0.5
    if dtype != torch.bfloat16:
        return scale
    bits = struct.unpack("<I", struct.pack("<f", scale))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _mask_logits(scores: torch.Tensor, q_pos: torch.Tensor,
                 kv_pos: torch.Tensor, *, causal: bool, window: int,
                 kv_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """scores: (B, KV, G, Sq, Skv); q_pos: (Sq,) absolute positions;
    kv_pos: (Skv,) or (B, Skv); kv_valid: (B, Skv) bool or None.  Masked
    logits are set to ``NEG_INF`` (the reference's ``_mask_logits``)."""
    if not (causal or window > 0 or kv_valid is not None):
        return scores                 # nothing masked (the encoder)
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None]
    rel_q = q_pos[None, :, None]
    rel_k = kv_pos[:, None, :]
    ok = torch.ones((), dtype=torch.bool, device=scores.device)
    if causal:
        ok = ok & (rel_k <= rel_q)
    if window > 0:
        ok = ok & ((rel_q - rel_k) < window)
        if not causal:
            ok = ok & ((rel_k - rel_q) < window)
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, :]
    return torch.where(ok[:, None, None], scores, NEG_INF)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                  window: int, kv_valid: Optional[torch.Tensor] = None,
                  chunked: Optional[bool] = None,
                  acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Masked GQA attention in plain torch, differentiable: the
    reference's ``gqa_attention``.  q: (B, Sq, H, hd), k/v: (B, Skv, KV,
    hd) -> (B, Sq, H, hd) in q's dtype.

    q is scaled by ``hd ** -0.5`` in its own dtype (`q_scale`), the
    logits and their running max and denominator are float32, and
    ``acc_dtype`` is the dtype of the softmax weights and the PV
    accumulator (bf16 is the config's ``attn_f32=False``).  Above
    ``CHUNK_THRESHOLD`` keys (and more than one query) the keys are taken
    ``KV_CHUNK`` at a time with an online softmax, so the (Sq, Skv)
    logits never exist whole; the ragged last chunk is padded with
    position -1 and ``valid=False``.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = (q.reshape(B, Sq, KV, G, hd) * q_scale(hd, q.dtype)).float()
    if chunked is None:
        chunked = Skv > CHUNK_THRESHOLD and Sq > 1
    if not chunked:
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())
        s = _mask_logits(s, q_pos, kv_pos, causal=causal, window=window,
                         kv_valid=kv_valid)
        w = torch.softmax(s, dim=-1).to(acc_dtype)
        o = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(acc_dtype))
        return o.reshape(B, Sq, H, hd).to(q.dtype)

    C = KV_CHUNK
    n_chunks = -(-Skv // C)
    pad = n_chunks * C - Skv
    valid = kv_valid if kv_valid is not None else torch.ones(
        (B, Skv), dtype=torch.bool, device=q.device)
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None].expand(B, Skv)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
        valid = F.pad(valid, (0, pad), value=False)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=acc_dtype, device=q.device)
    for i in range(n_chunks):
        sl = slice(i * C, (i + 1) * C)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, k[:, sl].float())
        s = _mask_logits(s, q_pos, kv_pos[:, sl], causal=causal,
                         window=window, kv_valid=valid[:, sl])
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).to(acc_dtype)
        l = l * alpha + p.sum(dim=-1, dtype=torch.float32)
        acc = acc * alpha[..., None].to(acc_dtype) + torch.einsum(
            "bkgqs,bskh->bkgqh", p, v[:, sl].to(acc_dtype))
        m = m_new
    o = acc.float() / l[..., None].clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def local_window_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, positions: torch.Tensor,
                           window: int, causal: bool,
                           acc_dtype: torch.dtype = torch.float32,
                           q_chunk: int = 1024) -> torch.Tensor:
    """Sliding-window attention that gives each chunk of ``q_chunk``
    queries only its (window + chunk) keys, O(S W) instead of O(S^2) with
    masking: the reference's ``local_window_attention``.  The ragged last
    chunk's queries are padded (at the last position) and cut off."""
    B, S = q.shape[:2]
    C = min(q_chunk, S)
    nq = -(-S // C)
    pad = nq * C - S
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        positions = F.pad(positions, (0, pad), value=positions.shape[0] - 1)
    outs = []
    for iq in range(nq):
        q_lo = iq * C
        q_hi = min(q_lo + C, S)
        kv_lo = max(0, q_lo - window + 1)
        outs.append(gqa_attention(
            q[:, q_lo:q_lo + C], k[:, kv_lo:q_hi], v[:, kv_lo:q_hi],
            q_pos=positions[q_lo:q_lo + C], kv_pos=positions[kv_lo:q_hi],
            causal=causal, window=window, chunked=False,
            acc_dtype=acc_dtype))
    return torch.cat(outs, dim=1)[:, :S]


def kv_chunk_for(cfg: ModelConfig, Sq: int, Skv: int) -> int:
    """The reference's branch for a query block against ``Skv`` keys: 0
    (dense) up to ``CHUNK_THRESHOLD`` keys or for a single query, else
    the chunk width, ``KV_CHUNK`` widened to ``ceil(Skv / 32)`` under the
    config's ``unroll_inner`` (the dry-run's programs set it)."""
    if Skv <= CHUNK_THRESHOLD or Sq <= 1:
        return 0
    return max(KV_CHUNK, -(-Skv // 32)) if cfg.unroll_inner else KV_CHUNK


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    return min(cfg.sliding_window, seq_len) if cfg.sliding_window > 0 \
        else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device) -> Dict[str, torch.Tensor]:
    """Empty KV cache of one attention layer: k, v (B, L, KV, hd) in
    ``cfg.dtype`` and each slot's absolute position (B, L) int32, -1 for
    an empty slot."""
    L = cache_len_for(cfg, seq_len)
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full((batch, L), -1, dtype=torch.int32,
                              device=device)}


def decode_mask(pos: torch.Tensor, cur_len: int,
                window: int) -> torch.Tensor:
    """(B, L) bool: the cache slots the token at position ``cur_len``
    attends to — filled, not in its future, inside the window."""
    ok = (pos >= 0) & (pos <= cur_len)
    if window > 0:
        ok &= (cur_len - pos) < window
    return ok


class Attention(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        self.cfg = cfg
        self.wq = ini.lecun((h * hd, d), fan_in=d)
        self.wk = ini.lecun((kv * hd, d), fan_in=d)
        self.wv = ini.lecun((kv * hd, d), fan_in=d)
        self.wo = ini.lecun((d, h * hd), fan_in=h * hd)
        if cfg.qkv_bias:
            self.bq = ini.zeros((h * hd,))
            self.bk = ini.zeros((kv * hd,))
            self.bv = ini.zeros((kv * hd,))
        else:
            self.bq = self.bk = self.bv = None

    def _qkv(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
        """q (B, S, H, hd), k and v (B, S, KV, hd) in x's dtype, RoPE
        applied to q and k."""
        cfg = self.cfg
        B, S, _ = x.shape
        dt = x.dtype

        def proj(w, b, heads):
            y = F.linear(x, w.to(dt))
            if b is not None:
                y = y + b.to(dt)
            return y.reshape(B, S, heads, cfg.head_dim)

        q = proj(self.wq, self.bq, cfg.n_heads)
        k = proj(self.wk, self.bk, cfg.n_kv_heads)
        v = proj(self.wv, self.bv, cfg.n_kv_heads)
        if cfg.use_rope:
            q = layers.apply_rope(q, sin, cos)
            k = layers.apply_rope(k, sin, cos)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return F.linear(o.reshape(B, S, -1), self.wo.to(o.dtype))

    def _scaled(self, q: torch.Tensor) -> torch.Tensor:
        return q * q_scale(self.cfg.head_dim, q.dtype)

    def forward(self, x: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
        """Full sequence at serving time.  x: (B, S, d) in the compute
        dtype.  Causal or windowed attention goes through the flash
        kernel (no backward) with ``apply_full``'s branch: dense for a
        causal window W with S > 2W (``local_window_attention``'s calls),
        else as prefill; the encoder's bidirectional attention is
        `forward_full`'s."""
        cfg = self.cfg
        if not (cfg.causal or cfg.sliding_window):
            return self.forward_full(x, sin, cos)
        S, W = x.shape[1], cfg.sliding_window
        q, k, v = self._qkv(x, sin, cos)
        o = flash_ops.flash_attention(
            self._scaled(q), k, v, causal=cfg.causal, window=W, scale=1.0,
            acc_bf16=not cfg.attn_f32,
            kv_chunk=0 if W > 0 and cfg.causal and S > 2 * W
            else kv_chunk_for(cfg, S, S))
        return self._out(o)

    def forward_full(self, x: torch.Tensor, sin: torch.Tensor,
                     cos: torch.Tensor) -> torch.Tensor:
        """Full sequence in plain torch under autograd: the reference's
        ``apply_full`` (training, the encoder).  x: (B, S, d) at positions
        0..S-1.  A causal window W with S > 2W goes through
        `local_window_attention` (query chunks of min(1024, W)), anything
        else through the masked `gqa_attention`; ``attn_f32=False`` makes
        the softmax weights and the PV sum bf16.  The config's ``unroll``
        and ``unroll_inner`` are the reference's levers for XLA's cost
        analysis in its dry runs; they do not change the result and are
        ignored here."""
        cfg = self.cfg
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        q, k, v = self._qkv(x, sin, cos)
        acc = torch.float32 if cfg.attn_f32 else torch.bfloat16
        W = cfg.sliding_window
        if W > 0 and cfg.causal and S > 2 * W:
            o = local_window_attention(q, k, v, positions=positions,
                                       window=W, causal=True, acc_dtype=acc,
                                       q_chunk=min(1024, W))
        else:
            o = gqa_attention(q, k, v, q_pos=positions, kv_pos=positions,
                              causal=cfg.causal, window=W, acc_dtype=acc)
        return self._out(o)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                sin: torch.Tensor, cos: torch.Tensor,
                cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Causal attention over the prompt, and the cache filled in
        place: with L >= S slots the prompt's tokens in order, else the
        last L tokens at slots ``t % L`` (the ring buffer)."""
        cfg = self.cfg
        S = x.shape[1]
        L = cache["k"].shape[1]
        q, k, v = self._qkv(x, sin, cos)
        o = flash_ops.flash_attention(self._scaled(q), k, v, causal=True,
                                      window=cfg.sliding_window, scale=1.0,
                                      acc_bf16=not cfg.attn_f32,
                                      kv_chunk=kv_chunk_for(cfg, S, S))
        kd = cache["k"].dtype
        if L >= S:
            cache["k"][:, :S] = k.to(kd)
            cache["v"][:, :S] = v.to(kd)
            cache["pos"][:, :S] = positions.to(torch.int32)
            cache["pos"][:, S:] = -1
        else:
            tail = positions[S - L:]
            slots = tail % L
            cache["k"][:, slots] = k[:, S - L:].to(kd)
            cache["v"][:, slots] = v[:, S - L:].to(kd)
            cache["pos"][:, slots] = tail.to(torch.int32)
        return self._out(o)

    def decode(self, x: torch.Tensor, cur_len: int, sin: torch.Tensor,
               cos: torch.Tensor,
               cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One token at absolute position ``cur_len`` (the tokens already
        in the cache).  x: (B, 1, d).  Writes slot ``cur_len % L`` in
        place; past L without a window this wraps, as the reference.
        The weights and the PV sum are float32 under either ``attn_f32``,
        as the reference's ``apply_decode``."""
        L = cache["k"].shape[1]
        q, k, v = self._qkv(x, sin, cos)
        slot = cur_len % L
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = cur_len
        valid = decode_mask(cache["pos"], cur_len, self.cfg.sliding_window)
        o = decode_ops.decode_attention(self._scaled(q), cache["k"],
                                        cache["v"], valid, scale=1.0)
        return self._out(o)
