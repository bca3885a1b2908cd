"""GQA/MQA attention: the encoder's full sequence, the decoder's full
sequence (``forward_lm``) and prefill (with its KV-cache build), and
single-token decode against a (possibly ring-buffer) KV cache.

Order of operations follows the reference (`repro/models/attention.py`
``gqa_attention``, ``apply_full``, ``apply_prefill``, ``apply_decode``):
q is scaled by ``head_dim ** -0.5`` *in the compute dtype*, the logits
and the softmax run in float32 (``attn_f32``), the PV product
accumulates in float32 and the output is cast back.  RoPE is applied to
k before the cache write, so decode needs no position recompute; the
ring buffer stores each slot's absolute position for masking.

* The encoder's non-causal path is plain ``torch.einsum`` / ``softmax``
  (`gqa_attention`), as the reference leaves it to its compiler; the
  chunked branch the reference takes above ``CHUNK_THRESHOLD`` tokens
  arrives with a later slice.
* Causal or windowed attention over a sequence (prefill, ``forward_lm``)
  goes through `kernels.flash_attention.ops.flash_attention` with
  implicit positions — on a card the hand-written CUDA kernel.  The
  reference's dense, chunked (above 2048 tokens) and local-window
  branches all compute this one function.
* Decode builds one (B, L) mask ``(pos >= 0) & (pos <= cur) &
  (cur - pos < W)`` and goes through
  `kernels.decode_attention.ops.decode_attention`.

Both kernels cast q to float32 and then multiply by their ``scale``
argument (the reference's kernels do the same with ``hd ** -0.5``); the
decoder has already scaled q in the compute dtype, as the reference's
model path does, and passes ``scale=1.0``.  In bf16 the two orders round
differently at hd = 96, so the choice keeps the model path's numbers.

Caches are updated in place (the reference returns new arrays): a
decode step writes one slot per layer instead of copying the cache.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.param import Initializer

CHUNK_THRESHOLD = 2048


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Non-causal, unmasked.  q: (B, Sq, H, hd), k/v: (B, Skv, KV, hd)
    -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd) * hd ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    w = torch.softmax(s, dim=-1).to(acc_dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(acc_dtype))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


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
        if not self.cfg.attn_f32:
            raise NotImplementedError(
                "attn_f32=False (bf16 softmax weights) is not supported by "
                "the attention kernels, which accumulate in float32")
        return q * self.cfg.head_dim ** -0.5

    def forward(self, x: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
        """Full sequence.  x: (B, S, d) in the compute dtype."""
        cfg = self.cfg
        q, k, v = self._qkv(x, sin, cos)
        if cfg.causal or cfg.sliding_window:
            o = flash_ops.flash_attention(
                self._scaled(q), k, v, causal=cfg.causal,
                window=cfg.sliding_window, scale=1.0)
            return self._out(o)
        if x.shape[1] > CHUNK_THRESHOLD:
            raise NotImplementedError(
                f"sequence {x.shape[1]} > {CHUNK_THRESHOLD}: the encoder's "
                "chunked attention arrives with a later slice of the port")
        acc = torch.float32 if cfg.attn_f32 else torch.bfloat16
        return self._out(gqa_attention(q, k, v, acc))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                sin: torch.Tensor, cos: torch.Tensor,
                cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Causal attention over the prompt, and the cache filled in
        place: with L >= S slots the prompt's tokens in order, else the
        last L tokens at slots ``t % L`` (the ring buffer)."""
        S = x.shape[1]
        L = cache["k"].shape[1]
        q, k, v = self._qkv(x, sin, cos)
        o = flash_ops.flash_attention(self._scaled(q), k, v, causal=True,
                                      window=self.cfg.sliding_window,
                                      scale=1.0)
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
        place; past L without a window this wraps, as the reference."""
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
