"""Full-sequence, non-causal GQA attention (the encoder's path).

Order of operations follows the reference's unchunked branch
(`repro/models/attention.py` ``gqa_attention`` and ``apply_full``): q
is scaled by ``head_dim ** -0.5`` in the compute dtype, the logits and
the softmax run in float32 (``attn_f32``), the PV product accumulates
in float32 and the output is cast back.  Plain ``torch.einsum`` /
``softmax``, as the reference leaves it to its compiler.  The chunked
online-softmax branch the reference takes above ``CHUNK_THRESHOLD``
tokens, causal and sliding-window masks and the decode paths arrive
with later slices of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.param import Initializer

CHUNK_THRESHOLD = 2048


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (B, Sq, H, hd), k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd) * hd ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    w = torch.softmax(s, dim=-1).to(acc_dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(acc_dtype))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


class Attention(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        if cfg.causal or cfg.sliding_window:
            raise NotImplementedError(
                "causal / sliding-window attention arrives with the "
                "decoder-zoo slice of the port")
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

    def forward(self, x: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
        """x: (B, S, d) in the compute dtype."""
        cfg = self.cfg
        B, S, _ = x.shape
        if S > CHUNK_THRESHOLD:
            raise NotImplementedError(
                f"sequence {S} > {CHUNK_THRESHOLD}: the chunked attention "
                "path arrives with a later slice of the port")
        dt = x.dtype

        def proj(w, b, heads):
            y = F.linear(x, w.to(dt), None if b is None else b.to(dt))
            return y.reshape(B, S, heads, cfg.head_dim)

        q = proj(self.wq, self.bq, cfg.n_heads)
        k = proj(self.wk, self.bk, cfg.n_kv_heads)
        v = proj(self.wv, self.bv, cfg.n_kv_heads)
        if cfg.use_rope:
            q = layers.apply_rope(q, sin, cos)
            k = layers.apply_rope(k, sin, cos)
        acc = torch.float32 if cfg.attn_f32 else torch.bfloat16
        o = gqa_attention(q, k, v, acc)
        return F.linear(o.reshape(B, S, -1), self.wo.to(o.dtype))
