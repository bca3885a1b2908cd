"""Common layers: norms, RoPE, dense MLPs (GeGLU, SwiGLU, GELU with
biases), token embedding and the unembedding.

Numerics follow the reference (`repro/models/layers.py`): norms run in
float32 with *population* variance and ``cfg.norm_eps`` (1e-6, not
torch's 1e-5) and cast back; RoPE rotates the two *halves* of each head
(not interleaved pairs) in float32; ``jax.nn.gelu`` defaults to the tanh
approximation, so GeGLU and the GELU MLP use ``approximate="tanh"``.
Weights stay in ``cfg.param_dtype`` and are cast to the activation dtype
per call, as the reference does; a bias is added after its matrix
product, not fused into it, so bf16 rounds where the reference rounds.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import Initializer


class Norm(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        self.kind = cfg.norm_type
        self.eps = cfg.norm_eps
        self.scale = ini.ones((cfg.d_model,))
        self.bias = ini.zeros((cfg.d_model,)) \
            if cfg.norm_type != "rmsnorm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.kind == "rmsnorm":
            var = x32.square().mean(-1, keepdim=True)
            y = x32 * torch.rsqrt(var + self.eps)
            return (y * self.scale.float()).to(x.dtype)
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


def rope_frequencies(cfg: ModelConfig, positions: torch.Tensor):
    """positions: (S,) int -> (sin, cos) of shape (S, head_dim // 2)."""
    hd = cfg.head_dim
    exponent = torch.arange(0, hd, 2, dtype=torch.float32,
                            device=positions.device) / hd
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); sin/cos: (S, hd/2).  Rotates halves."""
    x1, x2 = x.float().chunk(2, dim=-1)
    sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """(seq_len, d_model) float32 classic sinusoidal table from position
    ``offset`` (the audio backbone's stand-in for MusicGen's learned
    absolute positions): sin on the even columns, cos on the odd, at
    angle ``pos / 10000^(dim / d_model)``."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    angle = pos[:, None] / torch.pow(10_000.0, dim / d_model)[None, :]
    emb = torch.zeros((seq_len, d_model), dtype=torch.float32,
                      device=device)
    emb[:, 0::2] = torch.sin(angle)
    emb[:, 1::2] = torch.cos(angle)
    return emb


class MLP(nn.Module):
    """Dense FFN: gated (GeGLU for the encoder config, SwiGLU) or the
    plain GELU MLP with biases (``mlp_type="gelu"``, StarCoder2)."""

    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        if cfg.mlp_type not in ("geglu", "swiglu", "gelu"):
            raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
        d, f = cfg.d_model, cfg.d_ff
        self.kind = cfg.mlp_type
        if self.kind == "gelu":
            self.w_up = ini.lecun((f, d), fan_in=d)
            self.b_up = ini.zeros((f,))
            self.w_down = ini.lecun((d, f), fan_in=f)
            self.b_down = ini.zeros((d,))
            return
        self.w_gate = ini.lecun((f, d), fan_in=d)
        self.w_up = ini.lecun((f, d), fan_in=d)
        self.w_down = ini.lecun((d, f), fan_in=f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.kind == "gelu":
            h = F.gelu(F.linear(x, self.w_up.to(dt)) + self.b_up.to(dt),
                       approximate="tanh")
            return F.linear(h, self.w_down.to(dt)) + self.b_down.to(dt)
        g = F.linear(x, self.w_gate.to(dt))
        g = F.gelu(g, approximate="tanh") if self.kind == "geglu" \
            else F.silu(g)
        u = F.linear(x, self.w_up.to(dt))
        return F.linear(g * u, self.w_down.to(dt))


def padded_vocab(cfg: ModelConfig) -> int:
    """The vocab rounded up to a multiple of ``cfg.pad_vocab_to``."""
    if cfg.pad_vocab_to:
        m = cfg.pad_vocab_to
        return -(-cfg.vocab_size // m) * m
    return cfg.vocab_size


class TokenEmbedding(nn.Module):
    """The (padded vocab, d) table; rows past ``cfg.vocab_size`` are
    padding that no token reaches."""

    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        self.table = ini.normal((padded_vocab(cfg), cfg.d_model))
        self.dtype = getattr(torch, cfg.dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens.long()].to(self.dtype)


def unembed(cfg: ModelConfig, table: torch.Tensor,
            untied: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab in x's dtype: ``x`` times the tied
    table, or the untied ``(padded vocab, d)`` table (the reference's
    ``embed/unembed`` transposed); then the optional tanh soft-cap, and
    the padding columns set to -1e30 so that no softmax, loss or argmax
    picks them."""
    w = table if cfg.tie_embeddings else untied
    logits = F.linear(x, w.to(x.dtype))
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    v = padded_vocab(cfg)
    if v != cfg.vocab_size:
        col = torch.arange(v, device=x.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    return logits
