"""Common layers: norms, RoPE, dense GeGLU/SwiGLU MLP, token embedding.

Numerics follow the reference (`repro/models/layers.py`): norms run in
float32 with *population* variance and ``cfg.norm_eps`` (1e-6, not
torch's 1e-5) and cast back; RoPE rotates the two *halves* of each head
(not interleaved pairs) in float32; ``jax.nn.gelu`` defaults to the tanh
approximation, so GeGLU uses ``approximate="tanh"``.  Weights stay in
``cfg.param_dtype`` and are cast to the activation dtype per call, as
the reference does.
"""
from __future__ import annotations

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


class MLP(nn.Module):
    """Gated dense FFN (GeGLU for the encoder config, SwiGLU too)."""

    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        if cfg.mlp_type not in ("geglu", "swiglu"):
            raise NotImplementedError(
                f"mlp_type {cfg.mlp_type!r} arrives with the decoder-zoo "
                "slice of the port")
        d, f = cfg.d_model, cfg.d_ff
        self.kind = cfg.mlp_type
        self.w_gate = ini.lecun((f, d), fan_in=d)
        self.w_up = ini.lecun((f, d), fan_in=d)
        self.w_down = ini.lecun((d, f), fan_in=f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        g = F.linear(x, self.w_gate.to(dt))
        g = F.gelu(g, approximate="tanh") if self.kind == "geglu" \
            else F.silu(g)
        u = F.linear(x, self.w_up.to(dt))
        return F.linear(g * u, self.w_down.to(dt))


class TokenEmbedding(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        if cfg.pad_vocab_to:
            raise NotImplementedError("pad_vocab_to arrives with the "
                                      "decoder-zoo slice of the port")
        self.table = ini.normal((cfg.vocab_size, cfg.d_model))
        self.dtype = getattr(torch, cfg.dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens.long()].to(self.dtype)
