"""The encoder embedder (the paper's ModernBERT / LangCache-Embed arch).

``Encoder.encode(tokens, mask)`` mirrors the reference's
`repro/models/model.py` ``encode``: token embedding in ``cfg.dtype``,
the layers in order, final norm, float32 masked mean-pool, L2
normalisation.  As in the reference, the token mask is used **only**
for the mean-pool: every layer attends to every position, pad tokens
included.  Matching it keeps the port's embeddings equal to the
reference's; "fixing" it would change every cache key.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.param import make_initializer


class Encoder(nn.Module):
    """Encoder-only backbone; one ``Block`` per layer in period order.

    Parameters are drawn from ``seed`` on ``device`` (default the card;
    raises when CUDA is absent) with the reference's distributions, in
    ``cfg.param_dtype``; activations run in ``cfg.dtype``.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if not cfg.is_encoder:
            raise ValueError(f"{cfg.name} is not an encoder config")
        dev = resolve_device(device)
        ini = make_initializer(cfg, seed, dev)
        self.cfg = cfg
        self.embed = layers.TokenEmbedding(ini, cfg)
        self.layers = nn.ModuleList(
            blocks.Block(ini, cfg, spec) for spec in cfg.layer_specs())
        self.final_norm = layers.Norm(ini, cfg)

    def encode(self, tokens: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: (B, S) int; mask: (B, S) bool validity (None -> all
        valid).  Returns (B, d_model) float32 unit-norm cache keys."""
        x = self.embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        sin, cos = layers.rope_frequencies(self.cfg, positions)
        for blk in self.layers:
            x = blk(x, sin, cos)
        x = self.final_norm(x).float()
        if mask is None:
            emb = x.mean(dim=1)
        else:
            m = mask.float()[..., None]
            emb = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        return emb / torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True).clamp_min(1e-9)
