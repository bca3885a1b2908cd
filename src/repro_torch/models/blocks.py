"""Pre-norm transformer block: attention mixer + residual + dense FFN.

Only the reference's ``apply_full`` for ``LayerSpec(ATTN, DENSE)`` —
the encoder's layer.  MoE, Mamba and xLSTM mixers, prefill and decode
arrive with the decoder-zoo slice of the port.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig
from repro_torch.models import attention, layers
from repro_torch.models.param import Initializer


class Block(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig, spec: LayerSpec):
        super().__init__()
        if (spec.mixer, spec.ffn) != (ATTN, DENSE):
            raise NotImplementedError(
                f"layer {spec} arrives with the decoder-zoo slice of the "
                "port; only ATTN + DENSE is ported")
        self.norm1 = layers.Norm(ini, cfg)
        self.attn = attention.Attention(ini, cfg)
        self.norm2 = layers.Norm(ini, cfg)
        self.mlp = layers.MLP(ini, cfg)

    def forward(self, x: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), sin, cos)
        return x + self.mlp(self.norm2(x))
