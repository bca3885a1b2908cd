"""Pre-norm transformer block: attention mixer + residual + dense or
MoE FFN.

The reference's ``LayerSpec(ATTN, DENSE)`` and ``LayerSpec(ATTN, MOE)``
layers (`repro/models/blocks.py`) in their three entry points:
``forward`` (``apply_full``, the encoder and ``forward_lm``),
``prefill`` (``apply_prefill``: the full prompt, filling the layer's KV
cache) and ``decode`` (``apply_decode``: one token against it).  Each
returns ``(x, aux)``: the MoE FFN's load-balance + z-loss, or ``None``
for a dense FFN (the reference's zero, without a device op per layer).
``init_layer_state`` is the layer's empty decode state.  The Mamba,
mLSTM and sLSTM mixers arrive with their own slices of the port and
are refused here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import (
    ATTN, DENSE, MAMBA, MLSTM, MOE, SLSTM, LayerSpec, ModelConfig,
)
from repro_torch.models import attention, layers
from repro_torch.models.moe import MoE
from repro_torch.models.param import Initializer

_LATER = {MAMBA: "the Mamba slice", MLSTM: "the xLSTM slice",
          SLSTM: "the xLSTM slice"}


def _refuse(spec: LayerSpec) -> None:
    for part in (spec.mixer, spec.ffn):
        if part in _LATER:
            raise NotImplementedError(
                f"layer {spec}: {part} arrives with {_LATER[part]} of the "
                "port (ROADMAP.md queue A); only ATTN + DENSE or MOE is "
                "ported")
    if spec.mixer != ATTN or spec.ffn not in (DENSE, MOE):
        raise NotImplementedError(f"layer {spec} is not ported")


def init_layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     seq_len: int, device) -> Dict[str, torch.Tensor]:
    _refuse(spec)
    return attention.init_cache(cfg, batch, seq_len, device)


class Block(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig, spec: LayerSpec):
        super().__init__()
        _refuse(spec)
        self.norm1 = layers.Norm(ini, cfg)
        self.attn = attention.Attention(ini, cfg)
        self.norm2 = layers.Norm(ini, cfg)
        if spec.ffn == MOE:
            self.moe = MoE(ini, cfg)
        else:
            self.mlp = layers.MLP(ini, cfg)

    def _ffn(self, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = self.norm2(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h)
            return x + y, aux
        return x + self.mlp(h), None

    def forward(self, x: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._ffn(x + self.attn(self.norm1(x), sin, cos))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                sin: torch.Tensor, cos: torch.Tensor,
                state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._ffn(x + self.attn.prefill(self.norm1(x), positions,
                                               sin, cos, state))

    def decode(self, x: torch.Tensor, cur_len: int, sin: torch.Tensor,
               cos: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._ffn(x + self.attn.decode(self.norm1(x), cur_len, sin,
                                              cos, state))
