"""Pre-norm transformer block: attention mixer + residual + dense FFN.

The reference's ``LayerSpec(ATTN, DENSE)`` layer (`repro/models/
blocks.py`) in its three entry points: ``forward`` (``apply_full``, the
encoder and ``forward_lm``), ``prefill`` (``apply_prefill``: the full
prompt, filling the layer's KV cache) and ``decode`` (``apply_decode``:
one token against it).  ``init_layer_state`` is the layer's empty
decode state.  The MoE FFN, and the Mamba, mLSTM and sLSTM mixers,
arrive with their own slices of the port and are refused here.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import (
    ATTN, DENSE, MAMBA, MLSTM, MOE, SLSTM, LayerSpec, ModelConfig,
)
from repro_torch.models import attention, layers
from repro_torch.models.param import Initializer

_LATER = {MOE: "the MoE slice", MAMBA: "the Mamba slice",
          MLSTM: "the xLSTM slice", SLSTM: "the xLSTM slice"}


def _refuse(spec: LayerSpec) -> None:
    for part in (spec.mixer, spec.ffn):
        if part in _LATER:
            raise NotImplementedError(
                f"layer {spec}: {part} arrives with {_LATER[part]} of the "
                "port (ROADMAP.md queue A); only ATTN + DENSE is ported")
    if (spec.mixer, spec.ffn) != (ATTN, DENSE):
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
        self.mlp = layers.MLP(ini, cfg)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mlp(self.norm2(x))

    def forward(self, x: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
        return self._ffn(x + self.attn(self.norm1(x), sin, cos))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                sin: torch.Tensor, cos: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._ffn(x + self.attn.prefill(self.norm1(x), positions,
                                               sin, cos, state))

    def decode(self, x: torch.Tensor, cur_len: int, sin: torch.Tensor,
               cos: torch.Tensor,
               state: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._ffn(x + self.attn.decode(self.norm1(x), cur_len, sin,
                                              cos, state))
