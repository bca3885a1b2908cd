"""Pre-norm layer block: a mixer (attention, Mamba, mLSTM or sLSTM) +
residual + a dense, MoE or no FFN.

The reference's ``LayerSpec(mixer, ffn)`` layers (`repro/models/
blocks.py`) in their entry points: ``forward_full`` (``apply_full``
under autograd: training and the encoder, attention in plain torch),
``forward`` (the same at serving time, ``forward_lm``: causal attention
through the flash kernel), ``prefill`` (``apply_prefill``: the full
prompt, filling the layer's decode state) and ``decode``
(``apply_decode``: one token against it).  Each returns ``(x, aux)``:
the MoE FFN's load-balance + z-loss, or ``None`` for a dense FFN or none
(the reference's zero, without a device op per layer).  With ``ffn =
NONE`` (xLSTM) there is no ``norm2``.

``init_layer_state`` is the layer's empty decode state, a dict of
batch-first tensors: attention's KV cache (``k``, ``v``, ``pos``),
Mamba's ``h`` and ``conv``, the mLSTM's ``C``, ``n``, ``m``, ``conv``,
the sLSTM's ``c``, ``n``, ``h``, ``m``.  ``prefill`` and ``decode``
update it in place, so a batch row is copied into a pool by copying
each tensor's row (`serving/scheduler.py`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import (
    ATTN, DENSE, MAMBA, MLSTM, MOE, NONE, SLSTM, LayerSpec, ModelConfig,
)
from repro_torch.models import attention, layers, mamba, xlstm
from repro_torch.models.moe import MoE
from repro_torch.models.param import A, Initializer

# recurrent mixer kind -> (module, empty state); the module is held
# under the kind's name (``mamba``, ``mlstm``, ``slstm``)
_RECURRENT = {MAMBA: (mamba.Mamba, mamba.init_state),
              MLSTM: (xlstm.MLSTM, xlstm.init_mlstm_state),
              SLSTM: (xlstm.SLSTM, xlstm.init_slstm_state)}


# the reference's logical axes of each mixer's decode-state leaves
_STATE_AXES = {
    ATTN: {"k": ("batch", "cache", "kv_heads", "head_dim"),
           "v": ("batch", "cache", "kv_heads", "head_dim"),
           "pos": ("batch", "cache")},
    MAMBA: {"h": ("batch", "mlp", "ssm_state"),
            "conv": ("batch", "conv", "mlp")},
    MLSTM: {"C": ("batch", "heads", None, None),
            "n": ("batch", "heads", None), "m": ("batch", "heads"),
            "conv": ("batch", "conv", "mlp")},
    SLSTM: {k: ("batch", "embed") for k in ("c", "n", "h", "m")},
}


def layer_state_axes(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, str]:
    """Encoded logical axes of `init_layer_state`'s leaves (the
    reference's ``layer_state_axes``)."""
    if spec.mixer not in _STATE_AXES:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    return {k: A(*v) for k, v in _STATE_AXES[spec.mixer].items()}


def init_layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     seq_len: int, device) -> Dict[str, torch.Tensor]:
    if spec.mixer == ATTN:
        return attention.init_cache(cfg, batch, seq_len, device)
    if spec.mixer in _RECURRENT:
        return _RECURRENT[spec.mixer][1](cfg, batch, device)
    raise ValueError(f"unknown mixer {spec.mixer!r}")


class Block(nn.Module):
    def __init__(self, ini: Initializer, cfg: ModelConfig, spec: LayerSpec):
        super().__init__()
        if spec.ffn not in (DENSE, MOE, NONE):
            raise ValueError(f"unknown ffn {spec.ffn!r}")
        self.kind = spec.mixer
        self.norm1 = layers.Norm(ini, cfg)
        if spec.mixer == ATTN:
            self.attn = attention.Attention(ini, cfg)
        elif spec.mixer in _RECURRENT:
            setattr(self, spec.mixer, _RECURRENT[spec.mixer][0](ini, cfg))
        else:
            raise ValueError(f"unknown mixer {spec.mixer!r}")
        if spec.ffn != NONE:
            self.norm2 = layers.Norm(ini, cfg)
        if spec.ffn == MOE:
            self.moe = MoE(ini, cfg)
        elif spec.ffn == DENSE:
            self.mlp = layers.MLP(ini, cfg)

    def _ffn(self, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if hasattr(self, "moe"):
            y, aux = self.moe(self.norm2(x))
            return x + y, aux
        if hasattr(self, "mlp"):
            return x + self.mlp(self.norm2(x)), None
        return x, None

    def forward(self, x: torch.Tensor, sin: Optional[torch.Tensor],
                cos: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = self.norm1(x)
        if self.kind == ATTN:
            return self._ffn(x + self.attn(h, sin, cos))
        return self._ffn(x + getattr(self, self.kind)(h))

    def forward_full(self, x: torch.Tensor, sin: Optional[torch.Tensor],
                     cos: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The training forward: attention through
        ``Attention.forward_full``, the recurrent mixers through their
        full-sequence forwards."""
        h = self.norm1(x)
        if self.kind == ATTN:
            return self._ffn(x + self.attn.forward_full(h, sin, cos))
        return self._ffn(x + getattr(self, self.kind)(h))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
                state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = self.norm1(x)
        if self.kind == ATTN:
            y = self.attn.prefill(h, positions, sin, cos, state)
        else:
            y = getattr(self, self.kind).prefill(h, state)
        return self._ffn(x + y)

    def decode(self, x: torch.Tensor, cur_len: int,
               sin: Optional[torch.Tensor], cos: Optional[torch.Tensor],
               state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = self.norm1(x)
        if self.kind == ATTN:
            y = self.attn.decode(h, cur_len, sin, cos, state)
        else:
            y = getattr(self, self.kind).decode(h, state)
        return self._ffn(x + y)
