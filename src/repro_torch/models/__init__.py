from repro_torch.models.attention import cache_len_for, init_cache
from repro_torch.models.blocks import init_layer_state, layer_state_axes
from repro_torch.models.layers import padded_vocab
from repro_torch.models.model import LM, Encoder, lm_loss, lm_state_axes
from repro_torch.models.param import (
    A, Initializer, LeafAxes, make_initializer, param_axes,
    state_dict_from_reference, state_dict_to_reference,
)

__all__ = ["Encoder", "LM", "lm_loss", "Initializer", "make_initializer",
           "state_dict_from_reference", "state_dict_to_reference", "cache_len_for", "init_cache",
           "init_layer_state", "padded_vocab", "A", "LeafAxes",
           "param_axes", "layer_state_axes", "lm_state_axes"]
