from repro_torch.models.attention import cache_len_for, init_cache
from repro_torch.models.blocks import init_layer_state
from repro_torch.models.layers import padded_vocab
from repro_torch.models.model import LM, Encoder
from repro_torch.models.param import (
    Initializer, make_initializer, state_dict_from_reference,
)

__all__ = ["Encoder", "LM", "Initializer", "make_initializer",
           "state_dict_from_reference", "cache_len_for", "init_cache",
           "init_layer_state", "padded_vocab"]
