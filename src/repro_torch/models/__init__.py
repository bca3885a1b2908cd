from repro_torch.models.model import Encoder
from repro_torch.models.param import (
    Initializer, make_initializer, state_dict_from_reference,
)

__all__ = ["Encoder", "Initializer", "make_initializer",
           "state_dict_from_reference"]
