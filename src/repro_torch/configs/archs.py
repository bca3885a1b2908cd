"""Imports every architecture config module, populating the registry."""
from repro_torch.configs import (  # noqa: F401
    musicgen_large,
    granite_34b,
    starcoder2_15b,
    phi3_mini,
    pixtral_12b,
    jamba_1_5_large,
    phi3_5_moe,
    xlstm_125m,
    qwen2_5_32b,
    granite_moe_3b,
    modernbert_149m,
)
