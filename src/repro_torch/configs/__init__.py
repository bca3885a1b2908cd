from repro_torch.configs.base import (
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    XLSTMConfig,
    get_config,
    list_configs,
    register,
    ATTN, MAMBA, SLSTM, MLSTM, DENSE, MOE, NONE,
)

__all__ = [
    "ASSIGNED_ARCHS", "INPUT_SHAPES", "LayerSpec", "ModelConfig",
    "MoEConfig", "ShapeConfig", "SSMConfig", "XLSTMConfig",
    "get_config", "list_configs", "register",
    "ATTN", "MAMBA", "SLSTM", "MLSTM", "DENSE", "MOE", "NONE",
]
