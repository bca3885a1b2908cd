"""Jamba-1.5-Large (398B total / 94B active) — Mamba+attention hybrid MoE.

[arXiv:2403.19887]  72L, d_model=8192, 64 heads, kv=8, d_ff=24576,
MoE 16 experts top-2.  Attention:Mamba interleave is 1:7 (one attention
layer per period of 8); MoE replaces the dense FFN on every second
layer (e=16, top-2), matching the published 398B-total / 94B-active
split.  Sub-quadratic in sequence except for the 9 attention layers, so
``long_500k`` runs natively (attention KV for 9 layers is bounded and
sharded).
"""
from repro_torch.configs.base import (
    ModelConfig, LayerSpec, MoEConfig, SSMConfig,
    ATTN, MAMBA, DENSE, MOE, register,
)

# period of 8: attention at position 4 (1:7), MoE on odd positions (1:2)
_PERIOD = tuple(
    LayerSpec(
        mixer=ATTN if i == 4 else MAMBA,
        ffn=MOE if i % 2 == 1 else DENSE,
    )
    for i in range(8)
)

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    use_rope=False,          # Jamba uses no positional encoding
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    period=_PERIOD,
    # 398B params cannot hold fp32 master + fp32 Adam moments in one
    # v5e pod (4.8TB > 4TB HBM); bf16 params + bf16 moments fit
    # (DESIGN.md §2).  The launcher also selects bf16 moments for any
    # config above 100B params.
    param_dtype="bfloat16",
))
