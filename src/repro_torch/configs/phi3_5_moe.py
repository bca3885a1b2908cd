"""Phi-3.5-MoE (42B total / 6.6B active) — 16-expert top-2 MoE.

[hf:microsoft/Phi-3.5-MoE-instruct]  32L, d_model=4096, 32 heads, kv=8,
expert d_ff=6400, vocab=32064, 16 experts top-2.  Every FFN is MoE.
"""
from repro_torch.configs.base import (
    ModelConfig, LayerSpec, MoEConfig, ATTN, MOE, register,
)

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    use_rope=True,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=6400),
    period=(LayerSpec(ATTN, MOE),),
))
