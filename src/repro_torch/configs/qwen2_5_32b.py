"""Qwen2.5-32B — dense GQA decoder with QKV bias.

[hf:Qwen/Qwen2.5-0.5B family card]  64L, d_model=5120, 40 heads, kv=8,
d_ff=27648, vocab=152064.  RoPE + SwiGLU + RMSNorm + QKV bias.
Note: 40 heads do not divide the 16-way model axis; sharding rules fall
back per-tensor (see launch/sharding.py divisibility handling).
"""
from repro_torch.configs.base import ModelConfig, LayerSpec, ATTN, DENSE, register

CONFIG = register(ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    use_rope=True,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    period=(LayerSpec(ATTN, DENSE),),
))
