"""StarCoder2-15B — GQA + RoPE code model.

[arXiv:2402.19173]  40L, d_model=6144, 48 heads, kv=4, d_ff=24576,
vocab=49152.  StarCoder2 uses a GELU MLP (non-gated) and LayerNorm, with
QKV bias.
"""
from repro_torch.configs.base import ModelConfig, LayerSpec, ATTN, DENSE, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    use_rope=True,
    qkv_bias=True,
    period=(LayerSpec(ATTN, DENSE),),
))
