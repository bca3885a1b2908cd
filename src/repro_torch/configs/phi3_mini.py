"""Phi-3-mini-3.8B — compact dense decoder.

[arXiv:2404.14219]  32L, d_model=3072, 32 heads, kv=32 (MHA),
d_ff=8192, vocab=32064.  RoPE + SwiGLU + RMSNorm, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, LayerSpec, ATTN, DENSE, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    source="arXiv:2404.14219",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    use_rope=True,
    tie_embeddings=True,
    period=(LayerSpec(ATTN, DENSE),),
))
