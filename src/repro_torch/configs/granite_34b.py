"""Granite-34B-Code — MQA code model.

[arXiv:2405.04324]  88L, d_model=6144, 48 heads, kv=1 (multi-query),
d_ff=24576, vocab=49152.  The 34B code models are gpt_bigcode-family:
2-projection GELU MLP (which is what makes the listed dims total ~34B —
a SwiGLU MLP would give 47B), LayerNorm, MQA.  RoPE per the assignment
line.  Embeddings tied (gpt_bigcode).
"""
from repro_torch.configs.base import ModelConfig, LayerSpec, ATTN, DENSE, register

CONFIG = register(ModelConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    use_rope=True,
    tie_embeddings=True,
    period=(LayerSpec(ATTN, DENSE),),
))
