"""MusicGen-Large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284]  48L, d_model=2048, 32 heads (MHA: kv=32), d_ff=8192,
vocab=2048 (EnCodec codebook).  The EnCodec conv codec + text conditioner
are the *audio frontend stub*: ``input_specs`` supplies precomputed
conditioning frame embeddings of shape (B, frontend_len, d_model).
MusicGen uses learned positions + LayerNorm + GELU; we keep its GELU MLP
and LayerNorm, with RoPE disabled in favour of learned absolute
positions being approximated by RoPE=False + sinusoidal add (see
models/layers.py).
"""
from repro_torch.configs.base import ModelConfig, LayerSpec, ATTN, DENSE, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    norm_type="layernorm",
    use_rope=False,
    period=(LayerSpec(ATTN, DENSE),),
    frontend="audio",
    frontend_len=256,
))
