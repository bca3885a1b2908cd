"""Pixtral-12B — VLM: Pixtral-ViT encoder + Mistral-NeMo-style decoder.

[hf:mistralai/Pixtral-12B-2409]  Decoder backbone: 40L, d_model=5120,
32 heads, kv=8, d_ff=14336, vocab=131072, head_dim=128 (explicit — NOT
d_model/n_heads).  The vision encoder + projector is the *vision
frontend stub*: ``input_specs`` provides precomputed patch embeddings of
shape (B, frontend_len, d_model) prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig, LayerSpec, ATTN, DENSE, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    use_rope=True,
    rope_theta=1_000_000.0,
    period=(LayerSpec(ATTN, DENSE),),
    frontend="vision",
    frontend_len=256,
))
