"""ModernBERT-base (~149M) — the paper's own embedding-model architecture.

[arXiv:2412.13663]  22L, d_model=768, 12 heads, GeGLU d_ff=1152,
vocab=50368.  Encoder-only (bidirectional), RoPE, alternating
global/local (sliding-window 128) attention in the real model — we keep
global attention with an optional window.  Mean-pooled, L2-normalised
sentence embeddings; fine-tuned into **LangCache-Embed** with online
contrastive loss (repro/core/losses.py).

This is the 11th config: the cache-side embedder, not an assigned
serving backbone.  It has no decode path (encoder-only) — serving means
batched query embedding.
"""
from repro_torch.configs.base import ModelConfig, LayerSpec, ATTN, DENSE, register

CONFIG = register(ModelConfig(
    name="modernbert-149m",
    family="encoder",
    source="arXiv:2412.13663",
    n_layers=22,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=1152,
    vocab_size=50368,
    mlp_type="geglu",
    norm_type="layernorm",
    use_rope=True,
    causal=False,
    tie_embeddings=True,
    period=(LayerSpec(ATTN, DENSE),),
    max_seq_len=8192,
))
