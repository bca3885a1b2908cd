"""xLSTM-125M — sLSTM + mLSTM recurrent blocks.

[arXiv:2405.04517]  12L, d_model=768, 4 heads, vocab=50304, d_ff=0 (the
up/down projections live inside the xLSTM blocks themselves).  We use an
alternating mLSTM/sLSTM period (xLSTM[1:1] flavour).  Fully recurrent —
decode state is O(1) in sequence length, so ``long_500k`` runs natively.
"""
from repro_torch.configs.base import (
    ModelConfig, LayerSpec, XLSTMConfig, MLSTM, SLSTM, NONE, register,
)

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mlp_type="none",
    norm_type="layernorm",
    use_rope=False,
    tie_embeddings=True,
    xlstm=XLSTMConfig(),
    period=(LayerSpec(MLSTM, NONE), LayerSpec(SLSTM, NONE)),
))
