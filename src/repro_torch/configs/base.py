"""Configuration system for the LangCache reproduction framework.

Every assigned architecture is expressed as a :class:`ModelConfig`.  A
config is a *complete* description of the backbone: layer pattern (for
hybrids), attention geometry (GQA/MQA, RoPE, bias, sliding window), FFN
type (dense / MoE), SSM parameters, and modality frontend stubs.

Configs are frozen dataclasses so they hash and can key jit caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

# mixer kinds
ATTN = "attn"          # full (or sliding-window) self attention
MAMBA = "mamba"        # selective SSM (Mamba-1 style)
SLSTM = "slstm"        # xLSTM scalar-memory block
MLSTM = "mlstm"        # xLSTM matrix-memory block

# ffn kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period of a model."""

    mixer: str = ATTN
    ffn: str = DENSE


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    expert_d_ff: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    load_balance_coef: float = 0.01
    router_z_coef: float = 1e-3


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    # conv window used in front of the mLSTM qk path
    d_conv: int = 4
    mlstm_expand: int = 2
    slstm_ffn_factor: float = 1.3333


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    family: str = "dense"            # dense|moe|ssm|hybrid|audio|vlm|encoder
    source: str = ""                 # citation for the config
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"         # swiglu | gelu | geglu | none
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-6
    use_rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    sliding_window: int = 0          # 0 -> full attention
    causal: bool = True              # False for encoder-only
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # Repeating layer pattern.  n_layers % len(period) == 0.  For uniform
    # models the period has length 1.
    period: Tuple[LayerSpec, ...] = (LayerSpec(ATTN, DENSE),)
    # Modality frontend stub: '', 'audio', or 'vision'.  When set,
    # input_specs() provides precomputed frontend embeddings of shape
    # (batch, frontend_len, d_model) that are prepended to token embeds.
    frontend: str = ""
    frontend_len: int = 256
    max_seq_len: int = 524_288
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"     # master weight dtype
    remat: bool = True               # checkpoint the scanned layer body
    # scan_layers=False unrolls the layer loop (and inner seq chunks):
    # the reference compiler counts a while-loop body ONCE regardless of
    # trip count, so the dry-run/roofline path must lower unrolled to
    # get honest FLOP/byte counts.  Real training keeps the scan.
    scan_layers: bool = True
    unroll_inner: bool = False
    # attention softmax/accumulation precision: f32 (default, safest) or
    # bf16 probabilities+accumulator — the §Perf mixed-precision lever
    # that halves attention HBM traffic (what the Pallas flash kernel's
    # VMEM residency achieves structurally on TPU).
    attn_f32: bool = True
    # chunked cross-entropy: >0 fuses unembed into the loss over
    # sequence chunks of this many tokens, so the (B,S,vocab) logits
    # tensor never fully materialises (the §Perf train-memory lever).
    loss_chunk: int = 0
    # pad the embedding/unembedding tables to a multiple of this, so an
    # awkward vocab (granite-moe's 49155) can shard over the model axis;
    # pad logits are masked to -inf in unembed (§Perf H5 lever).
    pad_vocab_to: int = 0
    # pad the expert count to a multiple of this (router-masked dummy
    # experts) so fine-grained MoEs (granite-moe's 40 experts) can go
    # expert-parallel on the model axis (§Perf H7 lever).
    pad_experts_to: int = 0

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.period) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period length {len(self.period)}"
            )

    # ------------------------------------------------------------------
    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer does *full* attention over arbitrary length."""
        if self.sliding_window > 0:
            return True
        return all(s.mixer != ATTN for s in self.period)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """The full unrolled list of layer specs."""
        return tuple(self.period[i % len(self.period)] for i in range(self.n_layers))

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def for_long_context(self, window: int = 8192) -> "ModelConfig":
        """Variant safe to decode at 500k+ tokens.

        SSM / hybrid configs are already sub-quadratic in state and are
        returned unchanged; full-attention configs get a sliding window
        (ring-buffer KV cache), per DESIGN.md §Arch-applicability.
        """
        if all(s.mixer != ATTN for s in self.period):
            return self
        if self.sliding_window > 0:
            return self
        # Hybrids keep their attention layers full in the real model; for
        # 500k decode we window them too so the cache stays bounded on
        # dense archs.  Jamba/xLSTM never reach this branch for mixers
        # without attention.
        return self.replace(sliding_window=window, name=self.name + "-swa")

    # ------------------------------------------------------------------
    # Parameter counting (for roofline MODEL_FLOPS = 6*N*D)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        hd = self.head_dim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _dense_ffn_params(self) -> int:
        if self.mlp_type in ("swiglu", "geglu"):
            return 3 * self.d_model * self.d_ff
        if self.mlp_type == "gelu":
            return 2 * self.d_model * self.d_ff
        return 0

    def _moe_ffn_params(self, active_only: bool) -> int:
        m = self.moe
        assert m is not None
        e = m.top_k if active_only else m.num_experts
        per_expert = 3 * self.d_model * m.expert_d_ff
        router = self.d_model * m.num_experts
        return e * per_expert + router

    def _mamba_params(self) -> int:
        s = self.ssm or SSMConfig()
        d_in = s.expand * self.d_model
        dt_rank = s.dt_rank or -(-self.d_model // 16)
        return (
            self.d_model * 2 * d_in            # in_proj
            + s.d_conv * d_in                  # depthwise conv
            + d_in * (dt_rank + 2 * s.d_state) # x_proj
            + dt_rank * d_in                   # dt_proj
            + d_in * s.d_state                 # A_log
            + d_in                             # D
            + d_in * self.d_model              # out_proj
        )

    def _xlstm_params(self, kind: str) -> int:
        x = self.xlstm or XLSTMConfig()
        d = self.d_model
        if kind == MLSTM:
            d_in = x.mlstm_expand * d
            return d * 2 * d_in + 3 * d_in * d_in // max(1, 1) + d_in * d + 3 * d_in
        # slstm: 4 gates (i,f,z,o) each d->d plus recurrent per-head block
        hd = d // self.n_heads
        ffn = int(2 * d * d * x.slstm_ffn_factor)
        return 4 * d * d + 4 * self.n_heads * hd * hd + ffn

    def param_count(self, active_only: bool = False) -> int:
        n = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for spec in self.layer_specs():
            if spec.mixer == ATTN:
                n += self._attn_params()
            elif spec.mixer == MAMBA:
                n += self._mamba_params()
            elif spec.mixer in (SLSTM, MLSTM):
                n += self._xlstm_params(spec.mixer)
            if spec.ffn == DENSE:
                n += self._dense_ffn_params()
            elif spec.ffn == MOE:
                n += self._moe_ffn_params(active_only)
            n += 2 * self.d_model  # norms
        n += self.d_model  # final norm
        return n

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test variant of the same family (2 layers, tiny dims).

        Keeps the layer pattern / family shape but shrinks every
        dimension so a forward + train step runs on CPU in seconds.
        """
        period = self.period
        n_layers = len(period)
        if n_layers > 4:  # trim absurdly long periods while keeping variety
            period = period[:4]
            n_layers = 4
        if n_layers <= 2:
            n_layers = 2 * len(period)
        d_model = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        moe = None
        if self.moe is not None:
            # capacity_factor 4.0: smoke tests check prefill/decode
            # equivalence, which requires no capacity drops (the full
            # configs keep the production 1.25)
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                expert_d_ff=64, capacity_factor=4.0)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, d_state=8)
        kw = dict(
            name=self.name + "-smoke",
            n_layers=n_layers,
            period=period,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            moe=moe,
            ssm=ssm,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            frontend_len=8 if self.frontend else 0,
            max_seq_len=2048,
            dtype="float32",
            param_dtype="float32",
            remat=False,
        )
        kw.update(overrides)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}
_LOADED = [False]


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = (
    "musicgen-large",
    "granite-34b",
    "starcoder2-15b",
    "phi3-mini-3.8b",
    "pixtral-12b",
    "jamba-1.5-large-398b",
    "phi3.5-moe-42b-a6.6b",
    "xlstm-125m",
    "qwen2.5-32b",
    "granite-moe-3b-a800m",
)


def _ensure_loaded():
    # import the per-arch modules exactly once
    if _LOADED[0]:
        return
    _LOADED[0] = True
    from repro_torch.configs import archs  # noqa: F401
