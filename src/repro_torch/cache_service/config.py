"""Typed construction surface for ``CacheService`` (DESIGN.md §14.4).

The service's constructor grew one keyword per subsystem PR — ~30 flat
kwargs by the time the ensemble landed — which made call sites
unreadable and validation ad hoc.  ``CacheConfig`` is the v2 surface:
a frozen dataclass of frozen **grouped sub-configs**, one per
subsystem, each validating its own fields at construction:

  * ``TieringConfig``   — hot/warm/cold capacities, IVF shape, flush
    cadence, fused/quantized/blockwise execution (§2–§4, §12)
  * ``ShardingConfig``  — mesh + axis of the sharded warm tier (§8)
  * ``LearningConfig``  — §9 admission learning, §11 embedder refresh,
    §14.3 conformal hit calibration
  * ``EnsembleConfig``  — §13 fused multi-embedder cascade
  * ``StalenessConfig`` — §14.2 TTL/staleness (default TTL + clock)

Field-level validation (ranges, enums) happens here in
``__post_init__``; *cross-subsystem* validation (cold×sharded,
ensemble×refresh, tail-window clamping) stays in ``CacheService``,
which owns those invariants.

``CacheService`` takes only a ``CacheConfig``.  ``CacheConfig.from_kwargs``
maps the reference's flat keyword names onto the groups.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

from repro_torch.cache_service.policy import ColdRoutingPolicy, EmbedderRefreshPolicy


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class TieringConfig:
    """Shape and cadence of the hot/warm/cold hierarchy (§2–§4, §12)."""
    hot_capacity: int = 1024
    warm_capacity: int = 16384
    n_clusters: int = 64
    bucket: int = 256
    n_probe: int = 8
    flush_watermark: float = 0.85
    flush_size: Optional[int] = None     # None -> hot_capacity // 4
    rebuild_every: int = 1
    kmeans_iters: int = 4
    fused: bool = False                  # Pallas cascade kernel (§3.1)
    background_rebuild: bool = False     # double-buffered IVF (§7.1)
    warm_dtype: str = "float32"          # "float32" | "int8" (§8.1)
    warm_block: Optional[int] = None     # blockwise fused scan (§12.5)
    cold_capacity: int = 0               # 0 = no cold tier (§12)
    cold_policy: Optional[ColdRoutingPolicy] = None

    def __post_init__(self) -> None:
        _require(self.hot_capacity > 0,
                 f"hot_capacity must be positive: {self.hot_capacity}")
        _require(self.warm_capacity > 0,
                 f"warm_capacity must be positive: {self.warm_capacity}")
        _require(self.n_clusters > 0 and self.bucket > 0,
                 f"n_clusters/bucket must be positive: "
                 f"{self.n_clusters}/{self.bucket}")
        _require(self.n_probe >= 1, f"n_probe must be >= 1: {self.n_probe}")
        _require(0.0 < self.flush_watermark <= 1.0,
                 f"flush_watermark must be in (0, 1]: "
                 f"{self.flush_watermark}")
        _require(self.flush_size is None or self.flush_size > 0,
                 f"flush_size must be positive: {self.flush_size}")
        _require(self.rebuild_every >= 1,
                 f"rebuild_every must be >= 1: {self.rebuild_every}")
        _require(self.warm_dtype in ("float32", "int8"),
                 f"warm_dtype must be float32|int8, got "
                 f"{self.warm_dtype!r}")
        _require(self.warm_block is None or self.warm_block > 0,
                 f"warm_block must be positive: {self.warm_block}")
        _require(self.cold_capacity >= 0,
                 f"cold_capacity must be >= 0: {self.cold_capacity}")


@dataclass(frozen=True)
class ShardingConfig:
    """Warm tier sharding over a device mesh axis (§8)."""
    mesh: Optional[object] = None        # torch DeviceMesh
    shard_axis: str = "model"

    def __post_init__(self) -> None:
        _require(bool(self.shard_axis), "shard_axis must be non-empty")


@dataclass(frozen=True)
class LearningConfig:
    """The online learning loops (§9, §11) and the §14.3 conformal
    hit-calibration band.

    ``conformal=True`` maintains a per-tenant recency window of
    observed *negative* (non-duplicate) scores and floors each
    tenant's serving threshold at the split-conformal quantile of that
    window — the learned threshold can drift under §9, but the floor
    guarantees the false-hit budget holds on the recent score
    distribution even mid-drift.  Requires no other learning flag; it
    shares the feedback accumulator with §9 when both are on.
    """
    learned_admission: bool = False
    feedback: Optional[object] = None   # FeedbackConfig; implies
    #                                     learned_admission
    conformal: bool = False              # §14.3 conformal threshold floor
    learned_embedder: bool = False
    embedder_trainer: Optional[object] = None
    embedder_tokenizer: Optional[object] = None
    refresh_policy: Optional[EmbedderRefreshPolicy] = None  # implies
    #                                      learned_embedder


@dataclass(frozen=True)
class EnsembleConfig:
    """Fused multi-embedder cascade (§13)."""
    embedders: Union[int, Sequence, None] = None   # E or handles
    weights: Optional[Sequence[float]] = None      # default mixture

    def __post_init__(self) -> None:
        if isinstance(self.embedders, int):
            _require(self.embedders > 0,
                     f"embedders must be positive: {self.embedders}")


@dataclass(frozen=True)
class StalenessConfig:
    """TTL/staleness eviction (§14.2).

    ``default_ttl`` (seconds, None = entries never expire unless the
    request says so) stamps every admitted row with
    ``now + ttl``; expired rows are masked out of every tier at plan
    time and reaped on the maintenance tick.  ``clock`` injects the
    time source — benches drive a logical clock through it so expiry
    is deterministic; None uses wall time (``time.time``).  Only
    *differences* of clock values matter: the service rebases all
    times to the clock's value at construction, because deadlines
    live in float32 device arrays where absolute epoch seconds would
    quantize to ~256s steps.
    """
    default_ttl: Optional[float] = None
    clock: Optional[Callable[[], float]] = None

    def __post_init__(self) -> None:
        _require(self.default_ttl is None or self.default_ttl > 0,
                 f"default_ttl must be positive: {self.default_ttl}")


@dataclass(frozen=True)
class CacheConfig:
    """The full typed construction surface of ``CacheService``."""
    dim: int
    topk: int = 1
    threshold: float = 0.85
    admission_margin: float = 0.0
    seed: int = 0
    telemetry: Optional[object] = None   # obs.Telemetry; None = default
    tiering: TieringConfig = field(default_factory=TieringConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    learning: LearningConfig = field(default_factory=LearningConfig)
    ensemble: EnsembleConfig = field(default_factory=EnsembleConfig)
    staleness: StalenessConfig = field(default_factory=StalenessConfig)

    def __post_init__(self) -> None:
        _require(self.dim > 0, f"dim must be positive: {self.dim}")
        _require(self.topk >= 1, f"topk must be >= 1: {self.topk}")
        _require(0.0 < self.threshold <= 1.0,
                 f"threshold must be in (0, 1]: {self.threshold}")
        _require(self.admission_margin >= 0.0,
                 f"admission_margin must be >= 0: {self.admission_margin}")

    # ------------------------------------------------------------------
    # the reference's flat keyword names, grouped
    # ------------------------------------------------------------------
    _TIERING_KEYS = ("hot_capacity", "warm_capacity", "n_clusters",
                     "bucket", "n_probe", "flush_watermark", "flush_size",
                     "rebuild_every", "kmeans_iters", "fused",
                     "background_rebuild", "warm_dtype", "warm_block",
                     "cold_capacity", "cold_policy")
    _LEARNING_KEYS = ("learned_admission", "conformal",
                      "learned_embedder", "embedder_trainer",
                      "embedder_tokenizer")
    _TOP_KEYS = ("topk", "threshold", "admission_margin", "seed",
                 "telemetry")

    @classmethod
    def from_kwargs(cls, dim: int, **kwargs) -> "CacheConfig":
        """Map the reference's flat keyword surface onto the grouped
        config (handy for building a config from a flat flag
        namespace)."""
        top = {k: kwargs.pop(k) for k in cls._TOP_KEYS if k in kwargs}
        tiering = {k: kwargs.pop(k) for k in cls._TIERING_KEYS
                   if k in kwargs}
        learning = {k: kwargs.pop(k) for k in cls._LEARNING_KEYS
                    if k in kwargs}
        if "feedback_config" in kwargs:
            learning["feedback"] = kwargs.pop("feedback_config")
        if "refresh_policy" in kwargs:
            learning["refresh_policy"] = kwargs.pop("refresh_policy")
        sharding = {}
        if "mesh" in kwargs:
            sharding["mesh"] = kwargs.pop("mesh")
        if "shard_axis" in kwargs:
            sharding["shard_axis"] = kwargs.pop("shard_axis")
        ensemble = {}
        if "embedders" in kwargs:
            ensemble["embedders"] = kwargs.pop("embedders")
        if "ensemble_weights" in kwargs:
            ensemble["weights"] = kwargs.pop("ensemble_weights")
        staleness = {}
        if "default_ttl" in kwargs:
            staleness["default_ttl"] = kwargs.pop("default_ttl")
        if "clock" in kwargs:
            staleness["clock"] = kwargs.pop("clock")
        if kwargs:
            raise TypeError(
                f"unknown CacheService kwargs: {sorted(kwargs)} "
                "(see cache_service/config.py for the v2 surface)")
        return cls(dim=int(dim), **top,
                   tiering=TieringConfig(**tiering),
                   sharding=ShardingConfig(**sharding),
                   learning=LearningConfig(**learning),
                   ensemble=EnsembleConfig(**ensemble),
                   staleness=StalenessConfig(**staleness))
