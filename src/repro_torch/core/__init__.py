"""Core of the semantic cache: the encoder embedder (inference half),
the IVF index and threshold calibration."""
from repro_torch.core.calibration import (
    Calibration, calibrate_for_false_hit_budget, calibrate_for_precision,
)
from repro_torch.core.ivf import build_ivf, build_lists, kmeans
from repro_torch.core.trainer import EmbedderTrainer, FinetuneConfig

__all__ = [
    "Calibration", "calibrate_for_false_hit_budget",
    "calibrate_for_precision", "build_ivf", "build_lists", "kmeans",
    "EmbedderTrainer", "FinetuneConfig",
]
