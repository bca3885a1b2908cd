"""Optimizers of the port (`repro/training/` minus the schedules and the
checkpoint format, which arrive with a later slice)."""
from repro_torch.training.optim import (
    AdamState, adam, adamw, apply_updates, clip_by_global_norm, global_norm,
)

__all__ = ["AdamState", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "global_norm"]
