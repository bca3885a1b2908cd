"""Training of the port (`repro/training/`): the optimizers, the
learning-rate schedules, the checkpoint format and the LM train step."""
from repro_torch.training.optim import (
    AdamState, adam, adamw, apply_updates, clip_by_global_norm, global_norm,
)
from repro_torch.training.schedule import (
    constant, linear_decay, linear_warmup_cosine,
)
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.train import make_eval_step, make_train_step

__all__ = [
    "AdamState", "adam", "adamw", "apply_updates", "clip_by_global_norm",
    "global_norm", "constant", "linear_decay", "linear_warmup_cosine",
    "load_checkpoint", "save_checkpoint", "make_eval_step", "make_train_step",
]
