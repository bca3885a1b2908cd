"""Modality frontend stubs: the port of `repro/serving/frontend.py`.

The audio codec (MusicGen's EnCodec and text conditioner) and the vision
encoder (Pixtral's ViT and projector) are not implemented, as in the
reference: these stubs stand in for their precomputed frame or patch
embeddings, ``(batch, frontend_len, d_model)`` in ``cfg.dtype``, which
``LM.prefill`` / ``LM.forward_lm`` prepend to the token embeddings.

The draw is ``normal * 0.02`` from a ``torch.Generator`` seeded with
``seed``, on the card by default.  The reference draws from
``jax.random``, whose bits the port cannot reproduce, so the parity
tests pass the reference's draw across as numpy (as they do the k-means
seed row).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def stub_frontend_embeds(cfg: ModelConfig, batch: int, seed: int = 0,
                         device="cuda") -> Optional[torch.Tensor]:
    """Deterministic stand-in frame / patch embeddings, or None for a
    config without a frontend."""
    if not cfg.frontend:
        return None
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    e = torch.randn((batch, cfg.frontend_len, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=dev) * 0.02
    return e.to(getattr(torch, cfg.dtype))


def frontend_spec(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    """The stub's shape and dtype as a ``meta`` tensor (no storage), or
    None without a frontend."""
    if not cfg.frontend:
        return None
    return torch.empty((batch, cfg.frontend_len, cfg.d_model),
                       dtype=getattr(torch, cfg.dtype), device="meta")
