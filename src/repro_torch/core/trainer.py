"""Embedder trainer, inference half: config, encoder, text embedding.

Mirrors `repro/core/trainer.py` ``EmbedderTrainer`` minus the optimizer
step: ``fit`` (the paper's one-epoch online-contrastive fine-tune) and
``evaluate`` arrive with the training slice of the port and are absent
until then.  Without ``params`` the encoder is initialised from
``ft.seed`` at the config's widths, as the reference does; ``params``
takes a port state dict (e.g. `models.state_dict_from_reference` of the
reference's weights).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.corpora import PairDataset
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import Encoder


@dataclass
class FinetuneConfig:
    epochs: int = 1
    lr: float = 6.5383156211679e-5
    batch_size: int = 16
    max_grad_norm: Optional[float] = 0.5
    margin: float = 0.5
    loss: str = "online"          # 'online' | 'contrastive'
    max_len: int = 32
    seed: int = 0
    log_every: int = 50


class EmbedderTrainer:
    def __init__(self, model_cfg: ModelConfig, ft: FinetuneConfig = None,
                 params: Optional[Dict[str, torch.Tensor]] = None, *,
                 device="cuda"):
        assert model_cfg.is_encoder, "embedder must be an encoder config"
        self.cfg = model_cfg
        self.ft = ft or FinetuneConfig()
        self.model = Encoder(model_cfg, seed=self.ft.seed, device=device)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval()
        self.device = next(self.model.parameters()).device

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def embed_texts(self, texts, tokenizer: HashTokenizer,
                    batch_size: int = 64) -> np.ndarray:
        out = []
        for i in range(0, len(texts), batch_size):
            chunk = list(texts[i:i + batch_size])
            while len(chunk) < batch_size:    # one shape per call
                chunk.append("")
            ids, mask = tokenizer.encode_batch(chunk, self.ft.max_len)
            e = self.model.encode(
                torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device))
            out.append(e.cpu().numpy()[: len(texts[i:i + batch_size])])
        return np.concatenate(out, axis=0)

    def pair_scores(self, ds: PairDataset, tokenizer: HashTokenizer
                    ) -> np.ndarray:
        e1 = self.embed_texts(ds.q1, tokenizer)
        e2 = self.embed_texts(ds.q2, tokenizer)
        return np.sum(e1 * e2, axis=-1)

    def make_embed_fn(self, tokenizer: HashTokenizer) -> Callable:
        """list[str] -> (B, D) unit-norm np — plugs into CachedLLMService."""
        return lambda texts: self.embed_texts(texts, tokenizer)
