"""Baseline embedders — local stand-ins for the paper's comparison rows;
the port of `repro/core/embedders.py`.

  * ``EncoderEmbedder``  — an encoder from any registry config, untuned
    (weights from ``seed``) or carrying given weights.  The untuned
    ModernBERT config IS the paper's true base row.
  * ``HashNgramEmbedder`` — character-3-gram hashing (a cheap lexical
    baseline).
  * ``RandomProjectionEmbedder`` — mean-pooled random token projections
    (the floor: position-free lexical identity only).

All expose ``embed(list[str]) -> (B, D) float32`` (unit-norm, numpy)
plus a ``name``.  The two numpy baselines draw exactly the reference's
numbers (``np.random.default_rng(seed)``, FNV-1a 3-grams), so they give
the reference's embeddings bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import Encoder


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


class EncoderEmbedder:
    """``params`` is a port state dict (e.g.
    `models.state_dict_from_reference` of the reference's weights, or a
    fine-tuned trainer's); None draws the weights from ``seed``.  Texts
    are embedded in chunks of ``batch_size`` rows padded with ``""``,
    as the reference does, on ``device`` (default the card)."""

    def __init__(self, cfg: ModelConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 max_len: int = 32, name: str | None = None, seed: int = 0,
                 *, device="cuda"):
        self.cfg = cfg
        self.max_len = max_len
        self.name = name or f"encoder:{cfg.name}(untuned)"
        self.model = Encoder(cfg, seed=seed, device=device)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval()
        self.device = next(self.model.parameters()).device
        self.tok = HashTokenizer(vocab_size=cfg.vocab_size)

    @torch.inference_mode()
    def embed(self, texts: List[str], batch_size: int = 64) -> np.ndarray:
        out = []
        for i in range(0, len(texts), batch_size):
            chunk = list(texts[i:i + batch_size])
            n = len(chunk)
            while len(chunk) < batch_size:
                chunk.append("")
            ids, mask = self.tok.encode_batch(chunk, self.max_len)
            e = self.model.encode(torch.as_tensor(ids, device=self.device),
                                  torch.as_tensor(mask, device=self.device))
            out.append(e.cpu().numpy()[:n])
        return np.concatenate(out, 0)


class HashNgramEmbedder:
    name = "hash-3gram"

    def __init__(self, dim: int = 768):
        self.dim = dim

    def embed(self, texts: List[str], batch_size: int = 0) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            s = f"  {t.lower()}  "
            for j in range(len(s) - 2):
                h = hash_3gram(s[j:j + 3])
                out[i, h % self.dim] += 1.0 if (h >> 16) % 2 else -1.0
        return _l2(out)


def hash_3gram(g: str) -> int:
    h = 0xCBF29CE484222325
    for b in g.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class RandomProjectionEmbedder:
    name = "random-projection"

    def __init__(self, dim: int = 768, vocab: int = 50368, seed: int = 0):
        self.dim = dim
        self.tok = HashTokenizer(vocab_size=vocab)
        rng = np.random.default_rng(seed)
        self.proj = rng.standard_normal((vocab, dim)).astype(np.float32)
        self.proj /= np.sqrt(dim)

    def embed(self, texts: List[str], batch_size: int = 0) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            ids, mask = self.tok.encode(t, 32)
            out[i] = self.proj[ids[mask]].mean(0) if mask.any() \
                else np.zeros(self.dim)
        return _l2(out)
