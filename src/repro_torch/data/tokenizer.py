"""Deterministic hash-vocabulary tokenizer.

No trained vocabulary is available offline, so words map to stable ids
via FNV-1a hashing into the configured vocab (ids 0..3 reserved).  This
preserves the properties the cache pipeline needs: deterministic,
injective-enough (collisions ~ T/vocab), domain-independent, and
reproducible across processes (no Python ``hash`` randomisation).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
_RESERVED = 4
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.IGNORECASE)


def _fnv1a(word: str) -> int:
    h = 0xCBF29CE484222325
    for b in word.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass(frozen=True)
class HashTokenizer:
    vocab_size: int = 50368
    lowercase: bool = True

    def token_id(self, word: str) -> int:
        if self.lowercase:
            word = word.lower()
        return _RESERVED + _fnv1a(word) % (self.vocab_size - _RESERVED)

    def encode(self, text: str, max_len: int = 64, add_special: bool = True):
        """-> (ids (max_len,) int32, mask (max_len,) bool)."""
        words = _WORD_RE.findall(text)
        ids = [self.token_id(w) for w in words]
        if add_special:
            ids = [BOS] + ids[: max_len - 2] + [EOS]
        else:
            ids = ids[:max_len]
        n = len(ids)
        out = np.full(max_len, PAD, np.int32)
        out[:n] = ids[:max_len]
        mask = np.zeros(max_len, bool)
        mask[: min(n, max_len)] = True
        return out, mask

    def encode_batch(self, texts, max_len: int = 64):
        """-> (ids (B, max_len) int32, mask (B, max_len) bool)."""
        ids = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), bool)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, max_len)
        return ids, mask
