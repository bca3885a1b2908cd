"""Batch iterators over pair datasets — the port of
`repro/data/pairs.py` (numpy; batches move to the device in the
trainer)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.corpora import PairDataset
from repro_torch.data.tokenizer import HashTokenizer


def tokenize_pairs(ds: PairDataset, tok: HashTokenizer, max_len: int = 32):
    t1, m1 = tok.encode_batch(ds.q1, max_len)
    t2, m2 = tok.encode_batch(ds.q2, max_len)
    return {"tok1": t1, "mask1": m1, "tok2": t2, "mask2": m2,
            "label": ds.labels.astype(np.int32)}


def iter_batches(arrays: dict, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True,
                 epochs: int = 1) -> Iterator[dict]:
    """Batches in the reference's order: epoch ``ep`` is the permutation
    of ``np.random.default_rng(seed + ep)``."""
    n = len(arrays["label"])
    for ep in range(epochs):
        order = (np.random.default_rng(seed + ep).permutation(n)
                 if shuffle else np.arange(n))
        stop = n - (n % batch_size) if drop_remainder else n
        for i in range(0, stop, batch_size):
            ix = order[i:i + batch_size]
            yield {k: v[ix] for k, v in arrays.items()}


def shard_batch(batch: dict, mesh, batch_axes=("pod", "data")):
    """Placing a batch over a device mesh arrives with the sharded slice
    of the port."""
    raise NotImplementedError(
        "shard_batch arrives with the sharded slice of the port "
        "(torch.distributed); single-card training needs no sharding")
