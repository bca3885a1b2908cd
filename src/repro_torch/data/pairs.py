"""Batch iterators over pair datasets — the port of
`repro/data/pairs.py` (numpy; batches move to the device in the
trainer, or onto a device mesh through `shard_batch`)."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

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


def shard_batch(batch: dict, mesh, batch_axes=("pod", "data")) -> dict:
    """The host batch as DTensors on ``mesh`` with dim 0 sharded over the
    mesh's batch axes that are present (``Shard(0)`` on each, replicated
    over the others), the reference's ``NamedSharding``: rank r of the
    batch axes holds its block of rows (``DTensor.to_local()``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    placements = [Shard(0) if a in batch_axes else Replicate()
                  for a in mesh.mesh_dim_names]
    return {k: distribute_tensor(torch.as_tensor(np.asarray(v)).to(
                mesh.device_type), mesh, placements)
            for k, v in batch.items()}
