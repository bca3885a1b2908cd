"""Checkpoints in the reference's format (`repro/training/checkpoint.py`).

A tree of dicts, lists, tuples and NamedTuples whose leaves are arrays,
tensors or Python scalars is written as MessagePack: every leaf becomes
the numpy array ``np.asarray`` makes of it, framed as ``{"__nd__": True,
"dtype", "shape", "data"}``; a dict is ``{"__map__": [[key, value],
...]}`` with its keys in sorted order (the order the reference's
``tree_map`` leaves them in); a NamedTuple ``{"__nt__": name, "fields":
{...}}``; a list or tuple ``{"__seq__": "list" | "tuple", "items":
[...]}``.  The same tree gives the same bytes as the reference's
``save_checkpoint``, and each side reads the other's files.  The port's
``AdamState.step`` is an int where the reference's is an int32 array; it
is written as the reference writes it and read back as an int.

torch tensors are written from the host; a bfloat16 tensor as dtype
``"bfloat16"`` with its raw 2-byte values, read back as a bfloat16 torch
tensor (numpy has no bfloat16 type of its own).  Every other array is
read back as numpy.  The file is written to a temporary name in the same
directory and renamed over ``path``, so a reader never sees half a
checkpoint.  The codec is the port's own (`msgpack_lite`).
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.training import msgpack_lite
from repro_torch.training.optim import AdamState

_ND = "__nd__"


def _nd(obj) -> dict:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {_ND: True, "dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        obj = t.numpy()
    arr = np.asarray(obj)
    return {_ND: True, "dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _encode(obj):
    if isinstance(obj, AdamState) and not isinstance(obj.step, np.ndarray):
        obj = obj._replace(step=np.asarray(int(obj.step), np.int32))
    if isinstance(obj, dict):
        return {"__map__": [[k, _encode(obj[k])] for k in sorted(obj)]}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {"__nt__": type(obj).__name__,
                "fields": {f: _encode(getattr(obj, f)) for f in obj._fields}}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": "tuple" if isinstance(obj, tuple) else "list",
                "items": [_encode(x) for x in obj]}
    if obj is None:
        return None
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic, str, int,
                        float, bool)):
        return _nd(obj)
    raise TypeError(f"cannot checkpoint {type(obj)}")


def _decode(obj, ntt: dict):
    if not isinstance(obj, dict):
        return obj
    if obj.get(_ND):
        if obj["dtype"] == "bfloat16":
            return torch.frombuffer(bytearray(obj["data"]),
                                    dtype=torch.bfloat16).reshape(
                                        obj["shape"])
        return np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"])
                             ).reshape(obj["shape"]).copy()
    if "__map__" in obj:
        return {_decode(k, ntt): _decode(v, ntt) for k, v in obj["__map__"]}
    if "__nt__" in obj:
        fields = {f: _decode(v, ntt) for f, v in obj["fields"].items()}
        if obj["__nt__"] == "AdamState":
            fields["step"] = int(fields["step"])
        cls = ntt.get(obj["__nt__"])
        return cls(**fields) if cls is not None else fields
    if "__seq__" in obj:
        items = [_decode(x, ntt) for x in obj["items"]]
        return tuple(items) if obj["__seq__"] == "tuple" else items
    return obj


def save_checkpoint(path: str, tree) -> None:
    chunks = msgpack_lite.pack_chunks(_encode(tree))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            for c in chunks:
                f.write(c)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, namedtuple_types: Optional[dict] = None):
    """The tree `save_checkpoint` (or the reference's) wrote; NamedTuples
    of ``namedtuple_types`` (``AdamState`` always) are rebuilt, any other
    comes back as a dict of its fields."""
    ntt = {"AdamState": AdamState}
    ntt.update(namedtuple_types or {})
    with open(path, "rb") as f:
        return _decode(msgpack_lite.unpackb(f.read()), ntt)
