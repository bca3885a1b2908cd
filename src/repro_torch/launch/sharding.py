"""Logical-axis -> mesh-axis resolution, the port of
`repro/launch/sharding.py`, and its placement on ``DTensor``s.

Every parameter and state leaf carries the reference's encoded logical
axes (``"embed,mlp"``, ``"batch,cache,kv_heads,head_dim"``, ...).  Rules
map logical names to mesh axes; resolution is *divisibility-aware* per
tensor: a mesh axis that does not divide the dimension, or was already
consumed by an earlier dimension of the same tensor, is dropped
(replicated) rather than padded.  That is what makes qwen2.5's 40 heads
(∤16) or granite's kv=1 degrade gracefully, and what makes the KV
cache's ``cache`` axis pick up the data axes exactly when the batch
cannot use them (long_500k's batch of 1) — see DESIGN.md §3.

A resolved spec keeps the reference's form: per dim of the *reference's*
leaf, ``None``, a mesh-axis name, or a tuple of names, trailing
``None``s trimmed.  It is always resolved in the reference's dim order
(``used`` consumes mesh axes in that order), on the reference's shape —
for a layer leaf the stacked ``(n_periods, ...)`` one, whose 2-d norm
scales escape the rule that replicates 1-d vectors — and then placed on
the port's layout by `placements`: the port's ``(out, in)`` linear
weights, its merged ``(heads * head_dim)`` dims (a merged dim takes a
mesh axis only through its outermost logical axis; an inner one
cannot be written as a ``Shard`` and raises), its one module per layer
(the reference's replicated leading ``layers`` entry is dropped).

A dim sharded over several mesh axes (``("pod", "data")``, or
``SERVE_SEQSHARD_RULES``' ``("model", "pod", "data")`` on ``cache``)
becomes one ``Shard(d)`` per mesh dim.  ``DTensor`` chunks such a dim
in mesh-dim order — the first mesh dim outermost, so chunk ``c`` of it
lives on the ranks whose mesh coordinates, read in mesh-dim order over
the axes that shard it, spell ``c`` — where JAX reads the spec's tuple
major to minor.  For ``("pod", "data")`` the two orders agree; for
``("model", "pod", "data")`` on a ``(pod, data, model)`` mesh they
differ in which rank holds which chunk, never in the per-device shapes
and bytes, which is all a dry-run counts.

Leaves of an axes tree are encoded strings (the leaf is in the
reference's layout, dims identical) or `models.param.LeafAxes` (a
parameter in the port's layout).  A mesh is anything with named sizes:
a ``DeviceMesh``, a ``{name: size}`` dict, or an object whose ``shape``
is one.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from repro_torch.models.param import LeafAxes, decode_axes

# ---------------------------------------------------------------------------
# Rule sets (the reference's, copied)
# ---------------------------------------------------------------------------

# training: FSDP over 'data' on the embed axis of every weight + tensor
# parallel over 'model'; batch over (pod, data).
TRAIN_RULES: Dict[str, tuple] = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
    "cache": ("pod", "data"),
    "conv": (),
    "ssm": (),
    "ssm_state": (),
    "corpus": ("model",),
}

# serving: same tensor-parallel layout; weights additionally sharded over
# 'data' (weight-stationary FSDP-for-inference).
SERVE_RULES = dict(TRAIN_RULES)

# H1: serving WITHOUT weight-FSDP — weights replicated across 'data',
# sharded only over 'model'.
SERVE_NOFSDP_RULES = dict(TRAIN_RULES)
SERVE_NOFSDP_RULES["embed"] = ()

# H2: sequence-sharded KV cache for decode — the cache-length axis gets
# first claim on 'model' (flash-decode style partial-softmax combine).
SERVE_SEQSHARD_RULES = dict(TRAIN_RULES)
SERVE_SEQSHARD_RULES["cache"] = ("model", "pod", "data")

# H3 (cache_serve): the 149M encoder with NO tensor parallelism — pure
# data-parallel encoder (weights replicated), corpus sharded over the
# otherwise-idle 'model' axis, local top-k + tiny merge.
CACHE_DP_RULES = {**TRAIN_RULES,
                  "embed": (), "heads": (), "kv_heads": (), "mlp": (),
                  "vocab": (), "experts": ()}

RULE_SETS = {
    "train": TRAIN_RULES,
    "serve": SERVE_RULES,
    "serve_nofsdp": SERVE_NOFSDP_RULES,
    "serve_seqshard": SERVE_SEQSHARD_RULES,
    "cache_dp": CACHE_DP_RULES,
}


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh-dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def resolve_pspec(shape, axes_str: str, mesh, rules: Dict[str, tuple]
                  ) -> tuple:
    """The reference's ``resolve_pspec``: per dim ``None``, a mesh-axis
    name or a tuple of names, trailing ``None``s trimmed."""
    sizes = mesh_sizes(mesh)
    axes = decode_axes(axes_str)
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not match shape {shape}")
    # H4: 1-D parameter vectors (norm scales, biases) are tiny and stay
    # replicated, except genuinely large ones.
    if len(shape) == 1 and axes and axes[0] not in ("batch", "cache",
                                                    "corpus", "seq"):
        return ()
    used = set()
    parts = []
    for dim, name in zip(shape, axes):
        cand = rules.get(name, ()) if name else ()
        if isinstance(cand, str):
            cand = (cand,)
        sel = [a for a in cand if a in sizes and a not in used]
        # drop trailing axes until the product divides the dimension
        while sel and dim % math.prod(sizes[a] for a in sel) != 0:
            sel.pop()
        if sel:
            used.update(sel)
            parts.append(tuple(sel) if len(sel) > 1 else sel[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def leaf_spec(value, axes, mesh, rules) -> tuple:
    """The resolved spec of one leaf, over the dims of the reference's
    leaf as the port holds it (a stacked leaf's ``layers`` entry, always
    ``None``, dropped)."""
    if isinstance(axes, LeafAxes):
        spec = resolve_pspec(axes.ref_shape, axes.axes, mesh, rules)
        if axes.stacked:
            if spec and spec[0] is not None:
                raise ValueError(f"{axes.ref_key}: the layers axis took "
                                 f"mesh axes {spec[0]}")
            spec = spec[1:]
        return spec
    return resolve_pspec(tuple(value.shape), axes, mesh, rules)


def port_dims(value, axes) -> tuple:
    """Per port dim, the reference dims it holds (identity for a leaf in
    the reference's layout)."""
    if isinstance(axes, LeafAxes):
        return axes.dims
    return tuple((i,) for i in range(len(value.shape)))


def placements(spec: tuple, mesh, dims) -> tuple:
    """DTensor placements (one per mesh dim, in mesh-dim order) of a
    resolved ``spec`` on the port's layout: ``dims[p]`` lists the
    reference dims port dim ``p`` holds, outermost first."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    owner = {}
    for p, group in enumerate(dims):
        for pos, r in enumerate(group):
            owner[r] = (p, pos)
    for r, part in enumerate(spec):
        if part is None:
            continue
        p, pos = owner[r]
        if pos:
            raise ValueError(f"reference dim {r} is an inner axis of a "
                             f"merged port dim {dims[p]}; it cannot "
                             f"take mesh axes {part}")
        for a in (part if isinstance(part, tuple) else (part,)):
            out[names.index(a)] = Shard(p)
    return tuple(out)


def local_shape(value, axes, mesh, rules) -> tuple:
    """The per-device shape of one leaf in the port's layout."""
    sizes = mesh_sizes(mesh)
    spec = leaf_spec(value, axes, mesh, rules)
    shape = list(value.shape)
    dims = port_dims(value, axes)
    for r, part in enumerate(spec):
        if part is None:
            continue
        p = next(i for i, g in enumerate(dims) if r in g)
        n = math.prod(sizes[a] for a in
                      (part if isinstance(part, tuple) else (part,)))
        shape[p] //= n
    return tuple(shape)


def map_axes(fn, values, axes_tree):
    """``fn(value, axes)`` over the leaves of an axes tree (strings and
    `LeafAxes`) and the value tree of the same structure (dicts, lists,
    tuples and named tuples), into a tree of that structure."""
    if isinstance(axes_tree, (str, LeafAxes)):
        return fn(values, axes_tree)
    if isinstance(axes_tree, Mapping):
        return {k: map_axes(fn, values[k], a) for k, a in axes_tree.items()}
    out = [map_axes(fn, v, a) for v, a in zip(values, axes_tree)]
    if len(values) != len(axes_tree):
        raise ValueError(f"{len(values)} values for {len(axes_tree)} axes")
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*out)
    return type(axes_tree)(out)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists, tuples and named tuples."""
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def sharding_tree(values, axes_tree, mesh, rules=TRAIN_RULES):
    """(value tree, axes tree) -> tree of DTensor placements."""
    return map_axes(lambda v, a: placements(
        leaf_spec(v, a, mesh, rules), mesh, port_dims(v, a)),
        values, axes_tree)


def scalar_sharding(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(mesh_sizes(mesh))


def replicate_tree(values, mesh):
    if isinstance(values, Mapping):
        return {k: replicate_tree(v, mesh) for k, v in values.items()}
    if isinstance(values, (list, tuple)):
        out = [replicate_tree(v, mesh) for v in values]
        return type(values)(*out) if hasattr(values, "_fields") \
            else type(values)(out)
    return scalar_sharding(mesh)


def _itemsize(v) -> int:
    dt = v.dtype
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    import numpy as np
    return np.dtype(dt).itemsize


def sharded_bytes(values, axes_tree, mesh, rules=TRAIN_RULES) -> int:
    """Per-device bytes for a (values, axes) tree under the rules."""
    return sum(tree_leaves(map_axes(
        lambda v, a: math.prod(local_shape(v, a, mesh, rules))
        * _itemsize(v), values, axes_tree)))
