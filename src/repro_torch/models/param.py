"""Seeded parameter init and the weight carry-across from the reference.

The reference keeps parameters as a nested dict of arrays with the
layers stacked along a leading period axis (``layers/pos0/mixer/wq`` is
``(n_periods, d, h, hd)``) and initialises them with
``jax.random``.  The port keeps them as ``nn.Parameter``s of plain
``nn.Module``s, one module per layer, in PyTorch's ``(out, in)`` linear
layout.  ``Initializer`` draws every tensor from a seeded
``torch.Generator`` with the reference's distributions (lecun-normal,
normal(0.02), ones, zeros, constants); the numbers differ from ``jax.random``'s,
so parity tests carry the reference's own weights across with
``state_dict_from_reference`` instead.

`param_axes` gives every port tensor the reference's logical sharding
axes (``"embed,mlp"``, ...), in the reference's dim order, with the map
from those dims onto the port's layout; `launch.sharding` resolves the
axes to mesh axes there and places the result on the port's dims.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import (
    ATTN, MAMBA, MLSTM, MOE, SLSTM, ModelConfig,
)


def encode_axes(axes) -> str:
    """Logical axes as the reference's comma-joined string (``None`` is
    ``"."``), so an axes tree has the same structure as its value
    tree."""
    if isinstance(axes, str):
        return axes
    return ",".join("." if a is None else a for a in axes)


def decode_axes(s: str) -> Tuple:
    if s == "":
        return ()
    return tuple(None if a == "." else a for a in s.split(","))


def A(*names) -> str:
    return encode_axes(names)


class Initializer:
    """Creates parameters from one seeded generator, in creation order."""

    def __init__(self, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        self.gen = generator
        self.dtype = dtype
        self.device = device

    def normal(self, shape, stddev: float = 0.02) -> nn.Parameter:
        v = torch.randn(tuple(shape), generator=self.gen, dtype=self.dtype,
                        device=self.device) * stddev
        return nn.Parameter(v)

    def lecun(self, shape, fan_in: int) -> nn.Parameter:
        """Normal with std 1/sqrt(fan_in); ``fan_in`` is the reference's
        (the product of the input axes in its layout)."""
        return self.normal(shape, stddev=1.0 / max(1.0, fan_in) ** 0.5)

    def zeros(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.zeros(tuple(shape), dtype=self.dtype,
                                        device=self.device))

    def ones(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(tuple(shape), dtype=self.dtype,
                                       device=self.device))

    def constant(self, shape, value: float) -> nn.Parameter:
        return nn.Parameter(torch.full(tuple(shape), value, dtype=self.dtype,
                                       device=self.device))


def make_initializer(cfg: ModelConfig, seed: int, device) -> Initializer:
    """On the ``meta`` device (shapes only, for weights assigned later)
    there is nothing to draw, so no generator."""
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    return Initializer(gen, dtype=getattr(torch, cfg.param_dtype),
                       device=device)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


# the recurrent mixers' ``(in, out)`` matrices, carried transposed; their
# depthwise ``conv_w`` (K, C) goes to ``F.conv1d``'s (C, 1, K); every
# other leaf (biases, ``A_log``, ``D``, ``norm_scale``, sLSTM's
# per-head ``r_gates``) as it is
_TRANSPOSED = {
    MAMBA: ("in_proj", "x_proj", "dt_w", "out_proj"),
    MLSTM: ("w_up", "wq", "wk", "wv", "w_if", "w_down"),
    SLSTM: ("w_gates", "ff_gate", "ff_up", "ff_down"),
}


def _mixer_leaf(mixer: str, leaf: str, a: np.ndarray):
    """(port module attribute, array) for one ``mixer/<leaf>`` of a layer
    whose mixer is ``mixer`` — dispatched on the mixer first, since an
    mLSTM layer's ``wq``/``wk``/``wv`` are ``(d_in, d_in)`` matrices, not
    attention's ``(d, h, hd)``."""
    if mixer == ATTN:
        if leaf in ("wq", "wk", "wv"):
            return "attn." + leaf, a.reshape(a.shape[0], -1).T
        if leaf == "wo":
            return "attn.wo", a.reshape(-1, a.shape[-1]).T
        if leaf in ("bq", "bk", "bv"):
            return "attn." + leaf, a.reshape(-1)
        raise KeyError(f"no port counterpart for attention leaf {leaf}")
    if mixer not in _TRANSPOSED:
        raise KeyError(f"no port counterpart for mixer {mixer}")
    if leaf in _TRANSPOSED[mixer]:
        a = a.T
    elif leaf == "conv_w":
        a = a.T[:, None, :]
    return f"{mixer}.{leaf}", a


def state_dict_from_reference(tree: Mapping, cfg: ModelConfig, *,
                              copy: bool = True) -> Dict[str, torch.Tensor]:
    """The reference model's value tree (``split(init_lm(cfg))[0]``,
    leaves as numpy arrays) -> this port's ``Encoder`` or ``LM`` state dict.

    Layer ``j * len(cfg.period) + i`` of the port is period ``j`` of the
    reference's ``layers/pos{i}`` stack.  Transposed on the way (the
    reference multiplies ``x @ W`` with W in ``(in, out)`` order, the
    port uses ``F.linear`` with ``(out, in)``):

    * attention's ``mixer/wq``, ``wk``, ``wv``: ``(d, h, hd)`` ->
      ``(h*hd, d)``; ``mixer/wo``: ``(h, hd, d)`` -> ``(d, h*hd)``
    * a Mamba layer's ``in_proj``, ``x_proj``, ``dt_w``, ``out_proj``;
      an mLSTM layer's ``w_up``, ``wq``, ``wk``, ``wv``, ``w_if``,
      ``w_down``; an sLSTM layer's ``w_gates`` (its columns keep their
      gate-major order), ``ff_gate``, ``ff_up``, ``ff_down`` -> ``mamba.*``,
      ``mlstm.*``, ``slstm.*``; the Mamba and mLSTM depthwise ``conv_w``
      ``(K, C)`` -> ``(C, 1, K)``
    * ``ffn/w_gate``, ``w_up``: ``(d, f)`` -> ``(f, d)``;
      ``ffn/w_down``: ``(f, d)`` -> ``(d, f)``

    * an MoE layer's ``ffn/router`` (d, E), ``ffn/w_gate``, ``w_up``
      (E, d, f) and ``ffn/w_down`` (E, f, d) -> ``moe.*`` in the same
      layouts (not transposed: the port's ``MoE`` keeps the reference's)
    * ``embed/unembed`` (an untied decoder's): ``(d, vocab)`` ->
      ``unembed`` ``(vocab, d)``; an encoder has no use for it, and it
      is dropped there

    Not transposed: ``embed/table`` ``(vocab, d)``, every norm's
    ``scale``/``bias``, the attention biases (reshaped ``(h, hd)`` ->
    ``(h*hd,)``), the GELU MLP's ``b_up``/``b_down`` and the recurrent
    mixers' other leaves.  The same function carries an ``Encoder``'s
    and an ``LM``'s weights.

    ``copy=False`` returns views of the reference's arrays (transposes
    included; bfloat16 ones through their 16-bit pattern), for
    ``load_state_dict(..., assign=True)`` into a model built on the
    ``meta`` device: the two frameworks then share one copy of the
    weights.
    """
    flat = _flatten(tree)
    P = len(cfg.period)
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        if copy:
            return torch.from_numpy(np.array(a, copy=True))
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    sd["embed.table"] = t(flat["embed/table"])
    if "embed/unembed" in flat and not cfg.is_encoder:
        sd["unembed"] = t(flat["embed/unembed"].T)
    for name in ("scale", "bias"):
        if f"final_norm/{name}" in flat:
            sd[f"final_norm.{name}"] = t(flat[f"final_norm/{name}"])
    for key, arr in flat.items():
        if not key.startswith("layers/"):
            continue
        _, pos, *rest = key.split("/")
        i = int(pos[3:])
        spec = cfg.period[i]
        leaf = "/".join(rest)
        for j in range(arr.shape[0]):
            a = arr[j]
            if leaf.startswith("mixer/"):
                name, a = _mixer_leaf(spec.mixer, leaf[6:], a)
            elif leaf.startswith("ffn/") and spec.ffn == MOE:
                name = "moe." + leaf[4:]
            elif leaf.startswith("ffn/"):
                name, a = "mlp." + leaf[4:], a.T
            elif leaf.startswith(("norm1/", "norm2/")):
                name = leaf.replace("/", ".")
            else:
                raise KeyError(f"no port counterpart for {key}")
            sd[f"layers.{j * P + i}.{name}"] = t(a)
    return sd


def _host(t: torch.Tensor):
    """A tensor as the reference's leaf: a numpy array, or a CPU torch
    tensor for bfloat16 (numpy has no bfloat16 type of its own)."""
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _to_mixer_leaf(cfg: ModelConfig, mod: str, leaf: str,
                   a: torch.Tensor) -> torch.Tensor:
    """The inverse of `_mixer_leaf`: a port mixer attribute ``mod.leaf``
    back to the reference's ``mixer/<leaf>`` layout."""
    hd = cfg.head_dim
    if mod == "attn":
        heads = cfg.n_heads if leaf in ("wq", "bq", "wo") else cfg.n_kv_heads
        if leaf in ("wq", "wk", "wv"):
            return a.T.reshape(a.shape[1], heads, hd)
        if leaf == "wo":
            return a.T.reshape(heads, hd, a.shape[0])
        return a.reshape(heads, hd)
    if leaf in _TRANSPOSED[mod]:
        return a.t()
    if leaf == "conv_w":
        return a[:, 0, :].t()
    return a


def state_dict_to_reference(state_dict: Mapping[str, torch.Tensor],
                            cfg: ModelConfig) -> Dict:
    """This port's ``LM`` state dict -> the reference's value tree, the
    inverse of `state_dict_from_reference`: layer ``j * len(cfg.period) +
    i`` is stacked as period ``j`` of ``layers/pos{i}``, the transposes
    and reshapes are undone, and leaves come out as numpy arrays (bfloat16
    ones as CPU torch tensors).  A checkpoint of this tree is one the
    reference's ``load_checkpoint`` + ``forward_lm`` read."""
    P = len(cfg.period)
    tree: Dict = {"embed": {"table": _host(state_dict["embed.table"])}}
    if "unembed" in state_dict:
        tree["embed"]["unembed"] = _host(state_dict["unembed"].t())
    tree["final_norm"] = {k.split(".", 1)[1]: _host(v)
                          for k, v in state_dict.items()
                          if k.startswith("final_norm.")}
    stacks: Dict[int, Dict[str, Dict[int, torch.Tensor]]] = {}
    for key, a in state_dict.items():
        if not key.startswith("layers."):
            continue
        _, n, mod, leaf = key.split(".", 3)
        j, i = divmod(int(n), P)
        if mod in ("attn", *_TRANSPOSED):
            path, a = f"mixer/{leaf}", _to_mixer_leaf(cfg, mod, leaf, a)
        elif mod == "moe":
            path = f"ffn/{leaf}"
        elif mod == "mlp":
            path, a = f"ffn/{leaf}", a.t()
        elif mod in ("norm1", "norm2"):
            path = f"{mod}/{leaf}"
        else:
            raise KeyError(f"no reference counterpart for {key}")
        stacks.setdefault(i, {}).setdefault(path, {})[j] = a.detach()
    tree["layers"] = {}
    for i in sorted(stacks):
        pos: Dict = {}
        for path, by_j in stacks[i].items():
            group, leaf = path.split("/")
            pos.setdefault(group, {})[leaf] = _host(torch.stack(
                [by_j[j] for j in range(len(by_j))]))
        tree["layers"][f"pos{i}"] = pos
    return tree


# ---------------------------------------------------------------------------
# The reference's logical axes of every port tensor
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafAxes:
    """One port tensor as the reference sees it.

    ``ref_key``: the reference's leaf (``layers/pos0/mixer/wq``);
    ``axes``: its encoded logical axes and ``ref_shape`` its shape, both
    with the leading ``layers`` axis of a stacked leaf (the port holds
    one period of it: ``period``); ``dims[p]``: the reference dims (of
    one period, outermost first) that port dim ``p`` holds — ``(1, 2)``
    for a merged ``(heads, head_dim)``, ``()`` for a port-only
    singleton."""
    ref_key: str
    axes: str
    ref_shape: Tuple[int, ...]
    dims: Tuple[Tuple[int, ...], ...]
    period: Optional[int] = None

    @property
    def stacked(self) -> bool:
        return self.period is not None


def _t2(_n):                          # a transposed matrix
    return ((1,), (0,))


def _ident(n):
    return tuple((i,) for i in range(n))


# per layer group and leaf: (the reference's logical axes, port dims)
_MIXER_AXES = {
    ATTN: {"wq": (("embed", "heads", "head_dim"), ((1, 2), (0,))),
           "wk": (("embed", "kv_heads", "head_dim"), ((1, 2), (0,))),
           "wv": (("embed", "kv_heads", "head_dim"), ((1, 2), (0,))),
           "wo": (("heads", "head_dim", "embed"), ((2,), (0, 1))),
           "bq": (("heads", "head_dim"), ((0, 1),)),
           "bk": (("kv_heads", "head_dim"), ((0, 1),)),
           "bv": (("kv_heads", "head_dim"), ((0, 1),))},
    MAMBA: {"in_proj": ("embed", "mlp"), "conv_w": ("conv", "mlp"),
            "conv_b": ("mlp",), "x_proj": ("mlp", "ssm"),
            "dt_w": ("ssm", "mlp"), "dt_b": ("mlp",),
            "A_log": ("mlp", "ssm_state"), "D": ("mlp",),
            "out_proj": ("mlp", "embed")},
    MLSTM: {"w_up": ("embed", "mlp"), "conv_w": ("conv", "mlp"),
            "conv_b": ("mlp",), "wq": ("mlp", None), "wk": ("mlp", None),
            "wv": ("mlp", None), "w_if": ("mlp", None), "b_if": (None,),
            "norm_scale": ("mlp",), "w_down": ("mlp", "embed")},
    SLSTM: {"w_gates": ("embed", "mlp"), "b_gates": ("mlp",),
            "r_gates": (None, "heads", None, None),
            "norm_scale": ("embed",), "ff_gate": ("embed", "mlp"),
            "ff_up": ("embed", "mlp"), "ff_down": ("mlp", "embed")},
}
_FFN_AXES = {
    "mlp": {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed"), "b_up": ("mlp",),
            "b_down": ("embed",)},
    "moe": {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "mlp"),
            "w_up": ("experts", "embed", "mlp"),
            "w_down": ("experts", "mlp", "embed")},
}


def _port_dims(mod: str, leaf: str, ndim: int):
    """Port dims of a layer leaf, the layout `_mixer_leaf` and
    `state_dict_from_reference` carry the reference's into."""
    if mod in _TRANSPOSED:
        if leaf in _TRANSPOSED[mod]:
            return _t2(ndim)
        if leaf == "conv_w":                  # (K, C) -> (C, 1, K)
            return ((1,), (), (0,))
        return _ident(ndim)
    if mod == "mlp" and ndim == 2:
        return _t2(ndim)
    return _ident(ndim)


def _ref_shape(shape, dims, inner: int) -> Tuple[int, ...]:
    """The reference leaf's shape (one period) from the port's: a merged
    port dim splits as (size / inner, inner) — only attention merges,
    ``(heads, head_dim)``."""
    n = sum(len(d) for d in dims)
    out = [0] * n
    for size, group in zip(shape, dims):
        if len(group) == 1:
            out[group[0]] = size
        elif len(group) == 2:
            out[group[0]], out[group[1]] = size // inner, inner
    return tuple(out)


def param_axes(cfg: ModelConfig, model=None) -> Dict[str, LeafAxes]:
    """For every ``state_dict`` key of ``LM(cfg)`` / ``Encoder(cfg)``
    (of ``model`` when given; else one is built on fake tensors for its
    shapes), the reference leaf it comes from, that leaf's logical axes
    and shape, and the map of its dims onto the port's layout — the same
    table as `state_dict_from_reference`.  Layer ``j * len(cfg.period) +
    i`` is period ``j`` of ``layers/pos{i}``."""
    if model is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.models.model import LM, Encoder
        with FakeTensorMode():
            model = (Encoder if cfg.is_encoder else LM)(cfg, device="cpu")
    P = len(cfg.period)
    out: Dict[str, LeafAxes] = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if key == "embed.table":
            out[key] = LeafAxes("embed/table", A("vocab", "embed"), shape,
                                _ident(2))
        elif key == "unembed":
            out[key] = LeafAxes("embed/unembed", A("embed", "vocab"),
                                shape[::-1], _t2(2))
        elif key.startswith("final_norm."):
            out[key] = LeafAxes("final_norm/" + key.split(".")[1],
                                A("embed"), shape, _ident(1))
        else:
            _, n, mod, leaf = key.split(".", 3)
            j, i = divmod(int(n), P)
            if mod in ("norm1", "norm2"):
                group, axes, dims = mod, ("embed",), _ident(1)
            elif mod in _MIXER_AXES:
                group, entry = "mixer", _MIXER_AXES[mod][leaf]
                if mod == ATTN:
                    axes, dims = entry
                else:
                    axes, dims = entry, _port_dims(mod, leaf, len(shape))
            else:
                group, axes = "ffn", _FFN_AXES[mod][leaf]
                dims = _port_dims(mod, leaf, len(shape))
            ref = _ref_shape(shape, dims, cfg.head_dim)
            out[key] = LeafAxes(f"layers/pos{i}/{group}/{leaf}",
                                A("layers", *axes), (cfg.n_periods,) + ref,
                                dims, period=j)
    return out
