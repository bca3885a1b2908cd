"""The port's dry-run programs (`repro_torch.launch.programs`) against
the reference's (`repro.launch.programs`): for all 40 (arch × shape)
pairs and both cache variants the argument trees hold the same leaves —
shapes (through each parameter's layout map), dtypes and logical axes —
``resolve_config`` gives the same config field by field, and
``model_flops`` the same float.  Programs build from fake tensors; none
runs here, and no process group starts."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import programs as jprog
from repro.launch.roofline import model_flops as jmodel_flops
from repro_torch.configs import get_config
from repro_torch.launch import programs as prog
from repro_torch.launch.roofline import model_flops
from repro_torch.models.param import LeafAxes


def _dtype(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).split(".")[1]
    return np.dtype(x).name


def _flat(tree, axes, prefix=""):
    out = {}
    for k in tree:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], axes[k], key))
        else:
            out[key] = (tuple(tree[k].shape), _dtype(tree[k].dtype), axes[k])
    return out


def _port_shape(a: LeafAxes) -> tuple:
    one = a.ref_shape[1:] if a.stacked else a.ref_shape
    return tuple(math.prod(one[r] for r in group) for group in a.dims)


def _same_params(pv, pax, jpv, jpax, n_periods):
    """Every port parameter is a period of a reference leaf with that
    leaf's axes and dtype, its shape the layout map of the leaf's; every
    reference leaf is covered, a stacked one by all its periods."""
    ref = _flat(jpv, jpax)
    seen = {}
    assert set(pv) == set(pax)
    for key, t in pv.items():
        a = pax[key]
        shape, dt, axes = ref[a.ref_key]
        assert (shape, axes) == (a.ref_shape, a.axes), key
        assert _dtype(t.dtype) == dt, key
        assert tuple(t.shape) == _port_shape(a), key
        seen.setdefault(a.ref_key, set()).add(a.period)
    assert set(seen) == set(ref)
    for k, periods in seen.items():
        want = set(range(n_periods)) if k.startswith("layers/") else {None}
        assert periods == want, k


def _same_leaf(t, axes, sds, jaxes, stacked=False):
    shape = tuple(sds.shape[1:]) if stacked else tuple(sds.shape)
    assert tuple(t.shape) == shape
    assert _dtype(t.dtype) == _dtype(sds.dtype)
    assert axes == (jaxes.split(",", 1)[1] if stacked else jaxes)


def _same_batch(batch, axes, jbatch, jaxes):
    assert set(batch) == set(jbatch) and set(axes) == set(jaxes)
    for k in batch:
        _same_leaf(batch[k], axes[k], jbatch[k], jaxes[k])


def _same_state(state, axes, jstate, jaxes, period: int):
    _same_leaf(state["cur_len"], axes["cur_len"], jstate["cur_len"],
               jaxes["cur_len"])
    for n, (layer, lax_) in enumerate(zip(state["layers"], axes["layers"])):
        pos = f"pos{n % period}"
        assert set(layer) == set(jstate["layers"][pos]) == set(lax_)
        for leaf in layer:
            _same_leaf(layer[leaf], lax_[leaf], jstate["layers"][pos][leaf],
                       jaxes["layers"][pos][leaf], stacked=True)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_programs_match_the_reference(arch, monkeypatch):
    """The four shapes' programs: names, configs, argument trees and
    model flops.  The reference's ``build_program`` derives its train
    step's metric axes from ``jax.eval_shape`` of the whole step (minutes
    for the largest configs); the arguments do not depend on it, so it is
    replaced by an empty metrics tree for the call."""
    monkeypatch.setattr(jax, "eval_shape", lambda fn, *a: (None, None, {}))
    for shape in INPUT_SHAPES.values():
        cfg = prog.resolve_config(get_config(arch), shape)
        jcfg = jprog.resolve_config(jget_config(arch), shape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        p = prog.build_program(get_config(arch), shape)
        jp = jprog.build_program(jget_config(arch), shape)
        assert p.name == jp.name and len(p.args) == len(jp.args)
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(jp.cfg)
        assert model_flops(p.cfg, p.shape) == jmodel_flops(jp.cfg, jp.shape)
        n = p.cfg.n_periods
        _same_params(p.args[0], p.arg_axes[0], jp.args[0], jp.arg_axes[0], n)
        if shape.kind == "train":
            opt, oax = p.args[1], p.arg_axes[1]
            jopt, joax = jp.args[1], jp.arg_axes[1]
            _same_leaf(opt.step, oax.step, jopt.step, joax.step)
            for f in ("m", "v"):
                _same_params(getattr(opt, f), getattr(oax, f),
                             getattr(jopt, f), getattr(joax, f), n)
            _same_batch(p.args[2], p.arg_axes[2], jp.args[2], jp.arg_axes[2])
        elif shape.kind == "prefill":
            _same_batch(p.args[1], p.arg_axes[1], jp.args[1], jp.arg_axes[1])
        else:
            _same_state(p.args[1], p.arg_axes[1], jp.args[1],
                        jp.arg_axes[1], len(p.cfg.period))
            _same_leaf(p.args[2], p.arg_axes[2], jp.args[2], jp.arg_axes[2])


@pytest.mark.parametrize("arch", ["langcache", "langcache-shardmap",
                                  "langcache-shardmap-v3"])
def test_cache_programs_match_the_reference(arch, monkeypatch):
    """The reference's shardmap variant builds its production mesh at
    build time (256 devices, which this process lacks); its arguments do
    not depend on it, so the builder is replaced for the call."""
    import repro.launch.mesh as jmesh
    monkeypatch.setattr(jmesh, "make_production_mesh", lambda **kw: None)
    p = prog.get_program(arch, "cache_lookup")
    jp = jprog.get_program(arch, "cache_lookup")
    assert p.name == jp.name
    assert (p.shape.global_batch, p.shape.seq_len) == \
        (jp.shape.global_batch, jp.shape.seq_len) == (1024, 64)
    assert dataclasses.asdict(p.cfg) == dataclasses.asdict(jp.cfg)
    _same_params(p.args[0], p.arg_axes[0], jp.args[0], jp.arg_axes[0],
                 p.cfg.n_periods)
    for f in p.args[1]._fields:
        _same_leaf(getattr(p.args[1], f), getattr(p.arg_axes[1], f),
                   getattr(jp.args[1], f), getattr(jp.arg_axes[1], f))
    for i in (2, 3):
        _same_leaf(p.args[i], p.arg_axes[i], jp.args[i], jp.arg_axes[i])
    assert p.out_axes == jp.out_axes


def test_long500k_swa_for_dense_only():
    dense = prog.resolve_config(get_config("qwen2.5-32b"),
                                INPUT_SHAPES["long_500k"])
    assert dense.sliding_window == 8192
    hybrid = prog.resolve_config(get_config("jamba-1.5-large-398b"),
                                 INPUT_SHAPES["long_500k"])
    assert hybrid.sliding_window == 0


def test_model_flops_train_vs_decode():
    cfg = get_config("phi3-mini-3.8b")
    tr = model_flops(cfg, INPUT_SHAPES["train_4k"])
    de = model_flops(cfg, INPUT_SHAPES["decode_32k"])
    assert tr > 1e15 and de < 1e13 and tr > de
