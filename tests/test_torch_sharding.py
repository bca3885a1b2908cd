"""The port's logical-axis resolution (`repro_torch.launch.sharding`)
against the reference's (`repro.launch.sharding`): every parameter leaf
of the ten assigned archs at full width and every decode-state leaf of
the four input shapes, under all five rule sets, on both production
mesh shapes — specs equal entry for entry, per-device bytes equal as
integers — plus the reference's hand cases, its resolution invariant
(a seeded sweep), and the placement of a spec on the port's layout.
Shape-only meshes: no process group starts here."""
import math

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsh
from repro.launch.programs import resolve_config as jresolve_config
from repro.models import init_lm_state as jinit_lm_state
from repro.models import lm_param_specs as jlm_param_specs
from repro.models import lm_state_axes as jlm_state_axes
from repro_torch.configs import get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.programs import resolve_config
from repro_torch.models import blocks, lm_state_axes, param_axes
from repro_torch.models.param import LeafAxes


class FakeMesh:
    """Shape-only stand-in for a production mesh."""
    def __init__(self, shape):
        self.shape = shape


MESH_SP = FakeMesh({"data": 16, "model": 16})
MESH_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH_SP, "2x16x16": MESH_MP}


def _ref(spec) -> tuple:
    return tuple(spec)


def _flat(tree, axes, prefix=""):
    """{path: (shape, dtype itemsize, axes)} of a reference value tree."""
    out = {}
    for k in tree:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], axes[k], key))
        else:
            out[key] = (tuple(tree[k].shape),
                        np.dtype(tree[k].dtype).itemsize, axes[k])
    return out


def test_resolve_basic_rules():
    for mesh, shape, axes, want in (
            (MESH_SP, (6144, 24576), "embed,mlp", ("data", "model")),
            (MESH_MP, (256, 4096), "batch,seq", (("pod", "data"),))):
        got = sh.resolve_pspec(shape, axes, mesh, sh.TRAIN_RULES)
        assert got == want == _ref(jsh.resolve_pspec(shape, axes, mesh,
                                                     jsh.TRAIN_RULES))


def test_resolve_divisibility_fallback():
    # qwen's 40 heads don't divide 16; granite's kv=1 -> replicated
    for shape, axes in (((5120, 40, 128), "embed,heads,head_dim"),
                        ((6144, 1, 128), "embed,kv_heads,head_dim")):
        got = sh.resolve_pspec(shape, axes, MESH_SP, sh.TRAIN_RULES)
        assert got == ("data",) == _ref(jsh.resolve_pspec(
            shape, axes, MESH_SP, jsh.TRAIN_RULES))


@pytest.mark.parametrize("shape,want", [
    ((1, 524288, 8, 128), (None, ("pod", "data"))),
    ((128, 32768, 8, 128), (("pod", "data"),)),
    ((128, 32768, 16, 128), (("pod", "data"), None, "model")),
])
def test_resolve_cache_takes_data_axes_when_batch_cannot(shape, want):
    axes = "batch,cache,kv_heads,head_dim"
    got = sh.resolve_pspec(shape, axes, MESH_MP, sh.TRAIN_RULES)
    assert got == want == _ref(jsh.resolve_pspec(shape, axes, MESH_MP,
                                                 jsh.TRAIN_RULES))


def test_rule_sets_are_the_reference_s():
    assert list(sh.RULE_SETS) == list(jsh.RULE_SETS)
    for name, rules in sh.RULE_SETS.items():
        assert rules == jsh.RULE_SETS[name], name


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_leaves_resolve_as_the_reference(arch):
    """Every parameter leaf at full width, 5 rule sets x 2 meshes: the
    port's spec (its stacked leaf's, ``layers`` entry dropped) equals the
    reference's; the whole tree's per-device bytes are equal; every spec
    places on the port's layout (no published config shards an inner
    merged axis)."""
    jpv, jpax = jlm_param_specs(jget_config(arch))
    ref = _flat(jpv, jpax)
    cfg = get_config(arch)
    pax = param_axes(cfg)
    shapes = {k: _port_shape(a) for k, a in pax.items()}
    values = {k: torch.empty(s, dtype=getattr(torch, cfg.param_dtype),
                             device="meta") for k, s in shapes.items()}
    for mesh in MESHES.values():
        for rname, rules in sh.RULE_SETS.items():
            jspecs = {k: _ref(jsh.resolve_pspec(s, ax, mesh,
                                                jsh.RULE_SETS[rname]))
                      for k, (s, _, ax) in ref.items()}
            for key, a in pax.items():
                want = jspecs[a.ref_key]
                if a.stacked:
                    assert not want or want[0] is None
                    want = want[1:]
                got = sh.leaf_spec(values[key], a, mesh, rules)
                assert got == want, (arch, rname, key, got, want)
                sh.placements(got, mesh, a.dims)
            want_bytes = jsh.sharded_bytes(jpv, jpax, mesh,
                                           jsh.RULE_SETS[rname])
            got_bytes = sh.sharded_bytes(values, pax, mesh, rules)
            assert got_bytes == want_bytes, (arch, rname, got_bytes,
                                             want_bytes)


def _port_shape(a: LeafAxes) -> tuple:
    """The port tensor's shape from its reference leaf's."""
    one = a.ref_shape[1:] if a.stacked else a.ref_shape
    return tuple(math.prod(one[r] for r in group) for group in a.dims)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_state_leaves_resolve_as_the_reference(arch):
    """Every decode-state leaf of the four input shapes (each shape's
    resolved config, as the programs build it), 5 rule sets x 2 meshes:
    the port's per-layer spec equals the reference's stacked one less its
    ``layers`` entry, and the state's per-device bytes are equal."""
    for shape in INPUT_SHAPES.values():
        jcfg = jresolve_config(jget_config(arch), shape)
        cfg = resolve_config(get_config(arch), shape)
        B, S = shape.global_batch, shape.seq_len
        jst = jinit_lm_state(jcfg, B, S, abstract=True)
        jax_ = jlm_state_axes(jcfg)
        st = {"layers": [blocks.init_layer_state(cfg, spec, B, S, "meta")
                         for spec in cfg.layer_specs()],
              "cur_len": torch.empty((), dtype=torch.int32, device="meta")}
        axes = lm_state_axes(cfg)
        P = len(cfg.period)
        for mesh in MESHES.values():
            for rname, rules in sh.RULE_SETS.items():
                jr = jsh.RULE_SETS[rname]
                for n, (layer, lax_) in enumerate(zip(st["layers"],
                                                      axes["layers"])):
                    pos = f"pos{n % P}"
                    for leaf, t in layer.items():
                        js = jst["layers"][pos][leaf]
                        want = _ref(jsh.resolve_pspec(
                            js.shape, jax_["layers"][pos][leaf], mesh, jr))
                        assert not want or want[0] is None
                        assert tuple(js.shape[1:]) == tuple(t.shape)
                        got = sh.resolve_pspec(tuple(t.shape), lax_[leaf],
                                               mesh, rules)
                        assert got == want[1:], (arch, shape.name, leaf)
                assert sh.sharded_bytes(st, axes, mesh, rules) == \
                    jsh.sharded_bytes(jst, jax_, mesh, jr), (arch, shape.name)


@pytest.mark.parametrize("seed", range(24))
def test_resolve_pspec_total_sweep(seed):
    """The reference's hypothesis invariant as a seeded sweep: random
    dims and logical axes resolve as the reference's, each mesh axis is
    used at most once, and every sharded dim divides."""
    rng = np.random.default_rng(seed)
    names = ["batch", "embed", "heads", "mlp", "vocab", "experts", "cache",
             "corpus", "."]
    for mesh in MESHES.values():
        for _ in range(8):
            dims = tuple(int(d) for d in rng.choice(
                [1, 2, 3, 5, 8, 16, 40, 48, 128, 1536, 32768],
                size=int(rng.integers(1, 5))))
            axes = ",".join(names[int(rng.integers(len(names)))]
                            for _ in dims)
            for rname, rules in sh.RULE_SETS.items():
                spec = sh.resolve_pspec(dims, axes, mesh, rules)
                assert spec == _ref(jsh.resolve_pspec(
                    dims, axes, mesh, jsh.RULE_SETS[rname]))
                used = [a for part in spec if part
                        for a in (part if isinstance(part, tuple)
                                  else (part,))]
                assert len(used) == len(set(used))
                for dim, part in zip(dims, spec + (None,) * len(dims)):
                    if part:
                        parts = part if isinstance(part, tuple) else (part,)
                        assert dim % math.prod(mesh.shape[a]
                                               for a in parts) == 0
                assert sh.sharded_bytes(
                    torch.empty(dims, device="meta"), axes, mesh, rules) == \
                    jsh.sharded_bytes(jax.ShapeDtypeStruct(dims, np.float32),
                                      axes, mesh, jsh.RULE_SETS[rname])


def test_sharded_bytes_hand_cases():
    """Per-device bytes by hand: an FSDP x TP weight over 256, a batch
    over (pod, data), a replicated norm, a KV cache whose cache axis
    takes the data axes."""
    cases = [
        ((6144, 24576), "embed,mlp", MESH_SP, 4, 6144 * 24576 * 4 // 256),
        ((256, 4096), "batch,seq", MESH_MP, 4, 256 * 4096 * 4 // 32),
        ((3072,), "embed", MESH_SP, 4, 3072 * 4),
        ((1, 524288, 8, 128), "batch,cache,kv_heads,head_dim", MESH_MP, 2,
         524288 * 8 * 128 * 2 // 32),
    ]
    for shape, axes, mesh, item, want in cases:
        dt = (torch.float32, np.float32) if item == 4 \
            else (torch.bfloat16, np.float16)
        assert sh.sharded_bytes(torch.empty(shape, dtype=dt[0],
                                            device="meta"), axes, mesh) \
            == want == jsh.sharded_bytes(jax.ShapeDtypeStruct(shape, dt[1]),
                                         axes, mesh)


def test_placements_on_the_port_layout():
    """A (heads, head_dim)-merged, transposed weight takes ``heads``'s
    mesh axis on its outer dim; a dim over two mesh axes takes one
    ``Shard`` per mesh dim; an inner merged axis cannot be placed."""
    cfg = get_config("phi3-mini-3.8b")
    pax = param_axes(cfg)
    wq = pax["layers.0.attn.wq"]               # port (h*hd, d)
    assert wq.dims == ((1, 2), (0,))
    spec = sh.leaf_spec(None, wq, MESH_SP, sh.TRAIN_RULES)
    assert spec == ("data", "model")           # embed, heads
    assert sh.placements(spec, MESH_SP, wq.dims) == (Shard(1), Shard(0))
    assert sh.local_shape(torch.empty(3072, 3072, device="meta"), wq,
                          MESH_SP, sh.TRAIN_RULES) == (3072 // 16,
                                                       3072 // 16)
    tok = sh.resolve_pspec((256, 4096), "batch,seq", MESH_MP,
                           sh.TRAIN_RULES)
    assert sh.placements(tok, MESH_MP, ((0,), (1,))) == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="inner axis"):
        sh.placements((None, None, "model"), MESH_SP, wq.dims)
    norm = pax["layers.0.norm1.scale"]          # stacked (32, 3072): 2-d
    assert sh.leaf_spec(None, norm, MESH_SP, sh.TRAIN_RULES) == ("data",)
    final = pax["final_norm.scale"]             # 1-d: replicated (H4)
    assert sh.leaf_spec(None, final, MESH_SP, sh.TRAIN_RULES) == ()


def test_sharding_tree_and_replicated_trees():
    """``sharding_tree`` keeps its value tree's structure (dicts, tuples,
    named tuples) with one placement per mesh dim at each leaf;
    ``replicate_tree`` and ``scalar_sharding`` replicate everything."""
    from repro_torch.core.store import StoreState, store_axes
    store = StoreState(*(torch.empty(s, device="meta") for s in
                         ((4096, 768), (4096,), (4096,), (4096,), (4096,),
                          ())))
    tree = ({"tokens": torch.empty(256, 64, device="meta")}, store)
    axes = ({"tokens": "batch,seq"}, store_axes())
    got = sh.sharding_tree(tree, axes, MESH_SP, sh.TRAIN_RULES)
    assert got[0]["tokens"] == (Shard(0), Replicate())
    assert isinstance(got[1], StoreState)
    assert got[1].keys == (Replicate(), Shard(0))     # corpus -> model
    assert got[1].clock == (Replicate(), Replicate())
    rep = sh.replicate_tree(tree, MESH_MP)
    assert rep[0]["tokens"] == sh.scalar_sharding(MESH_MP) == \
        (Replicate(),) * 3
    assert isinstance(rep[1], StoreState)
