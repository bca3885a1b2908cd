"""The port's dry-run (`repro_torch.launch.dryrun`) end to end on a fake
2x2 ("data", "model") mesh: reduced Phi-3-mini's train, prefill and
decode programs run as ``DTensor``s over fake tensors, and their
argument bytes per device equal the reference's ``sharded_bytes`` of its
own program on a mesh of the same shape; the local flop count of
sharded products equals their count by hand; ``--attn-bf16`` runs the
serving programs: decode counts as without it, prefill moves fewer
bytes.

Every dry-run starts a fake process group, so each runs in a spawned
child (`test_torch_ranks.in_child`), never in the test worker; this
module imports no JAX at import time, so a child does not either (the
reference is imported inside the tests, in the parent)."""
import pytest

from repro_torch.launch.dryrun import KNOWN_FALLBACKS, check_fallbacks
from test_torch_ranks import in_child

MESH = {"data": 2, "model": 2}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _run_cases(cases):
    """run_one for each (arch, shape, mesh, kwargs); the numbers the
    tests read."""
    from repro_torch.launch.dryrun import run_one
    out = []
    for arch, shape, mesh, kw in cases:
        r = run_one(arch, shape, mesh=mesh, device="cpu", verbose=False,
                    **kw)
        out.append({"program": r["program"], "memory": r["memory"],
                    "flops": r["roofline"]["per_device_flops"],
                    "bytes": r["roofline"]["per_device_bytes"],
                    "collective": r["roofline"]["per_device_collective_bytes"],
                    "counts": r["roofline"]["collective_counts"],
                    "links": r["roofline"]["collective_by_link"],
                    "axes": r["mesh_axes_sharding_args"],
                    "fallbacks": r["fallbacks"]})
    return out


def _attn_bf16_runs():
    """Reduced Phi-3-mini's decode_32k and prefill_32k on the 2x2 mesh
    without and with ``attn_f32=False``, then ``main --attn-bf16`` on
    decode_32k at full width; (counts, main's exit code)."""
    from repro_torch.launch import dryrun
    counts = {}
    for shape in ("decode_32k", "prefill_32k"):
        for bf16 in (False, True):
            r = dryrun.run_one(
                "phi3-mini-3.8b", shape, mesh=MESH, device="cpu",
                verbose=False, reduced=True,
                overrides={"attn_f32": False} if bf16 else None)
            counts[shape, bf16] = {
                "args": r["memory"]["argument_bytes_per_device"],
                "temp": r["memory"]["temp_bytes_per_device"],
                "flops": r["roofline"]["per_device_flops"],
                "bytes": r["roofline"]["per_device_bytes"],
                "collective": r["roofline"]["per_device_collective_bytes"],
                "fallbacks": r["fallbacks"]}
    try:
        dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
                     "--attn-bf16", "--device", "cpu", "--mesh",
                     "data=2,model=2"])
    except SystemExit as e:
        return counts, e.code
    return counts, 0


def reference_arg_bytes(arch, shape, mesh, rules="train"):
    """The reference's per-device argument bytes of its program (reduced
    config) on a shape-only mesh."""
    import jax

    from repro.configs import INPUT_SHAPES, get_config
    from repro.launch import programs as jprog
    from repro.launch.sharding import RULE_SETS, sharded_bytes

    class FakeMesh:
        def __init__(self, shape):
            self.shape = shape
    eval_shape = jax.eval_shape
    jax.eval_shape = lambda fn, *a: (None, None, {})
    try:
        p = jprog.build_program(get_config(arch).reduced(),
                                INPUT_SHAPES[shape])
    finally:
        jax.eval_shape = eval_shape
    return sum(sharded_bytes(a, ax, FakeMesh(mesh), RULE_SETS[rules])
               for a, ax in zip(p.args, p.arg_axes))


def test_phi3_programs_on_a_2x2_mesh():
    res = in_child(_run_cases, ([("phi3-mini-3.8b", s, MESH,
                                  {"reduced": True}) for s in SHAPES],),
                   timeout=240)
    for shape, r in zip(SHAPES, res):
        want = reference_arg_bytes("phi3-mini-3.8b", shape, MESH)
        assert r["memory"]["argument_bytes_per_device"] == want, shape
        assert r["flops"] > 0 and r["bytes"] > 0, shape
        assert r["memory"]["temp_bytes_per_device"] > 0, shape
        # four ranks in one node: every group's link is NVLink
        assert set(r["links"]) <= {"nvlink"}, shape
        assert r["axes"] == ["data", "model"], shape
        assert set(r["fallbacks"]) <= set(KNOWN_FALLBACKS), shape
    assert [r["program"] for r in res] == ["train_step", "serve_prefill",
                                           "serve_decode"]
    assert res[0]["collective"] > 0 and res[0]["counts"]


def test_local_flops_are_the_hand_count():
    """`localcost.local_count_check`: a column-parallel, a row-parallel
    (partial-sum) and a 3-d linear product on a fake 2x2 mesh each count
    the flops of one rank's shards, and no transfer."""
    from repro_torch.launch.localcost import local_count_check
    got = in_child(local_count_check, timeout=120)
    assert set(got) == {"column", "row", "linear"}
    for name, (count, hand) in got.items():
        assert count == hand, name


def test_attn_bf16_runs_the_serving_programs():
    """``--attn-bf16`` (``attn_f32=False``) on Phi-3-mini's serving
    programs: every run ends (``main`` exits 0); decode counts exactly as
    without the flag (its attention stays float32, as the reference's
    ``apply_decode``); prefill's chunked plain attention keeps P and the
    PV sums in bf16 and moves fewer bytes than without the flag, at the
    same argument bytes."""
    counts, code = in_child(_attn_bf16_runs, timeout=240)
    assert code == 0
    assert counts["decode_32k", True] == counts["decode_32k", False]
    off, on = counts["prefill_32k", False], counts["prefill_32k", True]
    assert on["bytes"] < off["bytes"], (on["bytes"], off["bytes"])
    assert on["args"] == off["args"]
    for c in counts.values():
        assert set(c["fallbacks"]) <= set(KNOWN_FALLBACKS)


def _temps_with_and_without_gc(cases):
    """Each case's temp bytes with Python's cyclic collector on, then
    with it off for the whole run."""
    import gc

    from repro_torch.launch.dryrun import run_one
    out = []
    for enabled in (True, False):
        (gc.enable if enabled else gc.disable)()
        try:
            out.append([run_one(a, s, mesh=m, device="cpu", verbose=False,
                                **kw)["memory"]["temp_bytes_per_device"]
                        for a, s, m, kw in cases])
        finally:
            gc.enable()
    return out


def test_temp_does_not_follow_the_cyclic_collector():
    """Temp bytes are counted from storage frees, so nothing the run
    allocates may sit in a reference cycle: its storage would stay live
    until the cyclic collector happened to run.  The same runs with the
    collector on and off count the same temp."""
    cases = [("phi3-mini-3.8b", s, MESH, {"reduced": True})
             for s in ("train_4k", "decode_32k")]
    cases.append(("langcache", "cache_lookup", MESH,
                  {"reduced": True, "corpus": 4096}))
    on, off = in_child(_temps_with_and_without_gc, (cases,), timeout=180)
    assert on == off


def test_an_unknown_fallback_fails_the_pair():
    """An op that ran outside ``DTensor``'s sharding strategies and is no
    known gap of a torch release is a sharding bug: the pair fails, as
    the reference's does, rather than counting a replicated op."""
    check_fallbacks("p", {k: 3 for k in KNOWN_FALLBACKS})
    with pytest.raises(RuntimeError, match="aten.mm.default"):
        check_fallbacks("p", {"fill_ (local)": 1,
                              "aten.mm.default (replicated)": 1})


def _view_fallbacks(sizes):
    """The fallbacks of a view of a (2, 3, 8, 5) ``DTensor`` whose dim 2
    is sharded over model=4 (of a fake 1x4 mesh) to each of ``sizes``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.localcost import (
        LocalCost, contiguous_stride, fake_mesh,
    )
    out = []
    with fake_mesh({"data": 1, "model": 4}) as mesh, FakeTensorMode():
        shape = (2, 3, 8, 5)
        x = DTensor.from_local(torch.empty(2, 3, 2, 5), mesh,
                               [Replicate(), Shard(2)], run_check=False,
                               shape=shape, stride=contiguous_stride(shape))
        for size in sizes:
            with implicit_replication(), LocalCost(4) as cost:
                x.view(*size)
            out.append(dict(cost.fallbacks))
    return out


def test_a_view_is_a_known_fallback_only_where_it_splits_shards():
    """A view that splits the sharded dim (8 over 4 shards) into an outer
    factor the mesh dim does not divide (2 x 4: the attention's q.reshape
    into fewer KV groups than shards) falls back under its own key, which
    ``KNOWN_FALLBACKS`` names; the plain replicated-view key is no known
    gap, so any other view that fell back would fail its pair.  A split
    into 4 x 2 and views that merge dims keep their shards."""
    split = "aten.view.default (replicated, a sharded dim split)"
    assert split in KNOWN_FALLBACKS
    assert "aten.view.default (replicated)" not in KNOWN_FALLBACKS
    got = in_child(_view_fallbacks, ([(2, 3, 2, 4, 5), (2, 3, -1, 4, 5),
                                      (2, 3, 4, 2, 5), (6, 8, 5),
                                      (2, 3, 40)],), timeout=120)
    assert got == [{split: 1}, {split: 1}, {}, {}, {}]


OTHER_RULES = ("serve_nofsdp", "cache_dp")


@pytest.fixture(scope="module")
def other_rules():
    res = in_child(_run_cases, ([("phi3-mini-3.8b", "decode_32k", MESH,
                                  {"reduced": True, "rules": r})
                                 for r in OTHER_RULES],), timeout=180)
    return dict(zip(OTHER_RULES, res))


@pytest.mark.parametrize("rules", OTHER_RULES)
def test_argument_bytes_under_other_rules(other_rules, rules):
    want = reference_arg_bytes("phi3-mini-3.8b", "decode_32k", MESH, rules)
    assert other_rules[rules]["memory"]["argument_bytes_per_device"] == want

