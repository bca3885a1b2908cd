"""The port's dry-run on a fake 2x2x2 ("pod", "data", "model") mesh:
reduced Phi-3-mini's train, prefill and decode programs run as
``DTensor``s, their argument bytes per device equal the reference's
``sharded_bytes`` on a mesh of that shape, and ``pod`` shards their
arguments.  Each dry-run runs in a spawned child
(`test_torch_ranks.in_child`)."""
from test_torch_dryrun import _run_cases, reference_arg_bytes
from test_torch_ranks import in_child

MESH = {"pod": 2, "data": 2, "model": 2}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def test_phi3_programs_on_a_2x2x2_mesh():
    cases = [("phi3-mini-3.8b", s, MESH, {"reduced": True}) for s in SHAPES]
    res = in_child(_run_cases, (cases,), timeout=300)
    for shape, r in zip(SHAPES, res):
        want = reference_arg_bytes("phi3-mini-3.8b", shape, MESH)
        assert r["memory"]["argument_bytes_per_device"] == want, shape
        assert "pod" in r["axes"], shape
        assert r["flops"] > 0 and r["bytes"] > 0, shape
