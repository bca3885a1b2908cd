"""The port's dry-run of the paper's own program, the cache lookup
(reduced encoder, a 4096-row store): the ``auto`` variant (the store
placed by the rules, the lookup left to ``DTensor``'s propagation) on a
fake 2x2 mesh and both variants on a fake 2x2x2 one.  Argument bytes per
device equal the reference's ``sharded_bytes`` of its cache program on
a mesh of that shape; the shardmap lookup gathers (Q, k) candidates.
Each dry-run runs in a spawned child (`test_torch_ranks.in_child`)."""
import pytest

from repro_torch.launch.dryrun import KNOWN_FALLBACKS
from test_torch_dryrun import _run_cases
from test_torch_ranks import in_child

CORPUS = 4096
MESHES = {"2x2": {"data": 2, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
CASES = [("langcache", "2x2"), ("langcache", "2x2x2"),
         ("langcache-shardmap", "2x2x2")]


def reference_cache_arg_bytes(arch, mesh, port_cfg, corpus):
    """The reference's per-device argument bytes of its cache program
    with the port's (reduced) encoder config and store size."""
    import dataclasses

    import repro.launch.mesh as jmesh
    from repro.configs import get_config
    from repro.launch import programs as jprog
    from repro.launch.sharding import RULE_SETS, sharded_bytes

    class FakeMesh:
        def __init__(self, shape):
            self.shape = shape
    full = get_config("modernbert-149m")
    ov = {f.name: getattr(port_cfg, f.name)
          for f in dataclasses.fields(full)
          if f.name not in ("name", "scan_layers", "unroll_inner", "remat")
          and getattr(port_cfg, f.name) != getattr(full, f.name)}
    builder = jmesh.make_production_mesh
    jmesh.make_production_mesh = lambda **kw: None
    try:
        p = jprog.build_cache_program(
            corpus=corpus, variant="auto" if arch == "langcache"
            else "shardmap", overrides=ov)
    finally:
        jmesh.make_production_mesh = builder
    return sum(sharded_bytes(a, ax, FakeMesh(mesh), RULE_SETS["train"])
               for a, ax in zip(p.args, p.arg_axes))


@pytest.fixture(scope="module")
def results():
    cases = [(a, "cache_lookup", MESHES[m], {"reduced": True,
                                             "corpus": CORPUS})
             for a, m in CASES]
    return dict(zip(CASES, in_child(_run_cases, (cases,), timeout=300)))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_cache_program_argument_bytes(results, arch, mesh):
    from repro_torch.launch.programs import get_program
    cfg = get_program("langcache", "cache_lookup", reduced=True,
                      corpus=CORPUS).cfg
    r = results[(arch, mesh)]
    assert r["program"] == ("cache_serve_auto" if arch == "langcache"
                            else "cache_serve_shardmap")
    assert r["memory"]["argument_bytes_per_device"] == \
        reference_cache_arg_bytes(arch, MESHES[mesh], cfg, CORPUS)
    assert r["axes"] == sorted(MESHES[mesh])
    assert r["flops"] > 0 and r["counts"].get("all-gather", 0) > 0
    assert set(r["fallbacks"]) <= set(KNOWN_FALLBACKS)


def _cache_temps(depths):
    """The reduced cache program's temp bytes at one rank, one run per
    encoder depth, and the config's sizes."""
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.programs import CACHE_SHAPE, get_program
    cfg = get_program("langcache", "cache_lookup", reduced=True,
                      corpus=CORPUS).cfg
    temps = [run_one("langcache", "cache_lookup", mesh={"data": 1,
                                                       "model": 1},
                     device="cpu", verbose=False, reduced=True,
                     corpus=CORPUS, overrides={"n_layers": n}
                     )["memory"]["temp_bytes_per_device"] for n in depths]
    return temps, (CACHE_SHAPE.global_batch, CACHE_SHAPE.seq_len,
                   cfg.d_model, cfg.n_heads)


def test_cache_program_runs_forward_only():
    """The cache program is a forward pass, as the reference's jitted
    forward and the served lookup are: no activation is kept for a
    backward pass.  So its temp does not grow with the encoder's depth,
    and stays within one layer's working set, counted by hand: with
    T = Q·S tokens of width d and H heads, at most ten (T, d) float32
    activations and two (Q, H, S, S) float32 score tensors live at once.
    (The plain lookup's (Q, N) scores and their sort, 20 bytes an entry
    at N = 4096, are smaller.)"""
    (t2, t4), (Q, S, d, H) = in_child(_cache_temps, ((2, 4),), timeout=120)
    assert t2 == t4
    assert Q * CORPUS * 20 < 2 * Q * H * S * S * 4
    assert 0 < t2 <= 10 * Q * S * d * 4 + 2 * Q * H * S * S * 4
