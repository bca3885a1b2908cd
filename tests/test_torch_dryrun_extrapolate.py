"""The port's ``--extrapolate`` (`repro_torch.launch.dryrun.run_extrapolated`):
1- and 2-period runs scaled to N periods give, for reduced Phi-3-mini's
prefill at four layers on a fake 2x2 ("data", "model") mesh, the same
layer-linear terms as the whole four-layer run; ``main --extrapolate``
runs a full-width pair; the cache program, which has no periods to
scale, is refused.  Each dry-run runs in a spawned child
(`test_torch_ranks.in_child`)."""
import pytest

from test_torch_ranks import in_child

MESH = {"data": 2, "model": 2}


def _extrapolated_and_whole():
    from repro_torch.launch import dryrun
    kw = dict(mesh=MESH, reduced=True, overrides={"n_layers": 4},
              verbose=False)
    ext = dryrun.run_extrapolated("phi3-mini-3.8b", "prefill_32k", **kw)
    whole = dryrun.run_one("phi3-mini-3.8b", "prefill_32k", device="cpu",
                           **kw)
    cli = dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
                       "--extrapolate", "--mesh", "data=2,model=2",
                       "--device", "cpu"])
    return ext, whole, cli


def test_extrapolation_equals_the_whole_run_on_layer_linear_terms():
    ext, whole, cli = in_child(_extrapolated_and_whole, timeout=180)
    assert ext["extrapolated"] and ext["program"] == whole["program"]
    for key in ("per_device_flops", "per_device_bytes",
                "per_device_collective_bytes"):
        assert ext["roofline"][key] == whole["roofline"][key], key
        assert whole["roofline"][key] > 0, key
    assert ext["roofline"]["collective_counts"] == \
        whole["roofline"]["collective_counts"]
    assert ext["fallbacks"] == whole["fallbacks"]
    assert ext["roofline"]["t_collective"] == pytest.approx(
        whole["roofline"]["t_collective"], rel=1e-12)
    assert ext["memory"]["argument_bytes_per_device"] == \
        whole["memory"]["argument_bytes_per_device"]
    assert ext["model_flops"] == whole["model_flops"]
    assert ext["param_count"] == whole["param_count"]
    (r,) = cli
    assert r["extrapolated"] and r["mesh"] == [2, 2]
    assert r["param_count"] > 3e9 and r["roofline"]["per_device_flops"] > 0
    assert r["memory"]["device_memory_bytes"] > 0


def test_extrapolate_refuses_the_cache_program():
    from repro_torch.launch.dryrun import run_extrapolated
    with pytest.raises(ValueError, match="cache program"):
        run_extrapolated("langcache", "cache_lookup", mesh=MESH)
