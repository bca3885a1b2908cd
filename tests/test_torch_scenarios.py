"""``serve --scenario`` in the port (`launch.scenarios`, `launch.replay`)
against the reference's own entry point: for each of the eight (trace,
mode) cases the reference's bench replays, the port's launcher on the
CPU prints the reference's lines (``repro.launch.serve.run_scenario``,
smoke traces as its command line always builds them), all but the plan
timings equal; at full size the reference bench's replay and the port's
count alike; the traces are deterministic in their seed; and no trace
reaches the warm tier's k-means draw, which the port makes with numpy
where the reference uses ``jax.random``."""
import argparse
import importlib.util
import re

import numpy as np
import pytest

from repro_torch.core import ivf
from repro_torch.launch import replay, scenarios, serve

CASES = [("diurnal", True), ("zipf_tenants", True), ("drift", False),
         ("drift", True), ("bursty", True), ("adversarial", True),
         ("ttl_churn", True), ("cold_tenants", True)]
IDS = [f"{n}-{'conformal' if c else 'learned'}" for n, c in CASES]


def _timings_masked(lines):
    """The plan line's µs figures are host times: everything else of it
    (the timed batches) is compared."""
    return [re.sub(r"\d+ us/row", "_ us/row", ln) for ln in lines]


@pytest.mark.parametrize("name,conformal", CASES, ids=IDS)
def test_serve_scenario_prints_the_references_lines(name, conformal,
                                                    capsys):
    from repro.launch import serve as ref_serve
    ref_serve.run_scenario(argparse.Namespace(
        scenario=name, conformal=conformal, smoke=True))
    want = capsys.readouterr().out.splitlines()
    serve.main(["--device", "cpu", "--scenario", name]
               + (["--conformal"] if conformal else []))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) >= 3
    assert sum("plan p50" in ln for ln in got) == 1
    assert _timings_masked(got) == _timings_masked(want)


def test_an_unknown_scenario_exits_as_the_reference():
    from repro.launch import serve as ref_serve
    with pytest.raises(SystemExit) as want:
        ref_serve.run_scenario(argparse.Namespace(
            scenario="no-such", conformal=False, smoke=True))
    with pytest.raises(SystemExit) as got:
        serve.main(["--device", "cpu", "--scenario", "no-such"])
    assert str(got.value) == str(want.value)
    assert "cold_tenants" in str(got.value)


@pytest.fixture(scope="module")
def ref_bench():
    """The reference bench's module as its own entry point loads it: an
    unknown name makes ``run_scenario`` load the module and exit, and the
    module it made is kept."""
    from repro.launch import serve as ref_serve
    made = []
    real = importlib.util.module_from_spec

    def keep(spec):
        made.append(real(spec))
        return made[-1]
    importlib.util.module_from_spec = keep
    try:
        with pytest.raises(SystemExit):
            ref_serve.run_scenario(argparse.Namespace(
                scenario="no-such", conformal=False, smoke=True))
    finally:
        importlib.util.module_from_spec = real
    assert len(made) == 1
    return made[0]


FULL_INTS = ("n_steps", "n_queries", "timed_batches", "hits", "false_hits",
             "stale_serves", "ttl_stamped", "expired_masked",
             "expired_reaped", "hit_audits", "audited_false_hits",
             "per_tenant_queries")


@pytest.mark.parametrize("name,conformal", CASES, ids=IDS)
def test_full_size_replay_counts_as_the_references(name, conformal,
                                                   ref_bench):
    """At full size (the traces ``chip_smoke.py`` replays on the card),
    the reference bench's replay and the port's on the CPU count the same
    hits, false hits, stale serves, TTL and audit counters, tenant by
    tenant, with conformal floors within 1e-5: the adversarial rows just
    below the threshold among them."""
    want = ref_bench.replay(ref_bench.build(name, smoke=False),
                            conformal=conformal)
    got = replay.replay(scenarios.build(name, smoke=False),
                        conformal=conformal, device="cpu")
    assert {k: got.get(k) for k in FULL_INTS} == \
        {k: want.get(k) for k in FULL_INTS}
    assert got["n_queries"] >= 440
    assert got.get("prewindow_hit_rate") == want.get("prewindow_hit_rate")
    fw, fg = want.get("conformal_floors"), got.get("conformal_floors")
    assert (fw is None) == (fg is None) == (not conformal)
    if conformal:
        assert fg.keys() == fw.keys()
        for t in fw:
            assert abs(fg[t] - fw[t]) <= 1e-5, (t, fg[t], fw[t])


def _steps(trace):
    return [(s.t, s.embs, s.tenants, s.group, s.must_miss, s.ttl)
            for s in trace.steps]


@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_build_gives_the_same_trace_for_a_seed(name):
    a, b = (scenarios.build(name, seed=3, smoke=True) for _ in "ab")
    c = scenarios.build(name, seed=4, smoke=True)
    assert (a.name, a.seed, a.dim, a.threshold, a.false_hit_budget) == \
        (b.name, b.seed, b.dim, b.threshold, b.false_hit_budget)
    assert len(a.steps) == len(b.steps) and a.n_queries == b.n_queries
    for sa, sb in zip(_steps(a), _steps(b)):
        for x, y in zip(sa, sb):
            if x is None or y is None:
                assert x is y
            else:
                np.testing.assert_array_equal(x, y)
    assert set(a.calibration) == set(b.calibration)
    for t in a.calibration:
        for x, y in zip(a.calibration[t], b.calibration[t]):
            np.testing.assert_array_equal(x, y)
    assert not all(np.array_equal(x.embs, y.embs)
                   for x, y in zip(a.steps, c.steps))
    assert a.steps[0].embs.dtype == np.float32
    assert a.steps[0].tenants.dtype == np.int32


@pytest.mark.parametrize("name,conformal", CASES, ids=IDS)
def test_no_trace_draws_a_kmeans_seed(name, conformal, monkeypatch):
    """The port draws the warm tier's first k-means seed with numpy, the
    reference with ``jax.random``, so the two could build different IVF
    lists.  No trace gets that far: none fills its hot tier up to a
    flush (``ttl_churn``'s 32 rows are reaped as they expire), so the
    warm tier is never re-clustered and the outcomes cannot depend on
    the draw."""
    draws = []

    def first(valid, seed):
        draws.append(seed)
        return 0
    monkeypatch.setattr(ivf, "first_seed", first)
    row = replay.replay(scenarios.build(name, smoke=True),
                        conformal=conformal, device="cpu")
    assert row["n_queries"] > 0 and draws == []


@pytest.mark.parametrize("name,conformal", CASES, ids=IDS)
def test_the_cascade_kernel_path_gives_the_four_op_outcomes(name,
                                                            conformal):
    """``fused=True`` (the cascade kernel on a card, its plain version
    here) scores every trace as the reference's four-op lookup does: the
    adversarial rows just below the threshold among them."""
    trace = scenarios.build(name, smoke=True)
    a, b = (replay.replay(trace, conformal=conformal, device="cpu",
                          fused=f) for f in (False, True))
    timing = ("p50_us_per_row", "p99_us_per_row")
    assert {k: v for k, v in a.items() if k not in timing} == \
        {k: v for k, v in b.items() if k not in timing}
