"""Port parity for the serving telemetry (`repro_torch.obs`, DESIGN.md
§10), on the CPU.

Mirrors the reference's `tests/test_obs.py` on the port (registry
semantics, the exporters' round trip, span trees through the serving
pipeline, SLO health, the stats schema, the batcher's maintenance
accounting), and drives the reference's and the port's registries and
health trackers with the same operations: the snapshots, the JSON-lines
and the Prometheus text are equal exactly.  One difference is intended
and pinned: the tracer's ``annotate_xla=`` (a ``jax.profiler``
annotation) became ``annotate_profiler=`` (``torch.profiler.
record_function``).
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro.obs import HealthTracker as JHealthTracker
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import to_jsonl as jto_jsonl
from repro.obs import to_prometheus as jto_prometheus
from repro_torch.cache_service import CacheConfig, CacheService
from repro_torch.configs import get_config
from repro_torch.core import SemanticCache
from repro_torch.core.embedders import HashNgramEmbedder
from repro_torch.data import HashTokenizer
from repro_torch.models import LM
from repro_torch.obs import (
    DEFAULT_LATENCY_BUCKETS_S, SCHEMA, HealthTracker, MetricsRegistry,
    Telemetry, Tracer, check_overhead_budget, read_jsonl, tenant_label,
    to_jsonl, to_prometheus, validate_lines, write_jsonl,
)
from repro_torch.serving import CachedLLMService, ContinuousBatcher, Request


def _drive(reg):
    c = reg.counter("req_total", "requests", labels=("tenant",))
    c.inc(3, tenant=0)
    c.inc(2, tenant=1)
    c.labels(tenant=0).inc(5)
    reg.gauge("occ", "occupancy").set(0.625)
    h = reg.histogram("lat_seconds", "lat", labels=("stage",),
                      buckets=(1e-3, 1e-2, 1e-1))
    for i, v in enumerate((2e-4, 1e-3, 5e-3, 0.05, 0.2, 3.0)):
        h.observe(v, stage="plan" if i % 2 else "commit")
    return h


def test_registry_snapshot_and_exports_match_reference():
    a, b = JMetricsRegistry(), MetricsRegistry()
    ha, hb = _drive(a), _drive(b)
    assert b.snapshot() == a.snapshot()
    assert to_jsonl(b.snapshot()) == jto_jsonl(a.snapshot())
    assert to_prometheus(b.snapshot()) == jto_prometheus(a.snapshot())
    for q in (0.1, 0.5, 0.9, 1.0):
        assert hb.aggregate().quantile(q) == ha.aggregate().quantile(q)
    assert hb.aggregate(stage="plan").mean == ha.aggregate(stage="plan").mean


def test_health_snapshot_matches_reference():
    outs = []
    for cls in (JHealthTracker, HealthTracker):
        h = cls(budget_for=lambda t: 0.10)
        rng = np.random.default_rng(4)
        for _ in range(5):
            h.observe_plan(rng.integers(0, 3, 8).astype(np.int32),
                           rng.random(8) < 0.4)
            for t in range(3):
                h.observe_admission(t, duplicate=bool(rng.random() < 0.3),
                                    admitted=bool(rng.random() < 0.8))
        h.observe_rebuild_start(plans_now=10)
        h.observe_rebuild_publish(plans_now=17, stall_s=2e-3)
        reg = MetricsRegistry()
        h.drain(reg)
        outs.append((h.snapshot(), reg.snapshot()))
    assert outs[1] == outs[0]


def test_tracer_annotates_torch_profiler_not_xla():
    """The one intended difference: ``annotate_profiler=`` wraps each
    span in a ``torch.profiler.record_function``; the reference's
    ``annotate_xla=`` is not a keyword of the port's tracer."""
    with pytest.raises(TypeError):
        Tracer(annotate_xla=True)
    tr = Tracer(annotate_profiler=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("request"):
            with tr.span("plan"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"request", "plan"} <= names
    assert tr.last_root().stage_names() == ["plan"]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_counter_label_separation():
    reg = MetricsRegistry()
    c = reg.counter("req_total", "requests", labels=("tenant",))
    c.inc(3, tenant=0)
    c.inc(2, tenant=1)
    c.labels(tenant=0).inc(5)
    assert c.total(tenant=0) == 8 and c.total(tenant=1) == 2
    assert c.total() == 10 and reg.value("req_total") == 10
    assert reg.value("req_total", tenant=1) == 2
    assert reg.value("absent_total") == 0


def test_registry_registration_is_idempotent_but_checked():
    reg = MetricsRegistry()
    a = reg.counter("x_total", "x", labels=("tenant",))
    assert reg.counter("x_total", labels=("tenant",)) is a
    with pytest.raises(ValueError):
        reg.gauge("x_total", labels=("tenant",))
    with pytest.raises(ValueError):
        reg.counter("x_total", labels=("stage",))
    with pytest.raises(ValueError):
        a.inc(1, tenannt=0)


def test_histogram_bucket_boundaries():
    reg = MetricsRegistry()
    s = reg.histogram("lat_seconds", "lat", buckets=(1.0, 2.0, 4.0)).labels()
    for v in (0.5, 1.0, 1.5, 2.0, 2.5, 4.0, 9.0):
        s.observe(v)
    assert s.counts == [2, 2, 2, 1]
    assert s.count == 7 and s.vmin == 0.5 and s.vmax == 9.0
    assert s.sum == pytest.approx(20.5)
    with pytest.raises(ValueError):
        reg.histogram("bad_seconds", buckets=(2.0, 1.0))


def test_histogram_quantiles_interpolate():
    reg = MetricsRegistry()
    s = reg.histogram("q_seconds", buckets=(1.0, 2.0, 4.0)).labels()
    vals = (0.2, 0.4, 1.2, 1.8, 3.0, 8.0)
    for v in vals:
        s.observe(v)
    assert 1.0 <= s.quantile(0.5) <= 2.0
    assert 4.0 <= s.quantile(1.0) <= 8.0
    assert s.mean == pytest.approx(sum(vals) / 6)
    h2 = reg.histogram("stage_h_seconds", labels=("stage", "tenant"),
                       buckets=(1.0, 2.0))
    h2.observe(0.5, stage="plan", tenant="0")
    h2.observe(0.7, stage="plan", tenant="1")
    h2.observe(1.5, stage="commit", tenant="0")
    assert h2.aggregate(stage="plan").count == 2
    assert h2.aggregate(tenant="0").count == 2
    assert h2.aggregate().count == 3


def test_tenant_label():
    assert tenant_label(np.zeros(4, np.int32)) == "0"
    assert tenant_label(np.array([3, 3, 3])) == "3"
    assert tenant_label(np.array([1, 2])) == "mixed"
    assert tenant_label(np.array([], np.int32)) == "none"
    assert tenant_label(7) == "7"


def test_snapshot_under_concurrent_writer():
    """Snapshots taken while one writer records are JSON with monotone
    counters, and a quiescent snapshot validates clean."""
    reg = MetricsRegistry()
    c = reg.counter("w_total").labels()
    h = reg.histogram("w_seconds", buckets=DEFAULT_LATENCY_BUCKETS_S
                      ).labels()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            c.inc()
            h.observe(3e-3)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        last = 0
        for _ in range(100):
            snap = reg.snapshot()
            json.dumps(snap)
            cur = snap["metrics"]["w_total"]["series"][0]["value"]
            assert cur >= last
            last = cur
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    snap = reg.snapshot()
    s = snap["metrics"]["w_seconds"]["series"][0]
    assert sum(s["buckets"]) == s["count"]
    assert validate_lines(to_jsonl(snap).splitlines()) == []


def test_export_jsonl_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("a_total", labels=("tenant",)).inc(4, tenant=2)
    reg.gauge("b_occupancy").set(0.75)
    reg.histogram("c_seconds", labels=("stage",),
                  buckets=(1e-3, 1.0)).observe(2e-3, stage="plan")
    path = tmp_path / "metrics.jsonl"
    write_jsonl(path, reg.snapshot(), meta={"run": "t"})
    write_jsonl(path, reg.snapshot(), meta={"run": "t"}, append=True)
    metas, series = read_jsonl(path)
    assert len(metas) == 2 and metas[0]["schema"] == SCHEMA
    assert metas[0]["run"] == "t"
    by_name = {(s["name"], tuple(sorted(s["labels"].items()))): s
               for s in series}
    assert by_name[("a_total", (("tenant", "2"),))]["value"] == 4
    assert by_name[("b_occupancy", ())]["value"] == 0.75
    hist = by_name[("c_seconds", (("stage", "plan"),))]
    assert hist["count"] == 1 and sum(hist["buckets"]) == 1
    assert validate_lines(path.read_text().splitlines()) == []
    prom = to_prometheus(reg.snapshot())
    assert '# TYPE a_total counter' in prom
    assert 'a_total{tenant="2"} 4' in prom
    assert 'c_seconds_bucket{stage="plan",le="+Inf"} 1' in prom
    assert 'c_seconds_count{stage="plan"} 1' in prom


def test_export_validate_catches_corruption():
    reg = MetricsRegistry()
    reg.counter("ok_total").inc()
    lines = to_jsonl(reg.snapshot()).splitlines()
    assert validate_lines(lines) == []
    assert validate_lines(["not json"])
    assert validate_lines(['{"kind": "counter"}'])
    bad = json.loads(lines[1])
    bad["value"] = "NaN-ish"
    assert validate_lines([lines[0], json.dumps(bad)])


# ---------------------------------------------------------------------------
# tracer and health
# ---------------------------------------------------------------------------

def test_span_nesting_and_ring():
    tr = Tracer(keep=2)
    with tr.span("request", tenant="0") as root:
        with tr.span("embed"):
            pass
        with tr.span("plan"):
            with tr.span("warm_probe"):
                pass
    assert tr.current() is None and tr.last_root() is root
    assert root.stage_names() == ["embed", "plan"]
    assert root.find("warm_probe") is not None
    assert [s.name for s in root.walk()] == [
        "request", "embed", "plan", "warm_probe"]
    d = root.to_dict()
    assert d["name"] == "request" and len(d["children"]) == 2
    assert d["duration_s"] >= d["children"][0]["duration_s"]
    for i in range(3):
        with tr.span(f"r{i}"):
            pass
    assert [s.name for s in tr.roots()] == ["r1", "r2"]
    assert [s.name for s in tr.drain()] == ["r1", "r2"]
    assert tr.roots() == []


def test_disabled_tracer_is_inert():
    tel = Telemetry.disabled()
    with tel.tracer.span("request") as s:
        assert s.duration_s == 0.0
    assert tel.tracer.last_root() is None
    tel.registry.counter("x_total").inc(5)
    assert tel.registry.value("x_total") == 0
    assert tel.health is None


def test_health_rates_and_budget_burn():
    h = HealthTracker(budget_for=lambda t: 0.10)
    h.observe_plan(np.zeros(8, np.int32),
                   np.array([1, 1, 1, 1, 0, 0, 0, 0], bool))
    for dup in (True, True, False, False):
        h.observe_admission(0, duplicate=dup, admitted=True)
    t0 = h.snapshot()["tenants"]["0"]
    assert t0["hit"]["windowed"] == pytest.approx(0.5)
    assert t0["wasted_admission"]["windowed"] == pytest.approx(0.5)
    assert t0["budget"] == pytest.approx(0.10)
    assert t0["budget_burn"] == pytest.approx(5.0)
    h.observe_rebuild_start(plans_now=10)
    assert h.snapshot()["rebuild"]["in_overlap"]
    h.observe_rebuild_publish(plans_now=17, stall_s=2e-3)
    reb = h.snapshot()["rebuild"]
    assert reb["last_overlap_plans"] == 7 and reb["publishes"] == 1
    assert reb["stall_p99_s"] == pytest.approx(2e-3)
    reg = MetricsRegistry()
    h.drain(reg)
    assert reg.value("slo_budget_burn", tenant=0) == pytest.approx(5.0)
    assert reg.value("slo_hit_rate", tenant=0, kind="window") \
        == pytest.approx(0.5)
    assert reg.value("rebuild_overlap_plans") == 7


def test_overhead_budget_check():
    assert check_overhead_budget(1.0, 1.0) == []
    assert check_overhead_budget(1.02e-3, 1e-3) == []
    assert check_overhead_budget(2.0, 1.0)
    msg = check_overhead_budget(1.2e-1, 1e-1)
    assert msg and "over budget" in msg[0]


# ---------------------------------------------------------------------------
# the span tree through the pipeline, the stats schema, the batcher
# ---------------------------------------------------------------------------

def _service(fused: bool):
    tel = Telemetry()
    cache = CacheService(CacheConfig.from_kwargs(
        32, hot_capacity=16, warm_capacity=256, n_clusters=4, bucket=32,
        n_probe=2, threshold=0.93, flush_watermark=0.5, flush_size=4,
        kmeans_iters=2, seed=0, fused=fused, background_rebuild=True,
        telemetry=tel), device="cpu")
    embedder = HashNgramEmbedder(dim=32)
    svc = CachedLLMService(lambda qs: np.asarray(embedder.embed(qs)), cache,
                           None, HashTokenizer(vocab_size=512))
    return tel, cache, svc


@pytest.mark.parametrize("fused", [False, True])
def test_handle_produces_complete_span_tree(fused):
    """One request through ``handle`` yields the span tree (embed, plan,
    generate, commit and, once the flush watermark trips, maintenance)
    and tenant-labeled registry deltas, fused and four-op."""
    tel, cache, svc = _service(fused)
    queries = [f"distinct query number {i} about topic {i}"
               for i in range(12)]
    svc.handle(queries, tenant=3)
    root = tel.tracer.last_root()
    assert root is not None and root.name == "request"
    assert root.attrs["tenant"] == "3" and root.attrs["n"] == 12
    stages = root.stage_names()
    assert stages[:4] == ["embed", "plan", "generate", "commit"]
    assert "maintenance" in stages
    assert root.find("generate").attrs["n_leaders"] >= 1
    reg = tel.registry
    assert reg.value("serve_requests_total", tenant=3) == 12
    hits = reg.value("serve_hits_total", tenant=3)
    assert hits + reg.value("serve_misses_total", tenant=3) == 12
    assert reg.value("cache_plans_total") == 1
    assert reg.value("cache_commits_total") == 1
    assert reg.value("cache_admissions_total", tenant=3,
                     decision="admitted") >= 1
    assert reg.value("serve_maintenance_calls_total") == 1
    stage_h = tel.stage_histogram()
    for stage in ("embed", "plan", "generate", "commit"):
        assert stage_h.aggregate(stage=stage).count == 1, stage
        assert stage_h.aggregate(stage=stage, tenant="3").count == 1
    assert stage_h.aggregate(stage="maintenance").count >= 1
    svc.handle(queries, tenant=3)
    assert reg.value("serve_hits_total", tenant=3) > hits
    assert tel.tracer.last_root().stage_names()[:4] == [
        "embed", "plan", "generate", "commit"]
    cache.maintenance(block=True)


def test_flat_cache_shares_telemetry_with_engine():
    tel = Telemetry()
    cache = SemanticCache(capacity=64, dim=32, threshold=0.93,
                          telemetry=tel, device="cpu")
    embedder = HashNgramEmbedder(dim=32)
    svc = CachedLLMService(lambda qs: np.asarray(embedder.embed(qs)), cache,
                           None, HashTokenizer(vocab_size=512))
    assert svc.telemetry is tel
    svc.handle(["alpha beta", "gamma delta"])
    assert tel.registry.value("serve_requests_total") == 2
    assert tel.registry.value("cache_plans_total") == 1
    assert tel.tracer.last_root().stage_names()[:4] == [
        "embed", "plan", "generate", "commit"]


def test_stats_snapshot_schema():
    _, cache, svc = _service(fused=False)
    svc.handle(["one query", "two query"], tenant=1)
    d = cache.stats_snapshot().to_dict()
    assert d["schema"] == SCHEMA
    assert set(d) >= {"schema", "traffic", "admission", "tiers",
                      "rebuild", "health"}
    assert d["traffic"]["plans"] == 1
    assert d["admission"]["admitted"] >= 1
    assert d["health"]["tenants"]["1"]["hit"]["events"] == 2
    assert not hasattr(cache, "stats")


def test_batcher_idle_tick_accounts_exactly_once():
    """Every tick with a maintenance hook counts exactly one run or one
    skip."""
    lm = LM(get_config("phi3-mini-3.8b").reduced(), device="cpu").eval()
    b = ContinuousBatcher(lm, n_slots=2, max_len=48, prompt_len=8,
                          maintenance=lambda: "ran",
                          maintenance_max_interval=4)
    rng = np.random.default_rng(5)
    assert (b.maintenance_runs, b.maintenance_skips) == (0, 0)
    b.tick()
    assert (b.maintenance_runs, b.maintenance_skips) == (1, 0)
    assert b.last_maintenance == "ran"
    for i in range(6):
        b.submit(Request(uid=i, prompt=rng.integers(
            4, lm.cfg.vocab_size, 6).astype(np.int32), max_new_tokens=4))
    while b.pending or any(r is not None for r in b.slot_req):
        runs0, skips0 = b.maintenance_runs, b.maintenance_skips
        b.tick()
        assert (b.maintenance_runs - runs0) \
            + (b.maintenance_skips - skips0) == 1
    st = b.stats()
    assert st["ticks"] == b.maintenance_runs + b.maintenance_skips
    assert st["finished"] == 6 and st["admission_wait_p50_s"] >= 0.0
