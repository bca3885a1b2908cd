"""Port parity for the cache service's maintenance loop: the
double-buffered IVF rebuild (DESIGN.md §7) and conformal hit
calibration (§14.3), on the CPU.

The rebuild half mirrors the reference's `tests/test_background_
rebuild.py` on the port (a lookup issued mid-rebuild reads the old
index; no row is stranded under racing flushes; the receipt's
maintenance obligation; the advertised flag), shows that a snapshot is
left bit for bit unchanged by every tier op that serving applies after
it, and drives one trace through the reference and the port with
``maintenance(block=True)`` after every batch, so each publish lands at
the same point on both sides: inverted lists, sizes and ``indexed_total``
exactly, centroids within ``SCORE_ATOL``.  The conformal half feeds the
same hit audits to both services: the same floors, served thresholds
(``atol 1e-5``, the scores' tolerance: a floor is a score plus 1e-6) and
``stats_snapshot()["learning"]["conformal"]``.

The k-means seed row is handed to the port from the reference's
``jax.random.choice`` draw, as in the other service tests.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_service import CacheConfig as JCacheConfig
from repro.cache_service import CacheRequest as JCacheRequest
from repro.cache_service import CacheService as JCacheService
from repro.cache_service.feedback import ConformalWindow as JWindow
from repro.cache_service.feedback import FeedbackAccumulator as JAccumulator
from repro.cache_service.feedback import FeedbackConfig as JFeedbackConfig
from repro.cache_service.policy import PolicyTable as JPolicyTable
from repro.cache_service.policy import TenantPolicy as JTenantPolicy
from repro_torch.cache_service import (
    CacheConfig, CacheRequest, CacheService, FeedbackConfig, tiers,
)
from repro_torch.cache_service.feedback import (
    ConformalWindow, FeedbackAccumulator,
)
from repro_torch.cache_service.policy import PolicyTable, TenantPolicy
from repro_torch.cache_service.protocol import CachePlan
from repro_torch.core import ivf as port_ivf
from repro_torch.core.embedders import HashNgramEmbedder
from repro_torch.data import HashTokenizer
from repro_torch.serving import CachedLLMService

SCORE_ATOL = 1e-5
D = 16


def _reference_first_seed(valid, seed):
    v = jnp.asarray(valid.cpu().numpy())
    p = v.astype(jnp.float32)
    p = jnp.where(p.sum() > 0, p, jnp.ones_like(p))
    return int(jax.random.choice(jax.random.PRNGKey(seed), v.shape[0],
                                 p=p / p.sum()))


@pytest.fixture(autouse=True)
def _same_kmeans_seed(monkeypatch):
    monkeypatch.setattr(port_ivf, "first_seed", _reference_first_seed)


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _kw(background, **kw):
    cfg = dict(hot_capacity=16, warm_capacity=64, n_clusters=4, bucket=32,
               n_probe=4, threshold=0.9, flush_size=8, rebuild_every=2,
               background_rebuild=background)
    cfg.update(kw)
    return cfg


def _mk(background, **kw):
    return CacheService(CacheConfig.from_kwargs(D, **_kw(background, **kw)),
                        device="cpu")


def _lookup(svc, keys, tenant=0):
    plan = svc.plan(CacheRequest.build(np.asarray(keys), tenant),
                    coalesce=False)
    return plan.hit, plan.scores, plan.responses


def _insert(svc, keys, texts, tenant=0):
    req = CacheRequest.build(np.asarray(keys), tenant)
    plan = CachePlan.for_insert(req, np.ones(len(texts), bool), None,
                                epoch=svc._epoch,
                                embed_version=svc._embed_version)
    return svc.commit(plan, list(texts))


def _gate_first_rebuild(svc):
    """The first ``_rebuild`` call (the shadow thread's) parks on an
    Event; later calls run through."""
    gate = threading.Event()
    real = svc._rebuild
    state = {"first": True}

    def gated(warm):
        if state["first"]:
            state["first"] = False
            assert gate.wait(timeout=60), "test gate never opened"
        return real(warm)

    svc._rebuild = gated
    return gate


# ---------------------------------------------------------------------------
# double-buffered rebuild
# ---------------------------------------------------------------------------

def test_mid_rebuild_lookup_reads_old_published_index():
    rng = np.random.default_rng(41)
    svc = _mk(True, rebuild_every=3)     # tail 24: no forced join below
    gate = _gate_first_rebuild(svc)
    keys = _unit(rng.standard_normal((16, D)).astype(np.float32))
    _insert(svc, keys, [f"r{i}" for i in range(16)])

    svc.flush(rebuild=True)              # starts the gated shadow
    st = svc.stats_snapshot().rebuild
    assert st["in_flight"] and st["shadow_started"] == 1
    assert st["rebuilds"] == 0
    idx_before = int(svc.warm.indexed_total)

    hit, _, vals = _lookup(svc, keys)    # the tail serves the new rows
    assert hit.all() and all(v is not None for v in vals)
    assert int(svc.warm.indexed_total) == idx_before

    keys2 = _unit(rng.standard_normal((8, D)).astype(np.float32))
    _insert(svc, keys2, [f"s{i}" for i in range(8)])
    svc.flush(rebuild=False)             # more rows during the overlap
    hit, _, _ = _lookup(svc, np.concatenate([keys, keys2]))
    assert hit.all() and svc.stats_snapshot().rebuild["in_flight"]

    gate.set()
    rep = svc.maintenance(block=True)
    assert rep.rebuild_published and not rep.rebuild_in_flight
    assert rep.rebuild_wall_s > 0
    st = svc.stats_snapshot().rebuild
    assert st["rebuilds"] == 1 and not st["in_flight"]
    # indexed_total is the SNAPSHOT's: the overlap's rows stay in the tail
    assert int(svc.warm.indexed_total) > idx_before
    assert svc._backlog() > 0
    hit, _, _ = _lookup(svc, np.concatenate([keys, keys2]))
    assert hit.all()


def test_background_mode_never_strands_rows_under_sustained_traffic():
    """Real threads racing real flushes: after every batch every live
    entry is reachable, as in inline mode."""
    rng = np.random.default_rng(42)
    bg, inline = _mk(True), _mk(False)
    all_keys = []
    for step in range(20):
        e = _unit(rng.standard_normal((8, D)).astype(np.float32))
        all_keys.append(e)
        texts = [f"b{step}-{i}" for i in range(8)]
        _insert(bg, e, texts)
        _insert(inline, e, texts)
        keys = np.concatenate(all_keys)
        hb, _, _ = _lookup(bg, keys)
        hi, _, _ = _lookup(inline, keys)
        np.testing.assert_array_equal(hb, hi, err_msg=f"step {step}")
        assert len(bg.responses) == len(inline.responses)
        live = bg._live_vids()
        assert len(live) == len(bg.responses)
    bg.maintenance(block=True)
    st = bg.stats_snapshot().rebuild
    assert st["shadow_started"] > 0
    assert st["rebuilds"] >= 1 and not st["in_flight"]


def test_commit_receipt_surfaces_maintenance_obligation():
    rng = np.random.default_rng(43)
    svc = _mk(True, rebuild_every=1)
    due = False
    for step in range(6):
        e = _unit(rng.standard_normal((8, D)).astype(np.float32))
        plan = svc.plan(CacheRequest.build(e, 0))
        due = due or svc.commit(plan, [f"c{step}-{i}" for i in range(8)]
                                ).rebuild_due
    assert due
    svc.maintenance(block=True)
    assert svc.stats_snapshot().rebuild["rebuilds"] > 0


def test_pipeline_drives_maintenance_between_batches():
    emb = HashNgramEmbedder(dim=64)
    cache = CacheService(CacheConfig.from_kwargs(
        64, hot_capacity=16, warm_capacity=128, n_clusters=4, bucket=64,
        threshold=0.95, flush_size=8, rebuild_every=2,
        background_rebuild=True), device="cpu")
    svc = CachedLLMService(lambda t: np.asarray(emb.embed(t)), cache,
                           None, HashTokenizer())
    for step in range(12):
        out = svc.handle([f"question {step} variant {i}" for i in range(8)])
        assert all(r.response is not None for r in out)
    cache.maintenance(block=True)
    st = svc.stats()
    assert st["backend"]["rebuild"]["shadow_started"] > 0, st
    assert st["maintenance_calls"] > 0, st


def test_background_flag_is_advertised():
    assert _mk(True).capabilities().background_rebuild
    assert not _mk(False).capabilities().background_rebuild


def test_shadow_failure_is_raised_at_publish():
    """An exception on the shadow thread is never swallowed: the publish
    re-raises it as ``RuntimeError`` with the cause attached."""
    rng = np.random.default_rng(44)
    svc = _mk(True, rebuild_every=3)

    def broken(warm):
        raise ValueError("k-means exploded")

    svc._rebuild = broken
    _insert(svc, _unit(rng.standard_normal((16, D)).astype(np.float32)),
            [f"r{i}" for i in range(16)])
    svc.flush(rebuild=True)
    with pytest.raises(RuntimeError, match="background IVF rebuild failed"
                       ) as info:
        svc.maintenance(block=True)
    assert isinstance(info.value.__cause__, ValueError)


def _snapshot(state):
    return [t.clone() for t in state]


def _assert_unchanged(state, copy):
    for name, a, b in zip(state._fields, state, copy):
        assert torch.equal(a, b), name


def test_snapshot_is_unchanged_by_later_tier_ops():
    """The shadow thread reads a snapshot while serving goes on: every
    tier op serving applies after it (hot insert, LRU touch, demotion,
    warm append, rebuild, publish, TTL mask and reap, tenant eviction)
    returns new tensors and leaves the snapshot bit for bit as it was."""
    rng = np.random.default_rng(45)
    hot = tiers.init_hot(16, D)
    warm = tiers.init_warm(32, D, 4, 16)
    for step in range(6):
        e = torch.from_numpy(
            _unit(rng.standard_normal((12, D)).astype(np.float32)))
        hot, _ = tiers.hot_insert_batch(
            hot, e, torch.arange(12, dtype=torch.int32) + 12 * step,
            torch.zeros(12, dtype=torch.int32),
            torch.full((12,), 5.0 + step))
        hot, dem = tiers.demote_coldest(hot, 8)
        warm, _ = tiers.warm_append(warm, dem)
    hot_snap, warm_snap = _snapshot(hot), _snapshot(warm)
    h2, w2 = hot, warm
    e = torch.from_numpy(_unit(rng.standard_normal((12, D))
                               .astype(np.float32)))
    h2, _ = tiers.hot_insert_batch(h2, e, torch.arange(12, dtype=torch.int32)
                                   + 500, torch.ones(12, dtype=torch.int32))
    h2 = tiers.hot_touch(h2, torch.arange(4, dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool))
    h2, dem = tiers.demote_coldest(h2, 8)
    w2, _ = tiers.warm_append(w2, dem)
    w2 = tiers.warm_publish_index(w2, tiers.warm_rebuild(w2, 2, 0))
    tiers.mask_expired(h2, w2, 7.0)
    h2, w2, _, _ = tiers.reap_expired(h2, w2, 7.0)
    h2, w2, _, _ = tiers.evict_tenant(h2, w2, 0)
    _assert_unchanged(hot, hot_snap)
    _assert_unchanged(warm, warm_snap)
    assert not torch.equal(w2.value_ids, warm.value_ids)


def _ref_pair(background):
    kw = _kw(background)
    ref = JCacheService(JCacheConfig.from_kwargs(D, **kw))
    port = CacheService(CacheConfig.from_kwargs(D, **kw), device="cpu")
    return ref, port


def test_shadow_publish_matches_reference():
    """One trace through both services with ``maintenance(block=True)``
    after every commit: the same verdicts, the same published index
    after every batch, the same rebuild counters."""
    rng = np.random.default_rng(46)
    ref, port = _ref_pair(True)
    base = _unit(rng.standard_normal((40, D)).astype(np.float32))
    published = 0
    for step in range(24):
        ids = rng.integers(0, len(base), 8)
        embs = _unit(base[ids] + 0.05 * rng.standard_normal((8, D))
                     ).astype(np.float32)
        tenant = step % 2
        pa = ref.plan(JCacheRequest.build(embs, tenant))
        pb = port.plan(CacheRequest.build(embs, tenant))
        for name in ("hit", "value_ids", "admit", "miss_leader"):
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(pa, name), err_msg=name)
        np.testing.assert_allclose(pb.scores, pa.scores, atol=SCORE_ATOL)
        resp = [f"a{step}-{i}" for i in range(8)]
        ra, rb = ref.commit(pa, resp), port.commit(pb, resp)
        assert (ra.admitted, ra.evicted, ra.rebuild_due) \
            == (rb.admitted, rb.evicted, rb.rebuild_due)
        ma, mb = ref.maintenance(block=True), port.maintenance(block=True)
        assert (ma.rebuild_published, ma.rebuild_in_flight) \
            == (mb.rebuild_published, mb.rebuild_in_flight)
        published += mb.rebuild_published
        for name in ("members", "sizes", "indexed_total", "total",
                     "cursor"):
            np.testing.assert_array_equal(
                getattr(port.warm, name).numpy(),
                np.asarray(getattr(ref.warm, name)), err_msg=name)
        np.testing.assert_allclose(port.warm.centroids.numpy(),
                                   np.asarray(ref.warm.centroids),
                                   atol=SCORE_ATOL)
    assert published >= 2
    for key in ("rebuilds", "shadow_started", "in_flight"):
        assert port.stats_snapshot().rebuild[key] \
            == ref.stats_snapshot().rebuild[key], key
    assert ref.responses == port.responses


def test_published_shadow_equals_inline_rebuild():
    """The index a shadow publishes is the inline ``warm_rebuild`` of the
    same snapshot (same k-means seed row): lists and sizes exactly."""
    rng = np.random.default_rng(47)
    svc = _mk(True, rebuild_every=3)
    seen = {}
    real = svc._rebuild

    def capture(warm):
        seen["snapshot"] = warm
        seen["shadow"] = out = real(warm)
        return out

    svc._rebuild = capture
    _insert(svc, _unit(rng.standard_normal((16, D)).astype(np.float32)),
            [f"r{i}" for i in range(16)])
    svc.flush(rebuild=True)
    svc.maintenance(block=True)
    inline = tiers.warm_rebuild(seen["snapshot"], svc._kmeans_iters,
                                svc._seed)
    for name in ("members", "sizes", "indexed_total"):
        assert torch.equal(getattr(svc.warm, name), getattr(inline, name))
    torch.testing.assert_close(svc.warm.centroids, inline.centroids,
                               atol=SCORE_ATOL, rtol=0)
    assert int(inline.sizes.sum()) == int(seen["snapshot"].valid.sum())


# ---------------------------------------------------------------------------
# conformal hit calibration through the service
# ---------------------------------------------------------------------------

def _conformal_trace(seed, n_batches=30, batch=8):
    """Pairs of clusters whose centres sit ~0.9 apart: a query of one
    often hits an entry of its twin under a 0.85 threshold (a false
    hit the audit reports); the floor must learn that band."""
    rng = np.random.default_rng(seed)
    a = _unit(rng.standard_normal((6, D)))
    b = _unit(a + 0.45 * _unit(rng.standard_normal((6, D))))
    centres = np.concatenate([a, b])                 # cluster c, twin c^6
    out = []
    for _ in range(n_batches):
        c = rng.integers(0, 12, batch)
        e = _unit(centres[c] + 0.03 * rng.standard_normal((batch, D)))
        out.append((c, e.astype(np.float32)))
    return out


@pytest.mark.parametrize("learned", [False, True])
def test_conformal_floors_match_reference(learned):
    """The same hit audits (false iff the served answer is of another
    cluster) reach both services: served thresholds, floors and the
    conformal stats agree batch by batch, and the floor rises above the
    configured threshold.  Conformal alone (the default window, which
    needs 64 negatives, so a longer trace), and beside learned
    admission (a ``FeedbackConfig`` with a floor from 8 negatives)."""
    kw = dict(threshold=0.85, hot_capacity=64, warm_capacity=128,
              n_clusters=4, bucket=64, flush_size=16, conformal=True)
    ref_kw, port_kw = dict(kw), dict(kw)
    if learned:
        ref_kw["feedback_config"] = JFeedbackConfig(conformal_min=8)
        port_kw["feedback_config"] = FeedbackConfig(conformal_min=8)
    ref = JCacheService(JCacheConfig.from_kwargs(D, **ref_kw))
    port = CacheService(CacheConfig.from_kwargs(D, **port_kw),
                        device="cpu")
    assert port.capabilities().conformal and port.feedback is not None
    assert port.learned_admission == learned
    raised = False
    trace = _conformal_trace(7, n_batches=30 if learned else 80)
    for step, (c, e) in enumerate(trace):
        tenant = step % 2
        pa = ref.plan(JCacheRequest.build(e, tenant))
        pb = port.plan(CacheRequest.build(e, tenant))
        for name in ("hit", "value_ids", "admit"):
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(pa, name), err_msg=name)
        thr_a, thr_b = pa.margins + pa.scores, pb.margins + pb.scores
        np.testing.assert_allclose(thr_b, thr_a, atol=SCORE_ATOL)
        raised |= bool((thr_b > 0.85 + 1e-6).any())
        for svc, plan in ((ref, pa), (port, pb)):
            for i in np.flatnonzero(plan.hit):
                svc.feedback.observe_hit_audit(
                    tenant, float(plan.scores[i]),
                    plan.responses[i] == f"ans{c[i]}")
        resp = [f"ans{x}" for x in c]
        ref.commit(pa, resp)
        port.commit(pb, resp)
        ma, mb = ref.maintenance(), port.maintenance()
        assert (ma.refits_applied, ma.refits_checked) \
            == (mb.refits_applied, mb.refits_checked)
        for t in (0, 1):
            fa, fb_ = ref.feedback.conformal_floor(t), \
                port.feedback.conformal_floor(t)
            assert (fa is None) == (fb_ is None)
            if fa is not None:
                assert abs(fa - fb_) <= SCORE_ATOL
    assert raised
    ca = ref.stats_snapshot().learning["conformal"]
    cb = port.stats_snapshot().learning["conformal"]
    assert (ca["hit_audits"], ca["audited_false_hits"]) \
        == (cb["hit_audits"], cb["audited_false_hits"]) and ca["hit_audits"]
    assert ca["tenants"].keys() == cb["tenants"].keys()
    for t, w in ca["tenants"].items():
        assert (w["fill"], w["seen"]) == (cb["tenants"][t]["fill"],
                                          cb["tenants"][t]["seen"])
        assert abs(w["floor"] - cb["tenants"][t]["floor"]) <= SCORE_ATOL


def test_conformal_window_matches_reference():
    """The window's floor is the same order statistic on both sides,
    and it is a recency ring."""
    scores = np.random.default_rng(3).uniform(0, 0.9, 100)
    a, b = JWindow(capacity=64), ConformalWindow(capacity=64)
    for s in scores:
        a.add(float(s))
        b.add(float(s))
    for alpha in (1e-6, 0.01, 0.25, 0.9):
        assert b.floor(alpha) == pytest.approx(a.floor(alpha), abs=1e-7)
    w = ConformalWindow(capacity=8)
    for s in [0.9] * 8 + [0.1] * 8:
        w.add(s)
    assert w.floor(0.3) < 0.2


def test_hit_audits_and_effective_thresholds_match_reference():
    """Audited false hits raise the floor, true hits leave it; the
    effective threshold only ever raises a tenant's policy."""
    pairs = []
    for acc, cfg in ((JAccumulator, JFeedbackConfig),
                     (FeedbackAccumulator, FeedbackConfig)):
        fb = acc(cfg(conformal_min=8, max_false_hit_rate=0.05))
        for _ in range(16):
            fb.observe(0, 0.4, duplicate=False, admitted=True)
        low = fb.conformal_floor(0)
        for _ in range(16):
            fb.observe_hit_audit(0, 0.8, duplicate=False)
        high = fb.conformal_floor(0)
        for _ in range(16):
            fb.observe_hit_audit(0, 0.99, duplicate=True)
        pairs.append((low, high, fb.conformal_floor(0),
                      fb.counters["hit_audits"],
                      fb.counters["audited_false_hits"]))
    assert pairs[0] == pytest.approx(pairs[1])
    low, high, after, audits, false = pairs[1]
    assert low < 0.5 < 0.7 < high == pytest.approx(after)
    assert (audits, false) == (32, 16)
    effs = []
    for acc, cfg, table, pol in (
            (JAccumulator, JFeedbackConfig, JPolicyTable, JTenantPolicy),
            (FeedbackAccumulator, FeedbackConfig, PolicyTable,
             TenantPolicy)):
        fb = acc(cfg(conformal_min=4))
        for _ in range(8):
            fb.observe(0, 0.95, duplicate=False, admitted=True)
            fb.observe(1, 0.10, duplicate=False, admitted=True)
        effs.append(table(pol(threshold=0.85)).effective_thresholds(
            np.asarray([0, 1, 2]), fb))
    np.testing.assert_allclose(effs[1], effs[0], atol=1e-7)
    assert effs[1][0] > 0.9
    assert effs[1][1] == pytest.approx(0.85) == effs[1][2]
