"""Port parity for the host-RAM cold tier (DESIGN.md §12) on the CPU.

Mirrors the reference's `tests/test_cold_tier.py` on the port (demotion
capture, the eviction split, budgeted lookup and the router, tenant
isolation, asynchronous promotion, the eviction race) and feeds the
same seeded numpy inputs to the reference and the port: the
``ColdTier`` alone (int8 rows, route assignments, every fetch, hit,
promotion and counter exactly; scores ``atol 1e-5``; the int8 scales
within 2 float32 ulps, because XLA divides by 127 as a multiply by its
reciprocal, so dequantized keys and the routes' centroids within
``1e-6``) and one trace
through both
services, fp32 and int8 warm rows, four-op and fused (every plan's
verdicts, every receipt, every maintenance report and every counter
exactly).  A cold score is the exact cosine of a dequantized key, so
it is within the DESIGN.md §8.3 bound ``amax·√D/254`` of the fp32 key's.

The reference's ``test_sharded_plus_cold_rejected`` is mirrored below
on a one-rank mesh (and in `tests/test_torch_sharded_service.py`): a
cold tier over a sharded warm tier is refused at construction.
The k-means seed row of the warm IVF is handed to the port from the
reference's draw, as in the other service tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache_service import CacheConfig as JCacheConfig
from repro.cache_service import CacheRequest as JCacheRequest
from repro.cache_service import CacheService as JCacheService
from repro.cache_service import ColdRoutingPolicy as JColdRoutingPolicy
from repro.cache_service import ColdTier as JColdTier
from repro_torch.cache_service import (
    CacheConfig, CacheRequest, CacheService, ShardingConfig, TieringConfig,
    tiers,
)
from repro_torch.cache_service.cold import ColdTier
from repro_torch.cache_service.policy import ColdRoutingPolicy
from repro_torch.cache_service.protocol import CachePlan
from repro_torch.core import ivf as port_ivf

SCORE_ATOL = 1e-5
# XLA divides by 127 as a multiply by its reciprocal: the int8 scales
# (amax / 127) can differ by 2 float32 ulps, the int8 rows do not
SCALE_RTOL = 5e-7
RECEIPT = ("admitted", "skipped", "evicted", "rebuild_due", "demoted_cold",
           "cold_maintenance_due", "embed_version", "stale_version_skipped",
           "ttl_stamped")


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


def _keys(rng, n, d=16):
    return _unit(rng.standard_normal((n, d)).astype(np.float32))


POLICY = dict(min_rows_for_routing=16, n_clusters=4, route_rebuild_every=64,
              router_margin=2.0, promote_max=16)


def _service(d=16, cold_capacity=128, **kw):
    """Small enough that the warm ring wraps quickly; the router margin
    is opened wide so random keys (far from any coarse centroid) are
    still fetched."""
    pol = kw.pop("cold_policy", ColdRoutingPolicy(**POLICY))
    return CacheService(CacheConfig.from_kwargs(
        d, hot_capacity=16, warm_capacity=32, n_clusters=4, bucket=16,
        flush_size=8, threshold=0.8, cold_capacity=cold_capacity,
        cold_policy=pol, **kw), device="cpu")


def _fill(svc, keys, tenant=0, tag="", req=CacheRequest):
    for lo in range(0, len(keys), 8):
        plan = svc.plan(req.build(keys[lo:lo + 8], tenant))
        svc.commit(plan, [f"r{tag}{lo + i}" for i in range(8)])
    svc.flush()


def _insert(svc, keys, texts, tenant=0):
    req = CacheRequest.build(np.asarray(keys), tenant)
    plan = CachePlan.for_insert(req, np.ones(len(texts), bool), None,
                                epoch=svc._epoch,
                                embed_version=svc._embed_version)
    return svc.commit(plan, list(texts)).admitted


# ---------------------------------------------------------------------------
# the eviction split
# ---------------------------------------------------------------------------

def test_no_drops_with_cold_tier_enabled():
    """Every warm-ring overwrite is captured, never dropped, while the
    cold ring has room."""
    keys = _keys(np.random.default_rng(29), 200)
    svc = _service(cold_capacity=512)
    _fill(svc, keys)
    t = svc.stats_snapshot().tiers
    assert t["evictions_demoted"] > 0 and t["evictions_dropped"] == 0
    cold = t["cold"]
    assert cold["cold_rows"] == cold["cold_inserted"]
    assert cold["cold_dropped"] == 0
    assert len(svc.responses) == len(svc)


def test_drops_counted_without_cold_tier():
    keys = _keys(np.random.default_rng(30), 200)
    svc = CacheService(CacheConfig.from_kwargs(
        16, hot_capacity=16, warm_capacity=32, n_clusters=4, bucket=16,
        flush_size=8, threshold=0.8), device="cpu")
    assert svc.cold is None and not svc.capabilities().cold_tier
    _fill(svc, keys)
    t = svc.stats_snapshot().tiers
    assert t["evictions_demoted"] == 0
    assert 0 < t["evictions_dropped"] <= t["evictions"]


def test_cold_ring_overwrites_are_the_final_drops():
    keys = _keys(np.random.default_rng(31), 240)
    svc = _service(cold_capacity=64)
    _fill(svc, keys)
    t = svc.stats_snapshot().tiers
    assert t["evictions_dropped"] == 0
    assert t["cold"]["cold_dropped"] > 0
    assert t["evictions"] == t["cold"]["cold_dropped"]
    assert len(svc.responses) == len(svc)


def test_demote_tie_breaks_on_insertion_sequence():
    """Equal ``last_used`` clocks demote in insertion order (oldest
    first), not slot order."""
    cap, d, m = 8, 4, 3
    keys = _keys(np.random.default_rng(32), cap, d)
    hot = tiers.init_hot(cap, d)._replace(
        keys=torch.from_numpy(keys), valid=torch.ones(cap, dtype=bool),
        tenants=torch.zeros(cap, dtype=torch.int32),
        last_used=torch.full((cap,), 7, dtype=torch.int32),
        inserted_at=torch.arange(cap - 1, -1, -1, dtype=torch.int32),
        value_ids=torch.arange(cap, dtype=torch.int32),
        clock=torch.tensor(8, dtype=torch.int32))
    _, dem = tiers.demote_coldest(hot, m)
    assert dem.mask.all()
    assert sorted(dem.value_ids.tolist()) == [5, 6, 7]


# ---------------------------------------------------------------------------
# ColdTier against the reference's
# ---------------------------------------------------------------------------

def _tier_pair(n, d, **pol):
    return (JColdTier(n, d, policy=JColdRoutingPolicy(**pol)),
            ColdTier(n, d, policy=ColdRoutingPolicy(**pol), device="cpu"))


def _assert_fetch_equal(a, b):
    for name in ("value_ids", "slots", "consulted"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    np.testing.assert_allclose(b.scores, a.scores, atol=SCORE_ATOL)
    assert (a.fetched_rows, a.router_skips) == (b.fetched_rows,
                                                b.router_skips)


def test_cold_tier_matches_reference():
    """Bulk load (the int8 panel and the routes), lookups of offered
    rows, tenant masks, TTL masks and reaps, promotions and every
    counter, on both tiers."""
    rng = np.random.default_rng(33)
    d, n = 16, 256
    keys = _keys(rng, n, d)
    ten = (np.arange(n) % 3).astype(np.int32)
    exp = np.where(np.arange(n) % 5 == 0, 10.0, np.inf).astype(np.float32)
    a, b = _tier_pair(n + 64, d, min_rows_for_routing=16, n_clusters=8,
                      fetch_budget=8, router_margin=0.3)
    a.bulk_load(keys, np.arange(n), ten, exp)
    b.bulk_load(keys, np.arange(n), ten, exp)
    np.testing.assert_array_equal(b.keys_q, a.keys_q)
    np.testing.assert_allclose(b.scales, a.scales, rtol=SCALE_RTOL)
    np.testing.assert_allclose(b.centroids, a.centroids, atol=1e-6)
    np.testing.assert_array_equal(b._assign, a._assign)
    assert abs(b.route_slack - a.route_slack) <= 1e-6
    for step in range(4):
        q = np.concatenate([
            _unit(keys[rng.choice(n, 12)] + 0.02 * rng.standard_normal(
                (12, d)).astype(np.float32)), _keys(rng, 4, d)])
        qt = rng.integers(0, 3, 16).astype(np.int32)
        thr = np.full(16, 0.9, np.float32)
        need = rng.random(16) < 0.8
        now = None if step < 2 else 11.0
        _assert_fetch_equal(a.lookup(q, qt, thr, need, now=now),
                            b.lookup(q, qt, thr, need, now=now))
    extra = _keys(rng, 80, d)
    k8, sc = tiers.quantize_rows(torch.from_numpy(extra))
    da = a.insert(k8.numpy(), sc.numpy(), np.arange(n, n + 80),
                  np.zeros(80, np.int32))
    db = b.insert(k8.numpy(), sc.numpy(), np.arange(n, n + 80),
                  np.zeros(80, np.int32))
    np.testing.assert_array_equal(db, da)
    np.testing.assert_array_equal(b.reap_expired(11.0), a.reap_expired(11.0))
    pa, pb = a.take_promotions(5), b.take_promotions(5)
    for name in ("value_ids", "tenants", "expires"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(pa, name),
                                      err_msg=name)
    np.testing.assert_allclose(pb.keys, pa.keys, atol=1e-6)
    np.testing.assert_array_equal(b.evict_tenant(1), a.evict_tenant(1))
    assert b.stats() == a.stats()
    assert b.stats()["cold_hits"] > 0 and b.stats()["cold_promoted"] == 5


def test_cold_tier_budgeted_lookup_and_router():
    rng = np.random.default_rng(34)
    d, n = 16, 256
    keys = _keys(rng, n, d)
    cold = ColdTier(n, d, policy=ColdRoutingPolicy(
        min_rows_for_routing=16, n_clusters=8, fetch_budget=8,
        router_margin=2.0), device="cpu")
    cold.bulk_load(keys, np.arange(n), np.zeros(n, np.int32))
    assert cold.centroids is not None
    need = np.array([True, True, True, False, False, True])
    cf = cold.lookup(keys[:6], np.zeros(6, np.int32),
                     np.full(6, 0.9, np.float32), need)
    assert (cf.consulted == need).all()
    assert (cf.value_ids[need] == np.array([0, 1, 2, 5])).all()
    # int8 storage: within the quantization bound of the fp32 cosine 1
    amax = np.abs(keys[:6]).max(axis=1)[need]
    assert (np.abs(cf.scores[need] - 1.0)
            <= amax * np.sqrt(d) / 254 + 1e-5).all()
    assert cf.scores[~need].min() <= -1e29
    assert (cf.value_ids[~need] == -1).all()
    assert cf.fetched_rows <= need.sum() * cold.policy.fetch_budget
    assert cold.pending_promotions == int(need.sum())
    assert cold.route_slack > 0.2         # loose clusters open the gate

    cents = _keys(rng, 4, d)
    tkeys = _unit(np.repeat(cents, n // 4, axis=0)
                  + 0.02 * rng.standard_normal((n, d)).astype(np.float32))
    tight = ColdTier(n, d, policy=ColdRoutingPolicy(
        min_rows_for_routing=16, n_clusters=8, router_margin=0.01),
        device="cpu")
    tight.bulk_load(tkeys, np.arange(n), np.zeros(n, np.int32))
    assert tight.route_slack < 0.2
    cf2 = tight.lookup(_keys(rng, 4, d), np.zeros(4, np.int32),
                       np.full(4, 0.99, np.float32), np.ones(4, bool))
    assert cf2.router_skips == 4 and not cf2.consulted.any()
    assert tight.stats()["cold_router_skips"] == 4


def test_cold_tier_tenant_isolation():
    d, n = 8, 64
    keys = _keys(np.random.default_rng(35), n, d)
    cold = ColdTier(n, d, policy=ColdRoutingPolicy(
        min_rows_for_routing=1024, router_margin=2.0), device="cpu")
    cold.bulk_load(keys, np.arange(n), (np.arange(n) % 2).astype(np.int32))
    cf = cold.lookup(keys[:4], np.full(4, 1, np.int32),
                     np.full(4, 0.9, np.float32), np.ones(4, bool))
    assert (cf.value_ids[[1, 3]] == [1, 3]).all()
    assert not (cf.scores[[0, 2]] >= 0.9).any()


def test_take_promotions_skips_stale_entries():
    d, n = 8, 32
    keys = _keys(np.random.default_rng(36), n, d)
    cold = ColdTier(n, d, policy=ColdRoutingPolicy(
        min_rows_for_routing=1024, router_margin=2.0), device="cpu")
    cold.bulk_load(keys, np.arange(n), np.zeros(n, np.int32))
    cold.lookup(keys[:4], np.zeros(4, np.int32),
                np.full(4, 0.9, np.float32), np.ones(4, bool))
    assert cold.pending_promotions == 4
    cold.evict_tenant(0)
    assert cold.pending_promotions == 0
    assert cold.take_promotions(16) is None


# ---------------------------------------------------------------------------
# end to end through the service
# ---------------------------------------------------------------------------

def test_wraparound_demotes_to_cold_and_serves_back():
    """Rows pushed off the wrapped warm ring stay servable through the
    cold tier, and a cold hit is promoted back to warm by the next
    maintenance tick."""
    keys = _keys(np.random.default_rng(37), 200)
    svc = _service(cold_capacity=512)
    _fill(svc, keys)
    cold_vids = sorted(int(v) for v in svc.cold.value_ids[svc.cold.valid])
    assert len(cold_vids) > 100
    idx = cold_vids[:8]                  # vid == insertion index here
    plan = svc.plan(CacheRequest.build(keys[idx], 0))
    assert plan.hit.all()
    assert list(plan.responses) == [f"r{j}" for j in idx]
    s = svc.stats_snapshot()
    assert s.traffic["cold_hits"] >= 8
    assert s.tiers["cold"]["cold_fetches"] >= 8
    receipt = svc.commit(plan, [None] * 8)
    assert receipt.cold_maintenance_due
    rep = svc.maintenance()
    assert rep.cold_promoted >= 8
    plan2 = svc.plan(CacheRequest.build(keys[idx], 0))
    assert plan2.hit.all()
    t2 = svc.stats_snapshot()
    assert t2.traffic["hot_hits"] + t2.traffic["warm_hits"] >= 8
    assert t2.tiers["evictions_dropped"] == 0


def test_commit_receipt_reports_cold_demotions():
    keys = _keys(np.random.default_rng(38), 96)
    svc = _service(cold_capacity=256)
    demoted = 0
    for lo in range(0, len(keys), 8):
        plan = svc.plan(CacheRequest.build(keys[lo:lo + 8], 0))
        demoted += svc.commit(plan, [f"r{lo + i}" for i in range(8)]
                              ).demoted_cold
    assert demoted == svc.cold.n_inserted > 0
    svc.flush()
    assert svc.stats_snapshot().tiers["cold"]["cold_inserted"] \
        == svc.cold.n_inserted >= demoted


def test_evict_tenant_between_cold_hit_and_maintenance():
    """A tenant evicted after a cold hit queued its promotion does not
    resurrect through the maintenance drain, and its strings are freed."""
    rng = np.random.default_rng(39)
    keys = _keys(rng, 200)
    svc = _service(cold_capacity=512)
    _fill(svc, keys, tenant=0)
    other = _keys(rng, 8)
    _insert(svc, other, [f"t1-{i}" for i in range(8)], tenant=1)
    cold_vids = sorted(int(v) for v in svc.cold.value_ids[svc.cold.valid])
    plan = svc.plan(CacheRequest.build(keys[cold_vids[:8]], 0))
    assert plan.hit.all() and svc.cold.pending_promotions >= 8
    assert svc.evict_tenant(0) > 0
    rep = svc.maintenance()
    assert rep.cold_promoted == 0 and svc.cold.pending_promotions == 0
    assert not svc.plan(CacheRequest.build(keys[cold_vids[:8]], 0)).hit.any()
    assert sorted(svc.responses.values()) == [f"t1-{i}" for i in range(8)]
    plan = svc.plan(CacheRequest.build(other, 1), coalesce=False)
    assert plan.hit.all()
    assert all(v.startswith("t1-") for v in plan.responses)


def test_cold_with_warm_block_streaming():
    """``warm_block`` underneath, the cold tier behind: cold-enabled
    hits are a superset of warm-only hits, random queries never hit."""
    rng = np.random.default_rng(40)
    keys = _keys(rng, 120)
    svc = _service(cold_capacity=256, warm_block=16)
    _fill(svc, keys)
    base = CacheService(CacheConfig.from_kwargs(
        16, hot_capacity=16, warm_capacity=32, n_clusters=4, bucket=16,
        flush_size=8, threshold=0.8), device="cpu")
    _fill(base, keys)
    q = np.concatenate([keys[100:110], _keys(rng, 6)])
    p_cold = svc.plan(CacheRequest.build(q, 0))
    p_base = base.plan(CacheRequest.build(q, 0))
    assert (p_cold.hit | ~p_base.hit).all()
    assert not p_cold.hit[10:].any()


def test_cold_policy_alone_implies_capacity_and_mesh_is_refused():
    """``cold_policy`` without a capacity implies ``4 * warm_capacity``
    rows, as in the reference.  A cold tier over a sharded warm tier is
    refused when the service is built, as in the reference: an explicit
    capacity, or the one a policy alone implies, beside a mesh."""
    from test_torch_ranks import one_rank_mesh
    tiering = TieringConfig(warm_capacity=32, n_clusters=2, bucket=16,
                            cold_policy=ColdRoutingPolicy())
    svc = CacheService(CacheConfig(dim=8, tiering=tiering), device="cpu")
    assert svc.cold is not None and svc.cold.capacity == 128
    with one_rank_mesh() as mesh:
        for tc in (TieringConfig(cold_capacity=64), tiering):
            with pytest.raises(ValueError, match="unsharded warm tier"):
                CacheService(CacheConfig(
                    dim=8, tiering=tc, sharding=ShardingConfig(mesh=mesh)),
                    device="cpu")


@pytest.mark.parametrize("fused,int8", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_cold_service_matches_reference(fused, int8):
    """One trace of repeats and fresh queries on two tenants, with a
    ring that wraps and a cold ring that wraps too: every plan's
    verdicts and answers, every receipt, every maintenance report and
    every counter equal the reference's."""
    rng = np.random.default_rng(50)
    kw = dict(hot_capacity=16, warm_capacity=32, n_clusters=4, bucket=16,
              flush_size=8, threshold=0.8, cold_capacity=96, fused=fused,
              warm_dtype="int8" if int8 else "float32")
    ref = JCacheService(JCacheConfig.from_kwargs(
        16, cold_policy=JColdRoutingPolicy(**POLICY), **kw))
    port = CacheService(CacheConfig.from_kwargs(
        16, cold_policy=ColdRoutingPolicy(**POLICY), **kw), device="cpu")
    pool = _keys(rng, 160)
    for step in range(40):
        ids = np.where(rng.random(8) < 0.5,
                       rng.integers(0, min(len(pool), 8 * step + 8), 8),
                       np.arange(8 * step, 8 * step + 8) % len(pool))
        embs = _unit(pool[ids] + 0.01 * rng.standard_normal((8, 16))
                     ).astype(np.float32)
        tenant = step % 2
        pa = ref.plan(JCacheRequest.build(embs, tenant))
        pb = port.plan(CacheRequest.build(embs, tenant))
        for name in ("hit", "value_ids", "admit", "miss_leader"):
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(pa, name), err_msg=name)
        assert pb.responses == pa.responses
        np.testing.assert_allclose(pb.scores, pa.scores, atol=SCORE_ATOL)
        resp = [f"s{step}-{i}" for i in range(8)]
        ra, rb = ref.commit(pa, resp), port.commit(pb, resp)
        for name in RECEIPT:
            assert getattr(rb, name) == getattr(ra, name), name
        if step % 3 == 2:
            ma, mb = ref.maintenance(), port.maintenance()
            assert (ma.cold_promoted, ma.cold_route_rebuilt) \
                == (mb.cold_promoted, mb.cold_route_rebuilt)
    sa, sb = ref.stats_snapshot(), port.stats_snapshot()
    for sec in ("traffic", "admission"):
        assert getattr(sa, sec) == getattr(sb, sec), sec
    for key, v in sa.tiers.items():
        assert sb.tiers[key] == v, key
    assert ref.responses == port.responses
    cold = sb.tiers["cold"]
    assert sb.traffic["cold_hits"] > 0 and cold["cold_promoted"] > 0
    assert cold["cold_dropped"] > 0 and cold["cold_route_rebuilds"] > 0
    assert sb.tiers["evictions_dropped"] == 0
