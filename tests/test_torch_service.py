"""Port parity for the serving path: one trace driven through the
reference ``CacheService`` + ``CachedLLMService(engine=None)`` and the
port's (on the CPU), four-op and fused, fp32 and int8 warm scan.

Inputs are numpy, made from a seed.  The k-means seed row — drawn with
``jax.random.choice`` in the reference and from numpy in the port — is
handed to the port from the reference's draw, so both sides build the
same IVF.  Tolerances: scores ``atol 1e-5`` (float32 sums in another
order; the reference's own kernel and oracle differ by ~1 ulp); hits,
value ids, served strings and every stats counter exactly (the trace
keeps top-1/top-2 gaps and threshold margins far above 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.cache_service import (
    CacheConfig as JCacheConfig, CacheService as JCacheService,
    StalenessConfig as JStalenessConfig, TieringConfig as JTieringConfig,
)
from repro.data import HashTokenizer as JHashTokenizer
from repro.serving import CachedLLMService as JCachedLLMService
from repro_torch.cache_service import (
    CacheConfig, CacheService, StalenessConfig, TieringConfig,
)
from repro_torch.core import ivf as port_ivf
from repro_torch.data import HashTokenizer
from repro_torch.serving import CachedLLMService

D = 32
SCORE_ATOL = 1e-5


def _reference_first_seed(valid, seed):
    """The reference kmeans' first seed row (``jax.random.choice``)."""
    v = jnp.asarray(valid.cpu().numpy())
    p = v.astype(jnp.float32)
    p = jnp.where(p.sum() > 0, p, jnp.ones_like(p))
    p = p / p.sum()
    return int(jax.random.choice(jax.random.PRNGKey(seed), v.shape[0],
                                 p=p))


@pytest.fixture(autouse=True)
def _same_kmeans_seed(monkeypatch):
    monkeypatch.setattr(port_ivf, "first_seed", _reference_first_seed)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _trace(seed=0, n_batches=24, batch=8, n_base=48):
    """Batches of (texts, tenant) over a pool of paraphrase clusters;
    returns the batches and text -> embedding."""
    rng = np.random.default_rng(seed)
    base = _unit(rng.standard_normal((n_base, D)))
    table, batches = {}, []
    for b in range(n_batches):
        texts = []
        for i in range(batch):
            j = int(rng.integers(n_base))
            t = f"q{b}-{i}-c{j}"
            table[t] = _unit(base[j] + 0.08 * rng.standard_normal(D)
                             ).astype(np.float32)
            texts.append(t)
        batches.append((texts, b % 3))
    return batches, table


def _tiering(mod, fused, int8):
    return mod(hot_capacity=32, warm_capacity=128, n_clusters=4, bucket=32,
               n_probe=2, flush_size=8, rebuild_every=2, fused=fused,
               warm_dtype="int8" if int8 else "float32")


def _pair(fused, int8, **top):
    ref = JCacheService(JCacheConfig(
        dim=D, threshold=0.9, tiering=_tiering(JTieringConfig, fused, int8),
        **top))
    port = CacheService(CacheConfig(
        dim=D, threshold=0.9, tiering=_tiering(TieringConfig, fused, int8),
        **top), device="cpu")
    return ref, port


def _assert_stats_equal(a, b):
    for sec in ("traffic", "admission", "rebuild"):
        for key, v in getattr(a, sec).items():
            if key.endswith("wall_s"):
                continue
            assert getattr(b, sec)[key] == v, (sec, key)
    for key, v in a.tiers.items():
        assert b.tiers[key] == v, ("tiers", key)


@pytest.mark.parametrize("fused,int8", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_service_trace_matches_reference(fused, int8):
    batches, table = _trace()
    ref_cache, port_cache = _pair(fused, int8)
    embed = lambda texts: np.stack([table[t] for t in texts])
    ref = JCachedLLMService(embed, ref_cache, None, JHashTokenizer())
    port = CachedLLMService(embed, port_cache, None, HashTokenizer())
    n_hits = 0
    for texts, tenant in batches:
        a = ref.handle(texts, tenant=tenant)
        b = port.handle(texts, tenant=tenant)
        for x, y in zip(a, b):
            assert (x.query, x.response, x.cache_hit) \
                == (y.query, y.response, y.cache_hit)
            assert abs(x.score - y.score) <= SCORE_ATOL
            n_hits += x.cache_hit
    sa, sb = ref.stats(), port.stats()
    for key in ("requests", "hits", "misses", "generations",
                "coalesced_misses", "maintenance_calls", "hit_rate"):
        assert sa[key] == sb[key], key
    _assert_stats_equal(ref_cache.stats_snapshot(),
                        port_cache.stats_snapshot())
    st = port_cache.stats_snapshot()
    # the trace exercises the whole path: warm hits after demotion,
    # rebuilds, ring wrap-around evictions
    assert n_hits > 0 and st.traffic["warm_hits"] > 0
    assert st.rebuild["rebuilds"] > 0 and st.tiers["evictions"] > 0
    np.testing.assert_array_equal(np.asarray(ref_cache.warm.members),
                                  port_cache.warm.members.numpy())


def test_ttl_and_tenant_eviction_match_reference():
    """Logical-clock TTL (mask at plan time, reap on maintenance) and
    evict_tenant, through plan/commit on both sides."""
    from repro.cache_service import CacheRequest as JCacheRequest
    from repro_torch.cache_service import CacheRequest
    now = [1.7e9]                            # epoch-scale: rebasing matters
    clock = lambda: now[0]
    ref = JCacheService(JCacheConfig(
        dim=D, threshold=0.9, tiering=_tiering(JTieringConfig, True, False),
        staleness=JStalenessConfig(default_ttl=30.0, clock=clock)))
    port = CacheService(CacheConfig(
        dim=D, threshold=0.9, tiering=_tiering(TieringConfig, True, False),
        staleness=StalenessConfig(default_ttl=30.0, clock=clock)),
        device="cpu")
    batches, table = _trace(seed=1, n_batches=10)
    for step, (texts, tenant) in enumerate(batches):
        embs = np.stack([table[t] for t in texts])
        plans = [svc.plan(req.build(embs, tenant), coalesce=True)
                 for svc, req in ((ref, JCacheRequest),
                                  (port, CacheRequest))]
        for name in ("hit", "value_ids", "admit", "miss_leader"):
            np.testing.assert_array_equal(getattr(plans[0], name),
                                          getattr(plans[1], name))
        assert plans[0].expired_masked == plans[1].expired_masked
        resp = [f"r{step}-{i}" for i in range(len(texts))]
        ra = ref.commit(plans[0], resp)
        rb = port.commit(plans[1], resp)
        assert (ra.admitted, ra.evicted, ra.ttl_stamped) \
            == (rb.admitted, rb.evicted, rb.ttl_stamped)
        now[0] += 7.0
        if step % 3 == 2:
            ma, mb = ref.maintenance(), port.maintenance()
            assert ma.expired_reaped == mb.expired_reaped
    assert ref.evict_tenant(1) == port.evict_tenant(1)
    assert ref.responses == port.responses
    _assert_stats_equal(ref.stats_snapshot(), port.stats_snapshot())
    st = port.stats_snapshot().tiers["staleness"]
    assert st["expired_masked"] > 0 and st["expired_reaped"] > 0


def test_unported_features_are_refused():
    """Every feature of the reference's service is accepted now: a
    ``DeviceMesh`` for the sharded warm tier (a cold tier beside it is
    refused, as in the reference), the maintenance loop's fields and the
    embedder refresh's, which reach the service (a refresh without its
    trainer and tokenizer is refused there, as in the reference)."""
    from repro_torch.cache_service import LearningConfig, ShardingConfig
    from test_torch_ranks import one_rank_mesh
    with pytest.raises(ValueError, match="embedder_trainer"):
        CacheService(CacheConfig(dim=D, learning=LearningConfig(
            learned_embedder=True)), device="cpu")
    with one_rank_mesh() as mesh:
        sharding = ShardingConfig(mesh=mesh)
        assert CacheService(CacheConfig(dim=D, sharding=sharding),
                            device="cpu").capabilities().warm_sharded
        with pytest.raises(ValueError, match="unsharded warm tier"):
            CacheService(CacheConfig(
                dim=D, sharding=sharding,
                tiering=TieringConfig(cold_capacity=64)), device="cpu")
    svc = CacheService(CacheConfig(
        dim=D, tiering=TieringConfig(background_rebuild=True,
                                     cold_capacity=64),
        learning=LearningConfig(conformal=True)), device="cpu")
    caps = svc.capabilities()
    assert caps.background_rebuild and caps.cold_tier and caps.conformal


def test_warm_block_is_accepted_and_changes_nothing():
    """``--warm-block 256`` parses as in the reference's launcher, reaches
    ``TieringConfig(warm_block=)``, and a trace with warm hits gives the
    same answers, scores and stats with and without it (the reference's
    streaming block never changes results; the CUDA kernel has no use for
    it)."""
    from repro_torch.launch import serve
    from repro_torch.obs import Telemetry
    args = serve.parse_args(["--device", "cpu", "--cache",
                             "--warm-block", "256"])
    assert args.warm_block == 256 and args.tiered
    assert serve.make_cache(args, D, Telemetry()).warm_block == 256
    batches, table = _trace(seed=2)
    embed = lambda texts: np.stack([table[t] for t in texts])
    out = []
    for block in (None, 256):
        tiering = dataclasses.replace(_tiering(TieringConfig, True, False),
                                      warm_block=block)
        cache = CacheService(CacheConfig(dim=D, threshold=0.9,
                                         tiering=tiering), device="cpu")
        svc = CachedLLMService(embed, cache, None, HashTokenizer())
        res = [(r.query, r.response, r.cache_hit, r.score)
               for texts, tenant in batches
               for r in svc.handle(texts, tenant=tenant)]
        out.append((res, cache.stats_snapshot()))
    assert out[0][0] == out[1][0]
    assert out[1][1].traffic["warm_hits"] > 0
    _assert_stats_equal(out[0][1], out[1][1])


def test_calibrate_tenant_matches_reference():
    """A tenant's threshold fit to its own eval pairs under a false-hit
    budget: the same calibration and the same published policy on both
    sides, other tenants untouched."""
    rng = np.random.default_rng(7)
    labels = rng.random(400) < 0.4
    scores = np.where(labels, rng.normal(0.93, 0.03, 400),
                      rng.normal(0.85, 0.04, 400)).astype(np.float32)
    ref, port = _pair(False, False)
    for budget in (0.01, 0.05):
        a = ref.calibrate_tenant(3, scores, labels, max_false_hit_rate=budget)
        b = port.calibrate_tenant(3, scores, labels,
                                  max_false_hit_rate=budget)
        assert dataclasses.asdict(b) == pytest.approx(dataclasses.asdict(a))
        assert port.policies.get(3).threshold == \
            ref.policies.get(3).threshold == b.threshold
    assert port.policies.get(0).threshold == ref.policies.get(0).threshold \
        == 0.9


def test_occupancy_matches_reference():
    """The SemanticCache drop-in fraction of live rows over hot + warm
    capacity, through fills, demotions and a tenant eviction."""
    batches, table = _trace(seed=2, n_batches=12)
    ref, port = _pair(True, False)
    assert port.occupancy == ref.occupancy == 0.0
    embed = lambda texts: np.stack([table[t] for t in texts])
    rs = JCachedLLMService(embed, ref, None, JHashTokenizer())
    ps = CachedLLMService(embed, port, None, HashTokenizer())
    seen = set()
    for texts, tenant in batches:
        rs.handle(texts, tenant=tenant)
        ps.handle(texts, tenant=tenant)
        assert port.occupancy == pytest.approx(ref.occupancy, abs=0)
        seen.add(port.occupancy)
    assert len(seen) > 3 and port.stats_snapshot().tiers["demotions"] > 0
    assert port.occupancy == (len(port) / (port.hot_capacity
                                           + port.warm_capacity))
    ref.evict_tenant(1)
    port.evict_tenant(1)
    assert port.occupancy == ref.occupancy
