"""Port parity for the typed construction surface (`cache_service/
config.py`, DESIGN.md §14.4), on the CPU.

Mirrors the reference's `tests/test_cache_config.py` on the port: field
validation fires at dataclass construction, the flat-kwargs mapping
(``from_kwargs``) covers every renamed key, an unknown keyword is a
``TypeError``, and the config path refuses extra kwargs.  The reference's
flat-kwargs ``CacheService`` shim, which warns once per process, has no
port counterpart: the port's service takes only a ``CacheConfig``, and
``test_flat_kwargs_construction_is_refused`` pins that.  The same inputs
go to both sides: a field
the reference refuses the port refuses, and ``from_kwargs`` builds the
same grouped config.  ``ShardingConfig(mesh=...)`` takes a torch
``DeviceMesh`` where the reference takes a JAX mesh; the sharded cases
are in `tests/test_torch_service.py`, `tests/test_torch_feedback.py` and
`tests/test_torch_sharded_service.py`.
"""
import dataclasses

import pytest

import repro.cache_service as J
import repro_torch.cache_service as P
from repro.cache_service.feedback import FeedbackConfig as JFeedbackConfig
from repro_torch.cache_service import (
    CacheConfig, CacheService, EnsembleConfig, LearningConfig,
    StalenessConfig, TieringConfig,
)
from repro_torch.cache_service.feedback import FeedbackConfig


@pytest.mark.parametrize("bad", [
    dict(dim=0), dict(dim=-4),
    dict(dim=16, topk=0),
    dict(dim=16, threshold=0.0), dict(dim=16, threshold=1.2),
    dict(dim=16, admission_margin=-0.1),
])
def test_cache_config_rejects_bad_top_level(bad):
    for mod in (J, P):
        with pytest.raises(ValueError):
            mod.CacheConfig(**bad)


@pytest.mark.parametrize("bad", [
    dict(hot_capacity=0), dict(warm_capacity=0),
    dict(n_clusters=0), dict(bucket=0), dict(n_probe=0),
    dict(flush_watermark=0.0), dict(flush_watermark=1.5),
    dict(flush_size=0), dict(rebuild_every=0),
    dict(warm_dtype="bfloat16"), dict(warm_block=0),
    dict(cold_capacity=-1),
])
def test_tiering_config_rejects_bad_fields(bad):
    for mod in (J, P):
        with pytest.raises(ValueError):
            mod.TieringConfig(**bad)


def test_sub_config_validation():
    for mod in (J, P):
        with pytest.raises(ValueError):
            mod.ShardingConfig(shard_axis="")
        with pytest.raises(ValueError):
            mod.EnsembleConfig(embedders=0)
        with pytest.raises(ValueError):
            mod.StalenessConfig(default_ttl=0.0)
        with pytest.raises(dataclasses.FrozenInstanceError):
            mod.CacheConfig(dim=16).dim = 32


def _fields(cfg):
    """A config as nested plain values (sub-configs and the feedback
    config as field dicts), comparable across the two packages."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


def test_from_kwargs_groups_every_renamed_key():
    built = []
    for mod, fb in ((J, JFeedbackConfig()), (P, FeedbackConfig())):
        cfg = mod.CacheConfig.from_kwargs(
            32, threshold=0.9, hot_capacity=64, warm_capacity=256,
            fused=True, cold_capacity=512, learned_admission=True,
            feedback_config=fb, embedders=3, ensemble_weights=None,
            default_ttl=30.0, background_rebuild=True, conformal=True,
            warm_dtype="int8", flush_size=16, rebuild_every=2)
        assert cfg.learning.feedback is fb
        built.append(_fields(cfg))
    assert built[1] == built[0]
    cfg = built[1]
    assert cfg["dim"] == 32 and cfg["threshold"] == 0.9
    assert cfg["tiering"]["hot_capacity"] == 64
    assert cfg["tiering"]["fused"] and cfg["tiering"]["cold_capacity"] == 512
    assert cfg["tiering"]["background_rebuild"]
    assert cfg["learning"]["learned_admission"]
    assert cfg["learning"]["conformal"]
    assert cfg["ensemble"]["embedders"] == 3
    assert cfg["staleness"]["default_ttl"] == 30.0


def test_from_kwargs_groups_the_refresh_keys():
    """The embedder refresh's flat names land on ``LearningConfig`` on
    both sides, the policy's fields equal."""
    trainer, tok = object(), object()
    built = []
    for mod in (J, P):
        cfg = mod.CacheConfig.from_kwargs(
            32, learned_embedder=True, embedder_trainer=trainer,
            embedder_tokenizer=tok, refresh_policy=mod.EmbedderRefreshPolicy(
                min_pairs=24, synth_domain="medical", recalibrate=True))
        assert cfg.learning.embedder_trainer is trainer
        assert cfg.learning.embedder_tokenizer is tok
        built.append(_fields(cfg))
    assert built[1] == built[0]
    assert built[1]["learning"]["refresh_policy"]["min_pairs"] == 24


def test_from_kwargs_rejects_unknown_keyword():
    for mod in (J, P):
        with pytest.raises(TypeError, match="unknown CacheService kwargs"):
            mod.CacheConfig.from_kwargs(32, capacty=64)


def test_flat_kwargs_construction_is_refused():
    with pytest.raises(TypeError):
        CacheService(dim=16, hot_capacity=8, warm_capacity=32,
                     n_clusters=2, bucket=16, device="cpu")
    with pytest.raises(TypeError, match="takes a CacheConfig"):
        CacheService(16, device="cpu")


def test_config_path_rejects_extra_kwargs():
    with pytest.raises(TypeError, match="hot_capacity"):
        CacheService(CacheConfig(dim=16), hot_capacity=64, device="cpu")
    with pytest.raises(TypeError, match="config"):
        CacheService(device="cpu")


def test_config_and_legacy_paths_build_identically():
    cfg = CacheConfig(dim=16, threshold=0.9,
                      tiering=TieringConfig(hot_capacity=8, warm_capacity=32,
                                            n_clusters=2, bucket=16,
                                            cold_capacity=64),
                      learning=LearningConfig(conformal=True),
                      ensemble=EnsembleConfig(),
                      staleness=StalenessConfig(default_ttl=5.0))
    a = CacheService(cfg, device="cpu")
    b = CacheService(CacheConfig.from_kwargs(
        16, threshold=0.9, hot_capacity=8, warm_capacity=32, n_clusters=2,
        bucket=16, cold_capacity=64, conformal=True, default_ttl=5.0),
        device="cpu")
    assert a.config == b.config
    assert a.capabilities() == b.capabilities()
    assert a.capabilities().conformal and a.capabilities().cold_tier
