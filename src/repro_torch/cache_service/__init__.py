"""Tiered multi-tenant cache service of the port: hot exact tier, warm
IVF ring with demotion and a double-buffered rebuild, the host-RAM cold
tier, per-tenant thresholds and admission learned from feedback with a
conformal floor, the online embedder refresh, the fused multi-embedder
ensemble with learned mixture weights, host-side response GC, TTL —
driven through the typed
``CacheBackend`` plan/commit/maintenance protocol (DESIGN.md §7)."""
from repro_torch.cache_service.cold import ColdFetch, ColdTier, Promotion
from repro_torch.cache_service.config import (
    CacheConfig, EnsembleConfig, LearningConfig, ShardingConfig,
    StalenessConfig, TieringConfig,
)
from repro_torch.cache_service.feedback import (
    ConformalWindow, FeedbackAccumulator, FeedbackConfig,
)
from repro_torch.cache_service.policy import (
    ColdRoutingPolicy, EmbedderRefreshPolicy, PolicyTable, TenantPolicy,
)
from repro_torch.cache_service.protocol import (
    CacheBackend, CacheCapabilities, CachePlan, CacheRequest,
    CommitReceipt, MaintenanceReport, coalesce_misses, ungrouped_misses,
)
from repro_torch.cache_service.service import CacheService, ServiceStats

__all__ = [
    "CacheService", "ServiceStats",
    "CacheConfig", "TieringConfig", "ShardingConfig", "LearningConfig",
    "EnsembleConfig", "StalenessConfig", "EmbedderRefreshPolicy",
    "PolicyTable", "TenantPolicy",
    "ColdFetch", "ColdRoutingPolicy", "ColdTier", "Promotion",
    "ConformalWindow", "FeedbackAccumulator", "FeedbackConfig",
    "CacheBackend", "CacheCapabilities", "CachePlan", "CacheRequest",
    "CommitReceipt", "MaintenanceReport", "coalesce_misses",
    "ungrouped_misses",
]
