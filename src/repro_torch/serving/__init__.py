from repro_torch.serving.engine import (
    CachedLLMService, GenerationResult, ServedRequest, ServeEngine,
)
from repro_torch.serving.scheduler import ContinuousBatcher, Request

__all__ = ["CachedLLMService", "ContinuousBatcher", "GenerationResult",
           "Request", "ServedRequest", "ServeEngine"]
