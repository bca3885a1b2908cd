from repro_torch.serving.engine import (
    CachedLLMService, GenerationResult, ServedRequest, ServeEngine,
)

__all__ = ["CachedLLMService", "GenerationResult", "ServedRequest",
           "ServeEngine"]
