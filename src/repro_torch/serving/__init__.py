from repro_torch.serving.engine import CachedLLMService, ServedRequest

__all__ = ["CachedLLMService", "ServedRequest"]
