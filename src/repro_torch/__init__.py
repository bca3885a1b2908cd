"""PyTorch/CUDA port of the LangCache reproduction (the ``repro``
package is the JAX reference it is held against).

The port mirrors the reference module for module (``configs``,
``data``, ``obs``, ``models``, ``core``, ``kernels``,
``cache_service``, ``serving``).  Nothing here imports JAX or the
reference package.  Entry points take an explicit ``device`` that
defaults to ``"cuda"`` and raise when no card is present; the tests
pass ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
