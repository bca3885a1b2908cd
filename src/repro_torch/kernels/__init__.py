"""Hand-written Hopper kernels of the port, one package per reference
Pallas kernel, each with ``kernel.py`` (the CUDA kernel), ``ref.py``
(its plain torch version) and ``ops.py`` (kernel for CUDA tensors,
plain version for CPU tensors)."""
