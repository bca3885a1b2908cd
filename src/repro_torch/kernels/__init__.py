"""Hand-written Hopper kernels of the port, one package per reference
Pallas kernel, each with ``kernel.py`` (the CUDA kernel), ``ref.py``
(its plain torch version) and ``ops.py`` (kernel for CUDA tensors,
plain version for CPU tensors); ``_build`` compiles and loads them."""
import torch


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise ValueError unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device`` — what a kernel wrapper checks before it
    hands a pointer to CUDA."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def refuse_autograd(name, *tensors) -> None:
    """Raise RuntimeError when autograd would record a kernel's call: the
    ctypes launch fills a tensor that has no ``grad_fn``, so a loss taken
    through it would give its inputs no gradient and nothing would say
    so.  Training goes through the plain attention of
    ``Attention.forward_full`` (``LM.lm_loss``) instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and an input requires "
            "grad; train through LM.lm_loss (Attention.forward_full, plain "
            "attention under autograd) or call under torch.no_grad()")
