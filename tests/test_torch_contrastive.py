"""Port parity for the online-contrastive loss: its components against
the reference's plain version and its Pallas kernel (interpret mode, as
``tests/test_contrastive_kernel.py`` runs it), the online and classic
losses and their gradients against ``jax.value_and_grad``, on mixed and
one-class batches whose size is not a multiple of the kernel's block.

On the CPU the port's ``ops`` run the plain torch versions (the CUDA
kernels are held against those same versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).

Tolerances: component sums ``rtol 1e-5`` (sums in another order);
min_neg / max_pos ``atol 1e-6``; hard-pair fractions exactly; losses
``rtol 1e-5``; gradients ``atol 1e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.kernels.contrastive import kernel as jkernel
from repro.kernels.contrastive import ref as jref
from repro_torch.core import losses
from repro_torch.kernels.contrastive import ops, ref

# (B, D, block): B is no multiple of the block in all but the last
SHAPES = [(1, 8, 8), (13, 32, 8), (100, 64, 32), (16, 768, 16)]


def _pairs(B, D, labels, seed):
    rng = np.random.default_rng(seed)
    e1 = rng.standard_normal((B, D)).astype(np.float32)
    e2 = (0.6 * e1 + rng.standard_normal((B, D))).astype(np.float32)
    if labels == "mixed":
        lab = (rng.random(B) < 0.5).astype(np.int32)
        if B > 1:
            lab[0], lab[-1] = 0, 1
    else:
        lab = np.full(B, int(labels == "pos"), np.int32)
    return e1, e2, lab


def _labels(B):
    """A one-pair batch has one class."""
    return ["pos", "neg"] if B == 1 else ["mixed", "pos", "neg"]


@pytest.mark.parametrize("B,D,bb,labels", [
    (B, D, bb, lab) for B, D, bb in SHAPES for lab in _labels(B)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_components_match_reference(B, D, bb, labels, dtype):
    e1, e2, lab = _pairs(B, D, labels, seed=B + D)
    j1, j2 = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (e1, e2))
    t1, t2 = (torch.tensor(x).to(getattr(torch, dtype)) for x in (e1, e2))
    wants = [jref.contrastive_components(j1, j2, jnp.asarray(lab))]
    if dtype == "float32":        # the interpreted kernel: seconds a shape
        wants.append(jkernel.contrastive_components(
            j1, j2, jnp.asarray(lab), block_b=bb, interpret=True))
    got = ops.contrastive_components(t1, t2, torch.tensor(lab))
    for want in wants:
        np.testing.assert_allclose([float(x) for x in got[:2]],
                                   [float(x) for x in want[:2]],
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose([float(x) for x in got[2:]],
                                   [float(x) for x in want[2:]],
                                   rtol=0, atol=1e-6)
    jf = jlosses.hard_pair_fractions(j1, j2, jnp.asarray(lab))
    pf = losses.hard_pair_fractions(t1, t2, torch.tensor(lab))
    assert {k: float(v) for k, v in jf.items()} == \
        {k: float(v) for k, v in pf.items()}


@pytest.mark.parametrize("B,D,labels", [
    (B, D, lab) for B, D in ((1, 8), (13, 32), (100, 64))
    for lab in _labels(B)])
@pytest.mark.parametrize("loss", ["online_contrastive_loss",
                                  "contrastive_loss"])
def test_loss_and_gradients_match_reference(B, D, labels, loss):
    e1, e2, lab = _pairs(B, D, labels, seed=7 * B + D)
    jfn = getattr(jlosses, loss)
    jl, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: jfn(a, b, jnp.asarray(lab), margin=0.5),
        argnums=(0, 1))(jnp.asarray(e1), jnp.asarray(e2))
    t1 = torch.tensor(e1, requires_grad=True)
    t2 = torch.tensor(e2, requires_grad=True)
    fn = ops.online_contrastive_loss if loss == "online_contrastive_loss" \
        else losses.contrastive_loss
    tl = fn(t1, t2, torch.tensor(lab), 0.5)
    g1, g2 = torch.autograd.grad(tl, (t1, t2))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg1), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(g2.numpy(), np.asarray(jg2), rtol=0,
                               atol=1e-6)


def test_online_loss_focuses_on_hard_pairs():
    """Mirrors tests/test_core_cache.py: removing the easy pairs leaves
    the unnormalised loss unchanged."""
    rng = np.random.default_rng(7)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    base = unit(rng.standard_normal((1, 32)).astype(np.float32))
    orth = unit(rng.standard_normal((1, 32)).astype(np.float32))
    e1 = torch.tensor(np.concatenate([base] * 4))
    e2 = torch.tensor(np.concatenate([base, unit(base + 2.0 * orth), orth,
                                      unit(base + 0.1 * orth)]))
    lab = torch.tensor([1, 1, 0, 0])
    loss = ops.online_contrastive_loss(e1, e2, lab)
    hard = ops.online_contrastive_loss(e1[[1, 3]], e2[[1, 3]],
                                       torch.tensor([1, 0]))
    np.testing.assert_allclose(float(loss) * 4, float(hard) * 2, rtol=1e-5)


def test_plain_versions_only_for_cpu_tensors(monkeypatch):
    """CPU tensors reach the plain versions; any other device goes to the
    kernel or is refused (here: 'meta') — no fallback."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for non-CPU tensors")

    monkeypatch.setattr(ref, "contrastive_components", forbidden)
    monkeypatch.setattr(losses, "online_contrastive_loss", forbidden)
    e = torch.zeros(4, 8, device="meta")
    lab = torch.zeros(4, dtype=torch.int32, device="meta")
    for fn in (ops.contrastive_components, ops.online_contrastive_loss):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(e, e, lab)
