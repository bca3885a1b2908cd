"""Activation anchors (`repro_torch.models.actsharding`) against the
reference's (`repro.models.actsharding`): outside a context both return
the activation itself; inside one, the port anchors the batch to the
same mesh axes the reference constrains it to (captured by replacing
``jax.lax.with_sharding_constraint`` for the call; the reference's code
is untouched), ``pod`` dropped first when the batch does not divide.
Shape-only meshes: no process group starts here."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import actsharding as jact
from repro_torch.models import actsharding as act


class FakeMesh:
    """The reference's view (``shape`` a dict) and a ``DeviceMesh``'s
    (``mesh_dim_names`` and a ``shape`` tuple) of one mesh."""
    def __init__(self, sizes):
        self.sizes = dict(sizes)

    def jax_view(self):
        m = type("M", (), {})()
        m.shape = self.sizes
        return m

    def torch_view(self):
        m = type("M", (), {})()
        m.mesh_dim_names = tuple(self.sizes)
        m.shape = tuple(self.sizes.values())
        return m


MESHES = [FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 2, "model": 2}),
          FakeMesh({"model": 4})]
BATCHES = [1, 2, 4, 8, 16, 24, 32, 48, 64, 128, 256, 1024]


def _reference_axes(monkeypatch, mesh, n):
    """The mesh axes the reference's `constrain_batch` puts on a leading
    dim of ``n``: () when it returns the activation unconstrained."""
    seen = []

    def capture(x, spec):
        seen.append(spec)
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", capture)
    x = jnp.zeros((n, 3))
    with jact.activation_ctx(mesh.jax_view()):
        y = jact.constrain_batch(x)
    if not seen:
        assert y is x
        return ()
    first = seen[0][0]
    return first if isinstance(first, tuple) else (first,)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.sizes.items()))
def test_anchor_picks_the_reference_s_axes(monkeypatch, mesh):
    for n in BATCHES:
        want = _reference_axes(monkeypatch, mesh, n)
        with act.activation_ctx(mesh.torch_view()):
            got = act.batch_axes_for(n)
            x = torch.zeros(n, 3)
            assert act.constrain_batch(x) is x    # not a DTensor
        assert got == want, (mesh.sizes, n, got, want)


def test_outside_a_context_the_activation_itself():
    x = torch.zeros(256, 4)
    assert act.constrain_batch(x) is x
    assert act.batch_axes_for(256) == ()
    wrapped = act.wrap_with_activation_constraints(
        lambda t: (act.batch_axes_for(t.shape[0]), act.constrain_batch(t)),
        MESHES[0].torch_view())
    axes, y = wrapped(x)
    assert axes == ("data",) and y is x
    assert act.constrain_batch(x) is x            # the context is gone
