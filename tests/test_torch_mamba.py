"""Port parity for the Mamba mixer (`models/mamba.py`, Jamba's layers), on
the CPU.

The reference's ``init_mamba`` weights are carried into the port's
``Mamba`` module (``state_dict_from_reference``'s layouts: the ``(in,
out)`` matrices transposed, ``conv_w`` (K, C) -> (C, 1, K)) and the same
numpy inputs go through both.  Covered: the chunk scan against the naive
recurrence and against the reference's ``_chunk_scan`` (the reference's
own unit test, ported), the causal conv with and without carried state,
the full sequence, the prefill state and every decode step against the
reference's, full against stepwise, and chunk sizes that change nothing.

Tolerances: ``atol 1e-4`` for the scan (the reference's unit test),
``atol 2e-4, rtol 1e-3`` for mixer outputs and states in float32 (the
decoder's tolerance, `tests/test_torch_decoder.py`), ``3e-2`` in bf16;
one chunk size against another ``1e-5`` (the same arithmetic, but the
projections' float32 matmuls block their rows by chunk).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba as jmamba
from repro.models.param import Initializer as JInitializer
from repro.models.param import split
from repro_torch.configs import get_config
from repro_torch.models import mamba
from repro_torch.models.param import _mixer_leaf, make_initializer

TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
SCAN_ATOL = 1e-4
CHUNK_TOL = dict(atol=1e-5, rtol=1e-5)     # float32 matmuls, other blocking
JAMBA = "jamba-1.5-large-398b"


def _pair(dtype="float32", key=0):
    """The reference's init_mamba weights and the port's module holding
    them, at the reduced Jamba config (d 128, d_in 256, N 8, R 8)."""
    jcfg = jget_config(JAMBA).reduced(dtype=dtype)
    pcfg = get_config(JAMBA).reduced(dtype=dtype)
    pv, _ = split(jmamba.init_mamba(JInitializer(jax.random.PRNGKey(key)),
                                    jcfg))
    mod = mamba.Mamba(make_initializer(pcfg, 0, "cpu"), pcfg)
    sd = {}
    for leaf, a in pv.items():
        name, a = _mixer_leaf("mamba", leaf, np.asarray(a))
        sd[name.split(".", 1)[1]] = torch.from_numpy(np.array(a))
    mod.load_state_dict(sd)
    return jcfg, pv, mod.eval()


def _x(cfg, B=2, S=12, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _naive_selective_scan(A_bar, Bx, C):
    B, S, d_in, N = A_bar.shape
    h = np.zeros((B, d_in, N), np.float32)
    ys = np.zeros((B, S, d_in), np.float32)
    for t in range(S):
        h = A_bar[:, t] * h + Bx[:, t]
        ys[:, t] = (h * C[:, t][:, None, :]).sum(-1)
    return ys, h


def test_chunk_scan_equals_naive_and_reference():
    """Four chunks of 10 with the state carried between them: the
    naive recurrence (the reference's own unit test), and the
    reference's associative ``_chunk_scan`` on the same inputs."""
    rng = np.random.default_rng(3)
    B, S, d_in, N, chunk = 2, 40, 8, 4, 10
    A_bar = (rng.random((B, S, d_in, N)) * 0.9).astype(np.float32)
    Bx = rng.standard_normal((B, S, d_in, N)).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    h = torch.zeros(B, d_in, N)
    jh = jnp.zeros((B, d_in, N), jnp.float32)
    outs, jouts = [], []
    for i in range(0, S, chunk):
        h_all, h = mamba.chunk_scan(torch.as_tensor(A_bar[:, i:i + chunk]),
                                    torch.as_tensor(Bx[:, i:i + chunk]), h)
        j_all, jh = jmamba._chunk_scan(A_bar[:, i:i + chunk],
                                       Bx[:, i:i + chunk], jh)
        outs.append(h_all)
        jouts.append(np.asarray(j_all))
    h_all = torch.cat(outs, dim=1)
    ys = torch.einsum("bsdn,bsn->bsd", h_all, torch.as_tensor(C)).numpy()
    ys_ref, h_ref = _naive_selective_scan(A_bar, Bx, C)
    np.testing.assert_allclose(ys, ys_ref, atol=SCAN_ATOL)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=SCAN_ATOL)
    np.testing.assert_allclose(h_all.numpy(), np.concatenate(jouts, 1),
                               atol=SCAN_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=SCAN_ATOL)


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_reference(carried):
    """A cross-correlation over the last K inputs (not flipped), with
    zero padding or the carried inputs in front; the new state is the
    last K-1 inputs."""
    rng = np.random.default_rng(5)
    B, S, C, K = 2, 7, 6, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    st = rng.standard_normal((B, K - 1, C)).astype(np.float32) \
        if carried else None
    jy, jst = jmamba._causal_conv(x, w, b, state=st)
    y, new = mamba.causal_conv(torch.as_tensor(x),
                               torch.as_tensor(w.T[:, None, :].copy()),
                               torch.as_tensor(b),
                               None if st is None else torch.as_tensor(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jst))
    # position 0 sees w[K-1] on x[0] alone when nothing is carried
    if not carried:
        np.testing.assert_allclose(y[:, 0].numpy(), x[:, 0] * w[K - 1] + b,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_and_prefill_state_match_reference(dtype):
    jcfg, pv, mod = _pair(dtype)
    x = _x(jcfg)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jy, jst = jmamba.apply_full(pv, jcfg, jnp.asarray(x, dt),
                                return_state=True)
    state = mamba.init_state(mod.cfg, 2, "cpu")
    with torch.no_grad():
        y = mod.prefill(torch.as_tensor(x).to(getattr(torch, dtype)), state)
        y_full = mod(torch.as_tensor(x).to(getattr(torch, dtype)))
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    torch.testing.assert_close(y, y_full, rtol=0, atol=0)
    assert state["h"].dtype == torch.float32
    assert state["conv"].dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(state["h"]), _np(jst["h"]), **tol)
    np.testing.assert_allclose(_np(state["conv"]), _np(jst["conv"]), **tol)


def test_decode_steps_match_reference():
    """From the prefill state, every decode step's output and state."""
    jcfg, pv, mod = _pair()
    x = _x(jcfg, S=12)
    _, jst = jmamba.apply_full(pv, jcfg, jnp.asarray(x[:, :8]),
                               return_state=True)
    state = mamba.init_state(mod.cfg, 2, "cpu")
    with torch.no_grad():
        mod.prefill(torch.as_tensor(x[:, :8]), state)
        for t in range(8, 12):
            jy, jst = jmamba.apply_decode(pv, jcfg, jnp.asarray(x[:, t:t + 1]),
                                          jst)
            h_before = state["h"]
            y = mod.decode(torch.as_tensor(x[:, t:t + 1]), state)
            assert state["h"] is h_before            # advanced in place
            np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                       **TOL["float32"])
            for n in ("h", "conv"):
                np.testing.assert_allclose(state[n].numpy(),
                                           np.asarray(jst[n]),
                                           **TOL["float32"])


def test_full_matches_stepwise():
    """The reference's ``test_mamba_full_matches_stepwise``, ported: the
    full sequence equals token-by-token decode from the empty state."""
    _, _, mod = _pair()
    x = torch.as_tensor(_x(mod.cfg, B=1, S=12))
    state = mamba.init_state(mod.cfg, 1, "cpu")
    full_state = mamba.init_state(mod.cfg, 1, "cpu")
    with torch.no_grad():
        y_full = mod.prefill(x, full_state)
        ys = [mod.decode(x[:, t:t + 1], state) for t in range(12)]
    torch.testing.assert_close(torch.cat(ys, 1), y_full, atol=SCAN_ATOL,
                               rtol=0)
    torch.testing.assert_close(state["h"], full_state["h"], atol=SCAN_ATOL,
                               rtol=0)
    torch.testing.assert_close(state["conv"], full_state["conv"])


@pytest.mark.parametrize("chunk", [1, 5, 12])
def test_chunk_size_changes_nothing(monkeypatch, chunk):
    """The chunk bounds memory only: outputs and the prefill state are
    the same for any chunk, ragged last chunk included, and for
    ``unroll_inner`` (up to the float32 rounding of the projections,
    whose row blocking follows the chunk: ``CHUNK_TOL``)."""
    _, _, mod = _pair()
    x = torch.as_tensor(_x(mod.cfg, S=12))
    with torch.no_grad():
        want = mod._full(x)
        monkeypatch.setattr(mamba, "MAMBA_CHUNK", chunk)
        got = mod._full(x)
        mod.cfg = mod.cfg.replace(unroll_inner=True)
        unrolled = mod._full(x)
    for a, b, c in zip(want, got, unrolled):
        torch.testing.assert_close(b, a, **CHUNK_TOL)
        torch.testing.assert_close(c, a, **CHUNK_TOL)


def test_prefill_state_past_a_padded_chunk(monkeypatch):
    """Where the reference pads its last chunk (S not a multiple of its
    chunk), it keeps the state after the zero padding, decayed by the
    padded positions' ``A_bar``; the port's state is the recurrence's at
    position S, which is the reference's own token-by-token decode state.
    The outputs agree.  Shown at a chunk of 8 over 12 tokens on both
    sides (the reference's MAMBA_CHUNK of 256 pads from S = 257)."""
    jcfg, pv, mod = _pair()
    x = _x(jcfg, B=1, S=12)
    monkeypatch.setattr(jmamba, "MAMBA_CHUNK", 8)
    monkeypatch.setattr(mamba, "MAMBA_CHUNK", 8)
    jy, jst = jmamba.apply_full(pv, jcfg, jnp.asarray(x), return_state=True)
    step = jmamba.init_state(jcfg, 1)
    for t in range(12):
        _, step = jmamba.apply_decode(pv, jcfg, jnp.asarray(x[:, t:t + 1]),
                                      step)
    state = mamba.init_state(mod.cfg, 1, "cpu")
    with torch.no_grad():
        y = mod.prefill(torch.as_tensor(x), state)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL["float32"])
    np.testing.assert_allclose(state["h"].numpy(), np.asarray(step["h"]),
                               atol=SCAN_ATOL)
    # the reference's full-path state is the decayed one
    gap = np.abs(np.asarray(jst["h"]) - np.asarray(step["h"])).max()
    assert gap > 100 * SCAN_ATOL
