"""Port parity for the xLSTM mixers (`models/xlstm.py`: xLSTM-125M's
alternating mLSTM and sLSTM layers), on the CPU.

The reference's ``init_mlstm`` / ``init_slstm`` weights are carried into
the port's modules (``state_dict_from_reference``'s layouts, dispatched
on the mixer: an mLSTM's ``wq``/``wk``/``wv`` are (d_in, d_in) matrices,
not attention's (d, h, hd); the sLSTM's ``w_gates`` keeps its gate-major
columns, ``r_gates`` is carried as it is), and the same numpy inputs go
through both.  Covered for each mixer: the full sequence, the prefill
state, every decode step's output and state from it, and full against
token-by-token decode on the port.  The mLSTM's conv state is kept in
``cfg.dtype`` (bf16 on the card), as the reference's.

Tolerances: ``atol 2e-4, rtol 1e-3`` in float32 (the decoder's,
`tests/test_torch_decoder.py`).  In bf16 the two frameworks round the
mixers' chain of bf16 products (up-projection, conv, silu, q/k/v,
down-projection) at different places, and the mLSTM's ``1 / max(|n.q|,
1)`` carries those last bits on: bf16 outputs and states are held to
``atol 6.25e-2`` (8 bf16 ulps at 1.0) with a mean |diff| of at most
``1e-2`` — a wrong gate, scale or head layout moves them by O(0.1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import xlstm as jxlstm
from repro.models.param import Initializer as JInitializer
from repro.models.param import split
from repro_torch.configs import get_config
from repro_torch.models import xlstm
from repro_torch.models.param import _mixer_leaf, make_initializer

TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
       "bfloat16": dict(atol=6.25e-2, rtol=0.0)}
BF16_MEAN_TOL = 1e-2
XLSTM = "xlstm-125m"
# kind -> (reference init, full, decode, state init; port module, state)
MIXERS = {
    "mlstm": (jxlstm.init_mlstm, jxlstm.apply_mlstm_full,
              jxlstm.apply_mlstm_decode, jxlstm.init_mlstm_state,
              xlstm.MLSTM, xlstm.init_mlstm_state),
    "slstm": (jxlstm.init_slstm, jxlstm.apply_slstm_full,
              jxlstm.apply_slstm_decode, jxlstm.init_slstm_state,
              xlstm.SLSTM, xlstm.init_slstm_state),
}


def _pair(kind, dtype="float32", key=0):
    """The reference's weights for one mixer and the port's module
    holding them, at the reduced xLSTM config (d 128, 4 heads)."""
    jinit, *_, pmod, _ = MIXERS[kind]
    jcfg = jget_config(XLSTM).reduced(dtype=dtype)
    pcfg = get_config(XLSTM).reduced(dtype=dtype)
    pv, _ = split(jinit(JInitializer(jax.random.PRNGKey(key)), jcfg))
    mod = pmod(make_initializer(pcfg, 0, "cpu"), pcfg)
    sd = {}
    for leaf, a in pv.items():
        name, a = _mixer_leaf(kind, leaf, np.asarray(a))
        sd[name.split(".", 1)[1]] = torch.from_numpy(np.array(a))
    mod.load_state_dict(sd)
    return jcfg, pv, mod.eval()


def _x(cfg, B=2, S=10, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _assert_close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, err_msg=what, **TOL[dtype])
    if dtype == "bfloat16":
        assert np.abs(got - want).mean() <= BF16_MEAN_TOL, what


def _assert_state(state, jst, dtype):
    assert set(state) == set(jst)
    for n, t in state.items():
        assert t.shape == tuple(jst[n].shape), n
        assert str(t.dtype)[6:] == str(jst[n].dtype), n
        _assert_close(t, jst[n], dtype, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_full_and_prefill_state_match_reference(kind, dtype):
    jcfg, pv, mod = _pair(kind, dtype)
    _, jfull, _, _, _, pinit = MIXERS[kind]
    tdt = getattr(torch, dtype)
    x = _x(jcfg)
    jy, jst = jfull(pv, jcfg, jnp.asarray(x, jnp.dtype(dtype)),
                    return_state=True)
    state = pinit(mod.cfg, 2, "cpu")
    with torch.no_grad():
        y = mod.prefill(torch.as_tensor(x).to(tdt), state)
        y_full = mod(torch.as_tensor(x).to(tdt))
    assert y.dtype == tdt
    torch.testing.assert_close(y, y_full, rtol=0, atol=0)
    _assert_close(y, jy, dtype)
    _assert_state(state, jst, dtype)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_decode_steps_match_reference(kind):
    """From the prefill state, every decode step (the full path at S = 1
    with the carried state) against the reference's, state in place."""
    jcfg, pv, mod = _pair(kind)
    _, jfull, jdecode, _, _, pinit = MIXERS[kind]
    x = _x(jcfg, S=12)
    _, jst = jfull(pv, jcfg, jnp.asarray(x[:, :8]), return_state=True)
    state = pinit(mod.cfg, 2, "cpu")
    held = dict(state)
    with torch.no_grad():
        mod.prefill(torch.as_tensor(x[:, :8]), state)
        for t in range(8, 12):
            jy, jst = jdecode(pv, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
            y = mod.decode(torch.as_tensor(x[:, t:t + 1]), state)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                       **TOL["float32"])
            _assert_state(state, jst, "float32")
    assert all(state[n] is held[n] for n in state)    # advanced in place


@pytest.mark.parametrize("kind", list(MIXERS))
def test_full_matches_stepwise(kind):
    _, _, mod = _pair(kind)
    pinit = MIXERS[kind][-1]
    x = torch.as_tensor(_x(mod.cfg, B=1, S=9))
    step, full = pinit(mod.cfg, 1, "cpu"), pinit(mod.cfg, 1, "cpu")
    with torch.no_grad():
        y_full = mod.prefill(x, full)
        ys = [mod.decode(x[:, t:t + 1], step) for t in range(9)]
    torch.testing.assert_close(torch.cat(ys, 1), y_full, **TOL["float32"])
    for n in full:
        torch.testing.assert_close(step[n], full[n], **TOL["float32"])


def test_state_layouts():
    """The decode states: sLSTM's n starts at 1 (not 0), the mLSTM's
    conv rows are the last K-1 conv inputs in ``cfg.dtype``."""
    cfg = get_config(XLSTM).reduced(dtype="bfloat16")
    s = xlstm.init_slstm_state(cfg, 3, "cpu")
    assert all(t.shape == (3, cfg.d_model) and t.dtype == torch.float32
               for t in s.values())
    assert torch.equal(s["n"], torch.ones(3, cfg.d_model))
    assert all(not s[n].any() for n in ("c", "h", "m"))
    m = xlstm.init_mlstm_state(cfg, 3, "cpu")
    _, d_in, hd = xlstm.mlstm_dims(cfg)
    assert m["C"].shape == (3, cfg.n_heads, hd, hd)
    assert m["conv"].shape == (3, cfg.xlstm.d_conv - 1, d_in)
    assert m["conv"].dtype == torch.bfloat16
    jm = jxlstm.init_mlstm_state(jget_config(XLSTM).reduced(
        dtype="bfloat16"), 3)
    assert {n: tuple(t.shape) for n, t in m.items()} == \
        {n: tuple(a.shape) for n, a in jm.items()}
