"""Port parity for decoder training around the loss: the learning-rate
schedules, ``make_train_step`` against the reference's jitted step, the
in-place AdamW path, the checkpoint format and its MessagePack codec,
``state_dict_to_reference``, and the training launcher.

Tolerances: schedules ``rtol 1e-6`` (float32; the two libraries' cosine
rounds its last bit differently at a few steps); the train step's loss
``rtol 1e-5`` per step and the parameters after three steps within 5 %
of lr (as `tests/test_torch_training.py`: Adam moves a weight whose
gradient is near eps by a few percent of lr on a tiny difference); for
the recurrent decoders (xLSTM's mLSTM / sLSTM, Jamba's Mamba), whose
gradients go through the token loops, each leaf's gradient at step 0
within ``3e-5`` relative L2 of ``jax.grad``'s (worst readings 9.0e-6,
xLSTM's mLSTM ``b_if``, and 6.3e-6, Jamba's Mamba ``A_log``), xLSTM's
grad norm ``rtol 5e-4`` (its exponential gates make the third step's
1.8e-4 apart, the first two 1e-5; Jamba's three are within 6.6e-6 and
keep ``1e-4``), and the parameters within 0.25 lr, at most 16 of them
past 5 % of lr: Adam, dividing by sqrt(v), moves the few weights whose
gradients are ~1e-6 of the norm (v ~ 1e-11 .. 1e-13) by up to 0.21 lr
on float32 noise (12 such weights in xLSTM, 5 in Jamba); the in-place
update, checkpoint bytes, the codec's bytes and the round trips
exactly; the launcher's checkpoint read by the reference to the port's
logits ``atol 1e-5``.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ASSIGNED_ARCHS
from repro.models import forward_lm as jforward_lm
from repro.models import init_lm, split
from repro.training import adamw as jadamw
from repro.training import checkpoint as jckpt
from repro.training import make_train_step as jmake_train_step
from repro.training import schedule as jschedule
from repro_torch.configs import get_config
from repro_torch.kernels import refuse_autograd
from repro_torch.launch import train as launch_train
from repro_torch.models import (
    LM, state_dict_from_reference, state_dict_to_reference,
)
from repro_torch.models.param import _flatten
from repro_torch.training import (
    AdamState, adamw, apply_updates, load_checkpoint, make_eval_step,
    make_train_step, msgpack_lite, save_checkpoint, schedule,
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(name, **kw):
    jcfg, pcfg = jget_config(name).reduced(**kw), \
        get_config(name).reduced(**kw)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(_np(pv), pcfg))
    return jcfg, pv, lm


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("linear_warmup_cosine", (3e-4, 10, 100)),
    ("linear_warmup_cosine", (6.5383e-5, 7, 120, 0.2)),
    ("linear_decay", (1e-3, 90)),
])
def test_schedules_match_reference(name, args):
    jf, pf = getattr(jschedule, name)(*args), getattr(schedule, name)(*args)
    for step in range(121):
        got = pf(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(
            float(got), float(jf(jnp.asarray(step, jnp.int32))), rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

RECURRENT = ("xlstm-125m", "jamba-1.5-large-398b")


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "granite-moe-3b-a800m",
                                  *RECURRENT])
def test_three_train_steps_match_reference(name):
    lr = 1e-3
    norm_rtol = 5e-4 if name == "xlstm-125m" else 1e-4
    far, n_far = (0.25, 16) if name in RECURRENT else (0.05, 0)
    jcfg, pv, lm = _models(name)
    jinit, jupd = jadamw(lr, max_grad_norm=1.0)
    jopt = jinit(pv)
    jstep = jax.jit(jmake_train_step(jcfg, jupd))
    pinit, pupd = adamw(lr, max_grad_norm=1.0)
    popt = pinit(dict(lm.named_parameters()))
    pstep = make_train_step(lm, pupd)
    rng = np.random.default_rng(5)
    for i in range(3):
        toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
        pv, jopt, jm = jstep(pv, jopt, {"tokens": jnp.asarray(toks)})
        popt, pm = pstep(popt, {"tokens": torch.from_numpy(toks)})
        assert set(pm) == {"loss", "nll", "aux", "grad_norm", "lr"}
        assert all(v.dim() == 0 for v in pm.values())
        for k in ("loss", "nll"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} step {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=norm_rtol)
    assert popt.step == int(jopt.step) == 3
    after = state_dict_from_reference(_np(pv), lm.cfg)
    past = 0
    for n, p in lm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[n].numpy(),
                                   rtol=0, atol=far * lr, err_msg=n)
        past += int((np.abs(p.detach().numpy() - after[n].numpy())
                     > 0.05 * lr).sum())
    assert past <= n_far, past
    ev = make_eval_step(lm)({"tokens": torch.from_numpy(toks)})
    assert set(ev) == {"loss", "nll", "aux"} and bool(
        torch.isfinite(ev["loss"]))


@pytest.mark.parametrize("name", RECURRENT)
def test_gradients_through_the_token_loops_match_reference(name):
    """Each parameter's gradient of the loss at step 0, through the
    port's token loops (`models.scan`), against ``jax.grad`` through the
    reference's ``lax.scan``: relative L2 within 3e-5 leaf by leaf, so a
    gradient off in scale (which Adam would hide) fails."""
    from repro.models import lm_loss as jlm_loss
    jcfg, pv, lm = _models(name)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jg = jax.jit(jax.grad(
        lambda p: jlm_loss(p, jcfg, jnp.asarray(toks))[0]))(pv)
    want = state_dict_from_reference(_np(jg), lm.cfg)
    loss, _ = lm.lm_loss(torch.from_numpy(toks))
    loss.backward()
    for n, p in lm.named_parameters():
        g, w = p.grad.numpy(), want[n].numpy()
        assert np.linalg.norm(w) > 0, n
        assert np.linalg.norm(g - w) <= 3e-5 * np.linalg.norm(w), n


@pytest.mark.parametrize("wd,clip,state_dtype", [
    (0.0, 1.0, None), (0.01, None, torch.bfloat16), (0.0, 0.5, None),
    (0.1, 1e3, None)])
def test_in_place_update_equals_update_fn(wd, clip, state_dtype):
    """``update_fn.in_place`` against ``update_fn`` + ``apply_updates``,
    bit for bit, over four steps of a warm-up schedule."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (3,), "c": (4, 4, 2)}
    p1 = {k: torch.tensor(rng.standard_normal(s).astype(np.float32))
          for k, s in shapes.items()}
    p2 = {k: v.clone() for k, v in p1.items()}
    init, upd = adamw(schedule.linear_warmup_cosine(1e-2, 2, 10),
                      weight_decay=wd, max_grad_norm=clip,
                      state_dtype=state_dtype)
    s1, s2 = init(p1), init(p2)
    m2_ids = {k: id(v) for k, v in s2.m.items()}
    for _ in range(4):
        g = {k: torch.tensor(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
        u, s1, m1 = upd({k: v.clone() for k, v in g.items()}, s1, p1)
        apply_updates(p1, u)
        s2, m2 = upd.in_place({k: v.clone() for k, v in g.items()}, s2, p2)
        assert m1.keys() == m2.keys()
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
        for k in shapes:
            assert torch.equal(p1[k], p2[k]), k
            assert torch.equal(s1.m[k], s2.m[k]) and torch.equal(
                s1.v[k], s2.v[k]), k
    assert s2.step == 4 and {k: id(v) for k, v in s2.m.items()} == m2_ids


def test_refuse_autograd():
    """The serving kernels' guard: an input that requires grad while
    autograd records is refused, naming the training path."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="lm_loss"):
        refuse_autograd("flash_attention", torch.zeros(2), x)
    with torch.no_grad():
        refuse_autograd("flash_attention", x)
    refuse_autograd("flash_attention", torch.zeros(2))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]
CODEC_CASES = {
    "ints": INTS, "floats": [0.0, -1.5, 1e300, float("inf"), 3.25e-310],
    "scalars": [None, True, False],
    "strs": ["", "é" * 15, "a" * 31, "b" * 32, "c" * 255, "d" * 256,
             "e" * 70000],
    "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000],
    "arrays": [list(range(15)), list(range(16)), list(range(70000)),
               (1, "x", None)],
    "maps": [{f"k{i}": i for i in range(15)},
             {f"k{i}": [i, {"n": None}] for i in range(16)},
             {f"k{i}": i for i in range(70000)}],
}


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_msgpack_codec_matches_msgpack(case):
    for obj in CODEC_CASES[case]:
        want = msgpack.packb(obj, use_bin_type=True)
        assert b"".join(msgpack_lite.pack_chunks(obj)) == want
        assert msgpack_lite.unpackb(want) == msgpack.unpackb(want,
                                                             raw=False)


def test_checkpoint_bytes_and_cross_loads(tmp_path):
    """The same tree written by both sides gives the same bytes; each side
    reads the other's file (``AdamState`` as its own NamedTuple)."""
    jcfg, pv, lm = _models("phi3-mini-3.8b")
    jinit, _ = jadamw(1e-3)
    jopt = jinit(pv)._replace(step=jnp.asarray(7, jnp.int32))
    meta = [1, 2.5, True, None, (3, "x")]
    jtree = {"params": pv, "opt": jopt, "config": jcfg.name, "meta": meta}
    tree_p = state_dict_to_reference(lm.state_dict(), lm.cfg)
    ptree = {"params": tree_p,
             "opt": AdamState(step=7, m=_np(jopt.m), v=_np(jopt.v)),
             "config": jcfg.name, "meta": meta}
    jpath, ppath = tmp_path / "ref.msgpack", tmp_path / "port.msgpack"
    jckpt.save_checkpoint(str(jpath), jtree)
    save_checkpoint(str(ppath), ptree)
    assert ppath.read_bytes() == jpath.read_bytes()

    mine = load_checkpoint(str(jpath))
    assert isinstance(mine["opt"], AdamState) and mine["opt"].step == 7
    assert str(mine["config"]) == jcfg.name
    theirs = jckpt.load_checkpoint(str(ppath))
    assert int(theirs["opt"].step) == 7
    for a, b in ((_flatten(mine["params"]), _flatten(_np(pv))),
                 (_flatten(theirs["params"]), _flatten(tree_p)),
                 (_flatten(mine["opt"].m), _flatten(_np(jopt.m)))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_state_dict_to_reference_inverts_from_reference(name):
    jcfg, pv, lm = _models(name)
    back = _flatten(state_dict_to_reference(lm.state_dict(), lm.cfg))
    want = _flatten(_np(pv))
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_checkpoint_reads_in_the_reference(tmp_path, capsys):
    path = tmp_path / "ckpt.msgpack"
    lm = launch_train.main(["--device", "cpu", "--smoke", "--steps", "3",
                            "--ckpt", str(path)])
    out = capsys.readouterr().out
    assert "step    0 loss=" in out and "step    2 loss=" in out
    assert "tokens/s on cpu" in out and f"saved {path}" in out
    tree = jckpt.load_checkpoint(str(path))
    assert str(tree["config"]) == lm.cfg.name
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    want, _ = jforward_lm(tree["params"], jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = lm.forward_lm(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_launcher_refuses_the_production_mesh():
    """``--production-mesh`` parses, and the launcher builds the
    reference's 16x16 mesh, which refuses a world of one rank as
    ``jax.make_mesh`` refuses one device: "a (16, 16) mesh needs 256
    ranks".  The launcher starts its process group, so it runs in a
    spawned child, away from the test worker."""
    from test_torch_ranks import in_child
    assert launch_train.parse_args(["--production-mesh"]).production_mesh
    with pytest.raises(pytest.fail.Exception,
                       match=r"a \(16, 16\) mesh needs 256 ranks"):
        in_child(launch_train.main, (["--production-mesh", "--device",
                                      "cpu", "--smoke", "--steps", "1"],),
                 timeout=120)
