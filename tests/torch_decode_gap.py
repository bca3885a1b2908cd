"""The float32 decode-versus-``forward_lm`` logit gap of the reference and
of the port, from the same weights (the reference's ``init_lm``, carried
across): each side's largest |logit| difference between its teacher-forced
prefill + decode steps and its own full forward at the same positions,
over a ``t0``-token prompt and ``S - t0`` steps (`chip_smoke.py` phase
11(b)'s 32 + 16).  The reference runs compiled, as it serves.

    PYTHONPATH=src python tests/torch_decode_gap.py xlstm:full jamba:d1024
    PYTHONPATH=src python tests/torch_decode_gap.py jamba:zoo   # ~42 GB RSS

Each argument is ``model:size`` with model ``xlstm``, ``jamba`` or
``musicgen`` and size ``reduced`` (the zoo tests' reduced config: Jamba's
period positions 1-4, which keep its attention layer), ``dN`` (that at
d_model N), ``full`` (published widths) or ``zoo`` (`chip_smoke.py`
phase 11(b)'s config: published widths, Jamba cut to its first
``JAMBA_POSITIONS`` period positions, weights in the config's
``param_dtype``, float32 activations; experts cut to ``ZOO_EXPERTS``).
``reduced`` and ``dN`` hold float32 weights, ``full`` and ``zoo`` the
config's ``param_dtype`` (bfloat16 for Jamba).  The port's
``LM`` is built on the ``meta`` device and takes views of the
reference's arrays (``state_dict_from_reference(copy=False)``), so the
two frameworks share one copy of the weights; the last line gives the
process's peak RSS.  Used by ``tests/test_torch_zoo.py``; on the CPU.
"""
import dataclasses
import resource
import sys

import jax
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import forward_lm as jforward_lm
from repro.models import init_lm, split
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.models import LM, state_dict_from_reference

MODELS = {"xlstm": "xlstm-125m", "jamba": "jamba-1.5-large-398b",
          "musicgen": "musicgen-large"}
JAMBA_POSITIONS = 5       # chip_smoke.py's cut of Jamba (its phase 11)
ZOO_EXPERTS = 2           # of Jamba's 16 (top-2), so the weights fit a host


def configs(name: str, size: str):
    """(reference config, port config) for ``MODELS[name]`` at ``size``,
    float32 activations, MoE capacity without drops."""
    out = []
    for get in (jget_config, get_config):
        cfg = get(MODELS[name])
        if size == "zoo":
            if name == "jamba":
                cfg = cfg.replace(
                    n_layers=JAMBA_POSITIONS,
                    period=cfg.period[:JAMBA_POSITIONS],
                    moe=dataclasses.replace(cfg.moe,
                                            num_experts=ZOO_EXPERTS))
        elif size != "full":
            kw = (dict(period=cfg.period[1:5], n_layers=4)
                  if name == "jamba" else {})
            if size.startswith("d"):
                kw["d_model"] = int(size[1:])
            cfg = cfg.reduced(**kw)
        cfg = cfg.replace(dtype="float32")
        if cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts
                / cfg.moe.top_k))
        out.append(cfg)
    return out


def decode_gaps(name: str, size: str, S: int = 48, t0: int = 32):
    """(reference gap, port gap, logits' max |value|)."""
    jcfg, pcfg = configs(name, size)
    pv, _ = split(init_lm(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, S)).astype(np.int32)
    full, _ = jax.jit(jforward_lm, static_argnums=1)(pv, jcfg, toks)
    full = np.asarray(full)
    logits, state = jax.jit(jprefill, static_argnums=(1, 3))(
        pv, jcfg, toks[:, :t0], S)
    step = jax.jit(jdecode_step, static_argnums=1)
    ref = [np.abs(np.asarray(logits) - full[:, t0 - 1]).max()]
    for t in range(t0, S):
        logits, state = step(pv, jcfg, state, toks[:, t:t + 1])
        ref.append(np.abs(np.asarray(logits) - full[:, t]).max())
    lm = LM(pcfg, device="meta")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg, copy=False),
        assign=True)
    lm.eval()
    tt = torch.as_tensor(toks)
    with torch.no_grad():
        pfull, _ = lm.forward_lm(tt)
        logits, state = lm.prefill(tt[:, :t0], S)
        port = [(logits - pfull[:, t0 - 1]).abs().max()]
        for t in range(t0, S):
            logits, state = lm.decode_step(state, tt[:, t:t + 1])
            port.append((logits - pfull[:, t]).abs().max())
    return (float(max(ref)), float(max(port)),
            float(np.abs(full).max()))


if __name__ == "__main__":
    for arg in sys.argv[1:] or ["xlstm:reduced", "jamba:reduced"]:
        name, size = arg.split(":")
        jcfg, _ = configs(name, size)
        ref, port, top = decode_gaps(name, size)
        print(f"{MODELS[name]} {size} (d {jcfg.d_model}, {jcfg.n_layers} "
              f"layers): reference {ref:.4g}, port {port:.4g} "
              f"({port / ref:.3g}x); logits up to {top:.3f}")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"peak RSS {rss:.2f} GiB")
