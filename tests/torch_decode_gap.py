"""The float32 decode-versus-``forward_lm`` logit gap of the reference and
of the port, from the same weights (the reference's ``init_lm``, carried
across): each side's largest |logit| difference between its teacher-forced
prefill + decode steps and its own full forward at the same positions,
over a ``t0``-token prompt and ``S - t0`` steps (`chip_smoke.py` phase
11(b)'s 32 + 16).  The reference runs compiled, as it serves.

    PYTHONPATH=src python tests/torch_decode_gap.py xlstm:full jamba:d1024

Each argument is ``model:size`` with model ``xlstm``, ``jamba`` or
``musicgen`` and size ``reduced`` (the zoo tests' reduced config: Jamba's
period positions 1-4, which keep its attention layer), ``dN`` (that at
d_model N) or ``full`` (published widths).  Used by
``tests/test_torch_zoo.py``; on the CPU, float32 throughout.
"""
import dataclasses
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


def configs(name: str, size: str):
    """(reference config, port config) for ``MODELS[name]`` at ``size``,
    float32, MoE capacity without drops."""
    out = []
    for get in (jget_config, get_config):
        cfg = get(MODELS[name])
        if size != "full":
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
    lm = LM(pcfg, device="cpu")
    lm.load_state_dict(state_dict_from_reference(
        jax.tree_util.tree_map(np.asarray, pv), pcfg))
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
