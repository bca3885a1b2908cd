"""Training launcher: decoder training steps for any registry arch, the
port of `repro/launch/train.py` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --smoke --steps 20 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --smoke --steps 3                                   # on the CPU

As the reference: AdamW under ``linear_warmup_cosine(lr, 10, steps)``
with the gradient clipped at global norm 1.0, tokens drawn from
``np.random.default_rng(0).integers(0, vocab, (batch, seq))`` each step,
the frontend stub's frames (seeded by the step) for the audio and vision
configs, the loss / grad norm / lr every 5th and the last step, and the
tokens per second.  ``--ckpt PATH`` writes ``{"params": the reference's
value tree, "config": name}`` in the reference's checkpoint format, which
its ``load_checkpoint`` + ``forward_lm`` read.  ``--device`` defaults to
the card.  ``--production-mesh`` builds the reference's 16x16 mesh
(`launch.mesh.make_production_mesh`: it needs a process group of 256
ranks, and at one rank raises "a (16, 16) mesh needs 256 ranks"), and
prints the per-device parameter bytes of `launch.sharding.sharding_tree`
over it under ``TRAIN_RULES``; the steps then run as without it — the
reference jits its step with ``in_shardings=None``, so its steps are not
sharded either.  ``chip_smoke.py`` drives `train` on the full-width
Phi-3-mini.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import (
    TRAIN_RULES, sharded_bytes, sharding_tree,
)
from repro_torch.models import LM, param_axes, state_dict_to_reference
from repro_torch.serving.frontend import stub_frontend_embeds
from repro_torch.training import (
    adamw, linear_warmup_cosine, make_train_step, save_checkpoint,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (needs 256 ranks)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_batch(cfg, rng: np.random.Generator, batch: int, seq: int,
               step: int, device) -> dict:
    """The reference launcher's batch: uniform token ids, and for a
    frontend config the stub's frames seeded by ``step``."""
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        device=device)}
    if cfg.frontend:
        out["frontend_embeds"] = stub_frontend_embeds(cfg, batch, seed=step,
                                                      device=device)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train(lm: LM, *, steps: int, batch: int, seq: int, lr: float,
          log=print) -> dict:
    """``steps`` train steps of ``lm`` in place.  Returns the optimizer
    state and update function, each step's metrics (read to the host
    after the step) and wall ms (to the device's end of the step), the
    seconds of the loop and its tokens per second."""
    cfg, dev = lm.cfg, lm.device
    init_opt, update = adamw(linear_warmup_cosine(lr, 10, steps),
                             max_grad_norm=1.0)
    opt = init_opt(dict(lm.named_parameters()))
    step_fn = make_train_step(lm, update)
    rng = np.random.default_rng(0)
    history, step_ms = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        opt, metrics = step_fn(opt, make_batch(cfg, rng, batch, seq, i, dev))
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - ts))
        history.append({k: float(v) for k, v in metrics.items()})
        if i % 5 == 0 or i == steps - 1:
            m = history[-1]
            log(f"step {i:4d} loss={m['loss']:.4f} "
                f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}")
    dt = time.perf_counter() - t0
    return {"opt": opt, "update": update, "history": history,
            "step_ms": step_ms, "seconds": dt,
            "tokens_per_s": steps * batch * seq / dt}


def main(argv=None) -> LM:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh = make_production_mesh(device=args.device) \
        if args.production_mesh else None
    lm = LM(cfg, seed=0, device=args.device)
    where = torch.cuda.get_device_name(lm.device) \
        if lm.device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params={cfg.param_count():,} device={where}")
    if mesh is not None:
        params, axes = dict(lm.named_parameters()), param_axes(cfg, lm)
        placed = sharding_tree(params, axes, mesh, TRAIN_RULES)
        n_sharded = sum(any(p.is_shard() for p in pl)
                        for pl in placed.values())
        per_dev = sharded_bytes(params, axes, mesh, TRAIN_RULES)
        print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"{n_sharded} of {len(placed)} parameters sharded, "
              f"{per_dev:,} parameter bytes per device")
    run = train(lm, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr)
    print(f"{args.steps} steps in {run['seconds']:.1f}s "
          f"({run['tokens_per_s']:.0f} tokens/s on {where})")
    if args.ckpt:
        save_checkpoint(args.ckpt, {
            "params": state_dict_to_reference(lm.state_dict(), cfg),
            "config": cfg.name})
        print("saved", args.ckpt)
    return lm


if __name__ == "__main__":
    main()
