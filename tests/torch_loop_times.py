"""Train-step times through the recurrent mixers' token loops on the
card: xLSTM-125M at published widths (``chip_smoke.py`` phase 12(d)'s
``XLSTM_TRAIN``: B=2, S=256; mLSTM and sLSTM loops) and Jamba cut to its
first layer (a Mamba mixer and a dense FFN at published widths, B=1,
S=1024: four chunk scans), each through ``launch/train.py``'s loop.

``--src DIR`` imports ``repro_torch`` from another checkout's ``src``
(a parent commit's), so two trees are timed by one script in one call:

    python3 tests/torch_loop_times.py --src build/parent/src --tag parent
    python3 tests/torch_loop_times.py --tag change      # on an H100

``--arch`` keeps only the named rows (``--arch xlstm-125m``).

Prints the card, each run's step times (the first step, which builds
the graph and allocates, is reported apart from the median of the rest)
and, last, a JSON object; writes the same to ``--out``
(``build/loop_times_<tag>.json``).
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (arch, layers (None: all), batch, tokens, steps)
RUNS = (("xlstm-125m", None, 2, 256, 3),
        ("jamba-1.5-large-398b", 1, 1, 1024, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", default=None)
    ap.add_argument("--arch", action="append", choices=[r[0] for r in RUNS],
                    help="time only this arch's row (repeatable)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_loop_times: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LM

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    import repro_torch
    print(f"{card}; torch {torch.__version__}; repro_torch from "
          f"{Path(repro_torch.__file__).parent}")
    out = {"card": card, "tag": args.tag, "runs": {}}
    for arch, layers, B, S, steps in RUNS:
        if args.arch and arch not in args.arch:
            continue
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(n_layers=layers, period=cfg.period[:layers])
        torch.cuda.reset_peak_memory_stats()
        lm = LM(cfg, seed=0, device="cuda")
        run = launch_train.train(lm, steps=steps, batch=B, seq=S, lr=3e-4,
                                 log=lambda _: None)
        ms = run["step_ms"]
        row = {"layers": cfg.n_layers, "batch": B, "seq": S,
               "first_ms": ms[0], "median_ms": statistics.median(ms[1:]),
               "step_ms": ms,
               "loss": [m["loss"] for m in run["history"]],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        out["runs"][arch] = row
        print(f"  [{args.tag}] {arch} ({cfg.n_layers} layers, B={B}, S={S}): "
              f"first step {ms[0]:.1f} ms, median of the next "
              f"{len(ms) - 1} {row['median_ms']:.1f} ms, losses "
              f"{[round(x, 4) for x in row['loss']]}, peak "
              f"{row['peak_gb']:.2f} GB")
        del lm, run
        torch.cuda.empty_cache()
    path = Path(args.out or ROOT / "build" / f"loop_times_{args.tag}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
