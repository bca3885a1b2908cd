"""``chip_smoke.py`` phase 11(b)'s float32 decode-versus-``forward_lm``
logit gap for Jamba on the card, at its cut (published widths, d 8192,
the first ``JAMBA_POSITIONS`` period positions), in one process from the
same seed, 11(b)'s prompt and steps:

- at 2 experts (the config that ``tests/torch_decode_gap.py jamba:zoo``
  holds beside the reference on the CPU) and at the published 16 (11(b)'s
  own), through the kernels;
- at 2 experts with the decoder's attention on the plain versions
  (``chip_smoke.plain_attention``), which takes the kernels out;
- beside each, the float32 noise of ``forward_lm`` itself on the card:
  its logits for the batch against those of each sequence alone (the same
  function, other GEMM shapes).

    python3 tests/torch_jamba_gap.py      # on an H100; ~3 min

Prints a line a run and, last, a JSON object of the gaps; writes the
same to ``build/jamba_gap.json``.
"""
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from repro_torch.models import LM  # noqa: E402

S, T0 = 48, 32            # chip_smoke.py phase 11(b)'s tokens and prompt
RUNS = ((2, False), (2, True), (16, False))   # (experts, plain attention)


def gaps(lm, vocab: int, dev, plain: bool) -> dict:
    """Max |logit| gap of teacher-forced prefill + decode against
    ``forward_lm`` (as 11(b)), and of ``forward_lm`` on the batch against
    ``forward_lm`` on each sequence alone."""
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, vocab, (2, S)), device=dev)
    ctx = chip_smoke.plain_attention() if plain else contextlib.nullcontext()
    with ctx, torch.no_grad():
        full, _ = lm.forward_lm(toks)
        alone = torch.cat([lm.forward_lm(toks[i:i + 1])[0]
                           for i in range(toks.shape[0])])
        logits, state = lm.prefill(toks[:, :T0], S)
        errs = [float((logits - full[:, T0 - 1]).abs().max())]
        for t in range(T0, S):
            logits, state = lm.decode_step(state, toks[:, t:t + 1])
            errs.append(float((logits - full[:, t]).abs().max()))
    return {"decode": max(errs),
            "forward_batch_vs_alone": float((full - alone).abs().max()),
            "logits_max": float(full.abs().max())}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    cfg = chip_smoke.zoo_config(chip_smoke.JAMBA).replace(dtype="float32")
    out = {"card": card, "runs": []}
    lm, built = None, None
    for e, plain in RUNS:
        # capacity = T, as 11(b): no assignment dropped at any T
        c = cfg.replace(moe=dataclasses.replace(
            cfg.moe, num_experts=e, capacity_factor=e / cfg.moe.top_k))
        if built != e:
            lm = None
            chip_smoke.free_cuda()
            lm, built = LM(c, seed=0, device=dev), e
        res = gaps(lm, c.vocab_size, dev, plain)
        res.update(experts=e, attention="plain" if plain else "kernels")
        out["runs"].append(res)
        print(f"  {c.name}, float32, {e} experts, attention on the "
              f"{res['attention']}: decode vs forward_lm max |dlogit| "
              f"{res['decode']:.4g}; forward_lm batch vs alone "
              f"{res['forward_batch_vs_alone']:.4g} (logits up to "
              f"{res['logits_max']:.3f})", flush=True)
    text = json.dumps(out)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "jamba_gap.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
