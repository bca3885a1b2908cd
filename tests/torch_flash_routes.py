"""Both routes of the flash kernels' bf16-accumulate mode, on the card:
one walk (each tile's float32 values kept in shared memory between the
statistics and the weights phase) against two walks (K copied again and
q k^T run again), each forced on the same inputs and held to the plain
version in that mode under ``chip_smoke.py``'s bounds, and timed in a
CUDA graph.  ``kernel.acc_bf16_route`` takes one walk for a dense reach
of up to ``ONE_WALK_TILES`` tiles; these are the times behind that rule.

    python3 tests/torch_flash_routes.py            # on an H100; ~2 min
    python3 tests/torch_flash_routes.py bfloat16   # one dtype

Rows, in each dtype (bfloat16 and float32, or the one named):
``chip_smoke.py``'s dense flash shapes and route edges (its phase 2
seeds), then a ladder of causal prefills at Phi-3-mini's heads (B=8,
H=KV=32, hd 96) whose last block reaches 1..6 tiles.  Chunked launches
have no one-walk route.  Prints one line a row and, last, a JSON object;
writes the same to ``build/flash_routes.json``.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkern  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402

LADDER = tuple((f"ladder {t} tiles", 8, 32, 32, 64 * t, 96, True, 0)
               for t in range(1, 7))


def rows():
    """(name, B, H, KV, S, hd, causal, window, seed) of the dense rows."""
    shapes = chip_smoke.FLASH_SHAPES + chip_smoke.FLASH_ACC_BF16_EDGES
    out = [s + (20 + i,) for i, s in enumerate(shapes)]
    out += [s + (60 + i,) for i, s in enumerate(LADDER)]
    return [r for r in out if fref.kv_chunk_for(r[4], r[4]) == 0]


def one_row(dev, dtype, name, B, H, KV, S, hd, causal, window, seed):
    q, k, v, _, _ = chip_smoke.flash_case(dev, B, H, KV, S, hd, causal,
                                          window, dtype, seed)
    f32 = dtype == torch.float32
    kw = dict(causal=causal, window=window, kv_chunk=0)
    t = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = fref.flash_attention(*t, acc_dtype=torch.bfloat16,
                                **kw).transpose(1, 2).float()
    gap = float((fref.flash_attention(*t, **kw).transpose(1, 2).float()
                 - want).abs().mean())
    lim = chip_smoke.ACC_BF16_MAX_REL * float(v.float().abs().max())
    taken = fkern.acc_bf16_route(S, S, hd, causal, window, 0, f32)
    w = taken.warps
    need = fkern.tiles_per_chunk(S, S, 16 * w, causal, window, 0)
    row = dict(tiles=need, warps=w, route_taken=taken.route, graph_ms={})
    for cap in (need, 0):
        r = fkern.Route(w, fkern.f32_acc_bf16_smem(hd, w, cap) if f32
                        else fkern.acc_bf16_smem(hd, w, False, cap), cap)
        if r.smem > fkern.SMEM_LIMIT:
            continue

        def kern():
            return fops.flash_attention(q, k, v, acc_bf16=True, **kw)
        with chip_smoke.forced(fkern, "acc_bf16_route", r):
            err = (kern().float() - want).abs()
            if not (float(err.max()) <= lim and float(err.mean())
                    <= chip_smoke.ACC_BF16_MEAN_SHARE * gap):
                raise SystemExit(f"{name} {r.route}: max |diff| "
                                 f"{float(err.max()):.3g} (limit {lim:.3g}),"
                                 f" mean {float(err.mean()):.3g} (gap "
                                 f"{gap:.3g})")
            row["graph_ms"][r.route] = chip_smoke.graph_ms(kern)
    ms = row["graph_ms"]
    if len(ms) == 2:
        row["one_over_two"] = ms["one walk"] / ms["two walks"]
    print(f"  {name} {str(dtype)[6:]} (B={B} S={S} H={H} KV={KV} hd={hd} "
          f"W={window}): "
          f"{need} tiles, {w} warps, takes {taken.route}; graph ms {ms}"
          + (f", one / two {row['one_over_two']:.3f}"
             if "one_over_two" in row else ""), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    names = sys.argv[1:] or ["bfloat16", "float32"]
    out = {"card": card,
           "rows": {f"{r[0]} {n}": one_row(dev, getattr(torch, n), *r)
                    for n in names for r in rows()}}
    text = json.dumps(out)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "flash_routes.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
