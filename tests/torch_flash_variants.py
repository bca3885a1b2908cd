"""The float32 flash kernels' design choices, timed on the card: the
source as committed against variants of it, each made by textual edits of
``csrc/flash_attention.cu`` (every edit must match exactly once), built
in parallel beside it and launched through the same wrapper on the same
inputs in one process, at ``chip_smoke.py``'s ten flash shapes in
float32, in the float32-accumulate mode and the bf16-accumulate twin.
At every row the committed build and the variants are timed in the
order C V1 .. Vn C Vn .. V1 C (C: the committed build), so that a drift
of the card's clock cancels from a variant's mean; the committed build's
three times give the run-to-run spread (largest less smallest, over
their mean).

    python3 tests/torch_flash_variants.py               # on an H100; ~5 min
    python3 tests/torch_flash_variants.py f32_no_half   # the named ones

Variants (`VARIANTS`; "modes": the kernels an edit touches, the only
ones timed for it):

- ``rna_small``: the split's small half rounded by a second
  ``cvt.rna`` (the committed split leaves it to the tensor cores'
  truncation);
- ``one_product``: big times big alone, the two small products dropped
  (the small halves go with them) -- not float32-accurate;
- ``three_raw``: the three products on the raw float32 bits, the
  split's instructions gone (the tensor cores read each float as TF32)
  -- not float32-accurate; against the committed build it prices the
  split's ALU work, against ``one_product`` the two extra products;
- ``f32_no_half`` / ``f32_half_hd128``: the float32-accumulate kernel
  without its half tile, or with it at hd 128 too;
- ``f32_min_blocks``: that kernel with a minimum of one block in its
  ``__launch_bounds__``;
- ``twin_64_rows``: the twin's ring slots a whole tile at every shape
  (the committed twin takes 32-row slots for a dense launch over at most
  32 keys); ``twin_no_half``: that, and no half tile;
- ``twin_thread_bound`` / ``twin_min_blocks``: the twin with
  ``__launch_bounds__(W * 32)`` / ``(W * 32, 1)`` (it has none).

float32-accurate variants are held to ``chip_smoke.py``'s bounds for the
mode (a miss is printed and recorded, and the run goes on); the two that
are not print their max |diff| and are timed only.  Each build's
registers and stack bytes for every float32 kernel come from
``cuobjdump``.  Prints one line a row and, last, a JSON object; writes
the same to ``build/flash_variants.json``.
"""
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkern  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402

F32, TWIN = "f32", "twin"
_SPLIT = "  small = __float_as_uint(x - __uint_as_float(big));\n"
_SMALL_PRODUCTS = ("  ptx::mma_tf32_1688(d, as, bb0, bb1);\n"
                   "  ptx::mma_tf32_1688(d, ab, bs0, bs1);\n")
_F32_HALF = "    const bool half = HD <= 96 && k0 + KT / 2 >= k_hi;\n"
_F32_HEAD = ("__global__ void __launch_bounds__(W * 32)\n"
             "flash_attention_f32_kernel(")
_TWIN_HEAD = "__global__ void\nflash_attention_f32_acc_bf16_kernel("
_TWIN_ROWS = ("  return !CHUNKED && Skv <= kTK / 2 ? kTK / 2 : kTK;\n",
              "  return kTK;\n")
# name: (modes, float32-accurate, ((old, new), ...))
VARIANTS = {
    "rna_small": ((F32, TWIN), True, (
        (_SPLIT, "  small = ptx::cvt_tf32(x - __uint_as_float(big));\n"),)),
    "one_product": ((F32, TWIN), False, ((_SMALL_PRODUCTS, ""),)),
    "three_raw": ((F32, TWIN), False, (
        ("  big = ptx::cvt_tf32(x);\n" + _SPLIT,
         "  big = small = __float_as_uint(x);\n"),)),
    "f32_no_half": ((F32,), True, (
        (_F32_HALF, "    const bool half = false;\n"),)),
    "f32_half_hd128": ((F32,), True, (
        (_F32_HALF, "    const bool half = k0 + KT / 2 >= k_hi;\n"),)),
    "f32_min_blocks": ((F32,), True, (
        (_F32_HEAD, "__global__ void __launch_bounds__(W * 32, 1)\n"
                    "flash_attention_f32_kernel("),)),
    "twin_64_rows": ((TWIN,), True, (_TWIN_ROWS,)),
    "twin_no_half": ((TWIN,), True, (
        _TWIN_ROWS,
        ("    const bool half = k0 + kTK / 2 >= min(ce, k_hi);\n",
         "    const bool half = false;\n"))),
    "twin_thread_bound": ((TWIN,), True, (
        (_TWIN_HEAD, "__global__ void __launch_bounds__(W * 32)\n"
                     "flash_attention_f32_acc_bf16_kernel("),)),
    "twin_min_blocks": ((TWIN,), True, (
        (_TWIN_HEAD, "__global__ void __launch_bounds__(W * 32, 1)\n"
                     "flash_attention_f32_acc_bf16_kernel("),)),
}
_KERNEL = re.compile(r"(flash_attention_f32(?:_acc_bf16)?_kernel)"
                     r"ILi(\d+)ELi(\d+)E(?:Lb([01])E)?")


def variant_source(name: str) -> Path:
    """The committed source with ``name``'s edits, written under
    ``build/flash_variants/<name>/`` (headers are found in the shared
    ``kernels/csrc``); raises if an edit does not match exactly once."""
    text = fkern.SOURCE.read_text()
    for old, new in VARIANTS[name][2]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit of {old!r} matches "
                             f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    out = ROOT / "build" / "flash_variants" / name / fkern.SOURCE.name
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists() or out.read_text() != text:
        out.write_text(text)
    return out


def usage(lib: Path) -> dict:
    """{"f32 hd W" / "twin hd W dense|chunked": [registers, stack bytes]}
    of the float32 kernels in a built library."""
    out = {}
    for fn, u in chip_smoke.resource_usage(str(lib)).items():
        m = _KERNEL.search(fn)
        if m:
            kind = TWIN if "acc_bf16" in m[1] else F32
            key = f"{kind} {m[2]} {m[3]}" + (
                "" if m[4] is None else " chunked" if m[4] == "1"
                else " dense")
            out[key] = [u["REG"], u.get("STACK", 0) + u.get("LOCAL", 0)]
    return out


def one_row(dev, libs, i, name, B, H, KV, S, hd, causal, window):
    q, k, v, _, _ = chip_smoke.flash_case(dev, B, H, KV, S, hd, causal,
                                          window, torch.float32, 20 + i)
    kw = dict(causal=causal, window=window)
    t = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = fref.flash_attention(*t, **kw).transpose(1, 2)
    want_b = fref.flash_attention(*t, acc_dtype=torch.bfloat16,
                                  **kw).transpose(1, 2)
    gap = float((want - want_b).abs().mean())
    lim = chip_smoke.ACC_BF16_MAX_REL * float(v.abs().max())
    tol = chip_smoke.ATTN_TOL["float32"]
    rows = {}
    for mode in (F32, TWIN):
        def kern():
            return fops.flash_attention(q, k, v, acc_bf16=mode == TWIN, **kw)
        vs = [n for n in libs if n != "committed" and mode in VARIANTS[n][0]]
        row = {"graph_ms": {}}
        for n in ["committed"] + vs + ["committed"] + vs[::-1] \
                + ["committed"]:
            with chip_smoke.forced(fkern, "_lib", libs[n]):
                got = kern()
                err = (got - (want if mode == F32 else want_b)).abs()
                if mode == F32:
                    ok = bool((err <= tol["atol"]
                               + tol["rtol"] * want.abs()).all())
                else:
                    ok = (float(err.max()) <= lim and float(err.mean())
                          <= chip_smoke.ACC_BF16_MEAN_SHARE * gap)
                row["graph_ms"].setdefault(n, []).append(
                    chip_smoke.graph_ms(kern))
            if n != "committed":
                row.setdefault("max_abs_err", {})[n] = float(err.max())
                if VARIANTS[n][1] and not ok \
                        and n not in row.get("misses_bounds", []):
                    row.setdefault("misses_bounds", []).append(n)
            elif not ok:
                raise SystemExit(f"{name} {mode}: the committed kernel "
                                 f"misses its bounds")
        g = {n: sum(ms) / len(ms) for n, ms in row["graph_ms"].items()}
        c = row["graph_ms"]["committed"]
        row["spread"] = (max(c) - min(c)) / g["committed"]
        row["ratio"] = {n: g[n] / g["committed"] for n in vs}
        print(f"  {name} {mode} (B={B} S={S} H={H} KV={KV} hd={hd} "
              f"W={window}): committed "
              + " / ".join(f"{x:.4f}" for x in c)
              + f" ms (spread {row['spread']:.3f}); " + ", ".join(
                  f"{n} {g[n]:.4f} ({r:.3f}x)"
                  for n, r in row["ratio"].items())
              + (f"; outside the bounds: {row['misses_bounds']}"
                 if "misses_bounds" in row else ""), flush=True)
        rows[f"{name} {mode}"] = row
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    names = sys.argv[1:] or list(VARIANTS)
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    sources = {"committed": fkern.SOURCE,
               **{n: variant_source(n) for n in names}}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(_build.build, sources.values())))
    libs, use = {}, {}
    for n, path in built.items():
        libs[n] = _build.load(sources[n], fkern._declare)
        use[n] = usage(path)
        most = max(use[n].items(), key=lambda kv: kv[1][0])
        stack = {k: u for k, u in use[n].items() if u[1]}
        print(f"  build {n}: most registers {most[1][0]} ({most[0]}); "
              f"stack or local bytes {stack or 'none'}", flush=True)
    out = {"card": card, "usage": use, "rows": {}}
    for i, shape in enumerate(chip_smoke.FLASH_SHAPES):
        out["rows"].update(one_row(dev, libs, i, *shape))
    text = json.dumps(out)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "flash_variants.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
