"""The bf16-key cosine top-k kernel's design choices, timed on the card:
the source as committed against variants of it, each made by textual
edits of ``csrc/cosine_topk.cu`` (every edit must match exactly once),
built in parallel beside it and launched through the same wrapper on
the same inputs in one process.  At every row the committed build and
the variants are timed in the order C V1 .. Vn C Vn .. V1 C (C: the
committed build), so that a drift of the card's clock cancels from a
variant's mean; the committed build's three times give the run-to-run
spread (largest less smallest, over their mean).

    python3 tests/torch_topk_variants.py               # on an H100; ~3 min
    python3 tests/torch_topk_variants.py two_terms     # the named ones

Variants (`VARIANTS`; "modes": the query types an edit touches, the only
rows timed for it):

- ``two_terms``: float32 q split into two bf16 terms, not three (~2^-18
  |q| left, against ~2^-24);
- ``one_chain``: every product of a key tile into one accumulator
  fragment (committed: each stage's into a fresh fragment, added to the
  tile's sums with one rounding);
- ``bk_32``: 32 columns of D a stage, a ring of 4 stages, the same bytes
  (committed: 64 columns, 2 stages);
- ``block_ring``: one ring for the block, every stage behind a block
  barrier (committed: each warp stages its own key rows into its own
  slice of the ring and waits only for its own copies);
- ``q_pairs``: the block's queries read two values a load (the path for
  misaligned or odd-width q; committed: 16 bytes a load, 8 in flight a
  thread);
- ``key_tile_128``: 128-row key tiles, 16 keys a warp (committed: 256,
  32 a warp; the wrapper reads the tile from the library).

Ablations, each dropping one piece of the work (not the function; they
price the pieces of a stage's time): ``no_mma`` (the products),
``no_key_copies`` (the keys' cp.async copies; stale shared memory is
multiplied), ``no_fold`` (the top-k pushes).

Rows: Q=64, D=768 at the flat cache's N=4096 and at N=65536, bf16 q and
float32 q (the mixed path), and the cache program's Q=1024, N=2^20 with
float32 q; k=1, a quarter of the rows invalid.  Every variant is held to
the plain version (indices equal, scores within ``chip_smoke.py``'s
``SCORE_ATOL``); a miss is printed and recorded, and the run goes on.
Every build that takes float32 q also runs
`test_torch_cuda_kernels.third_term_error` (inputs on which a third
bf16 term moves a score by ~4e-6): its largest |score - float64 score|
is printed beside ``THIRD_TERM_ATOL``, the card test's limit.  Each
build's registers and stack bytes for every bf16-key kernel come from
``cuobjdump``.  Prints one line a row and, last, a JSON object;
writes the same to ``build/topk_variants.json``.
"""
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import chip_smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cosine_topk import kernel as tkern  # noqa: E402
from repro_torch.kernels.cosine_topk import ops as tops  # noqa: E402
from repro_torch.kernels.cosine_topk import ref as tref  # noqa: E402
from test_torch_cuda_kernels import (  # noqa: E402
    THIRD_TERM_ATOL, third_term_error)

F32, BF16 = "f32q", "bf16q"
_TERMS = "constexpr int kF32Terms = 3; "
_STAGES = "constexpr int kMmaStages = 2; "
_BK = "constexpr int kMmaBK = 64; "
_PART = "    float part[kMT][NT][4] = {};\n"
_MMA = ("            ptx::mma_bf16_16816(part[m][2 * np], a[m][j], bf[0], "
        "bf[1]);\n"
        "            ptx::mma_bf16_16816(part[m][2 * np + 1], a[m][j], bf[2],"
        "\n                                bf[3]);\n")
_TO_ACC = ("    if (c == 0) {\n#pragma unroll\n      for (int m = 0; m < kMT; "
           "++m)\n#pragma unroll\n        for (int n = 0; n < NT; ++n)\n"
           "#pragma unroll\n          for (int e = 0; e < 4; ++e) "
           "acc[m][n][e] = part[m][n][e];\n    } else {\n#pragma unroll\n"
           "      for (int m = 0; m < kMT; ++m)\n#pragma unroll\n        for "
           "(int n = 0; n < NT; ++n)\n#pragma unroll\n          for (int e = "
           "0; e < 4; ++e) acc[m][n][e] += part[m][n][e];\n    }\n")
# name: (modes, float32-accurate, ((old, new), ...))
VARIANTS = {
    "two_terms": ((F32,), False, (
        (_TERMS, "constexpr int kF32Terms = 2; "),)),
    "one_chain": ((F32, BF16), True, (
        (_PART, "    if (c == 0)\n      for (auto& f : acc)\n        for "
                "(auto& x : f) x[0] = x[1] = x[2] = x[3] = 0.f;\n"
                "    float (&part)[kMT][NT][4] = acc;\n"),
        (_TO_ACC, ""))),
    "bk_32": ((F32, BF16), True, (
        (_BK, "constexpr int kMmaBK = 32; "),
        (_STAGES, "constexpr int kMmaStages = 4; "))),
    "block_ring": ((F32, BF16), True, (
        ("      const int kr0 = r0 + t * kBN + warp * kWR;\n"
         "      bf16_bits* st = wring + (it % kStages) * kWR * kMmaKP;\n",
         "      const int kr0 = r0 + t * kBN;\n"
         "      bf16_bits* st = ring + (it % kStages) * kBN * kMmaKP;\n"),
        ("        for (int i = lane; i < kWR * kC8; i += 32) {",
         "        for (int i = tid; i < kBN * kC8; i += kMmaThreads) {"),
        ("        for (int i = lane; i < kWR * kMmaBK; i += 32) {",
         "        for (int i = tid; i < kBN * kMmaBK; i += kMmaThreads) {"),
        ("    __syncwarp();  ", "    __syncthreads();"),
        ("    const bf16_bits* ks = wring + (it % kStages) * kWR * kMmaKP;",
         "    const bf16_bits* ks = ring + (it % kStages) * kBN * kMmaKP + "
         "warp * kWR * kMmaKP;"))),
    "q_pairs": ((F32, BF16), True, (
        ("    if (vec & 2) {                    // 16 bytes a load",
         "    if (false) {                      // 16 bytes a load"),)),
    "key_tile_128": ((F32, BF16), True, (
        ("constexpr int kMmaNT = 4; ", "constexpr int kMmaNT = 2; "),)),
    "no_mma": ((F32, BF16), False, ((_MMA, ""),)),
    "no_key_copies": ((F32, BF16), False, (
        ("          ptx::cp_async_16(st + r * kMmaKP + c * 8,\n"
         "                           keys + (in ? (size_t)row * D + d : 0), "
         "in);\n", "          (void)in;\n"),)),
    "no_fold": ((F32, BF16), False, (
        ("                top[2 * m + h].push(ok ? acc[m][n][2 * h + e] : "
         "kNeg, r, k);\n", "                (void)ok;\n"),)),
}
ROWS = (("flat", 64, 4096), ("large", 64, 65536),
        ("cache program", 1024, 2 ** 20))


def variant_source(name: str) -> Path:
    """The committed source with ``name``'s edits, written under
    ``build/topk_variants/<name>/`` (headers are found in the shared
    ``kernels/csrc``); raises if an edit does not match exactly once."""
    text = tkern.SOURCE.read_text()
    for old, new in VARIANTS[name][2]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit of {old!r} matches "
                             f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    out = ROOT / "build" / "topk_variants" / name / tkern.SOURCE.name
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists() or out.read_text() != text:
        out.write_text(text)
    return out


def usage(lib: Path) -> dict:
    """{bf16-key kernel (mangled, cut): [registers, stack bytes]}."""
    return {fn[:60]: [u["REG"], u.get("STACK", 0) + u.get("LOCAL", 0)]
            for fn, u in chip_smoke.resource_usage(str(lib)).items()
            if "cosine_topk_mma_kernel" in fn}


def one_row(dev, libs, name, Q, N):
    g = torch.Generator(device=dev).manual_seed(Q + N)
    D = 768

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    keys = unit(torch.randn(N, D, generator=g, device=dev))
    valid = torch.rand(N, generator=g, device=dev) >= 0.25
    q = unit(torch.randn(Q, D, generator=g, device=dev))
    n = min(Q, 32)
    q[:n] = unit(keys[:n] + 0.05 * torch.randn(n, D, generator=g,
                                                device=dev))
    keys = keys.bfloat16()
    rows = {}
    iters = 3 if N > 65536 else 20
    for mode, qq in ((F32, q), (BF16, q.bfloat16())):
        if Q > 64 and mode == BF16:
            continue                  # the cache program's q is float32
        want = tref.cosine_topk(qq, keys, valid, 1)

        def kern():
            return tops.cosine_topk(qq, keys, valid, 1)
        vs = [v for v in libs if v != "committed" and mode in VARIANTS[v][0]]
        row = {"graph_ms": {}}
        for v in ["committed"] + vs + ["committed"] + vs[::-1] \
                + ["committed"]:
            with chip_smoke.forced(tkern, "_lib", libs[v]):
                got = kern()
                err = float((got[0] - want[0]).abs().max())
                ok = bool(torch.equal(got[1], want[1])) \
                    and err <= chip_smoke.SCORE_ATOL
                row["graph_ms"].setdefault(v, []).append(
                    chip_smoke.graph_ms(kern, iters=iters, reps=5))
            if v != "committed":
                row.setdefault("max_abs_err", {})[v] = err
                if not ok and v not in row.get("misses_plain", []):
                    row.setdefault("misses_plain", []).append(v)
            elif not ok:
                raise SystemExit(f"{name} {mode}: the committed kernel "
                                 f"misses its plain version ({err:.3g})")
            else:
                row["committed_max_abs_err"] = err
        m = {v: sum(ms) / len(ms) for v, ms in row["graph_ms"].items()}
        c = row["graph_ms"]["committed"]
        row["spread"] = (max(c) - min(c)) / m["committed"]
        row["ratio"] = {v: m[v] / m["committed"] for v in vs}
        print(f"  {name} {mode} (Q={Q} N={N} D={D}): committed "
              + " / ".join(f"{x:.4f}" for x in c)
              + f" ms (spread {row['spread']:.3f}; max |score diff| "
              f"{row['committed_max_abs_err']:.3g}); " + ", ".join(
                  f"{v} {m[v]:.4f} ({r:.3f}x, "
                  f"{row['max_abs_err'][v]:.3g})"
                  for v, r in row["ratio"].items())
              + (f"; off the plain version: {row['misses_plain']}"
                 if "misses_plain" in row else ""), flush=True)
        rows[f"{name} {mode}"] = row
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"card: {card}")
    sources = {"committed": tkern.SOURCE,
               **{n: variant_source(n) for n in names}}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(_build.build, sources.values())))
    libs, use = {}, {}
    for n, path in built.items():
        libs[n] = _build.load(sources[n], tkern._declare)
        use[n] = usage(path)
        most = max(use[n].items(), key=lambda kv: kv[1][0])
        stack = {k: u for k, u in use[n].items() if u[1]}
        print(f"  build {n}: most registers {most[1][0]} ({most[0]}); "
              f"stack or local bytes {stack or 'none'}", flush=True)
    out = {"card": card, "usage": use, "rows": {},
           "third_term_atol": THIRD_TERM_ATOL, "third_term_err": {}}
    for n in libs:
        if n == "committed" or (F32 in VARIANTS[n][0] and VARIANTS[n][1]
                                or n == "two_terms"):
            with chip_smoke.forced(tkern, "_lib", libs[n]):
                out["third_term_err"][n] = err = third_term_error(dev)
            print(f"  third-term inputs, {n}: max |score - float64| "
                  f"{err:.3g} (limit {THIRD_TERM_ATOL:g}: "
                  f"{'within' if err <= THIRD_TERM_ATOL else 'OVER'})",
                  flush=True)
    for name, Q, N in ROWS:
        out["rows"].update(one_row(dev, libs, name, Q, N))
    text = json.dumps(out)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "topk_variants.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
