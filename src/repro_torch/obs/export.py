"""Exporters for registry snapshots (DESIGN.md §10.1).

Two render targets from the same ``MetricsRegistry.snapshot()`` dict:

  * **JSON-lines** (``to_jsonl`` / ``write_jsonl``): first line is a
    meta record (``{"schema": "repro.obs/v1", "kind": "meta", ...}``),
    then one line per series.  Line-oriented so a long-running server
    can append a snapshot per ``--metrics-interval`` and the file
    stays greppable/tailable.  ``read_jsonl`` parses a file back into
    ``(meta, series_list)``; ``validate_lines`` checks the documented
    schema and is what the CI metrics-smoke step runs.
  * **Prometheus text** (``to_prometheus``): classic exposition
    format — ``# HELP``/``# TYPE`` then one sample per series, with
    ``_bucket``/``_sum``/``_count`` expansion for histograms.

Run ``PYTHONPATH=src python -m repro_torch.obs.export --validate FILE`` to
lint an emitted metrics file (exit 1 with reasons on mismatch).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from .registry import SCHEMA, MetricsRegistry

_KINDS = ("counter", "gauge", "histogram")


# ---------------------------------------------------------------------------
# JSON-lines
# ---------------------------------------------------------------------------

def to_jsonl(snapshot: Dict[str, object],
             meta: Optional[Dict[str, object]] = None) -> str:
    """Render one snapshot as JSON-lines (meta line first)."""
    head = {"schema": snapshot.get("schema", SCHEMA), "kind": "meta"}
    if meta:
        head.update(meta)
    lines = [json.dumps(head, sort_keys=True)]
    for name, m in sorted(snapshot.get("metrics", {}).items()):
        for s in m["series"]:
            rec = {"kind": m["kind"], "name": name, "labels": s["labels"]}
            if m["kind"] == "histogram":
                rec.update(count=s["count"], sum=s["sum"], le=s["le"],
                           buckets=s["buckets"], min=s["min"], max=s["max"])
            else:
                rec["value"] = s["value"]
            lines.append(json.dumps(rec, sort_keys=True))
    return "\n".join(lines) + "\n"


def write_jsonl(path: str, snapshot: Dict[str, object],
                meta: Optional[Dict[str, object]] = None,
                append: bool = False) -> None:
    with open(path, "a" if append else "w") as f:
        f.write(to_jsonl(snapshot, meta))


def read_jsonl(path: str) -> Tuple[List[Dict], List[Dict]]:
    """Parse a metrics file back: (meta records, series records)."""
    metas, series = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            (metas if rec.get("kind") == "meta" else series).append(rec)
    return metas, series


def validate_lines(lines: Iterable[str]) -> List[str]:
    """Check JSON-lines output against the documented schema
    (DESIGN.md §10.1).  Returns a list of problems; empty = valid."""
    problems: List[str] = []
    saw_meta = False
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            problems.append(f"line {i}: not JSON ({e})")
            continue
        if not isinstance(rec, dict):
            problems.append(f"line {i}: not an object")
            continue
        kind = rec.get("kind")
        if kind == "meta":
            if i == 1:
                saw_meta = True
            if rec.get("schema") != SCHEMA:
                problems.append(
                    f"line {i}: meta schema {rec.get('schema')!r} != "
                    f"{SCHEMA!r}")
            continue
        if kind not in _KINDS:
            problems.append(f"line {i}: unknown kind {kind!r}")
            continue
        if not isinstance(rec.get("name"), str) or not rec["name"]:
            problems.append(f"line {i}: missing metric name")
        if not isinstance(rec.get("labels"), dict):
            problems.append(f"line {i}: labels must be an object")
        if kind == "histogram":
            le, buckets = rec.get("le"), rec.get("buckets")
            if not isinstance(le, list) or not isinstance(buckets, list) \
                    or len(buckets) != len(le) + 1:
                problems.append(
                    f"line {i}: histogram needs len(buckets) == len(le)+1")
            elif sum(buckets) != rec.get("count"):
                problems.append(
                    f"line {i}: bucket counts {sum(buckets)} != count "
                    f"{rec.get('count')}")
            if not isinstance(rec.get("sum"), (int, float)):
                problems.append(f"line {i}: histogram missing sum")
        else:
            if not isinstance(rec.get("value"), (int, float)):
                problems.append(f"line {i}: {kind} missing numeric value")
    if not saw_meta:
        problems.append("line 1: first line must be the meta record")
    return problems


def validate_file(path: str) -> List[str]:
    with open(path) as f:
        return validate_lines(f)


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _fmt_labels(labels: Dict[str, str], extra: Tuple = ()) -> str:
    items = list(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in items)
    return "{" + body + "}"


def to_prometheus(snapshot: Dict[str, object]) -> str:
    """Classic Prometheus text format from a snapshot dict."""
    out: List[str] = []
    for name, m in sorted(snapshot.get("metrics", {}).items()):
        if m.get("help"):
            out.append(f"# HELP {name} {m['help']}")
        out.append(f"# TYPE {name} {m['kind']}")
        for s in m["series"]:
            lab = s["labels"]
            if m["kind"] == "histogram":
                acc = 0
                for bound, c in zip(s["le"], s["buckets"]):
                    acc += c
                    out.append(f"{name}_bucket"
                               f"{_fmt_labels(lab, (('le', repr(bound)),))}"
                               f" {acc}")
                acc += s["buckets"][-1]
                out.append(f"{name}_bucket"
                           f"{_fmt_labels(lab, (('le', '+Inf'),))} {acc}")
                out.append(f"{name}_sum{_fmt_labels(lab)} {s['sum']}")
                out.append(f"{name}_count{_fmt_labels(lab)} {s['count']}")
            else:
                out.append(f"{name}{_fmt_labels(lab)} {s['value']}")
    return "\n".join(out) + "\n"


def render(registry: MetricsRegistry, fmt: str = "jsonl",
           meta: Optional[Dict[str, object]] = None) -> str:
    snap = registry.snapshot()
    if fmt == "jsonl":
        return to_jsonl(snap, meta)
    if fmt in ("prom", "prometheus"):
        return to_prometheus(snap)
    raise ValueError(f"unknown format {fmt!r}")


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="validate or convert repro_torch.obs metrics files")
    ap.add_argument("path", help="JSON-lines metrics file")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check the file (exit 1 on problems)")
    ap.add_argument("--prom", action="store_true",
                    help="print the file re-rendered as Prometheus text")
    args = ap.parse_args(argv)
    problems = validate_file(args.path)
    if args.validate:
        for p in problems:
            print(f"FAIL {args.path}: {p}")
        if not problems:
            metas, series = read_jsonl(args.path)
            print(f"OK {args.path}: {len(metas)} snapshot(s), "
                  f"{len(series)} series")
        return 1 if problems else 0
    if args.prom:
        metas, series = read_jsonl(args.path)
        snap: Dict[str, object] = {"schema": SCHEMA, "metrics": {}}
        for rec in series:
            m = snap["metrics"].setdefault(
                rec["name"], {"kind": rec["kind"], "help": "",
                              "label_names": sorted(rec["labels"]),
                              "series": []})
            s = {"labels": rec["labels"]}
            if rec["kind"] == "histogram":
                s.update(count=rec["count"], sum=rec["sum"], le=rec["le"],
                         buckets=rec["buckets"], min=rec.get("min", 0),
                         max=rec.get("max", 0))
            else:
                s["value"] = rec["value"]
            m["series"].append(s)
        print(to_prometheus(snap), end="")
        return 0
    ap.error("pick one of --validate / --prom")
    return 2


if __name__ == "__main__":
    raise SystemExit(_main())
