"""Metrics registry: counters, gauges, fixed-bucket histograms
(DESIGN.md §10.1).

One process-local registry owns every serving metric.  The design is
sized for the single-writer serve loop:

  * **Recording is lock-free.**  A metric resolves its label values to
    a *series handle* once (``metric.labels(...)``), after which every
    ``inc``/``set``/``observe`` is a couple of attribute/bisect
    operations on plain Python ints — no locks, no allocation on the
    hot path.  The serve loop is the single writer; the only other
    reader is a drain/export thread taking ``snapshot()``, which under
    the GIL sees each individual value intact (a snapshot may straddle
    two increments of *different* metrics — torn across metrics, never
    within a value — which is the standard Prometheus contract).
  * **Labels are declared per metric** (e.g. ``("tenant", "stage")``)
    and resolved positionally, so a typo'd label name fails fast at
    the call site instead of minting a ghost series.
  * **Histograms use fixed bucket boundaries** (default: a 1-2.5-5
    latency ladder from 10 us to 30 s) so two snapshots are always
    mergeable/diffable and the export schema never depends on the
    data.  ``quantile()`` interpolates inside the landing bucket
    (log-linear) and tracks per-series min/max so the overflow bucket
    still yields a finite estimate.

``snapshot()`` returns plain dicts (JSON-able as-is); the exporters in
``repro_torch.obs.export`` render them as JSON-lines or Prometheus text.
``NULL_REGISTRY`` is a full no-op implementation so telemetry-off code
paths keep the exact call shape at zero cost (the bench's < 2%
overhead guard measures the difference).
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SCHEMA = "repro.obs/v1"

# 1-2.5-5 ladder, 10 us .. 30 s, in seconds.  Fixed across the repo so
# every exported histogram is diffable against every other.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    10e-6, 25e-6, 50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def tenant_label(tenants) -> str:
    """The batch-level tenant label: one tenant's id, or ``mixed``.

    Per-row tenant attribution goes through per-tenant *counters*; the
    latency histograms are per batch (one wall time per plan/commit),
    so a heterogeneous batch is labeled ``mixed`` rather than charged
    to an arbitrary member.
    """
    import numpy as np
    t = np.asarray(tenants).reshape(-1)
    if t.size == 0:
        return "none"
    first = int(t[0])
    return str(first) if bool((t == first).all()) else "mixed"


class _CounterSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class _GaugeSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> None:
        self.value += float(v)


class _HistogramSeries:
    __slots__ = ("counts", "sum", "count", "vmin", "vmax", "_bounds")

    def __init__(self, bounds: Sequence[float]):
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = +inf overflow
        self.sum = 0.0
        self.count = 0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self._bounds, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 when empty).

        Exact only at bucket boundaries; inside a bucket the mass is
        assumed uniform.  The overflow bucket interpolates toward the
        observed max, so a p99 beyond the last bound stays finite.
        """
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= rank:
                lo = self._bounds[i - 1] if i > 0 else max(
                    min(self.vmin, self._bounds[0] if self._bounds
                        else self.vmin), 0.0)
                hi = self._bounds[i] if i < len(self._bounds) else self.vmax
                hi = max(hi, lo)
                frac = (rank - acc) / c
                return lo + (hi - lo) * frac
            acc += c
        return self.vmax

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class _Metric:
    """Base: a named family of label-resolved series."""

    kind = "abstract"
    _series_cls = _CounterSeries

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[k]) for k in self.label_names)

    def labels(self, **labels):
        """Resolve label values to a series handle — do this once per
        distinct label set, then record through the handle."""
        key = self._key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._make_series()
        return s

    def _make_series(self):
        return self._series_cls()

    def series_items(self) -> List[Tuple[Dict[str, str], object]]:
        return [(dict(zip(self.label_names, k)), s)
                for k, s in list(self._series.items())]


class Counter(_Metric):
    kind = "counter"
    _series_cls = _CounterSeries

    def inc(self, n: int = 1, **labels) -> None:
        self.labels(**labels).inc(n)

    def total(self, **match) -> int:
        """Sum of every series whose labels include ``match``."""
        tot = 0
        for lab, s in self.series_items():
            if all(lab.get(k) == str(v) for k, v in match.items()):
                tot += s.value
        return tot


class Gauge(_Metric):
    kind = "gauge"
    _series_cls = _GaugeSeries

    def set(self, v: float, **labels) -> None:
        self.labels(**labels).set(v)

    def value(self, **labels) -> float:
        return self.labels(**labels).value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        super().__init__(name, help, label_names)
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram {name!r} buckets must be "
                             f"strictly increasing, got {b}")
        self.buckets = b

    def _make_series(self):
        return _HistogramSeries(self.buckets)

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).observe(v)

    def aggregate(self, **match) -> _HistogramSeries:
        """Merge every series whose labels include ``match`` (fixed
        buckets make this a plain vector add)."""
        agg = _HistogramSeries(self.buckets)
        for lab, s in self.series_items():
            if all(lab.get(k) == str(v) for k, v in match.items()):
                agg.counts = [a + b for a, b in zip(agg.counts, s.counts)]
                agg.sum += s.sum
                agg.count += s.count
                agg.vmin = min(agg.vmin, s.vmin)
                agg.vmax = max(agg.vmax, s.vmax)
        return agg


class MetricsRegistry:
    """Name -> metric.  Registration is idempotent: asking for an
    existing name returns the existing metric, provided kind and label
    schema match (a mismatch is a programming error and raises)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str,
                  label_names: Sequence[str], **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.label_names != tuple(label_names):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} "
                    f"with labels {m.label_names}")
            return m
        m = self._metrics[name] = cls(name, help, label_names, **kw)
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S
                  ) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def metrics(self) -> Iterable[_Metric]:
        return list(self._metrics.values())

    def value(self, name: str, **match) -> float:
        """Counter total / gauge value shortcut (0 when absent)."""
        m = self._metrics.get(name)
        if m is None:
            return 0
        if isinstance(m, Counter):
            return m.total(**match)
        if isinstance(m, Gauge):
            tot = 0.0
            for lab, s in m.series_items():
                if all(lab.get(k) == str(v) for k, v in match.items()):
                    tot += s.value
            return tot
        raise TypeError(f"value() is for counters/gauges, {name!r} is "
                        f"{m.kind}")

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict view of every series (JSON-able; the exporters'
        single input).  Safe to call from a drain thread — see the
        module docstring for the consistency contract."""
        out: Dict[str, object] = {"schema": SCHEMA, "metrics": {}}
        for m in self.metrics():
            series = []
            for lab, s in m.series_items():
                if m.kind == "histogram":
                    series.append({
                        "labels": lab, "count": s.count, "sum": s.sum,
                        "le": list(m.buckets), "buckets": list(s.counts),
                        "min": s.vmin if s.count else 0.0,
                        "max": s.vmax if s.count else 0.0,
                    })
                else:
                    series.append({"labels": lab, "value": s.value})
            out["metrics"][m.name] = {
                "kind": m.kind, "help": m.help,
                "label_names": list(m.label_names), "series": series,
            }
        return out


# ---------------------------------------------------------------------------
# no-op twins: telemetry-off call sites keep the exact call shape
# ---------------------------------------------------------------------------

class _NullSeries:
    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0


_NULL_SERIES = _NullSeries()


class _NullMetric:
    __slots__ = ()
    kind = "null"
    buckets = ()

    def labels(self, **labels):
        return _NULL_SERIES

    def inc(self, n: int = 1, **labels) -> None:
        pass

    def set(self, v: float, **labels) -> None:
        pass

    def observe(self, v: float, **labels) -> None:
        pass

    def total(self, **match) -> int:
        return 0

    def value(self, **labels) -> float:
        return 0.0

    def aggregate(self, **match):
        return _HistogramSeries(())

    def series_items(self):
        return []


_NULL_METRIC = _NullMetric()


class NullRegistry(MetricsRegistry):
    """Telemetry-off registry: every metric is a shared no-op."""

    def __init__(self):
        super().__init__()

    def counter(self, name, help="", labels=()):
        return _NULL_METRIC

    def gauge(self, name, help="", labels=()):
        return _NULL_METRIC

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_LATENCY_BUCKETS_S):
        return _NULL_METRIC

    def value(self, name, **match):
        return 0

    def snapshot(self):
        return {"schema": SCHEMA, "metrics": {}}


NULL_REGISTRY = NullRegistry()
