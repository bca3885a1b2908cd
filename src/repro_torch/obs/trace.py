"""Span tracer: per-request stage timing as a tree (DESIGN.md §10.2).

A *span* is one named, timed region of a request's life
(``embed``/``plan``/``generate``/``commit``/``maintenance``); spans
nest, so one ``CachedLLMService.handle`` call produces one *span tree*
rooted at ``request``.  The tracer is deliberately tiny:

  * ``tracer.span(name, **attrs)`` is a context manager; entering
    pushes onto a plain stack (the serve loop is single-threaded —
    the shadow-rebuild thread never traces), exiting stamps the wall
    time and attaches the span to its parent.
  * Finished *root* spans land in a bounded ring (``keep`` most
    recent), inspectable via ``last_root()`` / ``drain()`` — the unit
    tests assert the full embed->plan->generate->commit tree from
    here, and an operator can dump recent request timelines without
    having wired an exporter.
  * With ``annotate_profiler=True`` each span also enters a
    ``torch.profiler.record_function``, so when a ``torch.profiler``
    trace is being captured the host and CUDA work dispatched under a
    span shows up *attributed to that stage* in the profiler timeline
    (DESIGN.md §10.4).  Outside an active capture the annotation costs
    a few microseconds per span.
  * Spans are structural; they do **not** write metrics (the serving
    layers observe the ``stage_latency_seconds`` histogram directly,
    exactly once per stage — see DESIGN.md §10.2 for why the two are
    kept separate).  Pass ``histogram=`` to opt a tracer into
    recording span durations anyway (used by tools that only have a
    tracer).

``NULL_TRACER`` (or ``Tracer(enabled=False)``) makes ``span()`` return
a shared reusable no-op context manager.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

from torch.profiler import record_function


class Span:
    __slots__ = ("name", "attrs", "start_s", "end_s", "children")

    def __init__(self, name: str, attrs: Dict[str, object]):
        self.name = name
        self.attrs = attrs
        self.start_s = time.perf_counter()
        self.end_s: Optional[float] = None
        self.children: List["Span"] = []

    @property
    def duration_s(self) -> float:
        return (self.end_s or time.perf_counter()) - self.start_s

    def to_dict(self) -> Dict[str, object]:
        """Plain-dict tree (JSON-able)."""
        return {
            "name": self.name,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    def walk(self):
        """Pre-order iteration over the tree."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> Optional["Span"]:
        for s in self.walk():
            if s.name == name:
                return s
        return None

    def stage_names(self) -> List[str]:
        """Direct children's names in completion order — the stage
        sequence of one request."""
        return [c.name for c in self.children]

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.2f}ms, "
                f"{len(self.children)} children)")


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_attrs", "_span", "_ann")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Dict[str, object]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None
        self._ann = None

    def __enter__(self) -> Span:
        t = self._tracer
        self._span = span = Span(self._name, self._attrs)
        t._stack.append(span)
        if t.annotate_profiler:
            self._ann = record_function(self._name)
            self._ann.__enter__()
        return span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        t = self._tracer
        span = self._span
        span.end_s = time.perf_counter()
        # unwind to this span even if inner code leaked an open child
        while t._stack and t._stack[-1] is not span:
            t._stack.pop()
        if t._stack:
            t._stack.pop()
        if t._stack:
            t._stack[-1].children.append(span)
        else:
            t._roots.append(span)
        if t._histogram is not None:
            t._histogram.observe(
                span.duration_s, stage=span.name,
                tenant=str(span.attrs.get("tenant", "-")))


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc) -> None:
        pass


class _NullSpan:
    __slots__ = ()
    name = ""
    attrs: Dict[str, object] = {}
    duration_s = 0.0
    children: List[Span] = []

    def to_dict(self):
        return {}


_NULL_SPAN = _NullSpan()
_NULL_CTX = _NullCtx()


class Tracer:
    def __init__(self, *, enabled: bool = True, annotate_profiler: bool = False,
                 keep: int = 64, histogram=None):
        """``keep``: finished root spans retained (ring buffer).
        ``histogram``: optional `repro_torch.obs.registry.Histogram` with
        labels ``(stage, tenant)`` to observe on every span end."""
        self.enabled = bool(enabled)
        self.annotate_profiler = bool(annotate_profiler)
        self._stack: List[Span] = []
        self._roots: deque = deque(maxlen=keep)
        self._histogram = histogram

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, attrs)

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def last_root(self) -> Optional[Span]:
        return self._roots[-1] if self._roots else None

    def roots(self) -> List[Span]:
        return list(self._roots)

    def drain(self) -> List[Span]:
        out = list(self._roots)
        self._roots.clear()
        return out


NULL_TRACER = Tracer(enabled=False)
