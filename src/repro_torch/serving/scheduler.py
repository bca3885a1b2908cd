"""Slot-based continuous batching scheduler.

The port of `repro/serving/scheduler.py`.  Requests arrive and finish at
different times, so the decode step should run at full batch occupancy.
The batcher keeps a fixed pool of B slots over one decode state:

  * a free slot admits a pending request by a B=1 ``LM.prefill`` whose
    state is copied into that slot's rows of the pool (per-slot prefill,
    batched decode),
  * every engine tick decodes one token for ALL slots (``decode_step``),
  * slots retire on EOS or ``max_new_tokens`` and are refilled at once.

Reproduced from the reference, not fixed: the pool decodes every slot
at the pool's shared ``cur_len``, which starts at 0 and which an
admission never sets to the slot's prompt length (``_write_slot`` keeps
the pool's).  So a slot's first decode step writes its K/V over cache
slot ``cur_len`` with that RoPE position, and causal masking hides the
prompt tokens past it.

The semantic cache composes in front: hits never take a slot.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import EOS
from repro_torch.models import LM
from repro_torch.obs import Telemetry


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False


def _write_slot(pool_state: Dict, slot_state: Dict, slot: int) -> None:
    """Copy a B=1 decode state into batch row ``slot`` of the pool, in
    place: every per-layer tensor (``k``, ``v``, ``pos``).  The pool's
    ``cur_len`` is kept, as in the reference."""
    for pool, one in zip(pool_state["layers"], slot_state["layers"]):
        for name, t in pool.items():
            t[slot].copy_(one[name][0])


class ContinuousBatcher:
    def __init__(self, model: LM, *, n_slots: int = 4, max_len: int = 256,
                 prompt_len: int = 32,
                 maintenance: Optional[Callable[[], object]] = None,
                 maintenance_max_interval: int = 64,
                 telemetry: Optional[Telemetry] = None):
        """``model`` is the decoder (its device is the batcher's).

        ``maintenance`` (e.g. a cache backend's bound ``maintenance``)
        runs on *idle* engine ticks — no request waiting for a slot, or
        a free slot after admission — so background cache work (the
        double-buffered IVF publish) rides the real gaps instead of
        taking host time from every saturated decode step.  Under
        sustained full load it still runs at least every
        ``maintenance_max_interval`` ticks.

        Accounting lives on the telemetry registry
        (``batcher_maintenance_total{outcome=run|skip}``, queue depth and
        occupancy gauges per tick, and a submit -> slot admission
        latency histogram)."""
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.maintenance = maintenance
        self.maintenance_max_interval = max(maintenance_max_interval, 1)
        self.last_maintenance: Optional[object] = None
        self._ticks_since_maintenance = 0
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        reg = self.telemetry.registry
        m_maint = reg.counter(
            "batcher_maintenance_total",
            "idle-tick maintenance hook outcomes", labels=("outcome",))
        self._c_maint_run = m_maint.labels(outcome="run")
        self._c_maint_skip = m_maint.labels(outcome="skip")
        self._g_queue = reg.gauge(
            "batcher_queue_depth", "requests waiting for a slot").labels()
        self._g_occupancy = reg.gauge(
            "batcher_occupancy", "active slot fraction").labels()
        self._h_admission = reg.histogram(
            "batcher_admission_latency_seconds",
            "submit -> slot-admission wait").labels()
        self._submit_s: Dict[int, float] = {}
        self.pool = model.init_lm_state(n_slots, max_len)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.pending: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.ticks = 0
        self._next_tok = np.zeros((n_slots, 1), np.int64)

    def submit(self, req: Request) -> None:
        self._submit_s[req.uid] = time.perf_counter()
        self.pending.append(req)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.pending:
                req = self.pending.pop(0)
                t_sub = self._submit_s.pop(req.uid, None)
                if t_sub is not None:
                    self._h_admission.observe(time.perf_counter() - t_sub)
                toks = np.full((1, self.prompt_len), EOS, np.int64)
                n = min(len(req.prompt), self.prompt_len)
                toks[0, :n] = req.prompt[:n]
                logits, st = self.model.prefill(toks, self.max_len)
                _write_slot(self.pool, st, slot)
                self.slot_req[slot] = req
                first = int(torch.argmax(logits[0]))
                self._next_tok[slot, 0] = first
                req.generated.append(first)

    def _retire(self) -> None:
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            if (len(req.generated) >= req.max_new_tokens
                    or (req.generated and req.generated[-1] == EOS)):
                req.done = True
                self.finished[req.uid] = req
                self.slot_req[slot] = None

    def idle(self) -> bool:
        """The idle-tick signal driving the maintenance hook: no request
        is waiting for a slot, or the pool has a free slot."""
        free = sum(r is None for r in self.slot_req)
        return not self.pending or free > 0

    def tick(self) -> int:
        """One engine iteration: admit, decode all slots, retire, and the
        maintenance hook on an idle (or overdue) tick.  Returns the
        number of active slots this tick."""
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if active:
            logits, self.pool = self.model.decode_step(self.pool,
                                                       self._next_tok)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for slot in active:
                tok = int(nxt[slot])
                self._next_tok[slot, 0] = tok
                self.slot_req[slot].generated.append(tok)
        self._retire()
        if self.maintenance is not None:
            self._ticks_since_maintenance += 1
            overdue = (self._ticks_since_maintenance
                       >= self.maintenance_max_interval)
            if self.idle() or overdue:
                self.last_maintenance = self.maintenance()
                self._c_maint_run.inc()
                self._ticks_since_maintenance = 0
            else:
                self._c_maint_skip.inc()
        self.ticks += 1
        self._g_queue.set(len(self.pending))
        self._g_occupancy.set(self.occupancy)
        return len(active)

    def run(self, max_ticks: int = 10_000) -> Dict[int, Request]:
        while (self.pending or any(r is not None for r in self.slot_req)) \
                and self.ticks < max_ticks:
            self.tick()
        return self.finished

    @property
    def occupancy(self) -> float:
        n = sum(r is not None for r in self.slot_req)
        return n / self.n_slots

    @property
    def maintenance_runs(self) -> int:
        return self._c_maint_run.value

    @property
    def maintenance_skips(self) -> int:
        return self._c_maint_skip.value

    def stats(self) -> Dict[str, object]:
        """Batcher snapshot for the serve example and the launcher."""
        return {
            "ticks": self.ticks,
            "maintenance_runs": self.maintenance_runs,
            "maintenance_skips": self.maintenance_skips,
            "queue_depth": len(self.pending),
            "occupancy": self.occupancy,
            "finished": len(self.finished),
            "admission_wait_p50_s": self._h_admission.quantile(0.5),
        }
