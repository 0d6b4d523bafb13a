"""Op-level tracing: ROI markers in the reference's exact text format.

Counterpart of `rfhe_tpu/trace/markers.py`.  The reference instruments at
two levels (SURVEY.md §5):
  frontend ops:   "frontend: ROTATE" ... "ROTATE[14377 microseconds]"
                  (profile_framewk/src/dotprod_ckks.cpp:24-65)
  kernels:        "[NTT] total cost 123 us" (patched SEAL, build/sample.txt)

`scope()` emits the frontend markers and `kernel_cost()` / `kernel()` the
kernel lines; TraceCollector keeps the structured events, and
trace/analyze.py parses the text form.  Both `scope` and `kernel` also open
a `torch.profiler.record_function` range of the same name (through
`spans.named_range`), so a profile of the region shows each by name.
"""
from __future__ import annotations

import contextlib
import io
import time
from dataclasses import dataclass, field
from typing import List, Optional, TextIO

import torch

from . import spans


@dataclass
class TraceEvent:
    tag: str
    micros: float
    depth: int
    kind: str          # "begin" | "frontend" | "kernel"


def synchronizer(sync):
    """`sync` as a callable: a callable as it is; a device (str or
    torch.device) waits for that device's queue if it is a CUDA device."""
    if sync is None or callable(sync):
        return sync
    dev = torch.device(sync)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return None


@dataclass
class TraceCollector:
    events: List[TraceEvent] = field(default_factory=list)
    out: Optional[TextIO] = None
    _depth: int = 0

    def _emit(self, line: str) -> None:
        if self.out is not None:
            self.out.write(line + "\n")

    @contextlib.contextmanager
    def scope(self, name: str):
        """Frontend ROI: emits 'frontend: NAME' ... 'NAME[N microseconds]'."""
        self._emit(f"frontend: {name}")
        self.events.append(TraceEvent(name, 0.0, self._depth, "begin"))
        self._depth += 1
        t0 = time.perf_counter()
        try:
            with spans.named_range(name):
                yield
        finally:
            us = (time.perf_counter() - t0) * 1e6
            self._depth -= 1
            self.events.append(TraceEvent(name, us, self._depth, "frontend"))
            self._emit(f"{name}[{int(us)} microseconds]")

    def kernel_cost(self, tag: str, micros: float) -> None:
        """Kernel line: '[TAG] total cost N us' (patched-SEAL format,
        build/sample.txt:1-40)."""
        self.events.append(TraceEvent(tag, micros, self._depth, "kernel"))
        self._emit(f"[{tag}] total cost {int(micros)} us")

    @contextlib.contextmanager
    def kernel(self, tag: str, sync=None):
        """Time a kernel region inside a record_function range of its name.
        `sync` is called before the clock stops: a callable, or a device, for
        which a CUDA device means `torch.cuda.synchronize()` (the launches of
        the region have then finished, not only been queued)."""
        wait = synchronizer(sync)
        t0 = time.perf_counter()
        try:
            with spans.named_range(tag):
                yield
                if wait is not None:
                    wait()
        finally:
            self.kernel_cost(tag, (time.perf_counter() - t0) * 1e6)

    def text(self) -> str:
        buf = io.StringIO()
        for ev in self.events:
            if ev.kind == "kernel":
                buf.write(f"[{ev.tag}] total cost {int(ev.micros)} us\n")
            elif ev.kind == "begin":
                buf.write(f"frontend: {ev.tag}\n")
            else:
                buf.write(f"{ev.tag}[{int(ev.micros)} microseconds]\n")
        return buf.getvalue()

    def totals(self) -> dict:
        agg: dict = {}
        for ev in self.events:
            if ev.kind == "begin":
                continue
            agg[ev.tag] = agg.get(ev.tag, 0.0) + ev.micros
        return agg
