"""What a `--trace 1` run records, reduced in memory to what the readers need.

torch.profiler runs over a traced run's window (`harness.TRACE_SECONDS`)
with the CUDA activity alone: the device records (kernels, copies, fills)
and the CUDA runtime calls the host made.  No host operator is recorded and
no trace file is written: a window of a million records is read straight
from the profile's raw events.  The
benchmark's own spans (the window, each circuit's enqueue and wait) are taken
on the same clock, `time.time_ns()`.  From these it keeps the device records
inside the window, the host's launch records (`yardstick.LAUNCH_CALLS`, as
`rfhe_tpu_torch/device.py` counts them), the circuits' enqueue spans, and
the NTT transforms that ran by shape (the program's launch counter,
`ntt_cuda.KERNELS.by_shape`, to which a graph replay adds its transforms).
The program's span marks (`rfhe_span_mark`, one-thread kernels that stamp
its spans on the card) are the spans' clock, not the program's work: they
are counted and set apart, so that busy time, kernel sums and idle gaps
read as they would with the spans off.  Each idle gap is also named by the
program's host span open at its start (`spans.records`), where one is.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import yardstick


@dataclass
class Trace:
    circuits: int                                   # circuits completed in the window
    window_s: float
    device: List[Tuple[str, float, float]]          # (name, start µs, end µs), by start
    launches: int                                   # host launch records in the window
    enqueue_s: List[float]                          # each circuit's enqueue span
    ntt_by_shape: Dict[tuple, int] = field(default_factory=dict)
    gaps: List[list] = field(default_factory=list)  # longest idle stretches, named
    marks: int = 0                                  # span marks set apart

    def device_s(self, keep) -> float:
        """Seconds of device records whose name `keep` accepts."""
        return sum(e - s for name, s, e in self.device if keep(name)) * 1e-6

    def busy_s(self) -> float:
        """The union of the device records' intervals, in seconds."""
        total, reach = 0.0, float("-inf")
        for _, s, e in self.device:
            if e > reach:
                total += e - max(s, reach)
                reach = e
        return total * 1e-6

    def top_ops(self, k: int = 10) -> List[list]:
        """The k device operations that took most time, by short name."""
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return [[short(n), v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


SPAN_MARK = "rfhe_span_mark"


_NOISE = re.compile(r"\(anonymous namespace\)::|\b(?:void |at::native::|at::|std::|c10::|"
                    r"binary_internal::|gpu_kernel_impl_nocast<|vectorized_elementwise_kernel<)")


def short(name: str) -> str:
    """A kernel's name without namespaces and template noise, its functor
    kept, in at most 120 characters."""
    return _NOISE.sub("", name)[:120]


def records(prof) -> List[tuple]:
    """(name, on the device, start µs, end µs) of a profile's raw events."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        s = ev.start_ns()
        out.append((ev.name(), ev.device_type().name == "CUDA", s / 1e3,
                    (s + ev.duration_ns()) / 1e3))
    return out


def collect(recs: List[tuple], window: Tuple[int, int], spans: List[Tuple[int, int, int]],
            ntt_by_shape: dict, host_spans: Sequence[tuple] = ()) -> Trace:
    """The Trace of one window: `window` and each circuit's (start, enqueued,
    done) `spans` in ns of `time.time_ns()`; `host_spans` are the program's
    span records (`spans.records`: name, parent, request, start ns, end ns,
    detail) on the same clock."""
    w0, w1 = window[0] / 1e3, window[1] / 1e3
    inside = [(n, max(s, w0), min(e, w1)) for n, on, s, e in recs if on and e > w0 and s < w1]
    dev = sorted((r for r in inside if SPAN_MARK not in r[0]), key=lambda r: r[1])
    host = sorted(((n, s, e) for n, on, s, e in recs if not on and w0 <= s <= w1),
                  key=lambda r: r[1])
    launches = sum(1 for n, _, _ in host if n.startswith(yardstick.LAUNCH_CALLS))
    trace = Trace(circuits=len(spans), window_s=(w1 - w0) * 1e-6, device=dev,
                  launches=launches, enqueue_s=[(b - a) * 1e-9 for a, b, _ in spans],
                  ntt_by_shape=dict(ntt_by_shape), marks=len(inside) - len(dev))
    opened = sorted((s / 1e3, e / 1e3, name if detail is None else f"{name} {detail}")
                    for name, _, _, s, e, detail in host_spans)
    trace.gaps = _gaps(dev, host, [(a / 1e3, b / 1e3, c / 1e3) for a, b, c in spans], w0, w1,
                       opened)
    return trace


def _open_at(opened: List[tuple], at: float) -> Optional[str]:
    """The innermost of the spans (start µs, end µs, label), sorted by start,
    that is open at `at`: of those open, the last to start."""
    for s, e, label in reversed(opened[:bisect.bisect_right(opened, (at, float("inf")))]):
        if e > at:
            return label
    return None


def _gaps(dev, host, spans, w0: float, w1: float, opened=(), k: int = 10) -> List[list]:
    """The k longest stretches in which the device ran nothing, each named by
    the client's phase (enqueue, wait, between circuits), the runtime call
    the host was in at its start and the program's host span open then."""
    gaps, reach = [], w0
    for _, s, e in dev:
        if s > reach:
            gaps.append((s - reach, reach))
        reach = max(reach, e)
    if w1 > reach:
        gaps.append((w1 - reach, reach))
    starts = [r[1] for r in host]
    span_starts = [s[0] for s in spans]
    out = []
    for length, at in sorted(gaps, reverse=True)[:k]:
        j = bisect.bisect_right(span_starts, at) - 1
        phase = "between circuits"
        if j >= 0 and at < spans[j][2]:
            phase = "enqueue" if at < spans[j][1] else "wait"
        i = bisect.bisect_right(starts, at) - 1
        call = host[i][0] if i >= 0 and host[i][2] >= at else "host code"
        label = _open_at(opened, at)
        out.append([(f"{phase}: {call}" + (f" | {label}" if label else ""))[:120],
                    length * 1e-6])
    return out
