"""Spans and counters inside the port, on the host's clock and on the card's.

A span is a named stretch of work.  It opens inside the span open at that
moment (its parent) and closes before its parent does.  Tracing is off by
default: `enable(device)` turns it on, `disable()` off.  Off, `span`,
`host_span` and `phases` return one shared object that does nothing, after
one check of `ENABLED`.

On, every span records on the host its name, its parent, the request set by
`request(i)` (the spans of one circuit share it), and its start and end on
`time.time_ns()`, the clock of torch.profiler's records: one record in a
preallocated ring of RING records (`records`), and a sum per name.  Where
the recorder's device is a CUDA device, `span` and `phases` (not
`host_span`) also mark the card's stream: a boundary is one launch of the
one-thread kernel `rfhe_span_mark` (`csrc/ntt.cu`), which reads the card's
`%globaltimer`, adds the time since each span it closes opened to that
span's accumulator and counts it, and stamps each span it opens.  The
accumulators are one int64 tensor per device, allocated by the first
`enable` on it, outside every graph pool, at an address that never changes.
Inside a CUDA graph capture a mark is a node of the graph, so each replay
adds the phases it ran, with no host work and no synchronisation.
`utils/jitcache.py` keys its graphs by `MARKING`: a graph captured with
tracing off holds no mark node, and one captured with tracing on is never
served with it off.  A boundary that closes one phase and opens the next is
one mark (`phases`).  The body of a graphed op runs on the host only at its
capture, so on the card its spans are timed by the device alone, replay
after replay; on the CPU they are timed by the host alone.

The counters (`COUNTS`) are always on: integer adds in the graph cache and
in the protected evaluator's public ops.

`snapshot()` / `since(snap)` give, per span name, the closes and
nanoseconds on each clock, the parent, and the self time (the span's time
less its children's), computed on read.

The names of the keyswitch's phases are the upstream's kernel lines
(`[NTT]`, `[MULTEVK]`, ...): `PHASES`, shared with trace/profiled.py.  The
protected evaluator (fhe/protected.py) opens the same phases around the same
work, and each detector family's check as a phase of its own right after
the step it guards: `CHECK_PHASES`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

PHASES = ("PERMUTE", "INTT", "BASECONV", "NTT", "MULTEVK", "MODDOWN")
KEYSWITCH = "KEYSWITCH"     # BASECONV, NTT, MULTEVK and MODDOWN open inside it
# the phases of each `drop_limb` of the keyswitch's MODDOWN (fhe/rns.py)
MODDOWN_PHASES = ("MD_INTT", "MD_LIFT", "MD_NTT", "MD_SCALE")
# the protected evaluator's detectors: PERMUTE and INTT's checks beside
# those phases, BASECONV's and the keyswitch core's (after MULTEVK) in
# KEYSWITCH, the mod-down's four in MODDOWN, once per special prime
CHECK_PHASES = ("CHK_PERMUTE", "CHK_INTT", "CHK_BASECONV", "CHK_KS_CORE", "CHK_MD_INTT",
                "CHK_MD_LIFT", "CHK_MD_PROJ", "CHK_MD_RANGE")
DISPATCH = "dispatch"       # a graphed op's call on the host (utils/jitcache.py)
DEVICE_SPANS = 64           # names the card times: one bit each in a mark's masks
RING = 1 << 16              # host records kept, the newest

ENABLED = False
MARKING: Optional[int] = None    # the CUDA device index marks go to, or None

_acc: Dict[int, torch.Tensor] = {}    # device index -> (DEVICE_SPANS, 3) int64
_bits: Dict[str, int] = {}            # name -> its row of the accumulators
_parent: Dict[str, Optional[str]] = {}
_stack: List[str] = []                # names of the open spans, innermost last
_request: Optional[int] = None
_ring: list = [None] * RING           # (name, parent, request, start ns, end ns, detail)
_written = 0                          # records ever written
_host: Dict[str, list] = {}           # name -> [closes, ns]


def named_range(name: str):
    """A `torch.profiler.record_function` range: where the port opens every
    named range of a profile (trace/markers.py, device.py)."""
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# on and off
# ---------------------------------------------------------------------------

def _lib():
    from ..ops.ntt_cuda import KERNELS
    return KERNELS.lib()


def enable(device) -> None:
    """Turn tracing on.  On a CUDA device the spans also mark the card (the
    accumulators are allocated, and the kernels' library built, here: never
    inside a capture)."""
    global ENABLED, MARKING
    dev = torch.device(device)
    MARKING = None
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("spans.enable inside a CUDA graph capture")
        if index not in _acc:
            _acc[index] = torch.zeros((DEVICE_SPANS, 3), dtype=torch.int64,
                                      device=torch.device("cuda", index))
        _lib()
        MARKING = index
    ENABLED = True


def disable() -> None:
    global ENABLED, MARKING
    ENABLED, MARKING = False, None


def request(i: Optional[int]) -> None:
    """The request (circuit) the spans opened from now on belong to."""
    global _request
    _request = i


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def _bit(name: str) -> int:
    bit = _bits.get(name)
    if bit is None:
        if len(_bits) == DEVICE_SPANS:
            raise RuntimeError(f"more than {DEVICE_SPANS} span names on the card: {name!r}")
        bit = _bits[name] = len(_bits)
    return 1 << bit


def _mark(closes: int, opens: int) -> None:
    """One boundary on the current stream of the marked device."""
    if MARKING is None or not closes | opens:
        return
    stream = torch.cuda.current_stream(MARKING).cuda_stream
    rc = _lib().rfhe_span_mark_launch(_acc[MARKING].data_ptr(), closes, opens, stream)
    if rc != 0:
        raise RuntimeError(f"rfhe_span_mark launch failed: cudaError {rc}")


def _open(name: str) -> int:
    parent = _stack[-1] if _stack else None
    _parent[name] = parent
    _stack.append(name)
    return time.time_ns()


def _close(name: str, t0: int, detail) -> None:
    global _written
    t1 = time.time_ns()
    if _stack and _stack[-1] == name:
        _stack.pop()
    _ring[_written % RING] = (name, _parent[name], _request, t0, t1, detail)
    _written += 1
    agg = _host.get(name)
    if agg is None:
        agg = _host[name] = [0, 0]
    agg[0] += 1
    agg[1] += t1 - t0


class _Off:
    """What every span is while tracing is off, and the `phase` of a callee
    whose caller records no phases (`OFF`)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, name: str) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "detail", "device", "t0")

    def __init__(self, name: str, detail, device: bool):
        self.name, self.detail, self.device = name, detail, device

    def __enter__(self):
        self.t0 = _open(self.name)
        if self.device:
            _mark(0, _bit(self.name))
        return self

    def __exit__(self, kind, *exc):
        if self.device and kind is None:
            _mark(_bit(self.name), 0)
        _close(self.name, self.t0, self.detail)
        return False


def span(name: str):
    """A span timed on the host and, where the recorder marks a card, on
    the card: `with span("KEYSWITCH"): ...`."""
    return _Span(name, None, True) if ENABLED else OFF


def host_span(name: str, detail=None):
    """A span timed on the host only; `detail` is kept with its record
    (the op's name for DISPATCH)."""
    return _Span(name, detail, False) if ENABLED else OFF


class _Phases:
    """Consecutive child spans of `parent` (None: of the span open now):
    each call closes the phase before and opens the next in one mark, and
    the parent opens with the first phase and closes with the last."""
    __slots__ = ("parent", "t_parent", "now", "t_now", "pending")

    def __init__(self, parent: Optional[str]):
        self.parent, self.now, self.pending = parent, None, 0

    def __enter__(self):
        if self.parent is not None:
            self.t_parent = _open(self.parent)
            self.pending = _bit(self.parent)
        return self

    def __call__(self, name: str) -> None:
        closes = 0
        if self.now is not None:
            _close(self.now, self.t_now, None)
            closes = _bit(self.now)
        self.t_now = _open(name)
        _mark(closes, _bit(name) | self.pending)
        self.now, self.pending = name, 0

    def __exit__(self, kind, *exc):
        closes = 0
        if self.now is not None:
            _close(self.now, self.t_now, None)
            closes = _bit(self.now)
        if self.parent is not None:
            _close(self.parent, self.t_parent, None)
            if not self.pending:
                closes |= _bit(self.parent)
        if kind is None:
            _mark(closes, 0)
        return False


def phases(parent: Optional[str] = None):
    """`with phases("KEYSWITCH") as phase: phase("BASECONV"); ...;
    phase("NTT"); ...`: the phases of one parent, one mark per boundary."""
    return _Phases(parent) if ENABLED else OFF


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def snapshot() -> dict:
    """The recorder's sums now (reading the card's waits for its stream)."""
    return {"host": {k: tuple(v) for k, v in _host.items()},
            "device": {i: t.cpu() for i, t in _acc.items()},
            "written": _written}


def since(snap: dict) -> Dict[str, dict]:
    """Per span name that closed since `snap`: closes and nanoseconds on the
    host (`count`, `host_ns`) and on the card (`device_count`, `device_ns`),
    its `parent`, and its self times (`self_host_ns`, `self_device_ns`: its
    time on that clock less that of the spans whose parent it is; 0 on a
    clock that did not time it, as the card does not time DISPATCH)."""
    out: Dict[str, dict] = {}

    def entry(name):
        if name not in out:
            out[name] = {"count": 0, "host_ns": 0, "device_count": 0, "device_ns": 0,
                         "parent": _parent.get(name)}
        return out[name]

    for name, (count, ns) in _host.items():
        c0, n0 = snap["host"].get(name, (0, 0))
        if count != c0:
            e = entry(name)
            e["count"], e["host_ns"] = count - c0, ns - n0
    for index, acc in _acc.items():
        now = acc.cpu()
        then = snap["device"].get(index, torch.zeros_like(now))
        for name, bit in _bits.items():
            closes = int(now[bit, 2] - then[bit, 2])
            if closes:
                e = entry(name)
                e["device_count"] += closes
                e["device_ns"] += int(now[bit, 1] - then[bit, 1])
    for name, e in out.items():
        kids = [k for k in out.values() if k["parent"] == name]
        e["self_host_ns"] = e["host_ns"] - sum(k["host_ns"] for k in kids) if e["count"] else 0
        e["self_device_ns"] = (e["device_ns"] - sum(k["device_ns"] for k in kids)
                               if e["device_count"] else 0)
    return out


def records(snap: Optional[dict] = None) -> List[tuple]:
    """The host records written since `snap` (all kept, by default) that the
    ring still holds, oldest first: (name, parent, request, start ns, end
    ns, detail)."""
    first = max(0 if snap is None else snap["written"], _written - RING)
    return [_ring[i % RING] for i in range(first, _written)]


class Counters:
    """What the graph cache (utils/jitcache.py) did, counted on every call:
    replays and captures, the argument tensors copied into a graph's static
    inputs and their bytes, the outputs cloned out of it and their bytes,
    and the calls that ran eagerly (under `eager()`) with tensors on a card;
    and the detector flags (one bool tensor per family and mod-down) that
    the protected evaluator's ops returned."""
    FIELDS = ("replays", "captures", "copies_in", "copy_in_bytes", "clones_out",
              "clone_out_bytes", "eager_on_card", "detector_flags")
    __slots__ = FIELDS

    def __init__(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def snapshot(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    def since(self, snap: dict) -> dict:
        return {f: getattr(self, f) - snap[f] for f in self.FIELDS}


COUNTS = Counters()
