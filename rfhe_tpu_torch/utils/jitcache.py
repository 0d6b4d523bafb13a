"""Per-op compiled programs on the card: one CUDA graph per signature.

Counterpart of `rfhe_tpu/utils/jitcache.py`.  There every public evaluator
op is one jit program per (op, shapes, static metadata), traced once with
the plan tables and keys lifted out as device-resident arguments and then
replayed with one dispatch.  PyTorch's counterpart of "trace once per
signature, keep the constants on the device, replay with one dispatch" is a
CUDA graph captured per signature: a replay launches exactly the kernels
the eager op launched at capture (the NTT kernels of `csrc/ntt.cu`
included), on the same tables, so its arrays are the eager op's bit for bit.

`HoistedJit(fn)` on a call:

  on the CPU, or under `eager()`   runs `fn` (the plain path the tests use);
  inside an active capture         runs `fn` inline (the reference's Tracer
                                   check): the outer graph captures it;
  first call of a signature        runs `fn` once eagerly on a side stream, so
                                   that every table built at first use exists,
                                   and returns that result; then captures
                                   `fn` into a graph with static inputs;
  every later call                 copies the argument tensors into the
                                   static inputs, replays, and returns clones
                                   of the static outputs (a result that
                                   aliased a graph's buffer would be
                                   overwritten by the next replay).

The signature is the flattened argument tree (lists, tuples, dicts, None,
Python scalars as static values, and objects with `tree_flatten` /
`tree_unflatten`: a Ciphertext's components are children, its scale and
correction static) with each tensor's (shape, stride, dtype, device), and
the card that tracing marks (`trace/spans.py`'s MARKING, None when it is
off): a graph captured with tracing on holds its spans' marks, and is never
served with tracing off, nor the other way round.  An
object of a class marked `by_reference` (the keys, the protected probes) is
not copied: the graph reads its tensors where they lie, so its identity and
its tensors' addresses are part of the signature, and the cache entry holds
it, so that nothing a graph reads can be freed and reused.

NOTE (the reference's contract, `jitcache.py:30-34`): the closure is FROZEN
at the first capture of a signature.  Tensors `fn` reads from its closure or
from its context (plan tables, cached constants) are read by pointer on
every replay; data that changes between calls must be an argument.  A
context that replaces its keys drops its graphs (`CkksContext.load_keys`).

The cyclic garbage collector is held off during a capture: a graph it
destroyed then (a dropped context's) would invalidate the capture.  A
capture that fails raises with the op's name; nothing falls back to the
eager op on the card.  The kernels' launch counters (`ntt_cuda.KERNELS`) are
Python increments at launch time, so a capture records the counts it made
and takes them back (it ran nothing), and every replay adds them again: the
counters count transforms that ran, not host calls.  `spans.COUNTS` counts
what the cache does on every call: replays, captures, the tensors copied in
and cloned out and their bytes (a `Graph` knows its own at capture), calls
run eagerly on the card.  With tracing on, each call is a host span DISPATCH.
"""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..trace import spans as _spans

_EAGER = [0]        # depth of `eager()` blocks (the counterpart of jax.disable_jit)
_DISPATCHING = [False]  # inside an op's DISPATCH span (tracing on)


@contextlib.contextmanager
def eager():
    """Bypass the graph cache inside the block: every op runs eagerly, as
    `jax.disable_jit` runs the reference's.  What the graphs are compared with."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def by_reference(cls):
    """Mark a class whose instances a graph reads where they lie (keys,
    probes): never copied into a static input, identified by object and by
    the addresses of its tensors."""
    cls._jit_by_reference = True
    return cls


# ---------------------------------------------------------------------------
# argument trees
# ---------------------------------------------------------------------------

_STATIC = (type(None), bool, int, float, str)


def flatten(tree) -> Tuple[list, list, tuple]:
    """(tensors to copy, objects held by reference, tree definition).  The
    definition is hashable and holds every static value."""
    tensors, held = [], []
    return tensors, held, _walk(tree, tensors, held)


# `_walk` and `_build` are module functions, not closures that call
# themselves: such a closure is a reference cycle, one per call, that would
# hold the op's arguments (or its outputs) until the cyclic collector's next
# full pass, so device memory would grow with the number of calls.
def _walk(x, tensors: list, held: list):
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return ("T",)
    if getattr(type(x), "_jit_by_reference", False):
        held.append(x)
        return ("H",)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_walk(v, tensors, held) for v in x))
    if isinstance(x, dict):
        keys = tuple(x)
        return ("dict", keys, tuple(_walk(x[k], tensors, held) for k in keys))
    if hasattr(x, "tree_flatten"):
        children, aux = x.tree_flatten()
        return ("node", type(x), aux, tuple(_walk(c, tensors, held) for c in children))
    if isinstance(x, _STATIC):
        return ("static", x)
    raise TypeError(f"hoisted_jit takes tensors, lists, tuples, dicts, scalars and "
                    f"tree nodes, got {type(x).__name__}")


def unflatten(tdef: tuple, tensors: list, held: list):
    """The tree of `tdef` with its tensors and held objects in order."""
    return _build(tdef, iter(tensors), iter(held))


def _build(d: tuple, it, ih):
    kind = d[0]
    if kind == "T":
        return next(it)
    if kind == "H":
        return next(ih)
    if kind in ("list", "tuple"):
        items = [_build(c, it, ih) for c in d[1]]
        return items if kind == "list" else tuple(items)
    if kind == "dict":
        return {k: _build(c, it, ih) for k, c in zip(d[1], d[2])}
    if kind == "node":
        return d[1].tree_unflatten(d[2], [_build(c, it, ih) for c in d[3]])
    return d[1]


def _tensor_sig(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype, t.device


def _held_sig(obj) -> tuple:
    fields = tuple((k, v.data_ptr(), tuple(v.shape), v.dtype)
                   for k, v in sorted(vars(obj).items()) if isinstance(v, torch.Tensor))
    return type(obj).__name__, id(obj), fields


def held_tensors(held: list) -> List[torch.Tensor]:
    return [v for obj in held for v in vars(obj).values() if isinstance(v, torch.Tensor)]


def _signature(tensors: list, held: list, tdef: tuple) -> tuple:
    return (tdef, tuple(_tensor_sig(t) for t in tensors), tuple(_held_sig(h) for h in held),
            _spans.MARKING)


def signature(args: tuple) -> tuple:
    """What selects a graph: the tree definition, each copied tensor's
    (shape, stride, dtype, device), each held object's identity and the
    addresses of its tensors, and the card tracing marks (None: off)."""
    return _signature(*flatten(args))


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

class GraphPool:
    """One graph memory pool, shared by the graphs of one context (captures
    into a shared pool reuse each other's freed intermediates; the graphs
    replay one at a time on one stream), and what its captures cost."""

    def __init__(self) -> None:
        self._handles: Dict[int, Any] = {}
        self.graphs = 0             # captures into this pool
        self.bytes = 0              # memory the captures reserved
        self.capture_s = 0.0        # seconds spent capturing

    def handle(self, device: torch.device):
        """The pool's handle on `device` (a tensor's device: it has an index)."""
        if device.index not in self._handles:
            self._handles[device.index] = torch.cuda.graph_pool_handle()
        return self._handles[device.index]


_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that warms up and captures on `device` (a tensor's device)."""
    if device.index not in _STREAMS:
        _STREAMS[device.index] = torch.cuda.Stream(device=device)
    return _STREAMS[device.index]


def _kernels():
    from ..ops.ntt_cuda import KERNELS
    return KERNELS


@dataclass
class Graph:
    """One captured signature: the graph, its static inputs and outputs, the
    objects it reads by reference, the counter deltas of one run, and the
    bytes a replay copies in and clones out."""
    graph: Any
    inputs: List[torch.Tensor]
    held: list
    out_def: tuple
    outputs: List[torch.Tensor]
    counts: dict
    capture_s: float
    replays: int = 0

    def __post_init__(self) -> None:
        self.in_bytes = nbytes(self.inputs)
        self.out_bytes = nbytes(self.outputs)


def nbytes(tensors: List[torch.Tensor]) -> int:
    """Bytes a copy of each of `tensors` moves."""
    return sum(t.numel() * t.element_size() for t in tensors)


class CaptureError(RuntimeError):
    """A graph capture failed: the op does something a capture cannot hold
    (a host sync, a pageable copy, a table built at first use inside it)."""


class HoistedJit:
    """Callable wrapping `fn`: eager on the CPU, one CUDA graph per
    signature on the card (see the module's note)."""

    def __init__(self, fn: Callable, pool: Optional[GraphPool] = None,
                 name: Optional[str] = None):
        self._fn = fn
        self._pool = pool if pool is not None else GraphPool()
        self.name = name if name is not None else getattr(fn, "__name__", repr(fn))
        self._cache: Dict[tuple, Graph] = {}

    @property
    def graphs(self) -> List[Graph]:
        return list(self._cache.values())

    def __call__(self, *args):
        if _spans.ENABLED and not _DISPATCHING[0]:
            _DISPATCHING[0] = True          # an op called inside an op is in its span
            try:
                with _spans.host_span(_spans.DISPATCH, self.name):
                    return self._dispatch(args)
            finally:
                _DISPATCHING[0] = False
        return self._dispatch(args)

    def _dispatch(self, args: tuple):
        tensors, held, tdef = flatten(args)
        cuda = [t for t in tensors + held_tensors(held) if t.device.type == "cuda"]
        if _EAGER[0] or not cuda or torch.cuda.is_current_stream_capturing():
            _spans.COUNTS.eager_on_card += bool(_EAGER[0] and cuda)
            return self._fn(*args)
        off = [t.device for t in tensors if t.device.type != "cuda"]
        if off:
            raise ValueError(f"{self.name}: argument tensors on {off[0]} beside tensors on "
                             f"the card; a graph would freeze them")
        sig = _signature(tensors, held, tdef)
        entry = self._cache.get(sig)
        if entry is None:
            return self._capture(sig, args, tensors, held, tdef, cuda[0].device)
        for static, t in zip(entry.inputs, tensors):
            static.copy_(t)
        entry.graph.replay()
        entry.replays += 1
        _kernels().add(entry.counts)
        tally = _spans.COUNTS
        tally.replays += 1
        tally.copies_in += len(entry.inputs)
        tally.copy_in_bytes += entry.in_bytes
        tally.clones_out += len(entry.outputs)
        tally.clone_out_bytes += entry.out_bytes
        return unflatten(entry.out_def, [o.clone() for o in entry.outputs], [])

    def _capture(self, sig, args, tensors, held, tdef, device: torch.device):
        side = _side_stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        kernels = _kernels()
        with torch.cuda.stream(side):
            warm = self._fn(*args)
            inputs = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
                      for t in tensors]
            for static, t in zip(inputs, tensors):
                static.copy_(t)
            static_args = unflatten(tdef, inputs, held)
            graph = torch.cuda.CUDAGraph()
            before = kernels.snapshot()
            reserved = torch.cuda.memory_reserved(device)
            t0 = time.perf_counter()
            # A context dropped earlier is freed by the cyclic collector (its
            # ops' closures hold it); a graph it destroys during a capture
            # invalidates the capture, so the collector waits until the end.
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(pool=self._pool.handle(device))
                out = self._fn(*static_args)
                graph.capture_end()
            except Exception as e:
                _abandon_capture(graph, device)
                kernels.restore(before)
                raise CaptureError(f"capturing {self.name!r} into a CUDA graph failed: "
                                   f"{type(e).__name__}: {e}") from e
            finally:
                if collecting:
                    gc.enable()
            capture_s = time.perf_counter() - t0
            counts = kernels.since(before)
            kernels.restore(before)
            outputs, out_held, out_def = flatten(out)
            if out_held:
                raise CaptureError(f"{self.name!r} returns objects held by reference")
        current.wait_stream(side)
        tally = _spans.COUNTS
        tally.captures += 1
        tally.copies_in += len(inputs)
        tally.copy_in_bytes += nbytes(inputs)
        self._pool.graphs += 1
        self._pool.bytes += torch.cuda.memory_reserved(device) - reserved
        self._pool.capture_s += capture_s
        self._cache[sig] = Graph(graph=graph, inputs=inputs, held=list(held), out_def=out_def,
                                 outputs=outputs, counts=counts, capture_s=capture_s)
        return warm


def _abandon_capture(graph, device: torch.device) -> None:
    """End a capture that failed, if it is still open, so that the stream
    and the allocator leave capture mode; the side stream is not used again."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass                    # invalidated or already ended: ending it is all we want
    _STREAMS.pop(device.index, None)


def hoisted_jit(fn: Callable, pool: Optional[GraphPool] = None,
                name: Optional[str] = None) -> HoistedJit:
    return HoistedJit(fn, pool, name)
