"""The numpy/torch boundary, device checks, the card's name and the timers.

Residues live on the device as torch.int64: every q < 2^31, so the product
of two residues is < 2^62 and exact.  uint32 numpy arrays (the JAX package's
storage) are converted only here, at the edges.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from functools import lru_cache

import numpy as np
import torch

from .trace import spans


def to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 (or any integer) numpy array -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(arr).astype(np.int64)).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int64 residue tensor -> uint32 numpy array; raises if a value does
    not fit 32 bits."""
    a = t.detach().cpu().numpy()
    if a.size and (a.min() < 0 or a.max() >= (1 << 32)):
        raise ValueError("tensor holds values outside [0, 2^32)")
    return a.astype(np.uint32)


def check_device(t: torch.Tensor, device: torch.device, what: str = "tensor") -> None:
    """Raise unless `t` lies on `device` (the port never moves work silently)."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")


def check_residues(x: torch.Tensor, L: int, n: int, device: torch.device) -> None:
    """Raise unless x is a contiguous int64 tensor of shape (..., L, n) on
    `device`: the layout the NTT kernels and their plain versions take."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
        raise TypeError(f"expected an int64 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"expected shape (..., {L}, {n}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    check_device(x, device, "input")


def card() -> str:
    """The first card's name and power limit, as nvidia-smi gives them; every
    measured number is written beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def sampled_sm_clocks(period_ms: int = 20):
    """Sample the first card's SM clock with nvidia-smi while the block runs:
    yields a list that holds the readings in MHz once the block has ended.  A
    card that is busy a third of the time may clock lower than one that is
    kept busy, and a kernel bound by instructions then takes longer."""
    readings: list = []
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-i", "0",
         "-lms", str(period_ms)], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield readings
    finally:
        proc.terminate()
        out, _ = proc.communicate()
        readings.extend(int(v) for v in out.split() if v.isdigit())


def cuda_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of `fn` on the current CUDA stream, host-paced:
    CUDA events around `reps` calls after 3 warm-ups.  The device waits for
    the host between calls, so this reads no less than the host's time to
    enqueue one call: what a caller pays who launches them one by one."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


DEVICE_TIMER = "CUDA events around launches queued behind a blocker on the stream"


@lru_cache(maxsize=None)
def _spin_cycles_per_ms(index: int) -> float:
    """Cycles that `torch.cuda._sleep` spins in one millisecond on card `index`."""
    cycles = 20_000_000
    with torch.cuda.device(index):
        torch.cuda._sleep(cycles)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, reps: int = 20) -> float:
    """Milliseconds of device time per call of `fn` on the current CUDA
    stream, also where that is less than the host's time to enqueue a call.
    A blocker (a kernel that spins) is put on the stream first, then the start
    event, `reps` calls and the end event are queued behind it: when the
    blocker ends, the calls' kernels run back to back and the events read
    their time alone, the gap between two queued kernels included.  The
    blocker is sized from the host's time for the same calls; the reading
    counts only if the start event was still pending when the host had queued
    the last call, else the blocker is doubled and the calls are queued again."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    per_ms = _spin_cycles_per_ms(torch.cuda.current_device())
    block_ms = 2.0 * host_ms + 1.0
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(block_ms * per_ms))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_was_ahead = not start.query()
        torch.cuda.synchronize()
        if host_was_ahead:
            return start.elapsed_time(end) / reps
        block_ms *= 2.0
    raise RuntimeError(f"device_ms: the host could not queue {reps} calls ahead of the device "
                       f"(blocker {block_ms / 2:.1f} ms)")


# Launches per call up to which `device_ms` reads an op: it queues 20 calls
# behind its blocker, and about a thousand launches fit the card's queue.
QUEUED_LAUNCHES = 40
MODES = ("device-timer", "device-profiler", "wall", "device-unresolved")

# What the host launches: kernels, CUDA graphs (one launch replays an op's
# kernels, utils/jitcache.py) and copies (a graph's input copies and
# output clones).
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync")
_PAD_KERNEL = "spin_kernel"          # torch.cuda._sleep's kernel
MEASURED = "measured"


@contextlib.contextmanager
def padded_profile():
    """torch.profiler over the block (CPU and CUDA activities), the block in a
    record_function range MEASURED, with three short spin kernels run and
    waited for before and after it.  In a long process a session has lost the
    device records of a few of its launches, up to all five of a short
    session (seen in chip_smoke.py): the padding takes the first and
    last places, and `device_records` counts what is lost."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(3):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with spans.named_range(MEASURED):
            yield prof
            torch.cuda.synchronize()
        for _ in range(3):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def device_records(events, skip=()) -> tuple:
    """(the device records of a `padded_profile` but the padding, the user
    annotations and names in `skip`; the kernel launches made inside
    MEASURED; how many of those left no device record).  A record and its
    launch share a correlation id; the launches are host records, which the
    sessions that lost device records kept."""
    spans = [(ev.time_range.start, ev.time_range.end) for ev in events
             if ev.device_type == torch.autograd.DeviceType.CPU and ev.name == MEASURED]
    device = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA
              and ev.name != MEASURED and ev.name not in skip and _PAD_KERNEL not in ev.name
              and not getattr(ev, "is_user_annotation", False)]
    seen = {ev.id for ev in device}
    launches = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith(_LAUNCH_CALLS)
                and any(s <= ev.time_range.start <= e for s, e in spans)]
    return device, len(launches), sum(1 for ev in launches if ev.id not in seen)


def _profile(fn, reps: int, match: str = "", between=None) -> tuple:
    """(µs of the kernels matching `match`, their records, kernel launches,
    lost records) per call over `reps` calls, from the most complete of up to
    three `padded_profile` sessions, a short pause before each retry (a
    process that has begun to lose records mostly keeps losing them)."""
    fn()
    best = None
    for attempt in range(3):
        time.sleep(0.1 * attempt)
        torch.cuda.synchronize()
        with padded_profile() as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
        device, launched, lost = device_records(prof.events())
        kernels = [ev for ev in device if match in ev.name]
        total = sum(ev.device_time_total for ev in kernels)
        if (total > 0 or launched) and (best is None or lost < best[3]):
            best = (total / reps, len(kernels) / reps, launched / reps, lost)
        if best is not None and best[3] == 0:
            return best
    if best is None:
        raise RuntimeError("the profiler recorded neither a kernel nor a launch")
    print(f"[profile] each of three profiles lost device records; the most complete lost "
          f"{best[3]} of {best[2] * reps:.0f} launches, its kernel sum is short by as much")
    return best


def profile_kernels(fn, reps: int = 20, match: str = "", between=None) -> tuple:
    """(device microseconds, kernel launches) per call of `fn` by
    torch.profiler: the sum of the own durations of its kernels whose names
    contain `match`, without the gaps between them, and how many ran.
    `between`, if given, is called before every call of `fn` (to evict the
    L2, say); its kernels count only if they match too.  A session that lost
    device records is taken again (`_profile`).  If every session kept no
    device record of a call's few launches (seen for the hand kernels late in
    a long process), the device timer reads the call instead, and says so."""
    us, kernels, launched, _ = _profile(fn, reps, match, between)
    if us > 0:
        return us, kernels
    if 0 < launched <= QUEUED_LAUNCHES and not match and between is None:
        print(f"[profile] the profiler kept no device record of the call's {launched:.0f} "
              f"launches in three sessions; read by the device timer (device_ms) instead")
        return device_ms(fn, reps) * 1e3, launched
    raise RuntimeError(f"the profiler recorded no device time for kernels matching {match!r}")


def op_counts(fn, reps: int = 5) -> tuple:
    """(device operations, host launches, lost records) per call of `fn` on
    the card, from the most complete of up to three torch.profiler sessions
    (`_profile`): the kernels and copies that ran, and what the host launched
    (kernels, graph launches, copies)."""
    _, kernels, launches, lost = _profile(fn, reps)
    return kernels, launches, lost


def profiled_us(fn, reps: int = 20, match: str = "", between=None) -> float:
    """Device microseconds per call of `fn` by torch.profiler
    (`profile_kernels`)."""
    return profile_kernels(fn, reps, match, between)[0]


def wall_us(fn, reps: int = 20) -> float:
    """Host microseconds per call of `fn`, each call waited for: what one op
    costs a caller who reads its result."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def resolve_reading(measure, reps: int, escalations: int = 2):
    """The first nonzero reading of `measure(reps)`, with reps multiplied by
    4 after each zero, `escalations` times (the reference's adaptive
    escalation, `rfhe_tpu/bench/ops_devtime.py:40-47`).  Returns (reading,
    resolved); an op that still reads 0 is not resolved, and its reading is
    None, never a bare 0.0."""
    for _ in range(escalations + 1):
        v = measure(reps)
        if v > 0.0:
            return v, True
        reps *= 4
    return None, False


def op_us(fn, device, reps: int = 20) -> tuple:
    """(microseconds per call or None, mode, host launches per call, device
    operations per call) of `fn` on `device`.  On a CUDA device both counts
    come from a torch.profiler session: the host's launch records (kernels,
    graph launches and copies: a graphed op costs one graph launch, its input
    copies and its output clones) and the device records (the kernels and
    copies that ran).  The host launches pick the method: up to
    QUEUED_LAUNCHES, `device_ms` ('device-timer'); above, the profiler's kernel
    sum ('device-profiler'); a reading that stays 0 is 'device-unresolved'.
    On the CPU the host clock per call ('wall', both counts None): no device
    metric is read there."""
    if torch.device(device).type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6, "wall", None, None
    first, kernels, launches, _ = _profile(fn, reps)
    if launches <= QUEUED_LAUNCHES:
        us, ok = resolve_reading(lambda r: device_ms(fn, r) * 1e3, reps)
        mode = "device-timer"
    else:
        readings = [first]
        us, ok = resolve_reading(lambda r: readings.pop() if readings else profiled_us(fn, r), reps)
        mode = "device-profiler"
    return us, (mode if ok else "device-unresolved"), launches, kernels


def host_us(fn, device, iters: int = 50) -> float:
    """Host microseconds per call over `iters` calls queued back to back, the
    device waited for before the clock stops (the reference's wall rows)."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e6


def require(device) -> torch.device:
    """`device` as a torch.device; raises if it is a CUDA device and there is
    none (a measurement never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device: this measures on the card (pass --device cpu to run "
                         f"the plain versions on the CPU)")
    return dev
