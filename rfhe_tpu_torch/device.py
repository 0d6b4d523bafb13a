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


def profile_kernels(fn, reps: int = 20, match: str = "", between=None) -> tuple:
    """(device microseconds, kernel launches) per call of `fn` by
    torch.profiler: the sum of the own durations of its kernels whose names
    contain `match`, without the gaps between them, and how many ran.
    `between`, if given, is called before every call of `fn` (to evict the
    L2, say); its kernels count only if they match too.  A profile that comes
    back without a device event (it happens when profiles follow each other
    closely) is taken again, three times at most."""
    fn()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA and match in ev.name]
        total = sum(ev.device_time_total for ev in kernels)
        if total > 0:
            return total / reps, len(kernels) / reps
    raise RuntimeError(f"the profiler recorded no device time for kernels matching {match!r}")


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
