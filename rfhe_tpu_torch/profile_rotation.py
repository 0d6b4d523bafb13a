"""Where a warm CKKS rotation spends its time on the card.

Counterpart of the rotation rows of `rfhe_tpu/bench/phase_profile.py` for the
port: builds a context with 21 ciphertext limbs at ring n (per-limb or
grouped digits), warms one rotation, then reports per rotation

  wall      host clock around `reps` rotations ending in a synchronize
  enqueue   host clock until the last rotation's launches are queued
  device    the sum of the kernels' own device times (torch.profiler)
  launches  kernels launched, and the device time by kernel name

Run on a machine with one NVIDIA GPU and nvcc, from the root of a checkout:

    python3 -m rfhe_tpu_torch.profile_rotation --n 65536 --dnum 3

The profiler adds host time while it is on, so wall and enqueue are taken in
a separate loop without it.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .device import card
from .fhe import CkksContext, CkksParams

CHAIN = dict(levels=20, q0_bits=30, scale_bits=28)      # 21 ciphertext primes

# kernel name fragment -> row of the report, first match wins
GROUPS = (
    ("ntt_fwd", "NTT forward kernels"),
    ("ntt_inv", "NTT inverse kernels"),
    ("remainder", "aten::remainder (int64 %)"),
    ("index", "gathers (index_select / index)"),
    ("gather", "gathers (index_select / index)"),
    ("mul", "aten::mul"),
    ("sum", "aten::sum (digit sum)"),
    ("reduce", "aten::sum (digit sum)"),
)


def group_of(kernel_name: str) -> str:
    """The report row a device kernel belongs to."""
    low = kernel_name.lower()
    for fragment, row in GROUPS:
        if fragment in low:
            return row
    return "other elementwise (add, sub, where, compare, shift, copy)"


def profile_rotation(n: int, dnum: Optional[int], reps: int,
                     seed: int = 7) -> Tuple[Dict[str, float], Dict[str, Tuple[float, int]]]:
    """(totals, rows): totals holds wall_us, enqueue_us, device_us and launches
    per rotation; rows maps a report row to (device µs, launches) per rotation."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_rotation needs a CUDA device")
    ctx = CkksContext(CkksParams.make(n=n, **CHAIN), seed=seed, dnum=dnum, device="cuda")
    z = np.random.default_rng(0).uniform(-1, 1, n // 2) + 0j
    ct = ctx.encrypt(*ctx.encode(z))
    for _ in range(2):
        ctx.rotate(ct, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ctx.rotate(ct, 1)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            ctx.rotate(ct, 1)
        torch.cuda.synchronize()
    rows: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            row = rows[group_of(ev.name)]
            row[0] += ev.device_time_total
            row[1] += 1
    if not rows:
        raise RuntimeError("the profiler recorded no device kernel")
    per = {k: (us / reps, count / reps) for k, (us, count) in rows.items()}
    totals = {"wall_us": (t2 - t0) / reps * 1e6, "enqueue_us": (t1 - t0) / reps * 1e6,
              "device_us": sum(us for us, _ in per.values()),
              "launches": sum(count for _, count in per.values())}
    return totals, per


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--dnum", type=int, default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    totals, rows = profile_rotation(args.n, args.dnum, args.reps)
    print(f"[profile] {card()}: rotation N={args.n}, 21 ciphertext limbs, dnum={args.dnum}, "
          f"{args.reps} reps")
    print(f"[profile] per rotation: wall {totals['wall_us']:.1f} us, host enqueue "
          f"{totals['enqueue_us']:.1f} us, device busy {totals['device_us']:.1f} us "
          f"({100 * totals['device_us'] / totals['wall_us']:.1f}% of wall), "
          f"{totals['launches']:.1f} kernel launches")
    for name, (us, count) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {name:60s} {us:9.1f} us  {100 * us / totals['device_us']:5.1f}%  "
              f"{count:6.1f} launches")


if __name__ == "__main__":
    main()
