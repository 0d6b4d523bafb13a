"""NTT roofline: measured butterflies/s against the H100's two bounds.

Counterpart of `rfhe_tpu/bench/roofline.py` (the reference's batched
device-NTT throughput, reliability_test/ntt_test.cu:95).  One row per
implementation at one shape (n, limbs, batch):

  kernel_fwd_<form>, kernel_inv_<form>  the hand kernels (csrc/ntt.cu) in the
        form the shape takes by itself; from n = 16384 up the other
        large-ring form (two passes / cluster) beside it
  plain_fwd   the plain PyTorch butterflies (`ops/ntt.ntt_fwd_reference`)
  pease_fwd   the Pease constant-geometry pipeline (`ops/ntt_pease.py`)

The reference's MXU rows (`mxu_*`, `fused_*`: int8 MACs of its four-step
matmul form) have no counterpart on this card: the port's transform is a
radix-2 butterfly network on the integer pipes, so they are left out.

Work per negacyclic transform of one limb, as the reference counts it
(`roofline.py:64-71`): (n/2)·log2(n) butterflies and a floor of 2·4·n bytes
(32-bit words read and written once).  The H100's peaks replace the v5e's:
  HBM        3.35 TB/s (H100 SXM data sheet)
  integer    64 32-bit integer operations per clock per SM (add, multiply-add,
             multiply-high, compare, min: the CUDA C++ guide's throughput
             table for compute capability 9.0) x 132 SMs x the SM clock that
             nvidia-smi reads while the kernel runs
A butterfly costs OPS_PER_BUTTERFLY integer operations, counted from
`ct_round` / `gs_round` in csrc/ntt.cu: the lazy butterfly (q < 2^30) is
u = min(a, a - 2q) (2), v = a'·w - umulhi(a', w')·q (3 multiplies, 1
subtract), a + v and a - v + 2q (3): 9.  (A strict butterfly, q >= 2^30,
costs about 13; ptxas may fuse a multiply and an add into one IMAD, so the
count is an upper estimate of the instructions issued.)  The exit factor
adds a Shoup product, OPS_PER_EXIT = 5, per element.  Each row gives
`hbm_floor_pct` (the reference's byte floor over the time), `int_ops_peak_pct`
(the transform's integer operations over the integer peak), and `bound_by`,
the larger of the two least times: the bytes the port's int64 tensors must
move (16·n per transform, input read and output written once) over 3.35
TB/s, and the integer operations over the integer peak.

Times: the kernels by `device.device_ms` (one launch a call), the plain
butterflies and the Pease pipeline (hundreds of launches) by torch.profiler's
kernel sums (`device.op_us` picks by launch count; the `mode` column says).

Usage: python -m rfhe_tpu_torch.bench.roofline [--n 4096] [--limbs 21]
           [--batch 8] [--qbits 30] [--device cuda] [--out results]
"""
from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch

from ..device import op_us, require, sampled_sm_clocks
from .ops_devtime import write_csv
from .sweeps import prefix

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_CLOCK_PER_SM = 64
SMS = 132
OPS_PER_BUTTERFLY = 9
OPS_PER_EXIT = 5          # the exit factor's Shoup product, once per element
COLUMNS = ["impl", "n", "limbs", "batch", "mode", "us_per_call", "transforms_per_s",
           "butterflies_per_s", "hbm_floor_pct", "int_ops_per_s", "int_ops_peak_pct", "sm_mhz",
           "bytes_bound_us", "ops_bound_us", "bound_by"]


def butterflies(n: int) -> int:
    """Radix-2 butterflies of one transform of size n."""
    return (n // 2) * (n.bit_length() - 1)


def int_ops(n: int) -> int:
    """32-bit integer operations of one transform: the butterflies and the
    exit factor."""
    return butterflies(n) * OPS_PER_BUTTERFLY + n * OPS_PER_EXIT


def floor_bytes(n: int) -> int:
    """The reference's HBM floor of one transform: 32-bit words in and out."""
    return 2 * 4 * n


def int_peak(sm_mhz: float) -> float:
    """32-bit integer operations per second at SM clock `sm_mhz`."""
    return INT_OPS_PER_CLOCK_PER_SM * SMS * sm_mhz * 1e6


def bounds_us(transforms: int, n: int, sm_mhz: float) -> tuple:
    """(bytes bound, operations bound) in µs for `transforms` transforms:
    int64 input and output once over HBM; the butterflies' integer
    operations over the integer peak."""
    t_bytes = transforms * 16 * n / HBM_BYTES_PER_S * 1e6
    t_ops = transforms * int_ops(n) / int_peak(sm_mhz) * 1e6
    return t_bytes, t_ops


def row(impl: str, n: int, limbs: int, batch: int, us, mode: str, sm_mhz) -> dict:
    tr = batch * limbs
    out = {"impl": impl, "n": n, "limbs": limbs, "batch": batch, "mode": mode,
           "us_per_call": us}
    if us is None or sm_mhz is None:
        return out
    tps = tr / (us * 1e-6)
    t_bytes, t_ops = bounds_us(tr, n, sm_mhz)
    ops = tps * int_ops(n)
    out.update({"transforms_per_s": tps, "butterflies_per_s": f"{tps * butterflies(n):.4e}",
                "hbm_floor_pct": 100 * tps * floor_bytes(n) / HBM_BYTES_PER_S,
                "int_ops_per_s": f"{ops:.4e}", "int_ops_peak_pct": 100 * ops / int_peak(sm_mhz),
                "sm_mhz": sm_mhz, "bytes_bound_us": t_bytes, "ops_bound_us": t_ops,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    return out


def sm_clock_mhz(fn, seconds: float = 1.0):
    """Median SM clock nvidia-smi reads while `fn` runs back to back."""
    with sampled_sm_clocks() as clocks:
        until = time.perf_counter() + seconds
        while time.perf_counter() < until:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    return statistics.median(clocks) if clocks else None


def measure(n: int, limbs: int, batch: int, qbits: int = 30, device="cuda",
            sm_mhz=None) -> list:
    """The rows at one shape.  On the CPU the times are host times ('wall')
    and no bound is computed: `sm_mhz` is read on the card (or given)."""
    from .. import numth
    from ..ops import ntt_cuda, ntt_pease
    from ..ops.ntt import NttPlan, ntt_fwd_reference

    dev = require(device)
    primes = numth.find_ntt_primes(n, qbits, limbs)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, min(primes), (batch, limbs, n), dtype=np.int64)).to(dev)
    plan = NttPlan.make(n, primes, dev)
    pease = ntt_pease.PeaseNttPlan.make(n, primes, dev)
    impls = []
    if dev.type == "cuda":
        y = plan.fwd(x)
        own = ntt_cuda.default_split(n)
        splits = [own] if own == 0 else [own, (ntt_cuda.TWO_PASS, own), (ntt_cuda.CLUSTER, own)]
        seen = set()
        for s in splits:
            kind, _ = ntt_cuda.resolve_split(n, s, batch * limbs)
            if kind in seen:
                continue
            seen.add(kind)
            impls += [(f"kernel_fwd_{kind}", lambda s=s: ntt_cuda.fwd(x, plan, s)),
                      (f"kernel_inv_{kind}", lambda s=s: ntt_cuda.inv(y, plan, s))]
        if sm_mhz is None:
            sm_mhz = sm_clock_mhz(lambda: plan.fwd(x))
    impls += [("plain_fwd", lambda: ntt_fwd_reference(x, plan)),
              ("pease_fwd", lambda: ntt_pease.negacyclic_ntt(x, pease))]
    rows = []
    for name, fn in impls:
        us, mode, _, _ = op_us(fn, dev, reps=20 if name.startswith("kernel") else 5)
        rows.append(row(name, n, limbs, batch, us, mode, sm_mhz if dev.type == "cuda" else None))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--limbs", type=int, default=21)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--qbits", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    require(args.device)
    rows = measure(args.n, args.limbs, args.batch, args.qbits, args.device)
    name = f"roofline_n{args.n}_L{args.limbs}.csv"
    write_csv(os.path.join(args.out, prefix(args.device) + name), COLUMNS, rows)


if __name__ == "__main__":
    main()
