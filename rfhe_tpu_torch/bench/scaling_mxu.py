"""Scaling of the sharded production NTT, with the all_to_all's share.

Counterpart of `rfhe_tpu/bench/scaling_mxu.py`: `transform/mxu_sharded.py`'s
forward NTT of (limbs, n) words over meshes of 1, 2, 4, ... ranks, and the
stage-boundary all_to_all alone at the same per-rank block, (limbs, n2,
n1/d) words.  One CSV row per device count:

  devices,total_us,a2a_us,a2a_share,limb_transforms_per_s,efficiency

Times are the best of `iters` calls on rank 0's clock, the card waited for;
a 1-device row has a2a_us 0, as in the reference.  By default it runs on the
card, one NCCL rank per GPU; `--device cpu --devices 8` runs 8 gloo
processes on the CPU, the counterpart of the reference's virtual CPU mesh
(its numbers test the mechanics only).

  python3 -m rfhe_tpu_torch.bench.scaling_mxu [--n 4096] [--limbs 12]
      [--iters 30] [--device cuda|cpu] [--devices D] [--csv PATH]
"""
from __future__ import annotations

import argparse
import csv
import sys
import time

import numpy as np
import torch.distributed as dist

from .scaling import _sync, mesh_sizes, run_world, world_args

COLUMNS = ["devices", "total_us", "a2a_us", "a2a_share", "limb_transforms_per_s", "efficiency"]


def _best(fn, iters: int, device, group) -> float:
    """Best seconds of `iters` calls, each started together on the group."""
    fn()
    best = float("inf")
    for _ in range(iters):
        _sync(device)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def measure(n: int = 4096, limbs: int = 12, iters: int = 30, device="cuda") -> list:
    """Rows (`COLUMNS`) in an open world: every rank calls this; the rows
    carry rank 0's clock."""
    from ..device import to_torch
    from ..numth import find_ntt_primes
    from ..ops.ntt import NttPlan
    from ..parallel.mesh import all_to_all_tiled, make_mesh, members
    from ..transform.mxu_sharded import mxu_ntt_sharded, shard_coeffs

    primes = find_ntt_primes(n, 30, limbs)
    plan = NttPlan.make(n, primes, device)
    rng = np.random.default_rng(0)
    x = to_torch(rng.integers(0, min(primes), (limbs, n), dtype=np.uint32), device)
    rows = []
    for d in mesh_sizes(dist.get_world_size(), plan.n1, plan.n2):
        mesh = make_mesh(d, axis="fft", device=device)
        total = a2a = float("nan")
        if members(mesh):
            group = mesh.get_group("fft")
            xs = shard_coeffs(x, plan, mesh)
            total = _best(lambda: mxu_ntt_sharded(xs, plan, mesh), iters, device, group)
            B = to_torch(rng.integers(0, min(primes), (limbs, plan.n2, plan.n1 // d),
                                      dtype=np.uint32), device)
            a2a = _best(lambda: all_to_all_tiled(B, group, -2, -1), iters, device,
                        group) if d > 1 else 0.0
        dist.barrier()
        rows.append({"devices": d, "total_us": total * 1e6, "a2a_us": a2a * 1e6,
                     "a2a_share": a2a / total, "limb_transforms_per_s": limbs / total})
    base = rows[0]["limb_transforms_per_s"]
    for r in rows:
        r["efficiency"] = r["limb_transforms_per_s"] / (base * r["devices"])
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--limbs", type=int, default=12)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--csv", default=None)
    world_args(ap)
    args = ap.parse_args(argv)
    rows = run_world(args, measure, (args.n, args.limbs, args.iters))
    w = csv.DictWriter(sys.stdout, fieldnames=COLUMNS)
    w.writeheader()
    w.writerows(rows)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            wf = csv.DictWriter(f, fieldnames=COLUMNS)
            wf.writeheader()
            wf.writerows(rows)
        print("wrote", args.csv, file=sys.stderr)


if __name__ == "__main__":
    main()
