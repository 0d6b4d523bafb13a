"""Scaling of the sharded four-step NTT over device counts.

Counterpart of `rfhe_tpu/bench/scaling.py`: `transform/distributed.py`'s
forward NTT of (limbs, n) words over meshes of 1, 2, 4, ... ranks, limb
transforms per second and the efficiency against one rank.  By default it
runs on the card, one NCCL rank per GPU; `--device cpu --devices 8` runs a
world of 8 gloo processes on the CPU, the counterpart of the reference's
virtual CPU mesh, whose numbers test the mechanics only.

  python3 -m rfhe_tpu_torch.bench.scaling [--n 1024] [--limbs 8] [--iters 20]
      [--device cuda|cpu] [--devices D]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

COLUMNS = ["devices", "limb_transforms_per_s", "efficiency"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_sizes(world: int, *extents: int):
    """1, 2, 4, ... up to the world's size, each dividing every extent."""
    d = 1
    while d <= world and all(e % d == 0 for e in extents):
        yield d
        d *= 2


def measure(n: int = 1024, limbs: int = 8, iters: int = 20, device="cuda") -> list:
    """Rows (`COLUMNS`) in an open world: every rank calls this; the rows
    carry rank 0's clock (the others return the same keys)."""
    from ..device import to_torch
    from ..numth import find_ntt_prime
    from ..parallel.mesh import make_mesh, members
    from ..transform.distributed import four_step_ntt_sharded, shard_coeffs
    from ..transform.four_step import FourStepPlan

    q = find_ntt_prime(n, 28)
    plan = FourStepPlan.make(n, q, device)
    x = to_torch(np.random.default_rng(0).integers(0, q, size=(limbs, n), dtype=np.uint32), device)
    rows = []
    for d in mesh_sizes(dist.get_world_size(), plan.n1, plan.n2):
        mesh = make_mesh(d, axis="fft", device=device)
        dt = float("nan")
        if members(mesh):
            xs = shard_coeffs(x, plan, mesh)
            four_step_ntt_sharded(xs, plan, mesh)
            _sync(device)
            dist.barrier(group=mesh.get_group("fft"))
            t0 = time.perf_counter()
            for _ in range(iters):
                four_step_ntt_sharded(xs, plan, mesh)
            _sync(device)
            dt = (time.perf_counter() - t0) / iters
        dist.barrier()
        rows.append({"devices": d, "limb_transforms_per_s": limbs / dt})
    base = rows[0]["limb_transforms_per_s"]
    for r in rows:
        r["efficiency"] = r["limb_transforms_per_s"] / (base * r["devices"])
    return rows


def world_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks in the world (default: every GPU; 8 with --device cpu)")


def run_world(args, fn, fn_args: tuple) -> list:
    """fn(*fn_args, device) in a world of --devices ranks (NCCL on the cards,
    gloo on the CPU); rank 0's result."""
    from ..device import require
    from ..parallel.mesh import spawn_world
    require(args.device)
    if args.device == "cuda":
        world, backend = args.devices or torch.cuda.device_count(), "nccl"
    else:
        world, backend = args.devices or 8, "gloo"
    return spawn_world(fn, world, backend, args=fn_args + (args.device,), deadline_s=3000)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--limbs", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    world_args(ap)
    args = ap.parse_args(argv)
    for r in run_world(args, measure, (args.n, args.limbs, args.iters)):
        print(f"devices={r['devices']}: {r['limb_transforms_per_s']:.0f} "
              f"transforms/s, efficiency={r['efficiency']:.2f}")


if __name__ == "__main__":
    main()
