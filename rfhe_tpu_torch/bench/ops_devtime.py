"""Per-op device-time table for the headline CKKS configuration, with the
BGV and BFV rows.

Counterpart of `rfhe_tpu/bench/ops_devtime.py`, its rows in its order.  The
reference reads device time by its slope method (body^r1 and body^r2 in one
jit); on the card each row's method follows the op's launch count
(`device.op_us`):

  device-timer     CUDA events around 20 calls queued behind a spinning
                   blocker (`device.device_ms`), for ops of up to 40 launches
                   (the queued launches must fit the card's launch queue)
  device-profiler  the summed durations of the op's kernels by torch.profiler
                   (`device.profiled_us`), for ops of more launches
  wall             host clock over back-to-back calls, the device waited for
                   before the clock stops: mult_relin, rescale, encrypt,
                   decrypt, decrypt_decode (host); every row on the CPU
  device-unresolved  a row that still reads 0 after the reference's adaptive
                   escalation (reps x4, twice) has no number, never a bare 0.0

`launches` are the host's launches per call (kernels, graph launches and
copies: a public evaluator op is one graph replay with its input copies and
output clones), `kernels` the device operations that ran per call.

Keys are drawn before any row is timed (a lazily drawn key inside a timed
region would be measured).  BGV and BFV take a t of 16 bits, as the
reference: a 16-bit prime t ≡ 1 (mod 2n) exists at n = 4096 (t = 40961) but
not at n = 16384, where the CLI stops, as the reference raises there.

Usage: python -m rfhe_tpu_torch.bench.ops_devtime [--n 4096] [--levels 20]
           [--device cuda] [--out results]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

from ..device import host_us, op_us, require
from .sweeps import prefix

COLUMNS = ["op", "mode", "us", "launches", "kernels"]
T_BITS = 16


def _row(name, reading) -> dict:
    us, mode, launches, kernels = reading
    blank = lambda v: "" if v is None else v
    return {"op": name, "mode": mode, "us": "" if us is None else round(us, 3),
            "launches": blank(launches), "kernels": blank(kernels)}


def _wall(name, fn, device, iters=50) -> dict:
    return {"op": name, "mode": "wall", "us": round(host_us(fn, device, iters), 3),
            "launches": "", "kernels": ""}


def measure(n: int, levels: int, device: str = "cuda") -> list:
    from ..fhe import BfvContext, BfvParams, BgvContext, BgvParams, CkksContext, CkksParams
    from ..ops import ntt_pease
    from ..ops.modarith import mont_mul

    dev = require(device)
    ckks = CkksContext(CkksParams.make(n=n, levels=levels, q0_bits=30, scale_bits=28), seed=7,
                       device=dev)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 0j
    pt, scale = ckks.encode(z)
    ct = ckks.encrypt(pt, scale)
    ct2 = ckks.encrypt(pt, scale)
    x = ct.c[0].data
    # the ciphertext carries the active limbs; the context's plan also the special prime
    plan = ckks.ctx.plan.slice(x.shape[0])
    ckks.rotate(ct, 1), ckks.conjugate(ct), ckks.rlk          # keys before any timing
    rows = [
        _row("ntt_fwd", op_us(lambda: ntt_pease.negacyclic_ntt(x, plan), dev)),
        _row("ntt_inv", op_us(lambda: ntt_pease.negacyclic_intt(x, plan), dev)),
        _row("dyadic_mult", op_us(lambda: mont_mul(x, x, plan.qb(1), plan.rinvb(1)), dev)),
        _row("rotate", op_us(lambda: ckks.rotate(ct, 1), dev)),
        _row("conjugate", op_us(lambda: ckks.conjugate(ct), dev)),
        _row("add", op_us(lambda: ckks.add(ct, ct), dev)),
        _wall("mult_relin", lambda: ckks.multiply_relin(ct, ct2), dev),
    ]
    prod = ckks.multiply_relin(ct, ct2)
    rows += [_wall("rescale", lambda: ckks.rescale(prod), dev),
             _wall("encrypt", lambda: ckks.encrypt(pt, scale), dev),
             _wall("decrypt", lambda: ckks.decrypt(ct), dev, iters=20),
             _wall("decrypt_decode(host)", lambda: ckks.decrypt_decode(ct), dev, iters=5)]

    bgv = BgvContext(BgvParams.make(n=n, levels=min(levels, 9), q_bits=30, t_bits=T_BITS),
                     seed=11, device=dev)
    mb = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    ctb = bgv.encrypt(bgv.encode(mb))
    bgv.rotate_rows(ctb, 1), bgv.multiply_relin(ctb, ctb)     # keys
    rows += [_row("bgv_rotate_rows", op_us(lambda: bgv.rotate_rows(ctb, 1), dev)),
             _row("bgv_multiply_relin", op_us(lambda: bgv.multiply_relin(ctb, ctb), dev))]

    bfv = BfvContext(BfvParams.make(n=n, levels=min(levels, 9), q_bits=30, t_bits=T_BITS),
                     seed=13, device=dev)
    mf = rng.integers(0, bfv.t, (2, n // 2), dtype=np.uint32)
    ctf = bfv.encrypt(bfv.encode(mf))
    bfv.rotate_rows(ctf, 1), bfv.multiply_relin(ctf, ctf)     # keys
    rows += [_row("bfv_rotate_rows", op_us(lambda: bfv.rotate_rows(ctf, 1), dev)),
             _row("bfv_multiply_relin", op_us(lambda: bfv.multiply_relin(ctf, ctf), dev))]
    return rows


def write_csv(path: str, cols, rows) -> None:
    """The rows to stdout and, if `path`, to that file."""
    w = csv.DictWriter(sys.stdout, fieldnames=cols)
    w.writeheader()
    w.writerows(rows)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            wf = csv.DictWriter(f, fieldnames=cols)
            wf.writeheader()
            wf.writerows(rows)
        print("wrote", path, file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--levels", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    require(args.device)
    from ..numth import find_ntt_primes
    try:
        find_ntt_primes(args.n, T_BITS, 1)
    except ValueError:
        raise SystemExit(f"ops_devtime: no {T_BITS}-bit prime t ≡ 1 (mod {2 * args.n}) for the "
                         f"BGV/BFV rows at n={args.n}; the reference raises there too")
    rows = measure(args.n, args.levels, args.device)
    write_csv(os.path.join(args.out, prefix(args.device) + "ops_devtime.csv"), COLUMNS, rows)


if __name__ == "__main__":
    main()
