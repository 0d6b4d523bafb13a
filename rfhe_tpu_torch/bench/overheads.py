"""Measured per-atom protection overheads on the card: protected against
plain execution of the reference's three atoms.

Counterpart of `rfhe_tpu/bench/overheads.py` (which writes
results/atom_overheads.csv on the TPU), on identical inputs:

  NTTCost       the four-step NTT (transform/four_step.py) against its
                stages plus the three projection checks, whose probes are
                drawn from a fresh `prng` key split each call, as the
                reference draws them from PRNGKey(0)
  ModmulCost    mont_mul against mont_mul plus the 8-bit intra fold check
                of the 64-bit product
  BaseConvCost  base_conv against base_conv of the residues with the
                appended checksum column, and its check

ModMul and BaseConv are single passes of a few launches, read by the device
timer (`device.device_ms`).  The protected NTT draws its probes on the host
and copies them to the card each call, which the device timer cannot queue
behind its blocker, so the NTT pair is read by torch.profiler (device time
and device operations per call, `device.profile_kernels`).  Every atom also
gets the host's wall clock per call, each call waited for (`device.wall_us`).
Each pair is timed plain, protected, protected, plain.  "Others" is 2 by
construction (duplicated execution), as in the reference.

Usage: python -m rfhe_tpu_torch.bench.overheads [--n 4096] [--batch 8]
           [--iters 20] [--out results]
Writes OUT/h100_atom_overheads.csv.
"""
from __future__ import annotations

import argparse
import csv
import random
from pathlib import Path

ATOMS = ("NTTCost", "BaseConvCost", "ModmulCost")


def atoms(n: int = 4096, batch: int = 8, device: str = "cuda") -> dict:
    """{atom: (plain fn, protected fn)} on the reference's inputs (numpy
    seed 0, q the 30-bit NTT prime of n, BaseConv from 8 28-bit to 4 30-bit
    random primes).  A protected fn returns (output, ok)."""
    import numpy as np
    import torch
    from .. import numth, prng
    from ..device import to_torch
    from ..ops.baseconv import BaseConvPlan, base_conv
    from ..ops.modarith import mont_mul
    from ..ops.modring import ModArith
    from ..protect.checks import (baseconv_append_checksum, baseconv_ecc_check,
                                  stage1_projection_check, stage2_projection_check,
                                  twiddle_inter_check)
    from ..protect.fold import fold_2s1_u32, fold_2s1_u64, mul32_parts
    from ..transform.four_step import FourStepPlan, four_step_ntt, four_step_ntt_stages

    q = numth.find_ntt_prime(n, 30)
    plan = FourStepPlan.make(n, q, device=device)
    rng = np.random.default_rng(0)
    x = to_torch(rng.integers(0, q, (batch, n), dtype=np.uint32), device)
    key = prng.PRNGKey(0)

    def ntt_prot():
        k1, k2, k3 = prng.split(key, 3)
        A, B1, B2, Y = four_step_ntt_stages(x, plan)
        ok = (stage1_projection_check(A, B1, plan.W2, plan.digit, plan.arith, k1)
              & twiddle_inter_check(B1, B2, plan.T, plan.arith, k2)
              & stage2_projection_check(B2, Y, plan.W1T, plan.digit, plan.arith, k3))
        return Y.transpose(-1, -2).reshape(x.shape), ok

    rinv = ModArith.make(q).rinv
    a = to_torch(rng.integers(0, q, (batch, n), dtype=np.uint32), device)
    b = to_torch(rng.integers(0, q, (batch, n), dtype=np.uint32), device)

    def mm_prot():
        hi, lo = mul32_parts(a, b)
        ph, pl = mul32_parts(fold_2s1_u32(a, 8), fold_2s1_u32(b, 8))
        return mont_mul(a, b, q, rinv), fold_2s1_u64(ph, pl, 8) == fold_2s1_u64(hi, lo, 8)

    moduli_in = numth.generate_crt_primes(8, 28, random.Random(1))
    moduli_out = numth.generate_crt_primes(4, 30, random.Random(2))
    bplan = BaseConvPlan.make(moduli_in, moduli_out, device)
    res = to_torch(np.stack([rng.integers(0, p, n, dtype=np.uint32) for p in moduli_in]), device)
    q_in = torch.tensor(moduli_in, dtype=torch.int64, device=device)     # no copy per call
    q_out = torch.tensor(moduli_out, dtype=torch.int64, device=device)

    def bc_prot():
        out = base_conv(baseconv_append_checksum(res, q_in), bplan)
        return out[..., :-1], baseconv_ecc_check(out, q_out)

    return {"NTTCost": (lambda: four_step_ntt(x, plan), ntt_prot),
            "ModmulCost": (lambda: mont_mul(a, b, q, rinv), mm_prot),
            "BaseConvCost": (lambda: base_conv(res, bplan), bc_prot)}


def measure(n: int = 4096, batch: int = 8, iters: int = 20) -> dict:
    """The overheads on the current CUDA device, and the readings behind
    them: {"NTTCost": ..., "BaseConvCost": ..., "ModmulCost": ..., "Others": 2.0,
    "n": n, "batch": batch, "rows": [per-atom readings]}."""
    from ..device import DEVICE_TIMER, device_ms, profile_kernels, wall_us

    out = {"n": n, "batch": batch, "Others": 2.0, "rows": []}
    for name, (plain, prot) in atoms(n, batch).items():
        if name == "NTTCost":
            read = lambda fn: profile_kernels(fn, iters)
            timer = "torch.profiler kernel sums"
        else:
            read = lambda fn: (device_ms(fn, iters) * 1e3, None)
            timer = DEVICE_TIMER
        p1, g1, g2, p2 = read(plain), read(prot), read(prot), read(plain)
        w1, v1, v2, w2 = wall_us(plain, iters), wall_us(prot, iters), wall_us(prot, iters), \
            wall_us(plain, iters)
        plain_us, prot_us = (p1[0] + p2[0]) / 2, (g1[0] + g2[0]) / 2
        out[name] = prot_us / plain_us
        out["rows"].append({
            "atom": name, "plain_us": plain_us, "prot_us": prot_us, "overhead": out[name],
            "plain_wall_us": (w1 + w2) / 2, "prot_wall_us": (v1 + v2) / 2,
            "wall_overhead": (v1 + v2) / (w1 + w2),
            "plain_launches": p1[1], "prot_launches": g1[1], "timer": timer})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=str, default="results")
    args = ap.parse_args(argv)
    from ..device import card
    res = measure(args.n, args.batch, args.iters)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    path = Path(args.out) / "h100_atom_overheads.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["atom", "overhead"])
        for k in ATOMS + ("Others",):
            w.writerow([k, f"{res[k]:.4f}"])
    c = card()
    for row in res["rows"]:
        print(f"{c}: {row}")
    print("wrote", path)


if __name__ == "__main__":
    main()
