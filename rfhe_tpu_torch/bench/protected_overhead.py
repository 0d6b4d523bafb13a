"""What protection costs on the card: protected against plain, on the paths
the port runs.

Counterpart of `rfhe_tpu/bench/protected_overhead.py`, with the same four
atoms on identical inputs:

  NTT              plan.fwd against plan.fwd + NttGuard.check_fwd
  ModMul           mont_mul against mont_mul_checked (fold check, range)
  Rotation         the plain evaluator's apply_galois against the protected one
  HMul+Relin       multiply + relinearize against the protected multiply_relin

Single launches (NTT, ModMul) are read by the device timer
(`device.device_ms`); the ops by torch.profiler (device time and device
operations per op, `device.profile_kernels`) and by the host's wall clock
per op, each waited for (`device.wall_us`).  Probes are built before any
timing.  Each atom is timed plain, protected, protected, plain.

Usage: python -m rfhe_tpu_torch.bench.protected_overhead [--n 4096]
           [--levels 9] [--batch 8] [--q0-bits B] [--scale-bits 28]
           [--dnum D] [--csv PATH]
"""
from __future__ import annotations

import argparse
import csv
import sys

COLUMNS = ("config", "atom", "plain_us", "prot_us", "overhead", "plain_wall_us", "prot_wall_us",
           "wall_overhead", "plain_launches", "prot_launches", "timer")


def _pair(plain, prot, timer):
    """Readings of plain and prot in the order plain, prot, prot, plain:
    (plain mean, prot mean); a timer that returns a tuple is averaged field
    by field."""
    p1, g1, g2, p2 = timer(plain), timer(prot), timer(prot), timer(plain)
    if isinstance(p1, tuple):
        return tuple((a + b) / 2 for a, b in zip(p1, p2)), tuple((a + b) / 2 for a, b in zip(g1, g2))
    return (p1 + p2) / 2, (g1 + g2) / 2


def measure(n: int = 4096, levels: int = 9, batch: int = 8, q0_bits=None,
            scale_bits: int = 28, dnum=None, atoms=None):
    """Rows of protected-vs-plain readings at ring n with `levels` levels, on
    the current CUDA device."""
    import numpy as np
    import torch
    from .. import numth
    from ..device import device_ms, profile_kernels, wall_us
    from ..fhe.ckks import Ciphertext, CkksContext
    from ..fhe.params import CkksParams
    from ..fhe.protected import ProtectedCkks, all_ok
    from ..fhe.rns import RnsPoly
    from ..ops.modarith import mont_mul
    from ..ops.ntt import NttPlan
    from ..protect.checks import mont_mul_checked
    from ..protect.ntt_guard import NttGuard

    config = f"n={n} levels={levels}" + (f" dnum={dnum}" if dnum else "")
    atoms = atoms or ("NTT(guarded)", "ModMul(fold)", "Rotation(e2e)", "HMul+Relin(e2e)")
    rows = []
    device = "cuda"
    rng = np.random.default_rng(0)
    dev_us = lambda fn: device_ms(fn) * 1e3

    def single(atom, plain, prot):
        t_p, t_g = _pair(plain, prot, dev_us)
        rows.append({"config": config, "atom": atom, "plain_us": t_p, "prot_us": t_g,
                     "overhead": t_g / t_p, "timer": "device_ms"})

    if "NTT(guarded)" in atoms or "ModMul(fold)" in atoms:
        primes = numth.find_ntt_primes(n, 30, max(2 * levels + 1, 3))
        plan = NttPlan.make(n, primes, device)
        guard = NttGuard.make(plan)
        x = torch.from_numpy(rng.integers(0, min(primes), (batch, plan.L, n), dtype=np.int64)).to(device)
        w = torch.from_numpy(rng.integers(0, min(primes), (plan.L, n), dtype=np.int64)).to(device)
        qb, rinvb = plan.qb(1), plan.rinvb(1)

        def ntt_prot():
            y = plan.fwd(x)
            return y, guard.check_fwd(x, y)

        if "NTT(guarded)" in atoms:
            single("NTT(guarded)", lambda: plan.fwd(x), ntt_prot)
        if "ModMul(fold)" in atoms:
            single("ModMul(fold)", lambda: mont_mul(x, w, qb, rinvb),
                   lambda: mont_mul_checked(x, w, qb, rinvb))
        del x, w, guard, plan

    ops = [a for a in ("Rotation(e2e)", "HMul+Relin(e2e)") if a in atoms]
    if ops:
        ckks = CkksContext(CkksParams.make(n=n, levels=levels, q0_bits=q0_bits,
                                           scale_bits=scale_bits), dnum=dnum, device=device)
        prot = ProtectedCkks(ckks)
        lvl = ckks.L - 1
        g = ckks.rotation_galois_element(1)
        ksk, rlk = ckks.galois_key(g), ckks.rlk
        c01 = torch.from_numpy(np.stack([np.stack([
            rng.integers(0, int(ckks.ctx.moduli[i]), n, dtype=np.int64)
            for i in range(lvl + 1)]) for _ in range(2)])).to(device)
        ct = Ciphertext([RnsPoly(c01[0], True), RnsPoly(c01[1], True)], 1.0)
        ks_probe = prot._ks_probe(ksk, lvl, salt=g)
        perm_probe = prot._perm_probe(g, lvl + 1)
        rlk_probe = prot._ks_probe(rlk, lvl, salt=-1)
        cases = {
            "Rotation(e2e)": (lambda: ckks.apply_galois(ct, g),
                              lambda: all_ok(prot._galois_impl(ct, ksk, g, lvl, None,
                                                               ks_probe, perm_probe)[1])),
            "HMul+Relin(e2e)": (lambda: ckks.multiply_relin(ct, ct),
                                lambda: all_ok(prot._mul_relin_impl(
                                    [c01[0], c01[1]], [c01[0], c01[1]], rlk, rlk_probe,
                                    lvl, 1.0, None)[1])),
        }
        for atom in ops:
            plain, protected = cases[atom]
            (t_p, n_p), (t_g, n_g) = _pair(plain, protected, profile_kernels)
            w_p, w_g = _pair(plain, protected, wall_us)
            rows.append({"config": config, "atom": atom, "plain_us": t_p, "prot_us": t_g,
                         "overhead": t_g / t_p, "plain_wall_us": w_p, "prot_wall_us": w_g,
                         "wall_overhead": w_g / w_p, "plain_launches": n_p,
                         "prot_launches": n_g, "timer": "torch.profiler + host wall"})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--levels", type=int, default=9)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--q0-bits", type=int, default=None)
    ap.add_argument("--scale-bits", type=int, default=28)
    ap.add_argument("--dnum", type=int, default=None)
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    from ..device import card
    print(f"card: {card()}", file=sys.stderr)
    rows = measure(args.n, args.levels, args.batch, args.q0_bits, args.scale_bits, args.dnum)

    def write(f):
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        w.writerows(rows)

    write(sys.stdout)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            write(f)


if __name__ == "__main__":
    main()
