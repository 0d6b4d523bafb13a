"""Shape-grid audit of the NTT kernels: every (n, prime mix) the scheme layer
can ask for, in every form the ring takes, bit for bit.

Counterpart of `rfhe_tpu/bench/fused_validate.py`, which audits the fused
Pallas kernel against its XLA composition; here the hand kernels of
`csrc/ntt.cu` (K1 forward, K2 inverse) are held against the plain
butterflies, `ntt_fwd_reference` / `ntt_inv_reference`, on the reference's
grid and inputs: n = 512 ... 65536, prime mixes 31+30, 30x3 and 28x2, a batch
of 5 (an odd batch), residues from `default_rng(n ^ 0xA5)`.  Each ring runs
in the one-block form (n <= 8192) and in both large-ring forms, two passes
and cluster kernels, at its own split; n = 65536 with 31-bit primes, where
the TPU's fused kernel did not attach (`results/fused_validate_grid.csv`,
fused_attached=0), included.  A row checks the forward, the inverse of the
forward output, and the round trip.  On the CPU the plain versions run (form
"plain"), which checks only the grid.

The CSV keeps the reference's columns with `form` in place of
`fused_attached`; any mismatch exits 1.

Usage: python -m rfhe_tpu_torch.bench.fused_validate [--device cuda] [--csv PATH]
"""
from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

import numpy as np
import torch

from ..device import require
from ..numth import find_ntt_primes
from ..ops import ntt_cuda
from ..ops.ntt import NttPlan, ntt_fwd_reference, ntt_inv_reference

NS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
# prime-width mixes: the wide mix (31+30), the scheme default (30-bit chains)
# and a narrow chain
BIT_SETS = {"31+30": (31, 30), "30x3": (30, 30, 30), "28x2": (28, 28)}
BATCH = 5
COLUMNS = ["n", "n1", "n2", "bits", "L", "batch", "form", "fwd_ok", "inv_ok", "roundtrip_ok"]


def grid_primes(n: int, bits: tuple) -> list:
    """The reference's primes for a mix: the widest first."""
    primes = []
    for b in sorted(set(bits), reverse=True):
        primes += find_ntt_primes(n, b, bits.count(b))
    return primes


def grid_input(n: int, primes: list) -> np.ndarray:
    """(BATCH, L, n) residues, drawn as the reference draws them."""
    rng = np.random.default_rng(n ^ 0xA5)
    return np.stack([np.stack([rng.integers(0, q, n, dtype=np.uint32) for q in primes])
                     for _ in range(BATCH)])


def forms(n: int) -> dict:
    """Every form of ring n and its selector: the one-block kernels up to
    n = 8192, the two passes and the cluster kernels at the ring's own split."""
    own = ntt_cuda.large_split(n)
    out = {"one_block": 0} if n <= ntt_cuda.MAX_ONE_BLOCK_N else {}
    out.update({ntt_cuda.TWO_PASS: (ntt_cuda.TWO_PASS, own), ntt_cuda.CLUSTER: (ntt_cuda.CLUSTER, own)})
    return out


def grid_rows(device):
    """One row per (n, mix, form); a CPU device gives one 'plain' row per point."""
    dev = torch.device(device)
    for n in NS:
        for name, bits in BIT_SETS.items():
            primes = grid_primes(n, bits)
            plan = NttPlan.make(n, primes, dev)
            x = torch.from_numpy(grid_input(n, primes).astype(np.int64)).to(dev)
            y_ref = ntt_fwd_reference(x, plan)
            if dev.type == "cuda":
                runs = {form: (lambda v, s=split: ntt_cuda.fwd(v, plan, s),
                               lambda v, s=split: ntt_cuda.inv(v, plan, s))
                        for form, split in forms(n).items()}
            else:
                runs = {"plain": (plan.fwd, plan.inv)}
            for form, (fwd, inv) in runs.items():
                y = fwd(x)
                back = inv(y)
                yield dict(n=n, n1=plan.n1, n2=plan.n2, bits=name, L=len(primes), batch=BATCH,
                           form=form, fwd_ok=int(torch.equal(y, y_ref)),
                           inv_ok=int(torch.equal(back, ntt_inv_reference(y, plan))),
                           roundtrip_ok=int(torch.equal(back, x)))


def run(csv_path, device) -> int:
    rows, n_fail = [], 0
    for row in grid_rows(device):
        rows.append(row)
        ok = row["fwd_ok"] and row["inv_ok"] and row["roundtrip_ok"]
        n_fail += not ok
        print(f"n={row['n']:6d} n1={row['n1']:4d} n2={row['n2']:4d} bits={row['bits']:6s} "
              f"form={row['form']:9s} fwd={row['fwd_ok']} inv={row['inv_ok']} "
              f"rt={row['roundtrip_ok']}", flush=True)
        if csv_path:               # rewritten after every row: a crash keeps the rows before it
            Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
            with open(csv_path, "w", newline="") as fh:
                w = csv.DictWriter(fh, fieldnames=COLUMNS)
                w.writeheader()
                w.writerows(rows)
    if csv_path:
        print(f"wrote {csv_path} ({len(rows)} rows, {n_fail} failures)")
    return 1 if n_fail else 0


def main(argv=None) -> None:
    from .sweeps import prefix
    ap = argparse.ArgumentParser(description="shape-grid audit of the NTT kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", default=None,
                    help="default results/<h100_|cpu_>fused_validate_grid.csv")
    args = ap.parse_args(argv)
    require(args.device)
    sys.exit(run(args.csv or f"results/{prefix(args.device)}fused_validate_grid.csv", args.device))


if __name__ == "__main__":
    main()
