"""Campaign sweep drivers: the reference's sweeps whose modules the port has.

Counterpart of `rfhe_tpu/bench/sweeps.py`, with its argument names and
defaults, plus `--device` (default cuda):

  pbits      the three-stage pipeline's collision probability against the
             prime's bit length, every fault type
  relia_ntt  the protected four-step NTT against q's bit length
  ntt_err    error propagation through the forward NTT (the hand kernels
             on a GPU) against flips and corrupted words
  dotprod    ciphertext flips through the encrypted BGV dot product

Each sweep's rows come from a generator (`pbits_rows`, `relia_ntt_rows`,
`ntt_err_rows`, `dotprod_rows`) that chip_smoke.py drives too.  Output files
carry the reference's names with a prefix for the device they ran on
(`h100_` on the card, `cpu_` on the CPU), so no committed CSV is written.

Usage: python -m rfhe_tpu_torch.bench.sweeps <name> [--trials N] [--out DIR]
           [--device cuda] ...
"""
from __future__ import annotations

import argparse
import csv
import os
import random
import time
from pathlib import Path

PBITS_HEADER = ["ftype", "pbits", "stage", "injected", "undetected", "collision_prob"]
RELIA_HEADER = ["qbits", "kind", "det_rate", "miss_rate", "miss_stage1", "miss_stage2",
                "miss_stage3", "intra_catch", "inter_catch", "batch_catch"]
NTT_ERR_HEADER = ["num_flips", "num_symbols", "bit_error_rate", "symbol_error_rate", "hamming"]
DOTPROD_HEADER = ["bits_per_symbol", "num_symbols", "symbol_errors", "total_symbols",
                  "bit_errors", "dot_hamming"]


def pbits_rows(trials: int, N: int, W: int, seed: int, pbits_range, device: str):
    """Rows of the pbits CSV, as the reference formats them."""
    from .. import numth
    from ..faults.campaign import FAULT_TYPES, three_stage_campaign
    for ftype in FAULT_TYPES:
        for pbits in pbits_range:
            P = numth.find_prime_with_bitlen(pbits, random.Random(seed))
            res = three_stage_campaign(ftype, trials, S=int(N ** 0.5), P=P, W=W, seed=seed,
                                       device=device)
            for s in range(3):
                yield [ftype, pbits, s + 1, res["injected"][s], res["undetected"][s],
                       f"{res['collision_prob'][s]:.6f}"]


def relia_ntt_rows(trials: int, N: int, fold: int, seed: int, qbits_range, device: str):
    """Rows of the reliaNTT CSV: q of each bit length (no NTT prime: skipped)."""
    from .. import numth
    from ..faults.campaign import four_step_ntt_campaign
    for qbits in qbits_range:
        try:
            q = numth.find_ntt_prime(N, qbits, negacyclic=False)
        except ValueError:
            continue
        for kind in ("SBF", "DBF", "MOF1"):
            res = four_step_ntt_campaign(kind, trials, N, q, fold_width=fold, seed=seed,
                                         device=device)
            yield [qbits, kind, f"{res['det_rate']:.6f}", f"{res['miss_rate']:.6f}",
                   *(f"{m:.6f}" for m in res["per_stage_miss"]),
                   res["stats"]["intra_catch"], res["stats"]["inter_catch"],
                   res["stats"]["batch_catch"]]


def ntt_err_rows(plan, max_flips: int, max_symbols: int, seed: int):
    """Rows of the flipimpact CSV over the plan's limbs, batch 1."""
    from ..faults.hardware import ntt_flip_campaign
    for flips in range(1, max_flips + 1):
        for syms in range(1, max_symbols + 1):
            stats, _ = ntt_flip_campaign(plan, batch=1, num_flips=flips,
                                         num_target_symbols=syms, seed=seed)
            yield [flips, syms, f"{stats.bit_error_rate:.6f}",
                   f"{stats.symbol_error_rate:.6f}", stats.hamming_bits]


def dotprod_grid(max_bits: int, max_symbols: int):
    """(bits per symbol, symbols): bits 1..max_bits with one symbol, then
    symbols 2..max_symbols with one bit."""
    return [(b, 1) for b in range(1, max_bits + 1)] + [(1, s) for s in range(2, max_symbols + 1)]


def dotprod_rows(bgv, max_bits: int, max_symbols: int, seed: int):
    """(row of the dotprod CSV, the campaign's dict) per grid point."""
    from ..faults.hardware import dotprod_fault_campaign
    for bits, syms in dotprod_grid(max_bits, max_symbols):
        res = dotprod_fault_campaign(bgv, bits, syms, seed=seed)
        yield [bits, syms, res["symbol_errors"], res["total_symbols"], res["bit_errors"],
               res["dot_hamming"]], res


def _prefix(device: str) -> str:
    return "h100_" if device.startswith("cuda") else f"{device}_"


def _write(args, name: str, header, rows, tag: str) -> str:
    Path(args.out).mkdir(parents=True, exist_ok=True)
    path = os.path.join(args.out, _prefix(args.device) + name)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for row in rows:
            w.writerow(row)
            print(f"[{tag}] {row}", flush=True)
    print("wrote", path)
    return path


def sweep_pbits(args) -> str:
    return _write(args, f"pbits_W{args.W}_N{args.N}_T{args.trials}.csv", PBITS_HEADER,
                  pbits_rows(args.trials, args.N, args.W, args.seed,
                             range(args.pbits_min, args.pbits_max + 1, args.pbits_step),
                             args.device), "pbits")


def sweep_relia_ntt(args) -> str:
    return _write(args, f"reliaNTT_N{args.N}_T{args.trials}.csv", RELIA_HEADER,
                  relia_ntt_rows(args.trials, args.N, args.fold, args.seed,
                                 range(args.qbits_min, args.qbits_max + 1, args.qbits_step),
                                 args.device), "relia_ntt")


def sweep_ntt_err(args) -> str:
    from .. import numth
    from ..ops.ntt import NttPlan
    n = 1 << args.log_dim
    plan = NttPlan.make(n, numth.find_ntt_primes(n, 30, args.batch), args.device)
    return _write(args, f"flipimpact_logN{args.log_dim}.csv", NTT_ERR_HEADER,
                  ntt_err_rows(plan, args.max_flips, args.max_symbols, args.seed), "ntt_err")


def sweep_dotprod(args) -> str:
    from ..fhe.bgv import BgvContext
    from ..fhe.params import BgvParams
    bgv = BgvContext(BgvParams.make(n=args.N, levels=2, q_bits=30, t_bits=16), seed=args.seed,
                     device=args.device)
    rows = (row for row, _ in dotprod_rows(bgv, args.max_bits, args.max_symbols, args.seed))
    return _write(args, f"dotprod_N{args.N}.csv", DOTPROD_HEADER, rows, "dotprod")


SWEEPS = {
    "pbits": sweep_pbits,
    "relia_ntt": sweep_relia_ntt,
    "ntt_err": sweep_ntt_err,
    "dotprod": sweep_dotprod,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="rfhe_tpu_torch campaign sweeps")
    ap.add_argument("name", choices=sorted(SWEEPS))
    ap.add_argument("--trials", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", type=str, default="results")
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--W", type=int, default=24)
    ap.add_argument("--fold", type=int, default=24)
    ap.add_argument("--pbits-min", type=int, default=2)
    ap.add_argument("--pbits-max", type=int, default=30)
    ap.add_argument("--pbits-step", type=int, default=2)
    ap.add_argument("--qbits-min", type=int, default=10)
    ap.add_argument("--qbits-max", type=int, default=30)
    ap.add_argument("--qbits-step", type=int, default=2)
    ap.add_argument("--log-dim", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-flips", type=int, default=8)
    ap.add_argument("--max-symbols", type=int, default=4)
    ap.add_argument("--max-bits", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    t0 = time.time()
    SWEEPS[args.name](args)
    print(f"[{args.name}] done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
