"""Campaign sweep drivers: the reference's sweeps whose modules the port has.

Counterpart of `rfhe_tpu/bench/sweeps.py`, with its argument names and
defaults, plus `--device` (default cuda):

  pbits      the three-stage pipeline's collision probability against the
             prime's bit length, every fault type
  relia_ntt  the protected four-step NTT against q's bit length
  ntt_err    error propagation through the forward NTT (the hand kernels
             on a GPU) against flips and corrupted words
  dotprod    ciphertext flips through the encrypted BGV dot product
  rotation   the rotation's phase breakdown against the ring
             (bench/phase_profile.py), 2^logn_min ... 2^logn_max, levels+1
             ciphertext limbs
  dnum       the same against dnum at N (4096 when N <= 256)
  composition  the encrypted dot product's evaluator-op shares and the
             rotation's phase shares at N (4096 when N <= 256)

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

from ..device import require

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


def prefix(device) -> str:
    """Output files carry the device they ran on: h100_ on the card, cpu_ on the CPU."""
    return "h100_" if str(device).startswith("cuda") else f"{device}_"


def composition_rows(n: int, levels: int, seed: int, device):
    """Rows (group, part, share) of the measured op composition
    (build/data/draw_pie_chart.py analog, `rfhe_tpu.bench.sweeps.sweep_composition`):
    group 'dotprod' = the evaluator ops of the encrypted dot product
    (log2(slots) rotations and adds, one multiply+relin, one rescale), each
    at its device time; group 'rotate' = the rotation's phases
    (`phase_profile.phase_times`, MD_* left out: they decompose MODDOWN).
    The reference gets the rescale as (multiply+rescale) − multiply, its
    bodies being shape-preserving; eager PyTorch times the rescale of a
    product directly."""
    import numpy as np
    from ..device import op_us
    from ..fhe import CkksContext, CkksParams
    from ..trace.profiled import PHASES
    from .phase_profile import phase_times
    ckks = CkksContext(CkksParams.make(n=n, levels=levels + 2, q0_bits=30, scale_bits=26),
                       seed=seed, device=device)
    z = np.random.default_rng(0).uniform(-1, 1, n // 2) + 0j
    ct = ckks.encrypt(*ckks.encode(z))
    ckks.rlk, ckks.galois_key(ckks.rotation_galois_element(1))      # keys before any timing
    prod = ckks.multiply_relin(ct, ct)
    t = lambda fn: op_us(fn, device)[0]
    n_rot = (n // 2).bit_length() - 1
    costs = {"Rotate": n_rot * t(lambda: ckks.rotate(ct, 1)),
             "HMul+Relin": t(lambda: ckks.multiply_relin(ct, ct)),
             "Rescale": t(lambda: ckks.rescale(prod)),
             "Add": n_rot * t(lambda: ckks.add(ct, ct))}
    tot = sum(costs.values())
    ph = phase_times(ckks, ct.level)
    rtot = sum(ph[p] for p in PHASES)
    return ([["dotprod", k, f"{v / tot:.4f}"] for k, v in costs.items()]
            + [["rotate", p, f"{ph[p] / rtot:.4f}"] for p in PHASES])


def _write(args, name: str, header, rows, tag: str) -> str:
    Path(args.out).mkdir(parents=True, exist_ok=True)
    path = os.path.join(args.out, prefix(args.device) + name)
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


def _ring(args) -> int:
    return args.N if args.N > 256 else 4096


def _dict_rows(rows, cols):
    return ([r[c] for c in cols] for r in rows)


def sweep_rotation(args) -> str:
    """Rotation phase breakdown against the ring (draw_rotation.py analog)."""
    from . import phase_profile
    ns = [1 << g for g in range(args.logn_min, args.logn_max + 1)]
    rows = phase_profile.rotation_rows(ns, args.levels + 1, args.device)
    return _write(args, "rotation_profile.csv", phase_profile.COLUMNS,
                  _dict_rows(rows, phase_profile.COLUMNS), "rotation")


def sweep_dnum(args) -> str:
    """Rotation cost breakdown against dnum (draw_dnum.py analog): fewer
    digits, fewer NTTs but heavier base conversion and mod-down."""
    from . import phase_profile
    n = _ring(args)
    dnums = [int(v) for v in args.dnums.split(",")]
    rows = phase_profile.dnum_rows(n, args.levels + 1, dnums, args.device)
    return _write(args, f"dnum_N{n}.csv", phase_profile.COLUMNS,
                  _dict_rows(rows, phase_profile.COLUMNS), "dnum")


def sweep_composition(args) -> str:
    return _write(args, "op_composition.csv", ["group", "part", "share"],
                  composition_rows(_ring(args), args.levels, args.seed, args.device),
                  "composition")


SWEEPS = {
    "pbits": sweep_pbits,
    "relia_ntt": sweep_relia_ntt,
    "ntt_err": sweep_ntt_err,
    "dotprod": sweep_dotprod,
    "rotation": sweep_rotation,
    "dnum": sweep_dnum,
    "composition": sweep_composition,
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
    ap.add_argument("--logn-min", type=int, default=8)
    ap.add_argument("--logn-max", type=int, default=12)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--dnums", type=str, default="1,2,3,4,6,8,12,24")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    require(args.device)
    t0 = time.time()
    SWEEPS[args.name](args)
    print(f"[{args.name}] done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
