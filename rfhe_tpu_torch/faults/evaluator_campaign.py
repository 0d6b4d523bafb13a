"""Ciphertext-flip campaign against the protected evaluator.

Counterpart of `rfhe_tpu/faults/evaluator_campaign.py`.  For each keyswitch
stage, single-bit flips at random (limb, coefficient, bit) go into that
intermediate of a protected rotation or multiply_relin (`fhe/protected.py`),
and each trial records whether (a) the output ciphertext changed, (b) a
detector fired and (c) which ones.  The same seed draws the same triples as
the reference (numpy), so the rows are the reference's.

The campaign checks itself (`check_row`): a clean op raises no flag; at every
covered stage each flip that changes the output is detected; ks_out, a flip
into the final output after the last check, is never detected; at least 99%
of the injections change the output (fewer means injections are lost).

The trials of a stage run one after another on the host; on a card each
trial replays the stage's one cached program (`ProtectedCkks._jit`), its
(limb, idx, bit) read from the triples drawn once onto the device.  The
reference runs the trials as one vmapped program.

Usage: python -m rfhe_tpu_torch.faults.evaluator_campaign [--n 1024]
           [--levels 3] [--trials 4096] [--seed 0]
           [--ops rotate,multiply_relin] [--csv PATH] [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import sys
import time
from typing import Dict

STAGES = ("intt_out", "digits", "digits_ntt", "prod0", "acc0", "ks_out")
COMPUTE_STAGES = ("intt_out", "digits", "digits_ntt", "prod0", "acc0")
COLUMNS = ("op", "stage", "trials", "changed", "detected", "missed", "detect_rate",
           "miss_rate", "top_detector", "detectors")


def _clean_and_runner(prot, ct, op: str, r: int):
    """(clean output, its flags, fn(fault) -> (out, flags)) for the op."""
    if op == "rotate":
        clean, flags = prot.rotate(ct, r)
        return clean, flags, lambda fault: prot.rotate(ct, r, fault)
    if op == "multiply_relin":
        clean, flags = prot.multiply_relin(ct, ct)
        return clean, flags, lambda fault: prot.multiply_relin(ct, ct, fault)
    raise ValueError(op)


def triples(level: int, n: int, trials: int, seed: int):
    """The (limb, idx, bit) draws of a stage, the reference's
    (`evaluator_campaign.py:75-78`)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.integers(0, level + 1, trials), rng.integers(0, n, trials),
            rng.integers(0, 30, trials))


def stage_campaign(prot, ct, r: int, stage: str, trials: int, seed: int = 0,
                   op: str = "rotate") -> Dict:
    import torch
    from ..fhe.protected import Fault, all_ok

    clean, clean_flags, runner = _clean_and_runner(prot, ct, op, r)
    # a detector that fires on the fault-free op invalidates the campaign
    assert bool(all_ok(clean_flags)), (
        f"clean {op} raises detector flags: "
        f"{[k for k, v in clean_flags.items() if not bool(torch.all(v))]}")
    dev = prot.ckks.ctx.device
    li, ix, bi = (torch.from_numpy(v).to(dev)
                  for v in triples(ct.level, prot.ckks.params.n, trials, seed))
    changed, detected, fired = [], [], {}
    for j in range(trials):
        out, flags = runner(Fault(stage, li[j], ix[j], bi[j]))
        changed.append(torch.any(out.c[0].data != clean.c[0].data)
                       | torch.any(out.c[1].data != clean.c[1].data))
        f = {k: ~torch.all(v) for k, v in flags.items()}
        for k, v in f.items():
            fired.setdefault(k, []).append(v)
        detected.append(torch.stack(list(f.values())).any())
    changed = torch.stack(changed).cpu()
    detected = torch.stack(detected).cpu()
    n_changed = int(changed.sum())
    n_det = int(detected.sum())
    n_miss = int((changed & ~detected).sum())
    by_detector = {k: int(torch.stack(v).sum()) for k, v in fired.items()}
    by_detector = {k: v for k, v in by_detector.items() if v}
    top = max(by_detector, key=by_detector.get) if by_detector else ""
    return {
        "op": op, "stage": stage, "trials": trials, "changed": n_changed,
        "detected": n_det, "missed": n_miss,
        "detect_rate": round(n_det / trials, 6),
        "miss_rate": round(n_miss / max(1, n_changed), 6),
        "top_detector": top,
        "detectors": "+".join(sorted(by_detector)),
    }


def check_row(row: Dict) -> None:
    """The campaign's honesty asserts (see the module's note)."""
    stage = row["stage"]
    # every stage flips live data, so essentially every injection must change
    # the output (collision odds ~1/q); fewer means injections are lost
    assert row["changed"] >= 0.99 * row["trials"], (
        f"only {row['changed']}/{row['trials']} injections changed the output at "
        f"{row['op']}/{stage}: injections are being dropped")
    if stage in COMPUTE_STAGES:
        assert row["missed"] == 0, (
            f"covered stage {stage} missed {row['missed']} changing flips ({row['op']}): "
            "a detector is broken")
        assert row["detected"] >= row["changed"], row
    elif stage == "ks_out":
        assert row["detected"] == 0, (
            f"ks_out flips happen after the last check, yet {row['detected']} detections "
            f"fired ({row['op']}): a detector is stuck firing")


def run(n: int = 1024, levels: int = 3, trials: int = 4096, seed: int = 0,
        ops=("rotate", "multiply_relin"), do_check: bool = True, device: str = "cuda",
        q0_bits=None, scale_bits: int = 28, log=sys.stderr):
    """The reference's campaign (`evaluator_campaign.run`): CKKS at ring n
    with `levels` levels (the reference's chain unless q0_bits/scale_bits say
    otherwise), seed 3, a ciphertext of numpy seed 7, every stage of each op.
    Returns the rows; each is printed to `log` with its wall time."""
    import numpy as np
    from ..fhe.ckks import CkksContext
    from ..fhe.params import CkksParams
    from ..fhe.protected import ProtectedCkks

    params = CkksParams.make(n=n, levels=levels, q0_bits=q0_bits, scale_bits=scale_bits)
    ckks = CkksContext(params, seed=3, device=device)
    prot = ProtectedCkks(ckks)
    z = np.random.default_rng(7).normal(size=n // 2)
    ct = ckks.encrypt(*ckks.encode(z))
    rows = []
    for op in ops:
        for stage in STAGES:
            t0 = time.perf_counter()
            row = stage_campaign(prot, ct, 1, stage, trials, seed, op)
            secs = time.perf_counter() - t0
            if do_check:
                check_row(row)
            rows.append(row)
            if log is not None:
                print(f"{row} ({secs:.2f} s, {secs / trials * 1e3:.3f} ms per trial)",
                      file=log, flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--trials", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ops", default="rotate,multiply_relin")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the built-in honesty asserts (debug only)")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows = run(args.n, args.levels, args.trials, args.seed, tuple(args.ops.split(",")),
               not args.no_check, args.device)
    print(f"campaign: {len(rows)} stages x {args.trials} trials in "
          f"{time.perf_counter() - t0:.1f} s on {args.device}", file=sys.stderr)

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
