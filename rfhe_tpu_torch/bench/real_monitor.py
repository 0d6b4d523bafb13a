"""Long-running silent-fault monitor: the production NTT run twice on the
same input and diffed, run after run.

Counterpart of `rfhe_tpu/bench/real_monitor.py` (the reference's
run_real_test.sh stresses an overclocked GPU with clean NTTs run twice and
diffed).  Each run draws a batch of residues (seed + run), transforms it
twice with the port's NttPlan (the hand kernels on a GPU) and compares the
outputs; every `--dot-every` runs it also runs an encrypted BGV dot product
with no injection (n=1024, 2 levels, t of 16 bits, seed 11) and checks it
against the plaintext.  One log line per run; any nonzero Hamming distance is
a silent-fault capture and is logged as such, never hidden.

The log's header names the card as `device.card()` gives it (name and power
limit).  The default log is results/h100_real_monitor_log.txt; the TPU's
committed results/real_monitor_log.txt is never written.

Usage: python -m rfhe_tpu_torch.bench.real_monitor [--runs 1000] [--log-dim 12]
           [--batch 8] [--dot-every 100] [--seed 0]
           [--out results/h100_real_monitor_log.txt] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
import time


def run(runs: int = 1000, log_dim: int = 12, batch: int = 8, dot_every: int = 100,
        seed: int = 0, out: str = "results/h100_real_monitor_log.txt",
        device: str = "cuda", log=sys.stderr) -> dict:
    """Monitor for `runs` runs, writing the log to `out`.  Returns
    {"runs", "faults", "captures" (the log lines of nonzero runs), "seconds"}."""
    from .. import numth
    from ..faults.hardware import dotprod_fault_campaign, ntt_real_test
    from ..fhe.bgv import BgvContext
    from ..fhe.params import BgvParams
    from ..ops.ntt import NttPlan

    n = 1 << log_dim
    plan = NttPlan.make(n, numth.find_ntt_primes(n, 30, batch), device)
    bgv = BgvContext(BgvParams.make(n=1024, levels=2, q_bits=30, t_bits=16), seed=11,
                     device=device)
    if device == "cpu":
        where = "cpu"
    else:
        from ..device import card
        where = card()
    faults, captures = 0, []
    t_start = time.time()
    with open(out, "w") as f:
        f.write(f"# real-fault monitor: device={where} n={n} batch={batch} runs={runs} "
                f"started={time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        f.write("# run\tkind\thamming_bits\tsymbol_errors\telapsed_s\n")
        for r in range(runs):
            stats = ntt_real_test(plan, batch=batch, seed=seed + r)
            line = f"{r}\tntt\t{stats.hamming_bits}\t{stats.symbol_errors}\t{time.time() - t_start:.1f}"
            f.write(line + "\n")
            if stats.hamming_bits:
                faults += 1
                captures.append(line)
                f.write(f"# [FAULT DETECTED] run {r}: hamming={stats.hamming_bits}\n")
                print(f"[FAULT DETECTED] run {r}", file=log)
            if dot_every and r % dot_every == 0:
                res = dotprod_fault_campaign(bgv, 0, 0, seed=seed + r)
                line = (f"{r}\tdotprod\t{res['dot_hamming']}\t{res['symbol_errors']}\t"
                        f"{time.time() - t_start:.1f}")
                f.write(line + "\n")
                if not (res["symbol_errors"] == 0 and res["dot_hamming"] == 0):
                    faults += 1
                    captures.append(line)
            if r % 100 == 0:
                f.flush()
                if log is not None:
                    print(f"run {r}/{runs}: faults so far {faults}", file=log, flush=True)
        seconds = time.time() - t_start
        f.write(f"# finished: {runs} runs, {faults} silent faults, {seconds:.1f}s\n")
    return {"runs": runs, "faults": faults, "captures": captures, "seconds": seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1000)
    ap.add_argument("--log-dim", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dot-every", type=int, default=100,
                    help="also run a zero-injection encrypted dot product every K runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/h100_real_monitor_log.txt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.runs, args.log_dim, args.batch, args.dot_every, args.seed, args.out,
              args.device)
    print(f"wrote {args.out}: {res['runs']} runs, {res['faults']} silent faults")


if __name__ == "__main__":
    main()
