"""Read the numbers compared for a cell's control, and for sound runs, over
several seeds in one process: what each limit in `limits/<cell>.json` is set
between.  The benchmark's own runs never run this.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--seconds 2] [--sound]

The control is the configuration's `control`: the program with its messages
and weights at a lower scale (CKKS), or the reference in the program's place
in narrower words (BGV).  `--sound` also reads the program as configured.
Each reading is one JSON line: the seed, the mode, every number compared.
"""
import argparse
import json
import sys
import time

import torch

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    modes = (["sound"] if args.sound else []) + ["control"]
    for seed in args.seeds:
        for mode in modes:
            t0 = time.perf_counter()
            run, per_sample, extra, limits = harness.run_cell(
                harness.cell(spec, args.workload), seed, args.seconds, False, "cuda", t0,
                control=mode == "control")
            correct, failed, checks = harness.judgement(per_sample, extra, limits)
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "correct": correct, "circuits": len(run.ends),
                              "numbers": {k: v for k, (v, _) in checks.items()},
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
