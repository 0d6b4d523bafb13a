"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With `--trace 0` the result's metrics are the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, read from
a torch.profiler profile of the window, with `busy_s`, `window_s` and a
`breakdown`.  The numbers compared with the reference, each beside its
limit, are the last lines on standard error and the last key of the result.
Exits with 2 and prints no result where the card the cell asks for is
missing, and with 3 where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rfhe_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    parts = harness.cell(spec, args.workload)
    chips = parts[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run, per_sample, extra, limits = harness.run_cell(
        parts, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    correct, failed, checks = harness.judgement(per_sample, extra, limits)
    result = {"correct": correct, "attempted": len(run.ends), "failed": failed,
              "metrics": harness.metrics_of(spec, args.workload, run, bool(args.trace)),
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": chips, "memory_peak_bytes": run.peak_bytes}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.gaps}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    found = forbidden_modules()
    if found:
        print(f"loaded {found}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
