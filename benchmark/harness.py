"""One run of one cell: set-up, the measured window, the check.

Everything a cell is made of is found by name from `BENCHMARK.json`: the
configuration's file, `traffic/<mix>.json` (read by `circuits.py`, the one
generator), `limits/<cell>.json` (the limit of each number compared),
`metrics/<metric>.py` (one reader per metric, `read(run)`, which returns
None where it finds nothing to read) and, for a circuit kind that
`circuits.py` does not hold, `kinds/<kind>.py` (which registers it with
`@circuits.kind`).  A later cell, mix, metric or circuit kind is new files
and new entries; nothing here names one.  The configuration's scheme is
CKKS, BGV or BFV (`program.build`, `reference.scheme`).

The window is a closed loop with one client: circuit i is enqueued on input
set i mod pool, the client synchronises (and, in a protected circuit, reads
its flags), then starts circuit i + 1, until `seconds` have passed.  After
the window, outputs sampled from the seed are decrypted by the reference
and judged; the program's state is freed first.

A traced run also turns the program's spans on (`program.spans()`) before
the program is built, so that the warm-up captures its graphs with the
spans' marks, and reads the spans and counters over the window.  An
untraced run never turns them on.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from . import circuits, program, trace as tracing
from .reference import scheme

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# A traced run's window.  Stopping the profiler and reading its records took
# 1.5 to 9 s per traced second on an H100 host (the BGV dot product's 20 s
# window, 270 s), and a traced run has to end within 360 s.
TRACE_SECONDS = 5.0


@dataclass
class Run:
    """What the end-to-end readers read; `trace`, `spans` (the program's
    `spans.since`, by span name) and `counters` (`spans.COUNTS.since`) are
    the traced run's, over the window."""
    setup_s: float
    starts: List[float]
    ends: List[float]
    window_s: float
    peak_bytes: int
    trace: Optional[tracing.Trace] = None
    spans: Optional[dict] = None
    counters: Optional[dict] = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, name: str, root: Path = ROOT) -> tuple:
    """(workload entry, configuration, traffic mix, limits) of cell `name`,
    from the checkout at `root`."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = load_json(root / cfg_entry["file"])
    mix = load_json(root / HERE.name / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / HERE.name / "limits" / f"{name}.json")
    return w, cfg, mix, limits


def reader(name: str, root: Path = ROOT):
    """The `read` function of `metrics/<name>.py` in the checkout at `root`."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, name: str, run: Run, traced: bool) -> dict:
    """The cell's metrics that a reader found: end-to-end untraced, per-layer traced."""
    out = {}
    for m in spec["per_layer" if traced else "end_to_end"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _keep(ct, into=None) -> SimpleNamespace:
    """The residues of an output ciphertext, copied into buffers of the
    benchmark's own: new ones for the first samples, `into`'s in place for a
    later one.  The program's output is then dropped in every circuit alike,
    so which circuits the seed samples does not change what the program
    allocates, nor its peak."""
    if into is None:
        return SimpleNamespace(c=[SimpleNamespace(data=p.data.clone()) for p in ct.c])
    for dst, src in zip(into.c, ct.c):
        dst.data.copy_(src.data)
    return into


def run_cell(parts: tuple, seed: int, seconds: float, traced: bool, device,
             t_start: float, control: bool = False, root: Path = ROOT) -> tuple:
    """(Run, per-sample numbers, the protected cell's counts, limits) of one
    run of the cell `parts` (`cell(...)` of the checkout at `root`); see the
    module's note."""
    w, cfg, mix, limits = parts
    marks = [("start", t_start), ("imports", time.perf_counter())]
    dev = torch.device(device)
    dep = cfg["deployment"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    basis = scheme.Basis.make(dep, dev)
    keys = scheme.Keys(basis, gen, dep["sigma"])
    circ = circuits.make(mix, dep, cfg["control"] if control else None, keys, gen, dev, root)
    recorder = program.spans() if traced else None
    if recorder is not None:
        recorder.enable(dev)
    _sync(dev)
    marks.append(("device and secret key", time.perf_counter()))
    ctx = program.build(dep, keys, circ.galois(), circ.relin, seed, dev)
    _sync(dev)
    marks.append(("context and keys", time.perf_counter()))
    circ.setup(ctx)
    _sync(dev)
    marks.append(("inputs", time.perf_counter()))
    if dev.type == "cuda":
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(2):                        # the first captures every signature
        _, ok = circ.run(i)
        _sync(dev)
        if ok is not None:
            bool(ok)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", t_start + setup_s))
    print("[setup] " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                                  in zip(marks, marks[1:])), file=sys.stderr)
    warm_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    rng = random.Random(seed)
    samples, starts, ends, spans, flagged = [], [], [], [], 0
    profiler, snap = contextlib.nullcontext(), None
    if traced:
        from rfhe_tpu_torch.ops.ntt_cuda import KERNELS
        snap = KERNELS.snapshot()
        if recorder is not None:
            span_snap, count_snap = recorder.snapshot(), recorder.COUNTS.snapshot()
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        seconds = min(seconds, TRACE_SECONDS)
    with profiler as prof:
        w0, w0_ns = time.perf_counter(), time.time_ns()
        i = 0
        while True:
            t0, n0 = time.perf_counter(), time.time_ns()
            if recorder is not None:
                recorder.request(i)
            out, ok = circ.run(i)
            n1 = time.time_ns()
            _sync(dev)
            flagged += ok is not None and not bool(ok)
            t1, n2 = time.perf_counter(), time.time_ns()
            starts.append(t0)
            ends.append(t1)
            spans.append((n0, n1, n2))
            if len(samples) < mix["sample"]:
                samples.append((i, _keep(out)))
            else:
                j = rng.randrange(i + 1)
                if j < mix["sample"]:
                    samples[j] = (i, _keep(out, samples[j][1]))
            del out, ok
            i += 1
            if t1 - w0 >= seconds:
                break
        w1_ns = time.time_ns()
        stop = time.perf_counter()
    run = Run(setup_s=setup_s, starts=starts, ends=ends, window_s=ends[-1] - w0,
              peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    if dev.type == "cuda":
        print(f"[mem] held {held}, peak after the warm-up {warm_peak}, after the window "
              f"{run.peak_bytes}, reserved {torch.cuda.max_memory_reserved(dev)}", file=sys.stderr)
    if traced:
        host_spans = []
        if recorder is not None:
            run.spans, run.counters = recorder.since(span_snap), recorder.COUNTS.since(count_snap)
            host_spans = recorder.records(span_snap)
            recorder.request(None)
            recorder.disable()
        t_read = time.perf_counter()
        recs = tracing.records(prof)
        t_col = time.perf_counter()
        run.trace = tracing.collect(recs, (w0_ns, w1_ns), spans, KERNELS.since(snap)["by_shape"],
                                    host_spans)
        print(f"[trace] stop {t_read - stop:.1f} s, records {len(recs)} in {t_col - t_read:.1f} s, "
              f"collect {time.perf_counter() - t_col:.1f} s, span marks set apart "
              f"{run.trace.marks}", file=sys.stderr)
        del prof, recs, host_spans

    extra = {}
    if mix.get("protected"):
        missed = 0
        for stage in circ.FAULT_STAGES:
            fault = program.fault(stage, rng.randrange(basis.L - 1), rng.randrange(basis.n),
                                  rng.randrange(basis.ct[-1].bit_length() - 1))
            _, ok = circ.run(0, fault)
            missed += bool(ok)
        extra = {"flagged_clean": flagged, "faults_missed": missed}
    circ.release()
    del ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    per_sample = [circ.judge(i, ct) for i, ct in samples]
    return run, per_sample, extra, limits


def judgement(per_sample: List[dict], extra: dict, limits: dict) -> tuple:
    """(correct, failed, {number: (value, limit)}): each number at its worst
    over the samples, held against its limit; failed counts the samples
    over a limit and the clean circuits whose flags reported a fault."""
    worst: Dict[str, float] = {}
    failed = extra.get("flagged_clean", 0)
    for nums in per_sample:
        failed += any(v > limits[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    worst.update(extra)
    missing = set(limits) - set(worst)
    if missing:
        raise RuntimeError(f"no reading of {sorted(missing)}")
    checks = {k: (worst[k], limits[k]) for k in limits}
    return all(v <= lim for v, lim in checks.values()), failed, checks
