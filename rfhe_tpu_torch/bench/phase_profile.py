"""Rotation phase breakdown: where a CKKS rotation's device time goes.

Counterpart of `rfhe_tpu/bench/phase_profile.py`, with its columns.  The
reference times each keyswitch phase as a separate body by its slope method
(body^r1 and body^r2 inside one jit), with O(L·N) glue added to keep each
body shape-preserving, and takes the fused rotation's total from another
slope, retried until it is at least half the phase sum
(`rotation_total_checked`): the glue and the retry bias that total upward.
Neither carries over to eager PyTorch, and neither is needed here: the
phases are read from ONE torch.profiler profile of the real
`trace.ProfiledRotation` (whose arrays equal `CkksContext.rotate`'s), each
phase being the sum of the durations of the kernels launched inside its
`record_function` range.  The span of a range on the card is not used: it
includes the idle gaps between launches.  So the phases sum exactly to the
rotation's own kernel total, `total_us`, with no glue and no retry; beside
it, `rotate_us` is the kernel total of `CkksContext.rotate` profiled
in the same session, and `lost_records` the device records that session
lost (a long process has lost a few; the most complete of three sessions
counts).  On the CPU (`--device cpu`) the phases are the ranges' host times
('wall' mode), and total_us is the ROTATE range's.  On the card each phase
is a graph replay (`trace/profiled.py`): its kernels are placed at the graph
launch inside its range.  The copies into a graph's static inputs and out of
its outputs (`Memcpy` records, `GLUE`) are the cost of splitting the
rotation into graphs, not work of a phase: they count in no phase and not in
`rotate_us` (whose one graph has its own four).

Phases (reference kernel-line categories, profile_framewk sum_trace):
  PERMUTE   Galois slot gather
  INTT      c1 to coefficient domain
  BASECONV  digit extension to the (Q, P) basis
  NTT       forward transform of all digits
  MULTEVK   two dyadic MACs against the key + digit sums
  MODDOWN   divide-and-round by the special primes (and c0 + the c0 delta)
  MD_*      the mod-down's constituents, summed over the special primes:
            MD_INTT the special limb's inverse NTT, MD_BASECONV its centred
            lift, MD_NTT the delta's forward NTT, MD_MODMUL subtract and scale
Shares (`_shares`, draw_rotation.py's categories): NTT = INTT + NTT + MD_INTT
+ MD_NTT, ModMul = MULTEVK + MD_MODMUL, BaseConv = BASECONV + MD_BASECONV,
Others = PERMUTE + what of MODDOWN its constituents do not cover.

Usage:
  python -m rfhe_tpu_torch.bench.phase_profile rotation --ns 2048,...,65536
      --limbs 21 [--device cuda] [--out results]
  python -m rfhe_tpu_torch.bench.phase_profile dnum --n 4096 --limbs 21
      --dnums 1,2,3,4,6,8,12,24
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import device_records, padded_profile, require
from ..trace.profiled import MODDOWN_PARTS, PHASES, ProfiledRotation
from ..trace.spans import named_range
from .ops_devtime import write_csv
from .sweeps import prefix

COLUMNS = ["n", "limbs", "dnum", "PERMUTE_us", "INTT_us", "BASECONV_us", "NTT_us", "MULTEVK_us",
           "MODDOWN_us", "MD_INTT_us", "MD_BASECONV_us", "MD_NTT_us", "MD_MODMUL_us", "total_us",
           "NTT", "ModMul", "BaseConv", "Others", "rotate_us", "lost_records", "mode"]
TAGS = ("ROTATE",) + PHASES + MODDOWN_PARTS
GLUE = "Memcpy"               # a graph's input copies and output clones
ALONE = "CTX_ROTATE"          # the range of CkksContext.rotate profiled beside


def random_ciphertext(ckks, level: int, seed: int = 1):
    """Two NTT-domain components of uniform residues at `level` (the
    reference's `rotation_total` input)."""
    from ..fhe.ckks import Ciphertext
    rng = np.random.default_rng(seed)
    n = ckks.params.n
    comps = [np.stack([rng.integers(0, ckks.ctx.moduli[i], n, dtype=np.uint32)
                       for i in range(level + 1)]) for _ in range(2)]
    return Ciphertext.from_numpy(comps, 1.0, True, ckks.device)


def attribute(events, reps: int) -> Dict[str, float]:
    """Per tag, microseconds per rotation.  A CUDA profile: each device event
    (kernel, copy, fill) is placed at the host time of its launch (the
    runtime call that shares its correlation id) and counts toward every
    range of the tags that holds that time; it must lie in exactly one phase
    of a rotation.  A CPU profile: the ranges' own host time."""
    ranges = {t: [] for t in TAGS}
    launched_at = {}
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CPU:
            if ev.name in ranges:
                ranges[ev.name].append((ev.time_range.start, ev.time_range.end))
            elif ev.name.startswith("cu"):
                launched_at[ev.id] = ev.time_range.start
    if len(ranges["ROTATE"]) != reps:
        raise RuntimeError(f"{len(ranges['ROTATE'])} ROTATE ranges in a profile of {reps} rotations")
    if not any(ev.device_type == torch.autograd.DeviceType.CUDA for ev in events):
        return {t: sum(e - s for s, e in spans) / reps for t, spans in ranges.items()}
    out = dict.fromkeys(TAGS, 0.0)
    for ev in device_records(events, skip=TAGS + (ALONE,))[0]:
        if ev.name.startswith(GLUE):
            continue
        at = launched_at.get(ev.id, ev.time_range.start)
        inside = [t for t, spans in ranges.items() if any(s <= at <= e for s, e in spans)]
        if "ROTATE" not in inside or sum(t in PHASES for t in inside) != 1:
            raise RuntimeError(f"{ev.name} at {at} us lies in ranges {inside}: not exactly one "
                               f"phase of a rotation")
        for t in inside:
            out[t] += ev.time_range.end - ev.time_range.start
    return {t: v / reps for t, v in out.items()}


def phase_times(ckks, level: Optional[int] = None, reps: int = 5) -> Dict[str, float]:
    """Microseconds per rotation by phase (PHASES, MODDOWN_PARTS) and the
    rotation's total ('ROTATE'), from one profile of `reps` warm rotations
    by 1 of a random ciphertext at `level` (default the top), and on the
    card 'rotate': the kernel total of `reps` calls of `CkksContext.rotate`
    profiled in the same session, and 'lost': the device records the session
    lost (`device.padded_profile`).  A session that lost some is taken
    again, three times at most, and the most complete one counts."""
    level = ckks.L - 1 if level is None else level
    ct = random_ciphertext(ckks, level)
    prof_rot = ProfiledRotation(ckks)
    prof_rot.rotate(ct, 1)                       # keys, cached tables, the kernels' build
    if ckks.device.type != "cuda":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(reps):
                prof_rot.rotate(ct, 1)
        return attribute(prof.events(), reps)
    ckks.rotate(ct, 1)
    best = None
    for attempt in range(3):
        time.sleep(0.1 * attempt)
        with padded_profile() as prof:
            for _ in range(reps):
                prof_rot.rotate(ct, 1)
            with named_range(ALONE):
                for _ in range(reps):
                    ckks.rotate(ct, 1)
                torch.cuda.synchronize()
        events = prof.events()
        device, _, lost = device_records(events, skip=TAGS + (ALONE,))
        if best is None or lost < best[0]:
            best = (lost, events, device)
        if lost == 0:
            break
    lost, events, device = best
    span = next(ev.time_range for ev in events
                if ev.name == ALONE and ev.device_type == torch.autograd.DeviceType.CPU)
    launched = {ev.id for ev in events if ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith("cu") and span.start <= ev.time_range.start <= span.end}
    out = attribute([ev for ev in events if ev.id not in launched
                     or ev.device_type == torch.autograd.DeviceType.CPU], reps)
    out["rotate"] = sum(ev.time_range.end - ev.time_range.start for ev in device
                        if ev.id in launched and not ev.name.startswith(GLUE)) / reps
    out["lost"] = lost
    return out


def _shares(ph: Dict[str, float]) -> Dict[str, float]:
    """Kernel-class shares (reference categories, draw_rotation.py:10-15): a
    copy of the reference's `_shares`.  The measured mod-down constituents
    (MD_*) count toward the NTT / BaseConv / ModMul classes, as the
    reference's sum_trace.py attributes SEAL's [NTT] / [BASECONV] tags inside
    mod_switch, and only the residual of MODDOWN stays in Others."""
    md = [ph.get(k, 0.0) for k in ("MD_INTT", "MD_BASECONV", "MD_NTT", "MD_MODMUL")]
    md_scale = min(1.0, ph["MODDOWN"] / sum(md)) if sum(md) > 0 else 0.0
    mdi, mdb, mdn, mdm = (v * md_scale for v in md)
    ntt = ph["NTT"] + ph["INTT"] + mdi + mdn
    modmul = ph["MULTEVK"] + mdm
    baseconv = ph["BASECONV"] + mdb
    others = ph["PERMUTE"] + max(ph["MODDOWN"] - (mdi + mdb + mdn + mdm), 0.0)
    s = ntt + modmul + baseconv + others
    return {"NTT": ntt / s, "ModMul": modmul / s, "BaseConv": baseconv / s,
            "Others": others / s, "sum_us": s * 1e6}


def rotation_row(ckks, dnum="", reps: int = 5) -> dict:
    """One CSV row: the phases, total_us, the shares, and beside them the
    kernel total of `CkksContext.rotate` profiled separately (cuda only)."""
    ph = phase_times(ckks, reps=reps)
    total = ph.pop("ROTATE")
    rotate_us = ph.pop("rotate", "")
    lost = ph.pop("lost", "")
    phase_sum = sum(ph[t] for t in PHASES)
    cuda = ckks.device.type == "cuda"
    if cuda and not math.isclose(phase_sum, total, rel_tol=1e-9):
        raise RuntimeError(f"phases sum to {phase_sum} us, the rotation's kernels to {total} us")
    sh = _shares({k: v * 1e-6 for k, v in ph.items()})
    return {"n": ckks.params.n, "limbs": ckks.L, "dnum": dnum,
            **{f"{k}_us": v for k, v in ph.items()}, "total_us": total,
            **{k: sh[k] for k in ("NTT", "ModMul", "BaseConv", "Others")},
            "rotate_us": rotate_us, "lost_records": lost,
            "mode": "device-profiler" if cuda else "wall"}


def rotation_rows(ns, limbs: int, device, reps: int = 5):
    """Rows at each ring n with `limbs` ciphertext primes (the reference
    profiles 21 limbs at every polydim, draw_rotation.py:10-20)."""
    from ..fhe import CkksContext, CkksParams
    for n in ns:
        ckks = CkksContext(CkksParams.make(n=n, levels=limbs - 1), device=device)
        yield rotation_row(ckks, "", reps)


def dnum_rows(n: int, limbs: int, dnums, device, reps: int = 5):
    from ..fhe import CkksContext, CkksParams
    for dnum in dnums:
        ckks = CkksContext(CkksParams.make(n=n, levels=limbs - 1), dnum=dnum, device=device)
        yield rotation_row(ckks, dnum, reps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=["rotation", "dnum"])
    ap.add_argument("--ns", default="2048,4096,8192,16384,32768,65536")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--limbs", type=int, default=21)
    ap.add_argument("--dnums", default="1,2,3,4,6,8,12,24")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    dev = require(args.device)
    if args.cmd == "rotation":
        rows = rotation_rows([int(v) for v in args.ns.split(",")], args.limbs, dev, args.reps)
        name = "rotation_profile.csv"
    else:
        rows = dnum_rows(args.n, args.limbs, [int(v) for v in args.dnums.split(",")], dev,
                         args.reps)
        name = f"dnum_N{args.n}.csv"
    write_csv(os.path.join(args.out, prefix(args.device) + name), COLUMNS, list(rows))


if __name__ == "__main__":
    main()
