"""Rotation phase breakdown: where a CKKS rotation's device time goes.

Counterpart of `rfhe_tpu/bench/phase_profile.py`, with its columns.  The
reference times each keyswitch phase as a separate body by its slope method
(body^r1 and body^r2 inside one jit), with O(L·N) glue added to keep each
body shape-preserving, and takes the fused rotation's total from another
slope, retried until it is at least half the phase sum
(`rotation_total_checked`): the glue and the retry bias that total upward.
Neither carries over here, and neither is needed: the phases are the spans
of the main path (`trace/spans.py`), read over `reps` calls of
`trace.ProfiledRotation`, which runs `CkksContext.rotate` itself with
tracing on.  On the card a span's time is the card's own (each graph replay
adds the phases it ran, 'device-spans' mode); on the CPU (`--device cpu`) it
is the host's ('wall' mode).  `total_us` is the six phases' sum: the final
c0 + δ add lies in no phase.  Beside it on the card, `rotate_us` is the
kernel total of `reps` untraced calls of `CkksContext.rotate` (the graph's
input copies and output clones left out) from the most complete of up to
three `device.padded_profile` sessions, and `lost_records` the device
records that session lost.

Phases (reference kernel-line categories, profile_framewk sum_trace):
  PERMUTE   Galois slot gather
  INTT      c1 to coefficient domain
  BASECONV  digit extension to the (Q, P) basis
  NTT       forward transform of all digits
  MULTEVK   two dyadic MACs against the key + digit sums
  MODDOWN   divide-and-round by the special primes
  MD_*      the mod-down's spans (`spans.MODDOWN_PHASES`), summed over the
            special primes, under the reference's column names (`MD_COLUMNS`)
Shares (`_shares`, draw_rotation.py's categories): NTT = INTT + NTT + the
mod-down's two transforms, ModMul = MULTEVK + its subtract and scale,
BaseConv = BASECONV + its centred lift, Others = PERMUTE + what of MODDOWN
its spans do not cover.

Usage:
  python -m rfhe_tpu_torch.bench.phase_profile rotation --ns 2048,...,65536
      --limbs 21 [--device cuda] [--out results]
  python -m rfhe_tpu_torch.bench.phase_profile dnum --n 4096 --limbs 21
      --dnums 1,2,3,4,6,8,12,24
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np

from ..device import COPIES, _profile, require
from ..trace import spans
from ..trace.profiled import ProfiledRotation
from ..trace.spans import PHASES
from .ops_devtime import write_csv
from .sweeps import prefix

COLUMNS = ["n", "limbs", "dnum", "PERMUTE_us", "INTT_us", "BASECONV_us", "NTT_us", "MULTEVK_us",
           "MODDOWN_us", "MD_INTT_us", "MD_BASECONV_us", "MD_NTT_us", "MD_MODMUL_us", "total_us",
           "NTT", "ModMul", "BaseConv", "Others", "rotate_us", "lost_records", "mode"]
# the mod-down's spans (fhe/rns.py:drop_limb) -> the reference's column names
MD_COLUMNS = {"MD_INTT": "MD_INTT", "MD_LIFT": "MD_BASECONV", "MD_NTT": "MD_NTT",
              "MD_SCALE": "MD_MODMUL"}


def random_ciphertext(ckks, level: int, seed: int = 1):
    """Two NTT-domain components of uniform residues at `level` (the
    reference's `rotation_total` input)."""
    from ..fhe.ckks import Ciphertext
    rng = np.random.default_rng(seed)
    n = ckks.params.n
    comps = [np.stack([rng.integers(0, ckks.ctx.moduli[i], n, dtype=np.uint32)
                       for i in range(level + 1)]) for _ in range(2)]
    return Ciphertext.from_numpy(comps, 1.0, True, ckks.device)


def phase_times(ckks, level: Optional[int] = None, reps: int = 5) -> Dict[str, float]:
    """Microseconds per rotation by phase (PHASES, then the mod-down's spans
    under `MD_COLUMNS`' names) over `reps` warm rotations by 1 of a random
    ciphertext at `level` (default the top), on the clock the spans used;
    on the card also 'rotate', the kernel total of `reps` untraced calls of
    `CkksContext.rotate`, copies left out, and 'lost', the device records
    its profile lost."""
    level = ckks.L - 1 if level is None else level
    ct = random_ciphertext(ckks, level)
    prof_rot = ProfiledRotation(ckks)
    prof_rot.rotate(ct, 1)          # keys, cached tables, the kernels' build, the traced graph
    snap = spans.snapshot()
    for _ in range(reps):
        prof_rot.rotate(ct, 1)
    got = spans.since(snap)
    cuda = ckks.device.type == "cuda"
    clock = "device_ns" if cuda else "host_ns"
    out = {p: got[p][clock] / reps / 1e3 for p in PHASES}
    out.update({col: got[md][clock] / reps / 1e3 for md, col in MD_COLUMNS.items()})
    if cuda:
        out["rotate"], _, _, out["lost"] = _profile(lambda: ckks.rotate(ct, 1), reps,
                                                    leave_out=COPIES)
    return out


def _shares(ph: Dict[str, float]) -> Dict[str, float]:
    """Kernel-class shares (reference categories, draw_rotation.py:10-15): a
    copy of the reference's `_shares`.  The measured mod-down constituents
    (MD_*) count toward the NTT / BaseConv / ModMul classes, as the
    reference's sum_trace.py attributes SEAL's [NTT] / [BASECONV] tags inside
    mod_switch, and only the residual of MODDOWN stays in Others."""
    md = [ph.get(k, 0.0) for k in MD_COLUMNS.values()]
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
    """One CSV row: the phases, total_us (their sum), the shares, and beside
    them the kernel total of `CkksContext.rotate` profiled untraced (cuda
    only)."""
    ph = phase_times(ckks, reps=reps)
    rotate_us = ph.pop("rotate", "")
    lost = ph.pop("lost", "")
    sh = _shares({k: v * 1e-6 for k, v in ph.items()})
    return {"n": ckks.params.n, "limbs": ckks.L, "dnum": dnum,
            **{f"{k}_us": v for k, v in ph.items()}, "total_us": sum(ph[p] for p in PHASES),
            **{k: sh[k] for k in ("NTT", "ModMul", "BaseConv", "Others")},
            "rotate_us": rotate_us, "lost_records": lost,
            "mode": "device-spans" if ckks.device.type == "cuda" else "wall"}


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
