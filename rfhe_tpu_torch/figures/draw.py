"""Figure pipeline: a copy of `rfhe_tpu/figures/draw.py` over the same CSV
columns.  Every figure name and file name is the reference's; the motivation
figure computes its demos with the port's `models/motivation.py`, on the
card unless `--device cpu` is given.

Each figure reads by default the port's own H100 file, the reference's name
behind the `h100_` prefix the port's writers give (`DEFAULTS`; the README
names the command that writes each), never the reference's TPU CSVs, and
writes into `DEFAULT_OUT`, a directory git ignores, never over the
reference's committed `figures_out/`.  A title names the device its data
came from when the file's prefix says it (`h100_`, `cpu_`).

  rotation      eva_4/eva_5-class: rotation latency + cost breakdown vs polydim
                (profile_framewk/draw_rotation.py)
  barrett       eva_2-class: Barrett detection rate vs fold width per scheme
                (rfhe_framewk/src/draw_barrett.py)
  ntt_reliability  eva_8-class: 3-stage collision prob vs prime bits
                (profile_framewk/draw_ntt_reliability.py)
  relia_ntt     protected 4-step NTT miss rates vs q-bits
                (rfhe_framewk/src/ntt_test/draw_non_4step_ntt.py family)
  err_scatter   bit-error rate vs #flips/#symbols
                (reliability_test/draw_scripts/draw_err_scatter.py)
  evaluator     eva-class evaluator failure rate vs raw HW error rate
                (rfhe_framewk/src/draw_evaluator_reliability.py) — model curve
                P_fail = 1-(1-eps)^n_ops (baseline) vs that times the measured
                detector miss rate (protected)

Usage: python -m rfhe_tpu_torch.figures.draw <name> [--data results/...csv]
       [--overheads results/...csv] [--out DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import csv
import math
import os
from collections import defaultdict

import numpy as np

from .common import PALETTE, new_fig, save

# Each figure's default data: the file the port's own command writes on the
# card (bench/sweeps.py:prefix), as the README lists.
DEFAULTS = {
    "rotation": "results/h100_rotation_profile.csv",
    "barrett": "results/h100_barrett_fold_MOF_T1000.csv",
    "ntt_reliability": "results/h100_pbits_W24_N64_T1000.csv",
    "relia_ntt": "results/h100_reliaNTT_N64_T1000.csv",
    "err_scatter": "results/h100_flipimpact_logN12.csv",
    "evaluator": "results/h100_reliaNTT_scenarios_N64_q769_T1000.csv",
    "end_to_end": "results/h100_atom_overheads.csv",
    "dnum": "results/h100_dnum_N4096.csv",
    "pie": "results/h100_op_composition.csv",
    "poly_rot_mul": "results/h100_rotation_profile.csv",
}
DEFAULT_OVERHEADS = "results/h100_atom_overheads.csv"
DEFAULT_OUT = "build/figures_out/h100"
DEVICES = {"h100_": "H100", "cpu_": "CPU"}


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _data(args, name: str) -> str:
    return args.data or DEFAULTS[name]


def _optional(path: str, what: str, fallback: str):
    """The rows of `path`, or None when it is missing; either way the figure
    prints which data it drew."""
    if not os.path.exists(path):
        print(f"[{what}] {path} missing: drawn with {fallback}")
        return None
    print(f"[{what}] drawn from {path}")
    return _read(path)


def _title(text: str, path: str) -> str:
    """`text`, naming the device the data came from when the file's prefix
    says it: '(H100, measured)'."""
    dev = next((d for p, d in DEVICES.items() if os.path.basename(path).startswith(p)), None)
    return text.replace("(measured", f"({dev}, measured") if dev else text


def fig_rotation(args):
    path = _data(args, "rotation")
    rows = _read(path)
    ns = [int(r["n"]) for r in rows]
    total = [float(r["total_us"]) for r in rows]
    cats = ["NTT", "ModMul", "BaseConv", "Others"]
    fig, ax = new_fig()
    bottom = np.zeros(len(ns))
    for ci, c in enumerate(cats):
        frac = np.array([float(r[c]) for r in rows]) * np.array(total)
        ax.bar([str(n) for n in ns], frac, bottom=bottom, color=PALETTE[ci],
               label=c, width=0.6)
        bottom += frac
    ax.set_xlabel("polynomial degree N")
    ax.set_ylabel("rotation cost (µs)")
    ax.set_title(_title("CKKS rotation cost breakdown (measured)", path))
    ax.legend()
    print(save(fig, args.out, "rotation_breakdown.png"))
    fig, ax = new_fig()
    ax.plot([str(n) for n in ns], total, marker="o", color=PALETTE[0])
    ax.set_yscale("log")
    ax.set_xlabel("polynomial degree N")
    ax.set_ylabel("rotation latency (µs, log)")
    ax.set_title(_title("CKKS rotation latency vs polydim (measured)", path))
    print(save(fig, args.out, "rotation_latency.png"))


def fig_barrett(args):
    path = _data(args, "barrett")
    rows = _read(path)
    schemes = {"T-check": ("1", "0", "0"), "SN-check": ("0", "1", "0"),
               "Final-range": ("0", "0", "1")}
    fig, ax = new_fig()
    for ci, (name, key) in enumerate(schemes.items()):
        pts = [(int(r["fold_width"]), float(r["detection_rate"]))
               for r in rows
               if (r["use_t"], r["use_sn"], r["use_final"]) == key]
        pts.sort()
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o",
                    color=PALETTE[ci], label=name)
    ax.set_xlabel("fold width (bits)")
    ax.set_ylabel("detection rate  TP/(TP+FN)")
    ax.set_ylim(0, 1.05)
    ax.set_title(_title("Barrett detector schemes vs fold width (measured)", path))
    ax.legend()
    print(save(fig, args.out, "barrett_detection.png"))


def fig_ntt_reliability(args):
    path = _data(args, "ntt_reliability")
    rows = _read(path)
    by_type = defaultdict(list)
    for r in rows:
        worst = max(float(r["collision_prob"]), 1e-7)
        by_type[(r["ftype"], int(r["stage"]))].append((int(r["pbits"]), worst))
    fig, ax = new_fig()
    ci = 0
    for ftype in ("SCF-BF", "MCF-CLE"):
        for stage in (1, 2, 3):
            pts = sorted(by_type.get((ftype, stage), []))
            if pts:
                ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o",
                        color=PALETTE[ci % len(PALETTE)],
                        label=f"{ftype} stage{stage}")
                ci += 1
    ax.set_yscale("log")
    ax.set_xlabel("prime modulus bits")
    ax.set_ylabel("collision probability (log)")
    ax.set_title(_title("3-stage pipeline collision probability vs prime bits (measured)",
                        path))
    ax.legend(fontsize=8)
    print(save(fig, args.out, "ntt_reliability.png"))


def fig_relia_ntt(args):
    path = _data(args, "relia_ntt")
    rows = _read(path)
    fig, ax = new_fig()
    for ci, kind in enumerate(("SBF", "DBF", "MOF1")):
        pts = [(int(r["qbits"]), max(float(r["miss_rate"]), 1e-7))
               for r in rows if r["kind"] == kind]
        pts.sort()
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o",
                    color=PALETTE[ci], label=kind)
    ax.set_yscale("log")
    ax.set_xlabel("q bits")
    ax.set_ylabel("miss rate (log)")
    ax.set_title(_title("Protected four-step NTT miss rate vs modulus width (measured)", path))
    ax.legend()
    print(save(fig, args.out, "relia_ntt_miss.png"))


def fig_err_scatter(args):
    path = _data(args, "err_scatter")
    rows = _read(path)
    fig, ax = new_fig()
    one_sym = sorted((int(r["num_flips"]), float(r["bit_error_rate"]))
                     for r in rows if r["num_symbols"] == "1")
    ax.plot([p[0] for p in one_sym], [p[1] for p in one_sym], marker="o",
            color=PALETTE[0], label="1 symbol, k flips")
    one_flip = sorted((int(r["num_symbols"]), float(r["bit_error_rate"]))
                      for r in rows if r["num_flips"] == "1")
    ax.plot([p[0] for p in one_flip], [p[1] for p in one_flip], marker="s",
            color=PALETTE[1], label="k symbols, 1 flip")
    ax.set_xlabel("k")
    ax.set_ylabel("output bit-error rate")
    ax.set_title(_title("NTT error propagation (measured, injected faults)", path))
    ax.legend()
    print(save(fig, args.out, "err_scatter.png"))


def fig_evaluator(args):
    """Evaluator failure rate vs raw hardware error rate, one protected
    curve PER FAULT MODEL with the miss rate MEASURED by the repo's own
    campaigns (draw_evaluator_reliability.py:10-35 semantics): reads the
    scenario table (miss per fault kind, averaged over the three pipeline
    stages; `bench.sweeps scenarios` writes the default) instead of a
    scalar --miss-rate, which draws the curve when the table is missing."""
    n, L, dnum = 32768, 21, 21
    n_ops = n * L * dnum * 3          # keyswitch modmul count order (Rotation)
    path = _data(args, "evaluator")
    miss_by_kind = {}
    rows = _optional(path, "evaluator", f"--miss-rate {args.miss_rate:g}")
    if rows is not None:
        acc = {}
        for r in rows:
            if "+" in r["scenario"]:
                continue              # single-fault models only (reference)
            acc.setdefault(r["scenario"], []).append(float(r["miss_rate"]))
        miss_by_kind = {k: sum(v) / len(v) for k, v in acc.items()}
    if not miss_by_kind:
        miss_by_kind = {"model": args.miss_rate}
    eps = np.logspace(-14, -8, 40)
    fig, ax = new_fig()
    base = 1 - (1 - eps) ** n_ops
    ax.plot(eps, base, color="black", label="unprotected")
    for ci, (kind, miss) in enumerate(sorted(miss_by_kind.items())):
        ax.plot(eps, base * max(miss, 1e-12), color=PALETTE[ci % len(PALETTE)],
                linestyle="--", label=f"protected {kind} (miss={miss:.2e})")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("raw hardware error rate")
    ax.set_ylabel("evaluator failure rate")
    ax.set_title(_title("Evaluator failure vs HW error rate (measured miss rates)", path))
    ax.legend(fontsize=6)
    print(save(fig, args.out, "evaluator_reliability.png"))


# per-model op composition (share of NTT&INTT / BaseConv / ModMul / Others)
# — the reference's end-to-end workload mix (end_to_end/draw_end_to_end_cost.py
# data family); the overheads come from bench/overheads.py's CSV (measured)
WORKLOADS = {
    "Bootstrapping": {"NTTCost": 0.798, "BaseConvCost": 0.090,
                      "ModmulCost": 0.092, "Others": 0.020},
    "ResNet_ReLU":   {"NTTCost": 0.757, "BaseConvCost": 0.101,
                      "ModmulCost": 0.119, "Others": 0.023},
    "ResNet_SiLU":   {"NTTCost": 0.744, "BaseConvCost": 0.103,
                      "ModmulCost": 0.128, "Others": 0.025},
    "MLP":           {"NTTCost": 0.714, "BaseConvCost": 0.111,
                      "ModmulCost": 0.150, "Others": 0.025},
    "LoLa":          {"NTTCost": 0.731, "BaseConvCost": 0.108,
                      "ModmulCost": 0.134, "Others": 0.027},
    "LeNet":         {"NTTCost": 0.722, "BaseConvCost": 0.106,
                      "ModmulCost": 0.145, "Others": 0.027},
}


def fig_end_to_end(args):
    """Stacked baseline-vs-protected cost per end-to-end model with the
    measured per-atom overheads; total-overhead multiplier labeled on each
    protected bar (draw_end_to_end_cost.py analog)."""
    ovh = {"NTTCost": 1.02, "BaseConvCost": 1.001, "ModmulCost": 1.14,
           "Others": 2.0}
    path = _data(args, "end_to_end")
    for r in _optional(path, "end_to_end", "the reference's constant overheads") or []:
        ovh[r["atom"]] = float(r["overhead"])
    cats = ["NTTCost", "BaseConvCost", "ModmulCost", "Others"]
    labels = {"NTTCost": "NTT&INTT", "BaseConvCost": "BaseConv",
              "ModmulCost": "ModMul", "Others": "Others"}
    fig, ax = new_fig(8.0, 4.0)
    xpos = []
    xlab = []
    x = 0.0
    for model, comp in WORKLOADS.items():
        bottoms = [0.0, 0.0]
        total_prot = 0.0
        for ci, c in enumerate(cats):
            base_v = comp[c] * 100
            prot_v = base_v * ovh[c]
            total_prot += prot_v
            ax.bar([x], [base_v], bottom=[bottoms[0]], width=0.38,
                   color=PALETTE[ci], label=labels[c] if x == 0 else None)
            ax.bar([x + 0.42], [prot_v], bottom=[bottoms[1]], width=0.38,
                   color=PALETTE[ci], alpha=0.65)
            bottoms[0] += base_v
            bottoms[1] += prot_v
        ax.text(x + 0.42, bottoms[1] + 1.5, f"{total_prot / 100:.4f}x",
                ha="center", fontsize=7)
        xpos.append(x + 0.21)
        xlab.append(model)
        x += 1.2
    ax.set_xticks(xpos)
    ax.set_xticklabels(xlab, fontsize=8)
    ax.set_ylabel("relative cost (baseline = 100)")
    ax.set_title(_title("End-to-end cost: baseline vs protected (measured overheads)", path))
    ax.legend(fontsize=8)
    print(save(fig, args.out, "end_to_end_cost.png"))


def fig_dnum(args):
    """eva_6-class: rotation cost breakdown + latency vs dnum (number of
    keyswitch digit groups), from our measured sweep
    (profile_framewk/draw_dnum.py + draw_dnum_rot_mul.py analog).  Two
    stacked panels share the x axis — never a dual-axis chart."""
    path = _data(args, "dnum")
    rows = _read(path)
    dnums = [r["dnum"] for r in rows]
    total = np.array([float(r["total_us"]) for r in rows])
    cats = ["NTT", "ModMul", "BaseConv", "Others"]
    import matplotlib.pyplot as plt
    from .common import STYLE
    plt.rcParams.update(STYLE)
    fig, (ax, ax2) = plt.subplots(2, 1, figsize=(6.0, 5.2), sharex=True,
                                  height_ratios=[2, 1])
    bottom = np.zeros(len(dnums))
    for ci, c in enumerate(cats):
        frac = np.array([float(r[c]) for r in rows]) * 100
        ax.bar(dnums, frac, bottom=bottom, color=PALETTE[ci], label=c,
               width=0.6)
        bottom += frac
    ax.set_ylabel("share of rotation cost (%)")
    ax.set_title(_title("CKKS rotation breakdown vs dnum (measured)", path))
    ax.legend(fontsize=8, ncol=4)
    ax2.plot(dnums, total / 1e3, marker="o", color=PALETTE[0])
    ax2.set_xlabel("dnum (keyswitch digit groups)")
    ax2.set_ylabel("latency (ms)")
    print(save(fig, args.out, "dnum_breakdown.png"))


def fig_pie(args):
    """Op-composition figure (build/data/draw_pie_chart.py analog): what
    fraction of the encrypted dot product each evaluator op costs, and what
    the rotation spends internally.  Drawn as horizontal 100% composition
    bars (the pie form hides small shares; same data, better form)."""
    path = _data(args, "pie")
    rows = _read(path)
    groups = defaultdict(list)
    for r in rows:
        groups[r["group"]].append((r["part"], float(r["share"])))
    fig, ax = new_fig(7.0, 2.6)
    for gi, (gname, parts) in enumerate(groups.items()):
        parts = sorted(parts, key=lambda p: -p[1])
        left = 0.0
        for ci, (pname, share) in enumerate(parts):
            ax.barh([gname], [share * 100], left=[left],
                    color=PALETTE[ci % len(PALETTE)], height=0.55)
            if share > 0.04:
                ax.text(left + share * 50, gi, f"{pname}\n{share*100:.1f}%",
                        ha="center", va="center", fontsize=7)
            left += share * 100
    ax.set_xlabel("share of cost (%)")
    ax.set_xlim(0, 100)
    ax.set_title(_title("Op composition (measured)", path))
    print(save(fig, args.out, "op_composition.png"))


def fig_poly_rot_mul(args):
    """eva_5-class: mult+rotation cost breakdown vs polydim with the
    RFHE protection-overhead multiplier per dim
    (profile_framewk/draw_poly_rot_mul.py analog).  The protected bar uses
    the MEASURED per-atom overheads (--overheads, bench/overheads.py's CSV
    by default)."""
    path = _data(args, "poly_rot_mul")
    rows = _read(path)
    ovh = {"NTT": 1.02, "BaseConv": 1.001, "ModMul": 1.14, "Others": 2.0}
    amap = {"NTTCost": "NTT", "BaseConvCost": "BaseConv",
            "ModmulCost": "ModMul", "Others": "Others"}
    for r in _optional(args.overheads, "poly_rot_mul overheads",
                       "the reference's constant overheads") or []:
        ovh[amap.get(r["atom"], r["atom"])] = float(r["overhead"])
    cats = ["NTT", "ModMul", "BaseConv", "Others"]
    fig, ax = new_fig(7.5, 4.0)
    x = 0.0
    xpos, xlab = [], []
    for r in rows:
        total = float(r["total_us"]) / 1e3
        bottoms = [0.0, 0.0]
        prot_total = 0.0
        for ci, c in enumerate(cats):
            base_v = float(r[c]) * total
            prot_v = base_v * ovh[c]
            prot_total += prot_v
            ax.bar([x], [base_v], bottom=[bottoms[0]], width=0.38,
                   color=PALETTE[ci],
                   label=c if x == 0 else None)
            ax.bar([x + 0.42], [prot_v], bottom=[bottoms[1]], width=0.38,
                   color=PALETTE[ci], alpha=0.65)
            bottoms[0] += base_v
            bottoms[1] += prot_v
        ax.text(x + 0.42, bottoms[1] * 1.02, f"{prot_total/total:.3f}x",
                ha="center", fontsize=7)
        xpos.append(x + 0.21)
        xlab.append(r["n"])
        x += 1.2
    ax.set_xticks(xpos)
    ax.set_xticklabels(xlab)
    ax.set_xlabel("polynomial degree N")
    ax.set_ylabel("rotation+mult cost (ms)")
    ax.set_title(_title("Baseline vs RFHE-protected cost vs polydim (measured atoms)", path))
    ax.legend(fontsize=8)
    print(save(fig, args.out, "poly_rot_mul.png"))


def fig_motivation(args):
    """eva_0-class motivation figure (draw_dotprod.py:47-70 analog): one
    injected fault smears across (nearly) the whole output of every FHE
    primitive — computed live from models/motivation (deterministic)."""
    from ..models import motivation as M
    cases = [
        ("NTT\n1 flip", M.ntt_smear(n=256)["fraction"]),
        ("FFT encode\n1 perturb", M.fft_smear(n=256)["fraction"]),
        ("BSGS matmul\n1 flip", (lambda r: r["disturbed"] / r["dim"])(
            M.bsgs_block_smear())),
        ("BaseConv\n1 flip", (lambda r: r["elements_disturbed"] / 32)(
            M.baseconv_smear(n_el=32))),
        ("Plaintext mult\n1 perturb", (lambda r: r["disturbed"] /
                                       r["slots"])(M.plaintext_perturb(device=args.device))),
    ]
    fig, ax = new_fig()
    xs = np.arange(len(cases))
    ax.bar(xs, [c[1] for c in cases], color=PALETTE[0])
    for x, (_, v) in zip(xs, cases):
        ax.text(x, min(v + 0.02, 1.02), f"{100 * v:.0f}%", ha="center",
                fontsize=8)
    ax.set_xticks(xs)
    ax.set_xticklabels([c[0] for c in cases], fontsize=7)
    ax.set_ylim(0, 1.1)
    ax.set_ylabel("fraction of output slots disturbed")
    ax.set_title("One fault smears the whole ciphertext (motivation)")
    print(save(fig, args.out, "motivation_smear.png"))


FIGS = {
    "motivation": fig_motivation,
    "rotation": fig_rotation,
    "barrett": fig_barrett,
    "ntt_reliability": fig_ntt_reliability,
    "relia_ntt": fig_relia_ntt,
    "err_scatter": fig_err_scatter,
    "evaluator": fig_evaluator,
    "end_to_end": fig_end_to_end,
    "dnum": fig_dnum,
    "pie": fig_pie,
    "poly_rot_mul": fig_poly_rot_mul,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("name", choices=sorted(FIGS) + ["all"])
    ap.add_argument("--data", type=str, default=None)
    ap.add_argument("--overheads", type=str, default=DEFAULT_OVERHEADS,
                    help="poly_rot_mul's per-atom overheads (bench/overheads.py's CSV)")
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--miss-rate", type=float, default=2e-7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the motivation figure's plaintext product runs")
    args = ap.parse_args(argv)
    if args.name == "all":
        for name, fn in FIGS.items():
            try:
                fn(args)
            except FileNotFoundError as e:
                print(f"[skip {name}] missing data: {e}")
    else:
        FIGS[args.name](args)


if __name__ == "__main__":
    main()
