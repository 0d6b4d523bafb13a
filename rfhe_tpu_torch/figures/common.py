"""Shared figure style: a copy of `rfhe_tpu/figures/common.py`.

Follows the dataviz ground rules: categorical hues in fixed order from a
CVD-safe palette (Okabe-Ito), one axis per chart, thin marks, recessive
grids, legends for >= 2 series, sequential = single hue light->dark.
"""
from __future__ import annotations

import os
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

# Okabe-Ito (colorblind-safe), fixed assignment order
PALETTE = ["#0072B2", "#E69F00", "#009E73", "#CC79A7",
           "#56B4E9", "#D55E00", "#F0E442", "#000000"]

STYLE = {
    "axes.grid": True,
    "grid.color": "#DDDDDD",
    "grid.linewidth": 0.6,
    "axes.spines.top": False,
    "axes.spines.right": False,
    "lines.linewidth": 2.0,
    "lines.markersize": 6,
    "font.size": 10,
    "figure.dpi": 130,
}


def new_fig(w=6.0, h=3.6):
    plt.rcParams.update(STYLE)
    return plt.subplots(figsize=(w, h))


def save(fig, out_dir: str, name: str) -> str:
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
