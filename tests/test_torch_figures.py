"""figures/draw.py against rfhe_tpu.figures.draw: every figure name drawn
from the same CSVs (the synthesized sweep of test_figures_from_csv, the
committed results/ files and the sweeps' committed stand-ins) writes the
reference's file names, and every plotted array, bar and label is equal."""
import csv
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from rfhe_tpu.figures import draw as ref_draw  # noqa: E402
from rfhe_tpu_torch.figures import draw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# figures whose default CSV the repo does not hold, drawn from one it does
DATA = {"barrett": "results/barrett_fold_MOF_T10000.csv",
        "ntt_reliability": "results/pbits_W24_N64_T2000.csv"}


def _relia_csv(path: Path) -> str:
    """The sweep test_figures_from_csv synthesizes."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["qbits", "kind", "det_rate", "miss_rate", "miss_stage1",
                    "miss_stage2", "miss_stage3", "intra_catch", "inter_catch", "batch_catch"])
        for qb in (10, 12, 14):
            for kind in ("SBF", "DBF", "MOF1"):
                w.writerow([qb, kind, 0.999, 0.001, 0.001, 0.0, 0.001, 5, 3, 2])
    return str(path)


def _arrays(fig) -> list:
    """What a figure plots: per axes its lines' data, its bars' rectangles,
    its texts, tick labels, scales and limits."""
    out = []
    for ax in fig.axes:
        out.append({
            "lines": [(np.asarray(ln.get_xdata(), dtype=object), np.asarray(ln.get_ydata(), dtype=float),
                       ln.get_color(), ln.get_linestyle(), ln.get_marker(), ln.get_label())
                      for ln in ax.get_lines()],
            "bars": [(p.get_x(), p.get_y(), p.get_width(), p.get_height(), p.get_facecolor())
                     for p in ax.patches],
            "texts": [(t.get_text(), t.get_position()) for t in ax.texts],
            "ticks": [t.get_text() for t in ax.get_xticklabels()],
            "scales": (ax.get_xscale(), ax.get_yscale()),
            "limits": (ax.get_xlim(), ax.get_ylim()),
            "labels": (ax.get_xlabel(), ax.get_ylabel()),
        })
    return out


def _draw(module, monkeypatch, argv) -> list:
    saved = []
    real = module.save

    def save(fig, out_dir, name):
        saved.append((name, _arrays(fig)))
        return real(fig, out_dir, name)

    monkeypatch.setattr(module, "save", save)
    module.main(argv)
    return saved


def _same(a, b) -> None:
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(ref_draw.FIGS))
def test_figure_equals_reference(name, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    assert sorted(draw.FIGS) == sorted(ref_draw.FIGS)
    data = _relia_csv(tmp_path / "reliaNTT.csv") if name == "relia_ntt" else DATA.get(name)
    args = [name] + (["--data", data] if data else [])
    ref = _draw(ref_draw, monkeypatch, args + ["--out", str(tmp_path / "ref")])
    port = _draw(draw, monkeypatch, args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert [n for n, _ in port] == [n for n, _ in ref]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())
    for (_, a), (_, b) in zip(port, ref):
        _same(a, b)
