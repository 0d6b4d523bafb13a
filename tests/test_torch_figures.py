"""figures/draw.py against rfhe_tpu.figures.draw: every figure name drawn
from the same CSVs (the synthesized sweep of test_figures_from_csv, the
committed results/ files and the sweeps' committed stand-ins), passed to
both packages explicitly, writes the reference's file names, and every
plotted array, bar and label is equal.  The port's defaults are its own
H100 files and an output directory git ignores."""
import csv
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from rfhe_tpu.figures import draw as ref_draw  # noqa: E402
from rfhe_tpu_torch.figures import draw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the committed reference CSV each figure draws from in the comparison (the
# port's defaults are its own h100_ files, the reference's its TPU ones)
DATA = {"rotation": "results/rotation_profile.csv",
        "barrett": "results/barrett_fold_MOF_T10000.csv",
        "ntt_reliability": "results/pbits_W24_N64_T2000.csv",
        "err_scatter": "results/flipimpact_logN12.csv",
        "evaluator": "results/reliaNTT_scenarios_N64_q769_T1000000.csv",
        "end_to_end": "results/atom_overheads.csv",
        "dnum": "results/dnum_N4096.csv",
        "pie": "results/op_composition.csv",
        "poly_rot_mul": "results/rotation_profile.csv"}
# the overheads the reference's poly_rot_mul reads from the working directory
OVERHEADS = "results/atom_overheads.csv"


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
    port = _draw(draw, monkeypatch, args + ["--out", str(tmp_path / "port"), "--device", "cpu",
                                            "--overheads", OVERHEADS])
    assert [n for n, _ in port] == [n for n, _ in ref]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())
    for (_, a), (_, b) in zip(port, ref):
        _same(a, b)


def test_defaults_are_the_ports_own(tmp_path, monkeypatch, capsys):
    """With no --data, every figure reads the port's h100_ file of its
    reference name, never a committed TPU CSV, and writes into a directory
    that git ignores and that holds no tracked file.  `draw all` skips a
    figure whose file is missing, and a figure that falls back to constants
    says so."""
    # the output directory lies under one that .gitignore lists, so it can
    # hold no tracked file; figures_out/ holds the reference's
    ignored = [ln.strip().rstrip("/") for ln in (ROOT / ".gitignore").read_text().splitlines()]
    out = Path(draw.DEFAULT_OUT)
    assert out.parts[0] in ignored and out.parts[0] != "figures_out"
    assert sorted(draw.DEFAULTS) == sorted(n for n in draw.FIGS if n != "motivation")
    for path in list(draw.DEFAULTS.values()) + [draw.DEFAULT_OVERHEADS]:
        assert Path(path).parent == Path("results") and Path(path).name.startswith("h100_")
    # only the rotation profile is there: the figures reading it draw, the
    # others are skipped or drawn with their stated constants
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir()
    (tmp_path / draw.DEFAULTS["rotation"]).write_text((ROOT / DATA["rotation"]).read_text())
    monkeypatch.setitem(draw.FIGS, "motivation", lambda args: None)
    draw.main(["all", "--device", "cpu"])
    said = capsys.readouterr().out
    for name, path in draw.DEFAULTS.items():
        if name in ("rotation", "poly_rot_mul"):
            assert f"[skip {name}]" not in said
        elif name in ("evaluator", "end_to_end"):
            assert f"[{name}] {path} missing: drawn with" in said
        else:
            assert f"[skip {name}] missing data: [Errno 2] No such file or directory: '{path}'" in said
    assert f"[poly_rot_mul overheads] {draw.DEFAULT_OVERHEADS} missing: drawn with" in said
    assert sorted(p.name for p in (tmp_path / out).iterdir()) == [
        "end_to_end_cost.png", "evaluator_reliability.png", "poly_rot_mul.png",
        "rotation_breakdown.png", "rotation_latency.png"]


def test_evaluator_from_the_scenarios_sweep(tmp_path, monkeypatch):
    """`bench.sweeps scenarios` writes the evaluator figure's default table
    in the committed table's columns; both packages plot it alike."""
    from rfhe_tpu_torch.bench import sweeps
    sweeps.main(["scenarios", "--trials", "8", "--device", "cpu", "--out", str(tmp_path)])
    path = str(tmp_path / "cpu_reliaNTT_scenarios_N64_q769_T8.csv")
    with open(path) as f, open(ROOT / DATA["evaluator"]) as g:
        assert f.readline() == g.readline()
    monkeypatch.chdir(ROOT)
    args = ["evaluator", "--data", path]
    ref = _draw(ref_draw, monkeypatch, args + ["--out", str(tmp_path / "ref")])
    port = _draw(draw, monkeypatch, args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert len(port) == len(ref) == 1
    _same(port[0], ref[0])
