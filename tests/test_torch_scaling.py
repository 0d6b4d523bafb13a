"""bench/scaling.py and bench/scaling_mxu.py on a world of 2 gloo processes
on the CPU: rows for 1 and 2 devices with the reference's columns, the
1-device row's all_to_all at 0 and its efficiency 1 by definition.  The
reference's columns are read from its own harnesses, run on conftest's
virtual CPU mesh at small sizes."""
import csv
import math

import pytest

from rfhe_tpu.bench import scaling as ref_scaling
from rfhe_tpu.bench import scaling_mxu as ref_scaling_mxu
from rfhe_tpu_torch.bench import scaling, scaling_mxu
from rfhe_tpu_torch.parallel import worlds
from rfhe_tpu_torch.parallel.mesh import spawn_world

N, LIMBS = 64, 2                 # four-step: n1 = n2 = 8
N_MXU, LIMBS_MXU = 256, 2        # production split: n1 = 128, n2 = 2


@pytest.fixture(scope="module")
def rows():
    return spawn_world(worlds.scaling_rows, 2, "gloo", args=(N, LIMBS, N_MXU, LIMBS_MXU, 2, "cpu"),
                       timeout_s=60, deadline_s=300)[0]


@pytest.fixture(scope="module")
def reference_columns(tmp_path_factory):
    path = tmp_path_factory.mktemp("scaling") / "scaling_mxu.csv"
    ref_scaling_mxu.main(["--n", str(N_MXU), "--limbs", str(LIMBS_MXU), "--iters", "1",
                          "--csv", str(path)])
    with open(path) as f:
        mxu_cols = next(csv.reader(f))
    return {"scaling": list(ref_scaling.measure(N, LIMBS, 1)[0]), "scaling_mxu": mxu_cols}


@pytest.mark.parametrize("harness", ["scaling", "scaling_mxu"])
def test_reference_columns(rows, reference_columns, harness):
    assert [list(r) for r in rows[harness]] == [reference_columns[harness]] * 2
    assert (scaling.COLUMNS, scaling_mxu.COLUMNS) == (reference_columns["scaling"],
                                                      reference_columns["scaling_mxu"])


@pytest.mark.parametrize("harness", ["scaling", "scaling_mxu"])
def test_rows_per_device_count(rows, harness):
    rs = rows[harness]
    assert [r["devices"] for r in rs] == [1, 2]
    assert rs[0]["efficiency"] == 1.0
    for r in rs:
        assert all(math.isfinite(v) and v >= 0 for v in r.values())
        assert r["limb_transforms_per_s"] > 0


def test_mxu_all_to_all_share(rows):
    one, two = rows["scaling_mxu"]
    assert one["a2a_us"] == 0.0 and one["a2a_share"] == 0.0
    assert two["a2a_us"] > 0 and 0 < two["a2a_share"]
    for r in (one, two):
        assert r["limb_transforms_per_s"] == pytest.approx(LIMBS_MXU / (r["total_us"] * 1e-6))


def test_cli_writes_the_reference_csv(rows, tmp_path, monkeypatch, capsys):
    """main() prints and writes the rows of its world with the columns."""
    monkeypatch.setattr(scaling_mxu, "run_world", lambda args, fn, fn_args: rows["scaling_mxu"])
    path = tmp_path / "out.csv"
    scaling_mxu.main(["--device", "cpu", "--devices", "2", "--csv", str(path)])
    with open(path) as f:
        written = list(csv.DictReader(f))
    assert [list(r) for r in written] == [scaling_mxu.COLUMNS] * 2
    assert [int(r["devices"]) for r in written] == [1, 2]
    assert capsys.readouterr().out.splitlines()[0] == ",".join(scaling_mxu.COLUMNS)
