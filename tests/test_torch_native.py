"""Port parity: the port's binding of the native engine
(rfhe_tpu_torch.native) against rfhe_tpu.native in one process, so both
libraries run at the same OpenMP thread count; counts equal, and within the
reference tests' bounds (tests/test_native.py).  The port's library is built
into build/native/ and native/ is left as it is."""
import shutil

import pytest

from rfhe_tpu import native as ref
from rfhe_tpu_torch import native as port

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def test_builds_into_build_native():
    lib = port.build()
    assert lib.parent == port.ROOT / "build" / "native" and lib.exists()
    assert port.SOURCE == port.ROOT / "native" / "rfhe_mc.cpp"
    assert port.build() == lib                      # built once


@pytest.mark.parametrize("kind, trials, q, seed, stage", [
    ("SBF", 20_000, 769, 42, None), ("MOF1", 20_000, 769, 3, None),
    ("SBF+SBF", 20_000, 769, 42, 1), ("SBF+SBF", 20_000, 769, 42, 0), ("MLF+MLF", 20_000, 769, 42, 2),
])
def test_four_step_mc(kind, trials, q, seed, stage):
    got = port.four_step_mc(kind, trials, 64, q, 24, seed=seed, target_stage=stage)
    assert got == ref.four_step_mc(kind, trials, 64, q, 24, seed=seed, target_stage=stage)
    if stage == 1:
        assert got["miss_rate"] == 0.0 and got["stats"]["intra_catch"] == trials
    if stage == 0:
        assert 0.001 < got["miss_rate"] < 0.01


@pytest.mark.parametrize("ftype, P, W, seed", [("MCF-CLE", 3, 4, 1), ("SCF-BF", 12289, 24, 2)])
def test_three_stage_mc(ftype, P, W, seed):
    got = port.three_stage_mc(ftype, 20_000, 8, P, W, seed=seed)
    assert got == ref.three_stage_mc(ftype, 20_000, 8, P, W, seed=seed)
    if ftype == "MCF-CLE":
        assert 0.45 < got["collision_prob"][0] < 0.65
    else:
        assert max(got["collision_prob"]) < 0.01


def test_montgomery_and_barrett_final_mc():
    got = port.montgomery_mc(12, (True, True, True), 200, vec_len=256)
    assert got == ref.montgomery_mc(12, (True, True, True), 200, vec_len=256)
    got = port.barrett_final_mc(5, 3, 200, vec_len=256, use_range=False)
    assert got == ref.barrett_final_mc(5, 3, 200, vec_len=256, use_range=False)


def test_tables():
    assert port.SCENARIOS == ref.SCENARIOS
    assert port.FAULT_IDS == ref.FAULT_IDS
