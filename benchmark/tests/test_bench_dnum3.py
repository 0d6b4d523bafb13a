"""The dnum = 3 configuration and the mod-down's phases: its cell found by
name, its three digit groups run correct against the reference, the traced
run's MD_INTT / MD_LIFT / MD_NTT / MD_SCALE spans under MODDOWN in both
cells, and the two readers of those spans."""
import contextlib
import time

import pytest

from benchmark import harness
from benchmark.reference import scheme
from benchmark.tests import tiny
from rfhe_tpu_torch.trace import spans as program_spans

CELL = "ckks_n65536_l21_dnum3.bsgs_d64"


def test_the_cell_finds_its_configuration_mix_and_limits():
    w, cfg, mix, limits = harness.cell(tiny.SPEC, CELL, harness.ROOT)
    assert w["config"] == cfg["name"] == "ckks_n65536_l21_dnum3" and w["chips"] == 1
    assert w["traffic"] == "bsgs_d64" and mix["d"] == 64
    per_limb = harness.cell(tiny.SPEC, "ckks_n65536_l21.bsgs_d64", harness.ROOT)
    assert mix == per_limb[2]
    assert cfg["deployment"] == dict(per_limb[1]["deployment"], digits=3)
    assert cfg["reduced"] == [] and cfg["control"]["scale_bits"] == 24
    assert limits["limb_mismatch"] == 0 and 0 < limits["slot_err"] < 1
    basis = scheme.Basis.make(cfg["deployment"], "cpu")
    assert basis.L == 21 and len(basis.special) == 7
    assert basis.groups() == [list(range(7 * g, 7 * g + 7)) for g in range(3)]


def test_three_digit_groups_run_correct():
    """n = 256, L = 6: the configuration's three groups, 2 limbs each over 2
    special primes; keys the program's contexts take."""
    cut = tiny.parts(CELL)
    cut[1]["deployment"].update(levels=5)
    basis = scheme.Basis.make(cut[1]["deployment"], "cpu")
    assert basis.groups() == [[0, 1], [2, 3], [4, 5]] and len(basis.special) == 2
    correct, failed, checks, r = tiny.run(CELL, cut=cut)
    assert correct and failed == 0, checks
    assert checks["limb_mismatch"][0] == 0


@pytest.mark.parametrize("name,specials", [("ckks_n65536_l21.bsgs_d64", 1),
                                           (CELL, 2)])        # dnum 3 at L = 4
def test_a_traced_run_reads_the_moddown_phases(name, specials, monkeypatch):
    """The traced path on the CPU, the profiler left out: each keyswitch's
    MODDOWN holds the four phases of its drop_limbs once per special prime,
    and the card's readers find nothing in host spans."""
    monkeypatch.setattr(harness.torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(harness.tracing, "records", lambda prof: [])
    cut = tiny.parts(name)
    assert len(scheme.Basis.make(cut[1]["deployment"], "cpu").special) == specials
    r, per_sample, extra, limits = harness.run_cell(cut, 2 ** 31 + 5, 0.3, True, "cpu",
                                                    time.perf_counter())
    assert harness.judgement(per_sample, extra, limits)[0]
    assert not program_spans.ENABLED
    ks = r.spans["KEYSWITCH"]
    assert ks["count"] == 6 * len(r.ends)           # d = 16: 3 baby and 3 giant rotations
    for phase in program_spans.MODDOWN_PHASES:
        assert r.spans[phase]["parent"] == "MODDOWN", phase
        assert r.spans[phase]["count"] == specials * ks["count"], phase
    for metric in ("ks_moddown_ntt_device_ms_per_circuit",
                   "ks_moddown_residue_device_ms_per_circuit"):
        assert harness.reader(metric)(r) is None


SPANS = {"MODDOWN": 12e6, "MD_INTT": 1.5e6, "MD_LIFT": 4.5e6, "MD_NTT": 1.5e6,
         "MD_SCALE": 3e6}
READS = {"ks_moddown_ntt_device_ms_per_circuit": 1.0,
         "ks_moddown_residue_device_ms_per_circuit": 2.5}


@pytest.mark.parametrize("metric", sorted(READS))
def test_moddown_phase_readers_read_per_circuit(metric):
    entry = lambda ns: {"count": 3, "host_ns": 0, "device_count": 3, "device_ns": ns,
                        "parent": "MODDOWN"}
    run = harness.Run(setup_s=1.0, starts=[0.0, 1.0, 2.0], ends=[0.5, 1.5, 2.5],
                      window_s=3.0, peak_bytes=0,
                      spans={k: entry(v) for k, v in SPANS.items()}, counters={})
    assert harness.reader(metric)(run) == pytest.approx(READS[metric])
    # the parent's program records MODDOWN alone: the reader leaves its metric out
    parent = harness.Run(setup_s=1.0, starts=run.starts, ends=run.ends, window_s=3.0,
                         peak_bytes=0, spans={"MODDOWN": entry(12e6)}, counters={})
    bare = harness.Run(setup_s=1.0, starts=run.starts, ends=run.ends, window_s=3.0,
                       peak_bytes=0)
    assert harness.reader(metric)(parent) is None and harness.reader(metric)(bare) is None
