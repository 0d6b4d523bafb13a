"""The protected BGV dot product at N=32768 over 20 limbs: its cell found by
name, its basis, a tiny run correct with every fault caught, the control
failing, the traced run's keyswitch and detector spans, and the reader of
the detector spans."""
import contextlib
import time

import pytest

from benchmark import harness
from benchmark.reference import scheme
from benchmark.tests import tiny
from rfhe_tpu_torch.trace import spans as program_spans

CELL = "bgv_n32768_l20.dotprod_protected"


def test_the_cell_finds_its_configuration_mix_and_limits():
    w, cfg, mix, limits = harness.cell(tiny.SPEC, CELL, harness.ROOT)
    assert w["config"] == cfg["name"] == "bgv_n32768_l20" and w["chips"] == 1
    assert w["traffic"] == "dotprod_protected" and mix["protected"] is True
    assert (mix["pool"], mix["sample"]) == (4, 16)
    assert cfg["reduced"] == ["q_bits"] and cfg["control"]["dot_dtype"] == "int32"
    assert limits == {"slot_mismatch": 0, "limb_mismatch": 0, "flagged_clean": 0,
                      "faults_missed": 0}
    (metric,) = [m for m in tiny.SPEC["per_layer"] if m["name"] == "detect_device_ms_per_circuit"]
    assert metric["workloads"] == [CELL] and metric["moves"] == "circuits_per_s"


def test_the_basis_is_20_limbs_one_special_prime_and_t():
    cfg = harness.cell(tiny.SPEC, CELL, harness.ROOT)[1]
    basis = scheme.Basis.make(cfg["deployment"], "cpu")
    assert basis.n == 32768 and basis.L == 20 and len(basis.special) == 1
    assert basis.t == 786433 and basis.dnum is None
    assert all(q.bit_length() == 30 for q in basis.ct + basis.special)
    assert basis.special[0] not in basis.ct
    assert sum(q.bit_length() for q in basis.ct + basis.special) == 630


def test_a_tiny_run_is_correct_and_catches_every_fault():
    correct, failed, checks, r = tiny.run(CELL)
    assert correct and failed == 0, checks
    assert checks["faults_missed"] == (0, 0) and checks["flagged_clean"] == (0, 0)


def test_the_control_fails():
    correct, failed, checks, r = tiny.run(CELL, control=True)
    assert not correct and checks["slot_mismatch"][0] > 0


def test_a_traced_run_records_the_keyswitch_and_every_detector(monkeypatch):
    """The traced path on the CPU, the profiler left out: each circuit's
    log2(n/2) + 2 protected keyswitches (16 at n = 32768) open KEYSWITCH, and
    every detector phase closes under its parent; the card's readers find
    nothing in host spans."""
    monkeypatch.setattr(harness.torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(harness.tracing, "records", lambda prof: [])
    cut = tiny.parts(CELL)
    n = cut[1]["deployment"]["n"]
    r, per_sample, extra, limits = harness.run_cell(cut, 2 ** 31 + 7, 0.3, True, "cpu",
                                                    time.perf_counter())
    assert harness.judgement(per_sample, extra, limits)[0]
    assert not program_spans.ENABLED
    per_circuit = (n // 2).bit_length() - 1 + 2
    assert r.spans["KEYSWITCH"]["count"] == per_circuit * len(r.ends)
    parents = {"CHK_PERMUTE": "dispatch", "CHK_INTT": "dispatch",
               "CHK_BASECONV": "KEYSWITCH", "CHK_KS_CORE": "KEYSWITCH",
               **dict.fromkeys(("CHK_MD_INTT", "CHK_MD_LIFT", "CHK_MD_PROJ", "CHK_MD_RANGE"),
                               "MODDOWN")}
    assert set(parents) == set(program_spans.CHECK_PHASES)
    for name, parent in parents.items():
        assert r.spans[name]["parent"] == parent, name
    for name in program_spans.CHECK_PHASES[2:] + program_spans.MODDOWN_PHASES:
        assert r.spans[name]["count"] == r.spans["KEYSWITCH"]["count"], name
    # 8 flags a protected op (one special prime), 16 ops a circuit at n = 32768
    assert r.counters["detector_flags"] == 8 * per_circuit * len(r.ends)
    for metric in ("detect_device_ms_per_circuit", "keyswitch_device_ms_per_circuit",
                   "ks_multevk_device_ms_per_circuit"):
        assert harness.reader(metric)(r) is None


def test_the_detector_reader_reads_the_sum():
    entry = lambda ns: {"count": 3, "host_ns": 0, "device_count": 3, "device_ns": ns,
                        "parent": "MODDOWN"}
    names = program_spans.CHECK_PHASES
    spans = {name: entry(1e6 * (k + 1)) for k, name in enumerate(names)}
    spans["KEYSWITCH"] = entry(99e6)
    run = harness.Run(setup_s=1.0, starts=[0.0, 1.0, 2.0], ends=[0.5, 1.5, 2.5],
                      window_s=3.0, peak_bytes=0, spans=spans, counters={})
    read = harness.reader("detect_device_ms_per_circuit")
    assert read(run) == pytest.approx(sum(range(1, len(names) + 1)) / 3)
    # the parent's program records the keyswitch without detector spans
    parent = harness.Run(setup_s=1.0, starts=run.starts, ends=run.ends, window_s=3.0,
                         peak_bytes=0, spans={"KEYSWITCH": entry(99e6)}, counters={})
    bare = harness.Run(setup_s=1.0, starts=run.starts, ends=run.ends, window_s=3.0,
                       peak_bytes=0)
    assert read(parent) is None and read(bare) is None
