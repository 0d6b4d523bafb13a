"""The port's trace layer against rfhe_tpu's: the collector's text, the
trace parsers on the strings of tests/test_trace.py, and ProfiledRotation,
whose arrays equal the reference's `ckks.rotate` bit for bit (n = 256, 3
ciphertext primes, per-limb digits and dnum = 2) and whose kernel lines are
the main path's spans; `op_cost`'s keys on the CPU."""
import io
import re

import numpy as np
import pytest
import torch

from rfhe_tpu.fhe import CkksContext as RefContext, CkksParams as RefParams
from rfhe_tpu.trace import (TraceCollector as RefCollector, TraceEvent as RefEvent,
                            collapse_kernel_runs as ref_collapse, summarize_roi as ref_summarize)
from rfhe_tpu_torch.fhe import CkksContext, CkksParams
from rfhe_tpu_torch.trace import (ProfiledRotation, TraceCollector, TraceEvent,
                                  collapse_kernel_runs, evaluator_cost_report, format_report,
                                  op_cost, spans, summarize_roi)
from rfhe_tpu_torch.trace.spans import PHASES

torch.set_num_threads(1)

PARAMS = dict(n=256, levels=2, q0_bits=30, scale_bits=26)

COLLAPSE_LINES = [
    "frontend: ROTATE",
    "[NTT] total cost 100 us",
    "[NTT] total cost 50 us",
    "[MULTEVK] total cost 400 us",
    "[NTT] total cost 30 us",
    "ROTATE[600 microseconds]",
]
SUMMARY_LINES = [
    "frontend: ROTATE",
    "[NTT] total cost 100 us",
    "[NTT] total cost 50 us",
    "[MULTEVK] total cost 400 us",
    "[BASECONV] total cost 100 us",
    "ROTATE[700 microseconds]",
]
TWO_BLOCKS = SUMMARY_LINES + ["noise", "frontend: ROTATE", "[NTT] total cost 7 µs",
                              "[MODDOWN] total cost 20 us", "ROTATE[40 microseconds]"]


def test_collector_text_equals_the_reference():
    events = [("ROTATE", 0.0, 0, "begin"), ("NTT", 100.7, 1, "kernel"),
              ("NTT", 50.2, 1, "kernel"), ("MULTEVK", 200.0, 1, "kernel"),
              ("ROTATE", 612.9, 0, "frontend")]
    ours, theirs = TraceCollector(), RefCollector()
    ours.events = [TraceEvent(*e) for e in events]
    theirs.events = [RefEvent(*e) for e in events]
    assert ours.text() == theirs.text()
    assert ours.totals() == theirs.totals()


def test_collector_lines_and_kernel_sync():
    buf, ref_buf = io.StringIO(), io.StringIO()
    col, ref_col = TraceCollector(out=buf), RefCollector(out=ref_buf)
    for c in (col, ref_col):
        with c.scope("ROTATE"):
            c.kernel_cost("NTT", 100)
            c.kernel_cost("NTT", 50)
            c.kernel_cost("MULTEVK", 200)
    strip = lambda s: re.sub(r"\[\d+ microseconds\]", "[N microseconds]", s)
    assert strip(buf.getvalue()) == strip(ref_buf.getvalue())
    assert buf.getvalue().startswith("frontend: ROTATE\n[NTT] total cost 100 us\n")
    calls = []
    with col.kernel("BASECONV", sync=lambda: calls.append(1)):
        pass
    with col.kernel("PERMUTE", sync="cpu"):
        pass
    assert calls == [1]
    assert re.search(r"^\[PERMUTE\] total cost \d+ us$", buf.getvalue(), re.M)


@pytest.mark.parametrize("lines", [COLLAPSE_LINES, SUMMARY_LINES, TWO_BLOCKS])
def test_collapse_kernel_runs(lines):
    assert collapse_kernel_runs(lines) == ref_collapse(lines)


def test_collapse_values():
    out = collapse_kernel_runs(COLLAPSE_LINES)
    assert "[NTT] total cost 150 us" in out
    assert "[MULTEVK] total cost 250 us" in out
    assert "[NTT] total cost 30 us" in out


@pytest.mark.parametrize("lines", [COLLAPSE_LINES, SUMMARY_LINES, TWO_BLOCKS])
@pytest.mark.parametrize("all_blocks", [False, True])
def test_summarize_roi(lines, all_blocks):
    assert summarize_roi(lines, all_blocks=all_blocks) == ref_summarize(lines, all_blocks=all_blocks)


def test_summarize_values():
    s = summarize_roi(SUMMARY_LINES)
    assert s["roi_total_us"] == 700
    assert s["per_tag"] == {"NTT": 150, "MULTEVK": 250, "BASECONV": 100}


@pytest.fixture(scope="module", params=[None, 2], ids=["per-limb", "dnum2"])
def rotations(request):
    dnum = request.param
    rc = RefContext(RefParams.make(**PARAMS), seed=3, dnum=dnum)
    tc = CkksContext(CkksParams.make(**PARAMS), seed=3, dnum=dnum, device="cpu")
    z = np.random.default_rng(0).uniform(-1, 1, PARAMS["n"] // 2) + 0j
    ref_ct = rc.encrypt(*rc.encode(z))
    ct = tc.encrypt(*tc.encode(z))
    prof = ProfiledRotation(tc)
    buf = io.StringIO()
    out = prof.rotate(ct, 1, TraceCollector(out=buf))
    return rc.rotate(ref_ct, 1), out, tc.rotate(ct, 1), prof, buf.getvalue()


def test_profiled_rotation_equals_the_reference(rotations):
    ref_out, out, plain, _, _ = rotations
    for got, want, same in zip(out.c, ref_out.c, plain.c):
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data).astype(np.int64))
        assert torch.equal(got.data, same.data)
    assert out.scale == ref_out.scale


def test_profiled_rotation_lines(rotations):
    *_, prof, text = rotations
    tags = [m.group(1) for m in re.finditer(r"^\[(\w+)\] total cost \d+ us$", text, re.M)]
    assert tags == list(PHASES)
    assert text.startswith("frontend: ROTATE\n") and re.search(r"^ROTATE\[\d+ microseconds\]$",
                                                               text, re.M)
    bd = prof.breakdown()
    assert abs(bd["NTT"] + bd["ModMul"] + bd["BaseConv"] + bd["Others"] - 1.0) < 1e-9
    assert summarize_roi(prof.last_collector.text().splitlines())["per_tag"]["NTT"] >= 0


def test_profiled_rotation_phases_are_the_spans(rotations):
    """Each kernel line is the time of its phase's span in that rotation, on
    the host's clock here; each special prime's drop_limb closes the
    mod-down's four steps under MODDOWN."""
    tc = rotations[3].ckks
    ct = tc.encrypt(*tc.encode(np.zeros(PARAMS["n"] // 2)))
    col = TraceCollector()
    spans.enable("cpu")
    try:
        snap = spans.snapshot()
        ProfiledRotation(tc).rotate(ct, 1, col)
        got = spans.since(snap)
    finally:
        spans.disable()
    lines = [(ev.tag, ev.micros) for ev in col.events if ev.kind == "kernel"]
    assert lines == [(p, got[p]["host_ns"] / 1e3) for p in PHASES]
    n_sp = len(tc.ctx.moduli) - tc.L
    for step in spans.MODDOWN_PHASES:
        assert got[step]["count"] == n_sp and got[step]["parent"] == "MODDOWN", step


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_profiled_rotation_leaves_tracing_as_found(on):
    tc = CkksContext(CkksParams.make(**PARAMS), seed=3, device="cpu")
    ct = tc.encrypt(*tc.encode(np.zeros(PARAMS["n"] // 2)))
    if on:
        spans.enable("cpu")
    try:
        ProfiledRotation(tc).rotate(ct, 1)
        assert (spans.ENABLED, spans.MARKING) == (on, None)
    finally:
        spans.disable()


def test_op_cost_keys_on_the_cpu(rotations):
    tc = rotations[3].ckks
    ct = tc.encrypt(*tc.encode(np.zeros(PARAMS["n"] // 2)))
    cost = op_cost(lambda a, b: tc.add(a, b).c[0].data, ct, ct)
    assert set(cost) == {"device operations", "kernel us", "bytes accessed", "device"}
    assert cost["device"] == "cpu" and cost["device operations"] >= 1
    # add reads two (3, 256) int64 limbs per component pair at least
    assert cost["bytes accessed"] >= 2 * 8 * 3 * 256
    report = evaluator_cost_report(tc, ct, ct)
    assert list(report) == ["add", "multiply", "multiply_relin", "rescale", "rotate"]
    assert format_report(report).splitlines()[0].split() == ["op", "device", "ops", "kernel",
                                                             "us", "MB", "moved"]

