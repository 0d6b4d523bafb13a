"""The port's bench layer on the CPU: the composite-scale CKKS multiply +
rescale that bench/northstar.py runs at N = 65536 (here n = 256, 2^56
scale, two primes dropped per rescale) and the BSGS / naive matrix-vector
products (n = 256, d = 8) against rfhe_tpu, tolerance 0; phase_profile's
`_shares` against the reference's on the same dicts; the roofline's work
counts and bounds; the rows and columns of ops_devtime, perf_suite,
phase_profile and the sweeps at n <= 512; and the `device-unresolved` mode."""
import csv

import numpy as np
import pytest
import torch

from rfhe_tpu.bench.phase_profile import _shares as ref_shares
from rfhe_tpu.fhe import CkksContext as RefContext, CkksParams as RefParams
from rfhe_tpu.models import bsgs as ref_bsgs
from rfhe_tpu_torch.bench import northstar, ops_devtime, perf_suite, phase_profile, roofline, sweeps
from rfhe_tpu_torch.device import MEASURED, MODES, device_records, op_us, resolve_reading
from rfhe_tpu_torch.fhe import CkksContext, CkksParams
from rfhe_tpu_torch.models import bsgs

torch.set_num_threads(1)


def _same(ref_ct, ct):
    assert len(ref_ct.c) == len(ct.c) and ref_ct.scale == ct.scale
    for r, t in zip(ref_ct.c, ct.c):
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(r.data).astype(np.int64))


# ---------------------------------------------------------------------------
# composite scale (the north-star CKKS row's path)

COMPOSITE = dict(n=256, levels=2, q0_bits=31, scale_bits=56)


@pytest.fixture(scope="module")
def composite():
    rc = RefContext(RefParams.make(**COMPOSITE), seed=7)
    tc, z, ct, m = northstar.ckks_case("cpu", COMPOSITE, seed=7)
    ref_ct = rc.encrypt(*rc.encode(z))
    return rc, tc, z, ref_ct, ct, rc.rescale(rc.multiply(ref_ct, ref_ct)), m


def test_composite_params(composite):
    rc, tc, *_ = composite
    assert tc.params.moduli == rc.params.moduli and tc.params.alpha == rc.params.alpha == 2
    assert tc.ctx.moduli == rc.ctx.moduli


def test_composite_encrypt(composite):
    _, _, _, ref_ct, ct, _, _ = composite
    _same(ref_ct, ct)


def test_composite_multiply_rescale(composite):
    rc, tc, z, _, _, ref_m, m = composite
    _same(ref_m, m)
    assert m.level == ref_m.level == tc.params.L - 1 - 2
    got = tc.decrypt_decode(m)
    np.testing.assert_array_equal(got, rc.decrypt_decode(ref_m))
    assert np.max(np.abs(got - z * z)) < 1e-6


# ---------------------------------------------------------------------------
# BSGS

BSGS = dict(n=256, levels=2, q0_bits=30, scale_bits=26)
D = 8


def _eager_galois(rc):
    """The reference's apply_galois without its per-element jit (one compile
    per Galois element): its implementation, called eagerly."""
    rc.apply_galois = lambda ct, g: rc._apply_galois_impl(ct, rc.galois_key(g), g)
    return rc


@pytest.fixture(scope="module")
def matvec():
    rc = _eager_galois(RefContext(RefParams.make(**BSGS), seed=3))
    tc = CkksContext(CkksParams.make(**BSGS), seed=3, device="cpu")
    rng = np.random.default_rng(5)
    M = rng.uniform(-1, 1, (D, D))
    x = rng.uniform(-1, 1, D)
    slots = BSGS["n"] // 2
    zx = np.tile(x, slots // D) + 0j
    ref_ct, ct = rc.encrypt(*rc.encode(zx)), tc.encrypt(*tc.encode(zx))
    out = {}
    for name in ("matvec_naive", "matvec_bsgs"):
        out[name] = (getattr(ref_bsgs, name)(rc, M, ref_ct), getattr(bsgs, name)(tc, M, ct))
    return M, x, tc, out


@pytest.mark.parametrize("name", ["matvec_naive", "matvec_bsgs"])
def test_matvec_equals_the_reference(matvec, name):
    M, x, tc, out = matvec
    ref_y, y = out[name]
    _same(ref_y, y)
    got = tc.decrypt_decode(y)[:D].real
    np.testing.assert_allclose(got, M @ x, atol=1e-2)


def test_pack_diagonals_and_embed(matvec):
    M, _, tc, _ = matvec
    for a, b in zip(bsgs.pack_diagonals(M), ref_bsgs.pack_diagonals(M)):
        np.testing.assert_array_equal(a, b)
    assert bsgs._embed(tc, np.arange(D)).shape == (BSGS["n"] // 2,)


# ---------------------------------------------------------------------------
# phase_profile's shares and rows

SHARE_CASES = [
    {"PERMUTE": 6e-6, "INTT": 22e-6, "BASECONV": 70e-6, "NTT": 107e-6, "MULTEVK": 44e-6,
     "MODDOWN": 34e-6},
    {"PERMUTE": 6e-6, "INTT": 22e-6, "BASECONV": 70e-6, "NTT": 107e-6, "MULTEVK": 44e-6,
     "MODDOWN": 34e-6, "MD_INTT": 1.3e-6, "MD_BASECONV": 16e-6, "MD_NTT": 13e-6, "MD_MODMUL": 0.8e-6},
    {"PERMUTE": 7e-6, "INTT": 22e-6, "BASECONV": 177e-6, "NTT": 43e-6, "MULTEVK": 24e-6,
     "MODDOWN": 1000e-6, "MD_INTT": 23e-6, "MD_BASECONV": 418e-6, "MD_NTT": 577e-6,
     "MD_MODMUL": 14e-6},
]


@pytest.mark.parametrize("ph", SHARE_CASES)
def test_shares_equal_the_reference(ph):
    assert phase_profile._shares(dict(ph)) == ref_shares(dict(ph))


def test_rotation_rows_on_the_cpu(tmp_path):
    sweeps.main(["rotation", "--logn-min", "8", "--logn-max", "8", "--levels", "2",
                 "--device", "cpu", "--out", str(tmp_path)])
    sweeps.main(["dnum", "--N", "512", "--levels", "2", "--dnums", "1,3", "--device", "cpu",
                 "--out", str(tmp_path)])
    rot = list(csv.DictReader(open(tmp_path / "cpu_rotation_profile.csv")))
    dn = list(csv.DictReader(open(tmp_path / "cpu_dnum_N512.csv")))
    assert list(rot[0]) == phase_profile.COLUMNS
    assert [r["dnum"] for r in dn] == ["1", "3"] and [r["n"] for r in dn] == ["512", "512"]
    for r in rot + dn:
        assert r["mode"] == "wall" and r["limbs"] == "3"
        assert r["rotate_us"] == "" and r["lost_records"] == ""
        assert float(r["total_us"]) > 0 and all(float(r[f"{p}_us"]) > 0
                                                for p in ("PERMUTE", "NTT", "MD_NTT"))
        shares = [float(r[k]) for k in ("NTT", "ModMul", "BaseConv", "Others")]
        assert abs(sum(shares) - 1) < 1e-9


class _Ev:
    """A profiler event: name, device type, host-clock span, correlation id."""

    def __init__(self, name, cuda, start, end, id=0):
        self.name, self.id = name, id
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_attribute_sums_kernels_by_range():
    """Device events count toward every range that holds their launch (or,
    with no launch recorded, their start); each lies in exactly one phase of
    a rotation; the padding, annotations and the side range do not count."""
    events = [_Ev("ROTATE", False, 0, 100), _Ev("PERMUTE", False, 1, 10),
              _Ev("MODDOWN", False, 10, 99), _Ev("MD_NTT", False, 20, 30),
              _Ev("k1", True, 2, 5), _Ev("k2", True, 21, 28), _Ev("k3", True, 50, 51),
              _Ev("cudaLaunchKernel", False, 22, 23, id=7), _Ev("k5", True, 31, 33, id=7),
              _Ev("at::cuda::spin_kernel(long)", True, 100.5, 101),
              _Ev("MODDOWN", True, 10, 99), _Ev(phase_profile.ALONE, True, 120, 130)]
    out = phase_profile.attribute(events, 1)
    assert out["ROTATE"] == 13 and out["PERMUTE"] == 3 and out["MODDOWN"] == 10
    assert out["MD_NTT"] == 9 and out["NTT"] == 0
    with pytest.raises(RuntimeError, match="exactly one phase"):
        phase_profile.attribute(events + [_Ev("k4", True, 99.5, 99.7)], 1)


def test_attribute_places_graph_kernels_at_their_launch():
    """A replayed graph's kernels share the graph launch's correlation id and
    count in the phase whose range holds that launch, wherever the card ran
    them; the graph's input copies and output clones count in no phase."""
    events = [_Ev("ROTATE", False, 0, 100), _Ev("PERMUTE", False, 1, 10),
              _Ev("MODDOWN", False, 10, 99), _Ev("cudaGraphLaunch", False, 2, 3, id=9),
              _Ev("k1", True, 150, 154, id=9), _Ev("k2", True, 154, 155, id=9),
              _Ev("cudaMemcpyAsync", False, 4, 5, id=10),
              _Ev("Memcpy DtoD (Device -> Device)", True, 140, 141, id=10)]
    out = phase_profile.attribute(events, 1)
    assert out["PERMUTE"] == 5 and out["ROTATE"] == 5 and out["MODDOWN"] == 0


def test_device_records_count_lost_launches():
    """A launch inside the measured range whose correlation id has no
    device record is lost; the padding's records are dropped."""
    events = [_Ev(MEASURED, False, 10, 50), _Ev("cudaLaunchKernel", False, 11, 12, id=1),
              _Ev("cudaLaunchKernelExC", False, 13, 14, id=2), _Ev("k1", True, 15, 16, id=1),
              _Ev("cudaLaunchKernel", False, 5, 6, id=3), _Ev("at::cuda::spin_kernel(long)", True, 6, 7, id=3),
              _Ev("cudaLaunchKernel", False, 55, 56, id=4)]
    device, launched, lost = device_records(events)
    assert [ev.name for ev in device] == ["k1"] and launched == 2 and lost == 1


def test_composition_rows_on_the_cpu(tmp_path):
    sweeps.main(["composition", "--N", "512", "--levels", "1", "--device", "cpu",
                 "--out", str(tmp_path)])
    rows = list(csv.reader(open(tmp_path / "cpu_op_composition.csv")))
    assert rows[0] == ["group", "part", "share"]
    parts = [(g, p) for g, p, _ in rows[1:]]
    assert parts == [("dotprod", p) for p in ("Rotate", "HMul+Relin", "Rescale", "Add")] + \
        [("rotate", p) for p in ("PERMUTE", "INTT", "BASECONV", "NTT", "MULTEVK", "MODDOWN")]
    for group in ("dotprod", "rotate"):
        assert abs(sum(float(s) for g, _, s in rows[1:] if g == group) - 1) < 1e-3


# ---------------------------------------------------------------------------
# roofline

@pytest.mark.parametrize("n", [256, 4096, 16384, 65536])
def test_roofline_work_counts(n):
    log_n = n.bit_length() - 1
    assert roofline.butterflies(n) == (n // 2) * log_n
    assert roofline.floor_bytes(n) == 2 * 4 * n
    assert roofline.int_ops(n) == (n // 2) * log_n * 9 + 5 * n


def test_roofline_bounds():
    peak = roofline.int_peak(1980)
    assert peak == 64 * 132 * 1980e6
    t_bytes, t_ops = roofline.bounds_us(21 * 8, 4096, 1980)
    assert t_bytes == pytest.approx(168 * 16 * 4096 / 3.35e12 * 1e6)
    assert t_ops == pytest.approx(168 * (2048 * 12 * 9 + 5 * 4096) / peak * 1e6)
    r = roofline.row("kernel_fwd_one_block", 4096, 21, 8, 10.0, "device-timer", 1980)
    assert r["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
    assert r["hbm_floor_pct"] == pytest.approx(100 * 168 / 10e-6 * 8 * 4096 / 3.35e12)
    assert r["int_ops_peak_pct"] == pytest.approx(100 * t_ops / 10.0)
    assert set(r) == set(roofline.COLUMNS)
    assert set(roofline.row("pease_fwd", 256, 2, 2, 5.0, "wall", None)) < set(roofline.COLUMNS)


def test_roofline_rows_on_the_cpu():
    rows = roofline.measure(256, 2, 2, device="cpu")
    assert [r["impl"] for r in rows] == ["plain_fwd", "pease_fwd"]
    assert all(r["mode"] == "wall" and r["us_per_call"] > 0 for r in rows)


# ---------------------------------------------------------------------------
# ops_devtime, perf_suite and the modes

REF_OPS = ["ntt_fwd", "ntt_inv", "dyadic_mult", "rotate", "conjugate", "add", "mult_relin",
           "rescale", "encrypt", "decrypt", "decrypt_decode(host)", "bgv_rotate_rows",
           "bgv_multiply_relin", "bfv_rotate_rows", "bfv_multiply_relin"]


def test_ops_devtime_rows_on_the_cpu(tmp_path):
    rows = ops_devtime.measure(256, 2, "cpu")
    assert [r["op"] for r in rows] == REF_OPS
    assert all(list(r) == ops_devtime.COLUMNS for r in rows)
    assert all(r["mode"] == "wall" and r["us"] > 0 for r in rows)
    path = tmp_path / "x.csv"
    ops_devtime.write_csv(str(path), ops_devtime.COLUMNS, rows)
    assert next(csv.reader(open(path))) == ops_devtime.COLUMNS


def test_device_unresolved_mode():
    seen = []

    def zero(reps):
        seen.append(reps)
        return 0.0

    assert resolve_reading(zero, 20) == (None, False)
    assert seen == [20, 80, 320]                       # the reference's two x4 escalations
    assert resolve_reading(lambda reps: 0.0 if reps < 80 else 3.5, 20) == (3.5, True)
    row = ops_devtime._row("add", (None, "device-unresolved", 4.0, 6.0))
    assert row == {"op": "add", "mode": "device-unresolved", "us": "", "launches": 4.0,
                   "kernels": 6.0}
    assert "device-unresolved" in MODES


def test_cpu_timing_is_wall():
    us, mode, launches, kernels = op_us(lambda: torch.ones(8) + 1, "cpu", reps=3)
    assert mode == "wall" and launches is None and kernels is None and us > 0


REF_LINES = {
    "CKKS": ["encode", "encrypt", "add", "multiply", "multiply_relin", "multiply_plain",
             "square_relin", "rescale", "rotate_one", "rotate_random", "conjugate",
             "decrypt_decode", "serialize", "serialize_zlib", "serialize_lzma"],
    "BGV": ["batch_encode", "encrypt", "add", "multiply_relin", "multiply_plain", "mod_switch",
            "rotate_rows", "rotate_columns", "decrypt_decode"],
    "BFV": ["batch_encode", "encrypt", "add", "multiply", "square", "multiply_relin",
            "multiply_plain", "rotate_rows", "rotate_columns", "decrypt_decode"],
}


def test_perf_suite_lines_on_the_cpu():
    lines = list(perf_suite.lines("all", 256, 2, 2, "cpu"))
    heads = [i for i, line in enumerate(lines) if line.startswith("==")]
    assert [lines[i] for i in heads] == [f"== {s} performance (n=256, levels=2) =="
                                         for s in ("CKKS", "BGV", "BFV")]
    for (scheme, ops), start, end in zip(REF_LINES.items(), heads, heads[1:] + [len(lines)]):
        body = lines[start + 1:end]
        assert [line.split(":")[0] for line in body] == [f"Average {op}" for op in ops], scheme
        assert all(line.endswith(" microseconds") for line in body)


def test_perf_suite_microtest():
    t = perf_suite.MicroTest("ones", lambda: (torch.ones(4),), lambda a: a + 1, iters=3)
    assert perf_suite.MicroTest.registry["ones"] is t and t("cpu") > 0


def test_clis_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main, argv in ((ops_devtime.main, []), (northstar.main, []), (roofline.main, []),
                       (phase_profile.main, ["rotation"]), (perf_suite.main, []),
                       (sweeps.main, ["composition"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
