"""Port parity: rfhe_tpu_torch.faults.reduction_campaigns against
rfhe_tpu.faults.reduction_campaigns, tolerance 0 (TP/FP/TN/FN, miss counts,
p and Q equal), at vec 128 and T 40; chunked trials equal unchunked; the
device draws of `prng` equal its host draws."""
import numpy as np
import pytest
import torch

from rfhe_tpu.faults import reduction_campaigns as ref
from rfhe_tpu_torch import prng
from rfhe_tpu_torch.faults import reduction_campaigns as port

torch.set_num_threads(1)

VEC, T = 128, 40

CASES = [
    ("barrett_scheme_campaign", (4, (True, True, True), T),
     dict(elem_count=2, bits_per_elem=2, fault="BF")),
    ("barrett_scheme_campaign", (2, (True, False, True), T), dict(fault="MOF")),
    ("montgomery_campaign", (12, (True, True, True), T), {}),
    ("barrett_final_campaign", (4, 1, T), {}),
    ("barrett_final_campaign", (5, 2, T), {}),
    ("barrett_final_campaign", (6, 3, T), {}),
    ("barrett_final_campaign", (7, 4, T), dict(use_range=False)),
    ("outer_check_campaign", (4, "MOF2", T), {}),
    ("outer_check_campaign", (8, "SBF+DBF", T), {}),
    ("outer_check_campaign", (4, "MOF+DBF", T), dict(seed=9)),
]


def _id(case):
    name, args, kw = case
    return "-".join([name.replace("_campaign", "")] + [str(a) for a in args[:2]]
                    + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_campaign_dict(case):
    name, args, kw = case
    got = getattr(port, name)(*args, vec_len=VEC, device="cpu", **kw)
    assert got == getattr(ref, name)(*args, vec_len=VEC, **kw)


@pytest.mark.parametrize("case", CASES[::3], ids=_id)
def test_chunked_trials_equal_unchunked(case):
    name, args, kw = case
    timing = {}
    whole = getattr(port, name)(*args, vec_len=VEC, device="cpu", chunk=T, **kw)
    parts = getattr(port, name)(*args, vec_len=VEC, device="cpu", chunk=7, timing=timing, **kw)
    assert whole == parts
    assert timing["wall_s"] >= timing["host_draw_s"] + timing["device_draw_s"] > 0


def test_uniform_below_is_not_below_p():
    """The reference's 'uniform below p' words, 59-bit for a 37-bit p: the
    port gives the same words (ROADMAP, caveats in the reference)."""
    import jax
    p = 76177563817
    got = port._uniform_below(port._Draws(torch.device("cpu"), None),
                              prng.PRNGKey(0)[None], 4096, p, 2)[0]
    want = np.asarray(ref._uniform_below(jax.random.PRNGKey(0), (4096,), p, 2)).astype(np.int64)
    assert np.array_equal(got.numpy(), want)
    vals = np.array([int(w[0]) + (int(w[1]) << 32) for w in want], dtype=object)
    assert (vals >= p).all() and max(vals).bit_length() == 59


@pytest.mark.parametrize("shape, n", [((5, 3), 1024), ((2,), 8192), ((1,), 100000)])
def test_device_draws_equal_host_draws(shape, n):
    keys = prng.split(prng.PRNGKey(42), 9)
    assert np.array_equal(prng.random_bits_on(keys, shape, "cpu").numpy(),
                          prng.random_bits(keys, shape).astype(np.int64))
    assert np.array_equal(prng.choice_on(keys, n, shape[:1], "cpu").numpy(),
                          prng.choice(keys, n, shape[:1]).astype(np.int64))
    for hi in (n, 3457, 65536, 65537, 1073692673):
        for dtype in (np.int32, np.uint32):
            assert np.array_equal(prng.randint_on(keys, shape, 1, hi, "cpu").numpy(),
                                  prng.randint(keys, shape, 1, hi, dtype).astype(np.int64))


def test_reference_now_pins():
    """bench/reference_now.json (the rows chip_smoke.py holds the card
    against) is the reference's current output: two entries recomputed."""
    import json
    from pathlib import Path
    pins = json.loads((Path(port.__file__).parents[1] / "bench" / "reference_now.json").read_text())
    assert pins["outer_check_T2000"]["8,MOF+SBF"] == \
        ref.outer_check_campaign(8, "MOF+SBF", 2000, vec_len=256)
    assert pins["montgomery_T300"]["12,1,0"] == \
        ref.montgomery_campaign(12, (True, False, True), 300, pbits=37, vec_len=1024, seed=42)
    assert [len(pins[k]) for k in ("montgomery_T300", "barrett_final_T300", "barrett_fold_MOF_T1000",
                                   "barrett_fold_MOF_T10000", "outer_check_T2000")] == [21, 112, 36, 6, 16]


@pytest.mark.parametrize("name, argv, header", [
    ("barrett_fold", ["--fw-min", "20", "--fw-max", "22"], "fold_width,use_t,use_sn,use_final"),
    ("montgomery", [], "fold_width,use_m,use_mp,detection_rate"),
    ("barrett_final", [], "s,model,protection,miss_rate"),
    ("montgomery_native", [], "fold_width,use_m,use_mp,detection_rate,TP,FN"),
    ("barrett_final_native", [], "s,model,protection,miss_rate"),
    ("pbits_native", ["--pbits-min", "10", "--pbits-max", "12"], "ftype,pbits,stage,trials"),
    ("relia_ntt_native", ["--qbits-min", "12", "--qbits-max", "14"], "qbits,q,kind,det_rate"),
])
def test_sweep_clis_on_the_cpu(tmp_path, name, argv, header):
    import shutil
    from rfhe_tpu_torch.bench import sweeps
    if name.endswith("_native") and shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    sweeps.main([name, "--trials", "4", "--vec", "32", "--out", str(tmp_path), "--device", "cpu"]
                + argv)
    (path,) = tmp_path.iterdir()
    assert path.name.startswith("cpu_" + name.split("_native")[0].replace("relia_ntt", "reliaNTT"))
    lines = path.read_text().splitlines()
    assert lines[0].startswith(header) and len(lines) > 1
