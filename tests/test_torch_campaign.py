"""The fault injectors and the Monte-Carlo campaigns of the port against
rfhe_tpu, bit for bit (tolerance 0), on the CPU: every injector under the
same keys, batched over trials against the reference's vmap; the
three-stage campaign for every fault type; the protected four-step NTT
campaign for every scenario, sampled and pinned stage."""
import importlib.util
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu.faults import campaign as ref_campaign, inject as ref_inject
from rfhe_tpu.ops.modring import ModArith as RefArith
from rfhe_tpu.transform.four_step import FourStepPlan as RefPlan
from rfhe_tpu_torch.device import to_numpy_u32, to_torch
from rfhe_tpu_torch import numth
from rfhe_tpu_torch.faults import campaign, inject
from rfhe_tpu_torch.ops.modring import ModArith
from rfhe_tpu_torch.transform.four_step import FourStepPlan

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRIALS = 48
S = 8


def t(a):
    return to_torch(np.asarray(a), "cpu")


@pytest.fixture(scope="module")
def keys():
    return np.asarray(jax.random.split(jax.random.PRNGKey(42), TRIALS))


def _mats(q, seed, shape=(S, S)):
    return np.random.default_rng(seed).integers(0, q, (TRIALS,) + shape, dtype=np.uint32)


def _vmapped(fn, keys, *arrays):
    return np.asarray(jax.vmap(fn)(jnp.asarray(keys), *(jnp.asarray(a) for a in arrays)))


# P = 3 (2 bits) gives MBU masks above 2q, whose wrapped words stay at or
# above q; 53 and 769 stay canonical.
@pytest.mark.parametrize("q", [3, 53, 769])
@pytest.mark.parametrize("name", ["sbf", "dbf", "mbu", "cte"])
def test_bit_injectors(keys, q, name):
    bw = q.bit_length()
    x = _mats(q, q)
    ref_fn = getattr(ref_inject, f"inject_{name}")
    want = _vmapped(lambda k, v: ref_fn(k, v, q, bw), keys, x)
    got = getattr(inject, f"inject_{name}")(keys, t(x), q, bw)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    assert (want != x).reshape(TRIALS, -1).sum(axis=1).max() == 1


@pytest.mark.parametrize("q", [53, (1 << 24) - 1])
def test_mof1(keys, q):
    x = _mats(q, 1, (S * S,))
    want = _vmapped(lambda k, v: ref_inject.inject_mof1(k, v, q), keys, x)
    np.testing.assert_array_equal(to_numpy_u32(inject.inject_mof1(keys, t(x), q)), want)


@pytest.mark.parametrize("P", [3, 53])
def test_cle_matrix(keys, P):
    A, B = _mats(P, 2), _mats(P, 3)
    C = (A.astype(np.int64) @ B.astype(np.int64) % P).astype(np.uint32)
    ra, pa = RefArith.make(P), ModArith.make(P)
    want = _vmapped(lambda k, a, b, c: ref_inject.inject_cle_matrix(k, a, b, c, ra), keys, A, B, C)
    got = inject.inject_cle_matrix(keys, t(A), t(B), t(C), pa)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_cle_vector(keys):
    W = 24
    M = (1 << W) - 1
    X, T = _mats(M, 4, (S * S,)), _mats(M, 5, (S * S,))
    Y = (X.astype(np.uint64) * T % M).astype(np.uint32)
    want = _vmapped(lambda k, x, tw, y: ref_inject.inject_cle_vector(k, x, tw, y, M), keys, X, T, Y)
    np.testing.assert_array_equal(to_numpy_u32(inject.inject_cle_vector(keys, t(X), t(T), t(Y), M)),
                                  want)


@pytest.mark.parametrize("code", [inject.CODE_NONE, inject.CODE_SBF, inject.CODE_DBF,
                                  inject.CODE_MLF, inject.CODE_DELTA])
def test_inject_value(keys, code):
    q = 769
    v = _mats(q, 6, ())
    want = _vmapped(lambda k, x: ref_inject.inject_value(x, code, k, q, 10, delta=5), keys, v)
    got = inject.inject_value(t(v), code, keys, q, 10, delta=5)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    # a code per trial
    codes = np.arange(TRIALS) % 5
    want = _vmapped(lambda k, x, c: ref_inject.inject_value(x, c, k, q, 10, delta=5), keys, v, codes)
    got = inject.inject_value(t(v), t(codes), keys, q, 10, delta=5)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("count", [1, 2])
def test_sample_distinct_indices(keys, count):
    want = _vmapped(lambda k: ref_inject.sample_distinct_indices(k, count, 64), keys)
    np.testing.assert_array_equal(inject.sample_distinct_indices(keys, count, 64), want)


@pytest.mark.parametrize("scenario", sorted(inject.SCENARIO_KINDS))
def test_inject_elements(keys, scenario):
    q = 769
    codes = inject.SCENARIO_KINDS[scenario]
    assert codes == ref_inject.SCENARIO_KINDS[scenario]
    x = _mats(q, 7)
    want = _vmapped(lambda k, v: ref_inject.inject_elements(codes, k, v, q, 10), keys, x)
    np.testing.assert_array_equal(to_numpy_u32(inject.inject_elements(codes, keys, t(x), q, 10)),
                                  want)


@pytest.mark.parametrize("kind", ["SBF", "SCF-BF", "MCF-PPE", "DBF", "SCF-MBU", "MCF-CTE",
                                  "MOF1", "MLF"])
def test_inject_kind(keys, kind):
    q = 53
    x = _mats(q, 8)
    want = _vmapped(lambda k, v: ref_inject.inject_kind(kind, k, v, q, 6), keys, x)
    np.testing.assert_array_equal(to_numpy_u32(inject.inject_kind(kind, keys, t(x), q, 6)), want)
    with pytest.raises(ValueError):
        inject.inject_kind("XYZ", keys, t(x), q, 6)


def _same_result(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            assert b[k] == a[k], k


@pytest.mark.parametrize("ftype", campaign.FAULT_TYPES)
def test_three_stage_campaign(ftype):
    """At P = 3, the pbits CSV's smallest prime, every fault type lands
    words at or above q or collides often; the rest of the sweep is held on
    the card (chip_smoke.py phase A)."""
    assert campaign.FAULT_TYPES == ref_campaign.FAULT_TYPES
    want = ref_campaign.three_stage_campaign(ftype, 256, S=8, P=3, W=24, seed=42)
    got = campaign.three_stage_campaign(ftype, 256, S=8, P=3, W=24, seed=42, device="cpu")
    _same_result(want, got)


def test_pbits_reference_now():
    """chip_smoke.py phase A holds two rows of
    results/pbits_W24_N64_T2000.csv (SCF-MBU at pbits 2) against the values
    in its PBITS_REFERENCE_NOW instead of the file's: the reference's
    campaign at the file's own settings (T = 2000) gives those values, and
    the port gives the same."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    P = numth.find_prime_with_bitlen(2, random.Random(42))
    want = ref_campaign.three_stage_campaign("SCF-MBU", 2000, S=8, P=P, W=24, seed=42)
    got = campaign.three_stage_campaign("SCF-MBU", 2000, S=8, P=P, W=24, seed=42, device="cpu")
    _same_result(want, got)
    rows = {("SCF-MBU", "2", str(s + 1)): ["SCF-MBU", "2", str(s + 1), str(want["injected"][s]),
                                           str(want["undetected"][s]),
                                           f"{want['collision_prob'][s]:.6f}"]
            for s in range(3)}
    assert smoke.PBITS_REFERENCE_NOW
    for key, row in smoke.PBITS_REFERENCE_NOW.items():
        assert row == rows[key]
    committed = {tuple(r[:3]): r for r in smoke.committed_rows(smoke.PBITS_CSV)}
    assert [k for k in rows if committed[k] != rows[k]] == sorted(smoke.PBITS_REFERENCE_NOW)


def test_three_stage_campaign_mcf_cle_floor():
    """MCF-CLE at a 6-bit prime: the one fault type with a collision floor."""
    want = ref_campaign.three_stage_campaign("MCF-CLE", 256, S=8, P=53, W=24, seed=7)
    got = campaign.three_stage_campaign("MCF-CLE", 256, S=8, P=53, W=24, seed=7, device="cpu")
    _same_result(want, got)
    assert got["undetected"].sum() > 0


N, Q = 64, 769


@pytest.fixture(scope="module")
def plans():
    return RefPlan.make(N, Q), FourStepPlan.make(N, Q, device="cpu")


# every scenario sampled, and pinned to one stage (the stages cycle)
FOUR_STEP_CASES = ([(sc, None) for sc in campaign.FOUR_STEP_SCENARIOS]
                   + [(sc, i % 3) for i, sc in enumerate(campaign.FOUR_STEP_SCENARIOS)])


@pytest.mark.parametrize("scenario, target", FOUR_STEP_CASES, ids=str)
def test_four_step_trials(plans, scenario, target):
    """Each trial's stage, verdict and four detector flags, against the
    reference's trial under vmap (called eagerly: its campaign jits one
    program per scenario and stage)."""
    ref, plan = plans
    keys = jax.random.split(jax.random.PRNGKey(42), 128)
    stage, det, dets = jax.vmap(
        lambda k: ref_campaign._four_step_trial(k, scenario, ref, 24, target))(keys)
    got = campaign._four_step_trials(np.asarray(keys), scenario, plan, 24, target)
    np.testing.assert_array_equal(got[0], np.asarray(stage))
    np.testing.assert_array_equal(got[1], np.asarray(det))
    np.testing.assert_array_equal(got[2], np.asarray(dets))


@pytest.mark.parametrize("kind, target", [("MOF1", None), ("SBF+DBF", 1)])
def test_four_step_campaign(plans, kind, target):
    ref, plan = plans
    assert campaign._op_counts(plan.n1, plan.n2) == ref_campaign._op_counts(ref.n1, ref.n2)
    want = ref_campaign.four_step_ntt_campaign(kind, 256, N, Q, plan=ref, target_stage=target)
    got = campaign.four_step_ntt_campaign(kind, 256, N, Q, plan=plan, target_stage=target)
    _same_result({k: v for k, v in want.items() if k != "stats"},
                 {k: v for k, v in got.items() if k != "stats"})
    assert got["stats"] == want["stats"]


def test_four_step_scenario_table_rows():
    rows = campaign.four_step_scenario_table(16, N, Q, device="cpu")
    assert [(r["scenario"], r["stage"]) for r in rows] == \
        [(s, st) for s in ref_campaign.FOUR_STEP_SCENARIOS for st in (0, 1, 2)]
    assert all(0.0 <= r["det_rate"] <= 1.0 for r in rows)
