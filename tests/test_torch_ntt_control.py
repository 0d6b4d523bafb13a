"""Port parity: rfhe_tpu_torch.faults.ntt_control against
rfhe_tpu.faults.ntt_control, tolerance 0: the lazy checker's outputs and
verdicts per fault kind (the reference called eagerly, one trial at a time,
the port on a trial axis), a DELTA bucket cancellation, and the campaign's
dicts at n=64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu import numth as ref_numth
from rfhe_tpu.faults import ntt_control as ref
from rfhe_tpu.ops.ntt import NttPlan as RefPlan
from rfhe_tpu_torch import prng
from rfhe_tpu_torch.faults import ntt_control as port
from rfhe_tpu_torch.ops.ntt_stacked import Radix2NttPlan

torch.set_num_threads(1)

N = 64
Q = ref_numth.find_ntt_prime(N, 12, negacyclic=False)
TRIALS = 4


@pytest.fixture(scope="module")
def plans():
    return Radix2NttPlan.make(N, Q, "cpu"), RefPlan.make(N, Q)


def _x(seed, T=TRIALS):
    return np.random.default_rng(seed).integers(0, Q, (T, N)).astype(np.uint32)


def _run_both(plans, xs, seeds, **kw):
    """The port on all trials at once; the reference trial by trial."""
    p, r = plans
    keys = np.stack([prng.PRNGKey(s) for s in seeds])
    y, ok = port.ntt_standard_lazy(torch.from_numpy(xs.astype(np.int64)), p, keys, **kw)
    for t, s in enumerate(seeds):
        rkw = {k: (jnp.asarray(np.asarray(v)[t]) if k in ("mult_ops", "storage_stages")
                   else jnp.asarray(np.asarray(v), dtype=jnp.uint32 if k == "mult_deltas" else None))
               for k, v in kw.items() if k != "storage_kind"}
        if "storage_kind" in kw:
            rkw["storage_kind"] = kw["storage_kind"]
        ry, rok = ref.ntt_standard_lazy(jnp.asarray(xs[t]), r, jax.random.PRNGKey(s), **rkw)
        assert np.array_equal(y[t].numpy(), np.asarray(ry).astype(np.int64)), t
        assert bool(ok[t]) == bool(rok), t
    return y, ok


def test_clean_matches_ntt(plans):
    y, ok = _run_both(plans, _x(0), [0, 1, 2, 3])
    assert bool(ok.all())


@pytest.mark.parametrize("kind", ["SBF", "DBF", "MLF", "DELTA"])
def test_mult_fault_per_kind(plans, kind):
    total = (N // 2) * (N.bit_length() - 1)
    ops = np.random.default_rng(7).integers(-1, total, (TRIALS, 1))
    kw = dict(mult_ops=ops, mult_kinds=[port.KIND_CODES[kind]])
    if kind == "DELTA":
        kw["mult_deltas"] = [321]
    _run_both(plans, _x(1), [10, 11, 12, 13], **kw)


@pytest.mark.parametrize("kind", ["SBF", "DBF", "MLF"])
def test_storage_fault_per_kind(plans, kind):
    stages = np.random.default_rng(8).integers(-1, N.bit_length() - 1, (TRIALS, 2))
    y, ok = _run_both(plans, _x(2), [20, 21, 22, 23], storage_stages=stages, storage_kind=kind)
    assert bool(ok.all())               # storage faults are invisible to the buckets


def test_delta_bucket_cancellation(plans):
    """+δ and −δ in one bucket (ops 0 and B of stage 0) evade the checker;
    in two buckets (ops 0 and 1) they are caught."""
    B = port.lazy_num_buckets(N)
    assert B == ref.lazy_num_buckets(N)
    xs = _x(3, 2)
    delta = 123
    ops = np.array([[0, B], [0, 1]])
    y, ok = _run_both(plans, xs, [0, 0], mult_ops=ops, mult_kinds=[port.KIND_DELTA] * 2,
                      mult_deltas=[delta, Q - delta])
    clean = port.ntt(torch.from_numpy(xs.astype(np.int64)), plans[0])
    assert bool((y != clean).any(dim=-1).all())
    assert ok.tolist() == [True, False]


@pytest.mark.parametrize("scenario, target", [("SBF", "mult"), ("MLF+DBF", "mult"),
                                              ("SBF", "storage"), ("SBF+DBF", "storage")])
def test_campaign_dicts(scenario, target):
    got = port.standard_ntt_campaign(scenario, target, 60, N, Q, seed=5, device="cpu")
    assert got == ref.standard_ntt_campaign(scenario, target, 60, N, Q, seed=5)


def test_tables():
    assert port.SCENARIOS == ref.SCENARIOS
    assert port.KIND_CODES == ref.KIND_CODES
    for n in (4, 64, 128, 4096):
        assert port.lazy_num_buckets(n) == ref.lazy_num_buckets(n)
