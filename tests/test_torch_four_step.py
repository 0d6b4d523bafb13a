"""The exact modular matmul, the four-step NTT and the three probe checks of
the port against rfhe_tpu, bit for bit (tolerance 0), on the CPU."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu import numth as ref_numth
from rfhe_tpu.ops.matmul_mod import DigitPlan as RefDigitPlan, matmul_mod as ref_matmul_mod
from rfhe_tpu.protect import checks as ref_checks
from rfhe_tpu.transform.four_step import (FourStepPlan as RefPlan, four_step_intt as ref_intt,
                                          four_step_ntt as ref_ntt,
                                          four_step_ntt_stages as ref_stages)
from rfhe_tpu_torch import numth
from rfhe_tpu_torch.device import to_numpy_u32, to_torch
from rfhe_tpu_torch.ops.matmul_mod import DigitPlan, matmul_mod, matvec_mod
from rfhe_tpu_torch.protect import checks
from rfhe_tpu_torch.transform.four_step import (FourStepPlan, four_step_intt, four_step_ntt,
                                                four_step_ntt_stages)

torch.set_num_threads(1)

RINGS = (16, 64, 128, 256)          # 128: n1 = 8, n2 = 16 (not square)


def t(a):
    return to_torch(np.asarray(a), "cpu")


def test_numth_copies():
    for bits in (2, 6, 10, 14, 22, 30):
        assert numth.find_prime_with_bitlen(bits, random.Random(42)) == \
            ref_numth.find_prime_with_bitlen(bits, random.Random(42))
    for n, bits in ((64, 10), (64, 20), (4096, 30), (128, 14)):
        for neg in (True, False):
            try:
                want = ref_numth.find_ntt_prime(n, bits, negacyclic=neg)
            except ValueError:
                with pytest.raises(ValueError):
                    numth.find_ntt_prime(n, bits, negacyclic=neg)
                continue
            assert numth.find_ntt_prime(n, bits, negacyclic=neg) == want
            assert numth.root_of_unity(n, want) == ref_numth.root_of_unity(n, want)
            assert numth.montgomery_constants(want) == ref_numth.montgomery_constants(want)
    for v in (0, 2, 90, 1 << 20, (1 << 30) + 3):
        assert numth.next_prime_ge(v) == ref_numth.next_prime_ge(v)
    assert numth.generate_crt_primes(8, 28, random.Random(1)) == \
        ref_numth.generate_crt_primes(8, 28, random.Random(1))


@pytest.mark.parametrize("words", ["canonical", "full width"])
@pytest.mark.parametrize("bits", [10, 20, 30, 31])
def test_matmul_mod(words, bits):
    """In-domain words, or words up to 2^(digit_bits·n_digits) of the
    reference's int8 path, capped at 2^32, which its digits read whole;
    batched and broadcast."""
    q = ref_numth.find_ntt_prime(64, bits)
    ref = RefDigitPlan.make(q, ref_numth.montgomery_constants(q)[1])
    plan = DigitPlan(q)
    assert plan.word_mask == (1 << min(32, ref.digit_bits * ref.n_digits)) - 1
    rng = np.random.default_rng(bits)
    hi = q if words == "canonical" else plan.word_mask + 1
    a = rng.integers(0, hi, (3, 24, 40), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, hi, (40, 16), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref_matmul_mod(jnp.asarray(a), jnp.asarray(b), ref))
    np.testing.assert_array_equal(to_numpy_u32(matmul_mod(t(a), t(b), plan)), want)
    v = rng.integers(0, hi, (3, 40), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref_matmul_mod(jnp.asarray(a), jnp.asarray(v)[..., None], ref))[..., 0]
    np.testing.assert_array_equal(to_numpy_u32(matvec_mod(t(a), t(v), plan)), want)


def test_matmul_mod_long_contraction():
    """k = 8192: the reference chunks its contraction; one float64 product
    here stays exact."""
    q = ref_numth.find_ntt_prime(64, 30)
    ref = RefDigitPlan.make(q, ref_numth.montgomery_constants(q)[1])
    plan = DigitPlan(q)
    rng = np.random.default_rng(1)
    a = rng.integers(0, q, (4, 8192), dtype=np.uint32)
    b = rng.integers(0, q, (8192, 3), dtype=np.uint32)
    np.testing.assert_array_equal(to_numpy_u32(matmul_mod(t(a), t(b), plan)),
                                  np.asarray(ref_matmul_mod(jnp.asarray(a), jnp.asarray(b), ref)))


@pytest.fixture(scope="module", params=RINGS)
def plans(request):
    n = request.param
    q = ref_numth.find_ntt_prime(n, 20 if n < 256 else 30)
    return RefPlan.make(n, q), FourStepPlan.make(n, q, device="cpu")


def test_tables(plans):
    ref, plan = plans
    assert (plan.n, plan.n1, plan.n2, plan.q) == (ref.n, ref.n1, ref.n2, ref.q)
    for name in ("W2", "W1T", "T", "T_shoup", "W2i", "W1Ti", "Ti", "Ti_shoup"):
        np.testing.assert_array_equal(to_numpy_u32(getattr(plan, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert plan.digit.word_mask == (1 << min(32, ref.digit.digit_bits * ref.digit.n_digits)) - 1


def test_transforms(plans):
    ref, plan = plans
    x = np.random.default_rng(plan.n).integers(0, plan.q, (3, plan.n), dtype=np.uint32)
    want = np.asarray(ref_ntt(jnp.asarray(x), ref))
    got = four_step_ntt(t(x), plan)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(to_numpy_u32(four_step_intt(got, plan)),
                                  np.asarray(ref_intt(jnp.asarray(want), ref)))
    np.testing.assert_array_equal(to_numpy_u32(four_step_intt(got, plan)), x)
    for a, b in zip(four_step_ntt_stages(t(x), plan), ref_stages(jnp.asarray(x), ref)):
        np.testing.assert_array_equal(to_numpy_u32(a), np.asarray(b))


TRIALS = 16


@pytest.fixture(scope="module")
def probe_case():
    """Stage tensors of TRIALS vectors at n = 64, clean and with one
    element of B1, B2 or Y changed per trial, and per-trial keys."""
    n = 64
    q = ref_numth.find_ntt_prime(n, 20)
    ref, plan = RefPlan.make(n, q), FourStepPlan.make(n, q, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.integers(0, q, (TRIALS, n), dtype=np.uint32)
    A, B1, B2, Y = (np.asarray(s) for s in ref_stages(jnp.asarray(x), ref))
    faulty = []
    for s in (B1, B2, Y):
        f = s.copy().reshape(TRIALS, -1)
        idx = rng.integers(0, n, TRIALS)
        f[np.arange(TRIALS), idx] = (f[np.arange(TRIALS), idx] + rng.integers(1, q, TRIALS)) % q
        faulty.append(f.reshape(s.shape).astype(np.uint32))
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(42), TRIALS))
    return ref, plan, (A, B1, B2, Y), faulty, keys


def _both(ref_fn, port_fn, args, keys):
    want = np.asarray(jax.vmap(lambda *a: ref_fn(*a[:-1], a[-1]))(
        *(jnp.asarray(v) for v in args), jnp.asarray(keys)))
    got = port_fn(*(t(v) for v in args), keys).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def test_stage1_projection_check(probe_case):
    ref, plan, (A, B1, _, _), (B1f, _, _), keys = probe_case
    r = lambda a, b, k: ref_checks.stage1_projection_check(a, b, ref.W2, ref.digit, ref.arith, k)
    p = lambda a, b, k: checks.stage1_projection_check(a, b, plan.W2, plan.digit, plan.arith, k)
    assert _both(r, p, (A, B1), keys).all()
    assert not _both(r, p, (A, B1f), keys).any()


def test_stage2_projection_check(probe_case):
    ref, plan, (_, _, B2, Y), (_, _, Yf), keys = probe_case
    r = lambda b, y, k: ref_checks.stage2_projection_check(b, y, ref.W1T, ref.digit, ref.arith, k)
    p = lambda b, y, k: checks.stage2_projection_check(b, y, plan.W1T, plan.digit, plan.arith, k)
    assert _both(r, p, (B2, Y), keys).all()
    assert not _both(r, p, (B2, Yf), keys).any()


def test_twiddle_inter_check(probe_case):
    ref, plan, (_, B1, B2, _), (_, B2f, _), keys = probe_case
    r = lambda b1, b2, k: ref_checks.twiddle_inter_check(b1, b2, ref.T, ref.arith, k)
    p = lambda b1, b2, k: checks.twiddle_inter_check(b1, b2, plan.T, plan.arith, k)
    assert _both(r, p, (B1, B2), keys).all()
    assert not _both(r, p, (B1, B2f), keys).any()


def test_probe_from_one_key_broadcasts(probe_case):
    """One key for a batch of vectors (the overheads' use): one probe."""
    ref, plan, (A, B1, _, _), _, keys = probe_case
    want = np.asarray(ref_checks.stage1_projection_check(
        jnp.asarray(A), jnp.asarray(B1), ref.W2, ref.digit, ref.arith, jnp.asarray(keys[0])))
    got = checks.stage1_projection_check(t(A), t(B1), plan.W2, plan.digit, plan.arith, keys[0])
    np.testing.assert_array_equal(got.numpy(), want)
