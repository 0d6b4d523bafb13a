"""The port's Pease constant-geometry NTT against rfhe_tpu's: tables,
forward, inverse, negacyclic pair and Galois permutations at n = 16, 256 and
1024 with three 30-bit limbs, tolerance 0; and the dispatch that sends an
`NttPlan` to its own transforms (the hand kernels on a CUDA tensor)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu import numth, oracle
from rfhe_tpu.ops import ntt_pease as ref
from rfhe_tpu.ops.ntt import bit_reverse_indices as ref_bit_reverse
from rfhe_tpu_torch.ops import ntt_pease
from rfhe_tpu_torch.ops.ntt import NttPlan

torch.set_num_threads(1)

NS = (16, 256, 1024)


@pytest.fixture(scope="module", params=NS)
def plans(request):
    n = request.param
    primes = numth.find_ntt_primes(n, 30, 3)
    return n, primes, ref.PeaseNttPlan.make(n, primes), ntt_pease.PeaseNttPlan.make(n, primes, "cpu")


def _x(n, primes, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, (batch, n), dtype=np.uint32) for q in primes], axis=1)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_bit_reverse_copy():
    for n in (2, 16, 1024):
        np.testing.assert_array_equal(ntt_pease.bit_reverse_indices(n), ref_bit_reverse(n))


@pytest.mark.parametrize("table", ["fwd_w", "fwd_w_shoup", "inv_w", "inv_w_shoup", "psi_mont",
                                   "psi_mont_shoup", "psi_inv_n"])
def test_tables(plans, table):
    _, _, rp, tp = plans
    np.testing.assert_array_equal(getattr(tp, table).numpy(),
                                  np.asarray(getattr(rp, table)).astype(np.int64))
    np.testing.assert_array_equal(tp.nu, rp.nu)
    np.testing.assert_array_equal(tp.nu_inv, rp.nu_inv)


def test_cyclic_forward_and_inverse(plans):
    n, primes, rp, tp = plans
    x = _x(n, primes)
    y = ntt_pease.ntt(_t(x), tp)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref.ntt(jnp.asarray(x), rp)).astype(np.int64))
    back = ntt_pease.intt(y, tp)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.intt(jnp.asarray(np.asarray(y, dtype=np.uint32)), rp)).astype(np.int64))


def test_negacyclic_pair(plans):
    n, primes, rp, tp = plans
    x = _x(n, primes, seed=1)
    y = ntt_pease.negacyclic_ntt(_t(x), tp)
    ry = ref.negacyclic_ntt(jnp.asarray(x), rp)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry).astype(np.int64))
    back = ntt_pease.negacyclic_intt(y, tp)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(ref.negacyclic_intt(ry, rp)).astype(np.int64))
    np.testing.assert_array_equal(back.numpy(), x.astype(np.int64))


def test_forward_is_the_ntt_in_slot_order_nu():
    """Slot p holds NTT coefficient nu[p] of the oracle's cyclic NTT."""
    n = 64
    primes = numth.find_ntt_primes(n, 28, 2)
    tp = ntt_pease.PeaseNttPlan.make(n, primes, "cpu")
    x = _x(n, primes, batch=1)[0]
    y = ntt_pease.ntt(_t(x), tp).numpy()
    for li, q in enumerate(primes):
        omega = numth.PrimeCtx.make(q, n).omega
        expect = np.array(oracle.ntt(list(map(int, x[li])), omega, q), dtype=np.int64)
        np.testing.assert_array_equal(y[li], expect[tp.nu])


def test_take_and_slice(plans):
    n, primes, rp, tp = plans
    x = _x(n, primes)[:, [2, 0]]
    y = ntt_pease.negacyclic_ntt(_t(x).contiguous(), tp.take([2, 0]))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(ref.negacyclic_ntt(jnp.asarray(x), rp.take([2, 0]))).astype(np.int64))
    assert tp.slice(2).L == 2 and tp.slice(2).q_arr.tolist() == list(primes[:2])


@pytest.mark.parametrize("g_of", [lambda n: 5, lambda n: 25, lambda n: pow(5, n // 4 - 1, 2 * n),
                                  lambda n: 2 * n - 1])
def test_galois_perm_pease_order(plans, g_of):
    n, _, rp, tp = plans
    g = g_of(n)
    np.testing.assert_array_equal(ntt_pease.galois_perm(tp, g), ref.galois_perm(rp, g))


def test_galois_perm_follows_the_plan_type(plans):
    """An NttPlan gives its own order's permutation; in both orders the
    permutation is the same map of evaluation points."""
    n, primes, _, tp = plans
    plan = NttPlan.make(n, primes, "cpu")
    g = 5
    pk, pp = ntt_pease.galois_perm(plan, g), ntt_pease.galois_perm(tp, g)
    np.testing.assert_array_equal(pk, plan.galois_perm(g))
    # slot p of an order evaluates at exponent 2·nu[p]+1: the permutations
    # pull the same exponent in both orders
    np.testing.assert_array_equal(plan.nu[pk][plan.nu_inv], tp.nu[pp][tp.nu_inv])


def test_dispatch_on_an_ntt_plan(plans):
    """negacyclic_ntt / negacyclic_intt on an NttPlan are its fwd / inv (the
    hand kernels on a CUDA tensor); the Pease and NttPlan outputs are the
    same evaluations in their two slot orders."""
    n, primes, _, tp = plans
    plan = NttPlan.make(n, primes, "cpu")
    x = _t(_x(n, primes, seed=2))
    y = ntt_pease.negacyclic_ntt(x, plan)
    assert torch.equal(y, plan.fwd(x))
    assert torch.equal(ntt_pease.negacyclic_intt(y, plan), plan.inv(y))
    yp = ntt_pease.negacyclic_ntt(x, tp)
    np.testing.assert_array_equal(yp.numpy()[..., tp.nu_inv], y.numpy()[..., plan.nu_inv])


def test_pease_checks_inputs(plans):
    n, primes, _, tp = plans
    with pytest.raises(ValueError):
        ntt_pease.ntt(torch.zeros((2, n), dtype=torch.int64), tp)
    with pytest.raises(TypeError):
        ntt_pease.negacyclic_ntt(torch.zeros((3, n), dtype=torch.int32), tp)
