"""The port's detector layer against rfhe_tpu on the same numpy inputs,
tolerance 0: modular sums, the four folds, the exact sums, the checked
Montgomery product (clean, with its product or its output corrupted), the
Barrett range windows, the fold and matmul checksums, the base-conversion
checksum pair and the NttGuard tables, checks and transposed probes.  Words
go up to 2^32 where the reference takes them (faulted values are not
canonical)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu import numth as ref_numth
from rfhe_tpu.ops import u32
from rfhe_tpu.ops.modring import ModArith as RefArith, sum_mod as ref_sum_mod
from rfhe_tpu.ops.ntt_mxu import MxuNttPlan
from rfhe_tpu.protect import checks as rc
from rfhe_tpu.protect import fold as rf
from rfhe_tpu.protect.ntt_guard import NttGuard as RefGuard
from rfhe_tpu_torch import numth
from rfhe_tpu_torch.ops.modring import ModArith, sum_mod
from rfhe_tpu_torch.ops.ntt import NttPlan
from rfhe_tpu_torch.protect import checks as tc
from rfhe_tpu_torch.protect import fold as tf
from rfhe_tpu_torch.protect.ntt_guard import NttGuard

torch.set_num_threads(1)

N = 256
PRIMES = tuple(ref_numth.find_ntt_primes(N, 30, 2)) + tuple(ref_numth.find_ntt_primes(N, 31, 1))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def _same(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref).astype(np.asarray(port).dtype))


def _words(rng, shape):
    """Words below 2^32 with the extremes 0 and 2^32 - 1 in them."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.int64)
    w.reshape(-1)[:2] = (0, (1 << 32) - 1)
    return w


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


@pytest.mark.parametrize("axis, length", [(-1, N), (1, 5), (1, 1)])
def test_sum_mod(rng, axis, length):
    """Any words below 2^32 along an axis of 256, 5 and 1 (which the reference
    returns unreduced)."""
    shape = (3, length, N) if axis == 1 else (3, 5, length)
    x = _words(rng, shape)
    q = np.array(PRIMES, dtype=np.uint64)[:, None]
    _same(sum_mod(_t(x), _t(q), axis=axis), ref_sum_mod(_j(x), jnp.asarray(q.astype(np.uint32)), axis=axis))
    _same(sum_mod(_t(x), PRIMES[2], axis=axis), ref_sum_mod(_j(x), PRIMES[2], axis=axis))


@pytest.mark.parametrize("w", [2, 7, 16, 24])
def test_folds(rng, w):
    """fold_u32, fold_u64, fold_2s1_u32 and fold_2s1_u64 on any words."""
    hi, lo = _words(rng, (4, N)), _words(rng, (4, N))
    _same(tf.fold_u32(_t(lo), w), rf.fold_u32(_j(lo), w))
    _same(tf.fold_2s1_u32(_t(lo), w), rf.fold_2s1_u32(_j(lo), w))
    _same(tf.fold_u64(_t(hi), _t(lo), w), rf.fold_u64(_j(hi), _j(lo), w))
    _same(tf.fold_2s1_u64(_t(hi), _t(lo), w), rf.fold_2s1_u64(_j(hi), _j(lo), w))


def test_mul32_parts_and_sum_u64_exact(rng):
    a, b = _words(rng, (2, N)), _words(rng, (2, N))
    for port, ref in zip(tf.mul32_parts(_t(a), _t(b)), u32.mul32_parts(_j(a), _j(b))):
        _same(port, ref)
    for port, ref in zip(tc.sum_u64_exact(_t(a)), rc.sum_u64_exact(_j(a))):
        _same(port, ref)


def _mont_ref(hi, lo, q, qinv):
    """The reference's Montgomery reduction of a 64-bit (hi, lo), as
    `mont_mul_checked` runs it (`checks.py:214-219`)."""
    m = lo * qinv
    mq_hi, _ = u32.mul32_parts(m, q)
    t = hi + mq_hi + (lo != 0).astype(jnp.uint32)
    return jnp.where(t >= q, t - q, t)


def test_mont_mul_checked(rng):
    """Clean (a any word, b < q), with one product bit flipped (caught by the
    fold check), with one output bit flipped (caught by the range window
    where the word leaves [0, q))."""
    qs = np.array(PRIMES, dtype=np.uint64)[:, None]
    qinv = np.array([ref_numth.montgomery_constants(int(q), 32)[1] for q in PRIMES],
                    dtype=np.uint32)[:, None]
    rinv = np.array([pow((1 << 32) % int(q), -1, int(q)) for q in PRIMES])[:, None]
    a = _words(rng, (3, N))
    b = rng.integers(0, 1 << 62, (3, N)) % qs.astype(np.int64)
    qj, qinvj = jnp.asarray(qs.astype(np.uint32)), jnp.asarray(qinv)
    out, ok = tc.mont_mul_checked(_t(a), _t(b), _t(qs), _t(rinv))
    r_out, r_ok = rc.mont_mul_checked(_j(a), _j(b), qj, qinvj)
    _same(out, r_out)
    _same(ok, r_ok)
    assert bool(ok.all())
    # one product bit flipped, a < q so that the flipped product stays under q·2^32
    a = rng.integers(0, 1 << 62, (3, N)) % qs.astype(np.int64)
    bit = rng.integers(0, 40, (3, N))
    prod = a * b ^ (np.int64(1) << bit)
    out, ok = tc.mont_mul_checked_product(_t(a), _t(b), _t(prod), _t(qs), _t(rinv))
    hi, lo = _j(prod >> 32), _j(prod & 0xFFFFFFFF)
    r_out = _mont_ref(hi, lo, qj, qinvj)
    fa, fb = rf.fold_2s1_u32(_j(a), 16), rf.fold_2s1_u32(_j(b), 16)
    r_ok = (rf.fold_2s1_u64(*u32.mul32_parts(fa, fb), 16) == rf.fold_2s1_u64(hi, lo, 16)) & (r_out < qj)
    _same(out, r_out)
    _same(ok, r_ok)
    assert not bool(ok.any())
    # one output bit flipped
    out, ok = tc.mont_mul_checked(_t(a), _t(b), _t(qs), _t(rinv))
    flipped = out ^ (torch.ones_like(out) << _t(rng.integers(0, 32, (3, N))))
    r_flipped = _j(flipped.numpy())
    _same(ok & (flipped < _t(qs)), rc.mont_mul_checked(_j(a), _j(b), qj, qinvj)[1] & (r_flipped < qj))


def test_intra_fold_product_check(rng):
    a, b = _words(rng, (2, N)), _words(rng, (2, N))
    hi, lo = u32.mul32_parts(_j(a), _j(b))
    hi, lo = np.asarray(hi).astype(np.int64), np.asarray(lo).astype(np.int64)
    lo[0, 5] ^= 1 << 7
    for s in (8, 16):
        _same(tc.intra_fold_product_check(_t(a), _t(b), _t(hi), _t(lo), s),
              rc.intra_fold_product_check(_j(a), _j(b), _j(hi), _j(lo), s))


@pytest.mark.parametrize("q", [PRIMES[0], PRIMES[2]])
def test_barrett_range_protected(rng, q):
    """x < q^2 reduces inside both windows; a flipped high word leaves the
    pre-subtraction window."""
    mu, k = ref_numth.barrett_constants(q)
    x = rng.integers(0, q, (2, N)) * rng.integers(0, q, (2, N))
    hi, lo = x >> 32, x & 0xFFFFFFFF
    hi_bad = hi ^ (np.int64(1) << rng.integers(0, 32, (2, N)))
    for h in (hi, hi_bad):
        for port, ref in zip(tc.barrett_range_protected(_t(h), _t(lo), q, mu, k),
                             rc.barrett_range_protected(_j(h), _j(lo), q, mu, k)):
            _same(port, ref)


@pytest.mark.parametrize("w", [12, 24])
def test_elementwise_fold_check(rng, w):
    M = (1 << w) - 1
    X, T = _words(rng, (3, N)), _words(rng, (3, N))
    Y = (X % M) * (T % M) % M
    Y[1, 9] ^= 1 << 3
    _same(tc.elementwise_fold_check(_t(X), _t(T), _t(Y), w), rc.elementwise_fold_check(_j(X), _j(T), _j(Y), w))


def test_matmul_check(rng):
    q = PRIMES[0]
    A = rng.integers(0, q, (2, 8, 6))
    B = rng.integers(0, q, (2, 6, 5))
    C = np.einsum("bik,bkj->bij", A.astype(object), B.astype(object)) % q
    C = C.astype(np.int64)
    C[1, 2, 3] = (C[1, 2, 3] + 1) % q
    _same(tc.matmul_check(_t(A), _t(B), _t(C), ModArith.make(q)),
          rc.matmul_check(_j(A), _j(B), _j(C), RefArith.make(q)))


def test_mod_arith(rng):
    q = PRIMES[1]
    a, b = rng.integers(0, q, N), rng.integers(0, q, N)
    mine, ref = ModArith.make(q), RefArith.make(q)
    for op in ("add", "sub", "mul", "mont_mul", "dot"):
        _same(getattr(mine, op)(_t(a), _t(b)), getattr(ref, op)(_j(a), _j(b)))
    _same(mine.neg(_t(a)), ref.neg(_j(a)))
    _same(mine.sum(_t(a)), ref.sum(_j(a)))


def test_baseconv_checksum_pair(rng):
    moduli = list(PRIMES)
    res = np.stack([rng.integers(0, q, (2, N)) for q in moduli], axis=-2)      # (2, 3, N)
    app = tc.baseconv_append_checksum(_t(res), moduli)
    _same(app, rc.baseconv_append_checksum(_j(res), moduli))
    bad = app.clone()
    bad[1, 2, 40] ^= 1 << 11
    for x in (app, bad):
        _same(tc.baseconv_ecc_check(x, moduli), rc.baseconv_ecc_check(_j(x.numpy()), moduli))


def test_twiddle_collision_model(rng):
    B = rng.integers(0, PRIMES[0], (2, 16, 16))
    Bf = B.copy()
    Bf[0, 3, 4] ^= 1 << 5
    Bf[1, 0, 0] += (1 << 24) + 1                       # a collision of the 24-bit fold
    _same(tc.twiddle_collision_model(_t(B), _t(Bf)), rc.twiddle_collision_model(_j(B), _j(Bf)))


@pytest.fixture(scope="module")
def guards():
    ref_plan = MxuNttPlan.make(N, PRIMES)
    plan = NttPlan.make(N, PRIMES, "cpu")
    return ref_plan, RefGuard.make(ref_plan), plan, NttGuard.make(plan)


def test_psi_matches_prime_ctx():
    """The guard's ψ (numth.psi_negacyclic) is the reference's PrimeCtx.psi
    on the chains the guard is built for."""
    for n in (256, 1024, 4096, 65536):
        for q in ref_numth.find_ntt_primes(n, 30, 2) + ref_numth.find_ntt_primes(n, 31, 1):
            assert numth.psi_negacyclic(n, q) == ref_numth.PrimeCtx.make(q, n).psi


def test_guard_tables(guards):
    ref_plan, ref_g, plan, g = guards
    np.testing.assert_array_equal(plan.nu_inv, ref_plan.nu_inv)
    for name, ref_name in (("phi_mont", "phi_mont"), ("vf_mont", "vf_mont"),
                           ("vi_mont", "vi_mont"), ("psi_inv", "psi_inv"), ("dmont", "dmont")):
        _same(getattr(g, name), getattr(ref_g, ref_name))
    sub = g.take([2, 0])
    _same(sub.vf_mont, ref_g.take([2, 0]).vf_mont)
    _same(g.slice(2).q_arr, ref_g.slice(2).q_arr)


def test_guard_checks(rng, guards):
    """check_fwd/check_inv on a transform pair, on a corrupted output and on a
    non-canonical input word."""
    ref_plan, ref_g, plan, g = guards
    q = np.array(PRIMES, dtype=np.int64)[:, None]
    x = rng.integers(0, 1 << 62, (2, 3, N)) % q
    y = plan.fwd(_t(x)).numpy()
    y_bad, x_odd = y.copy(), x.copy()
    y_bad[1, 2, 100] ^= 1 << 4
    x_odd[0, 0, 3] |= 1 << 30
    for xi, yi in ((x, y), (x, y_bad), (x_odd, y)):
        _same(g.check_fwd(_t(xi), _t(yi)), ref_g.check_fwd(_j(xi), _j(yi)))
        _same(g.check_inv(_t(yi), _t(xi)), ref_g.check_inv(_j(yi), _j(xi)))
    assert bool(g.check_fwd(_t(x), _t(y)).all()) and not bool(g.check_fwd(_t(x), _t(y_bad)).all())


def test_transpose_probe(rng, guards):
    """V = Mᵀu for a probe of two polynomials over a take of the limbs; and
    its defining identity Σ mont(V, x) == Σ mont(u, fwd(x))."""
    ref_plan, ref_g, plan, g = guards
    take = [2, 0]
    q = np.array([PRIMES[i] for i in take], dtype=np.int64)[:, None]
    u = rng.integers(0, 1 << 62, (2, 2, N)) % q
    V = g.take(take).transpose_probe(plan.take(take), _t(u))
    _same(V, ref_g.take(take).transpose_probe(ref_plan.take(np.array(take)), _j(u)))
    x = rng.integers(0, 1 << 62, (2, 2, N)) % q
    gt = g.take(take)
    lhs = gt._dot(V, _t(x))
    rhs = gt._dot(_t(u), plan.take(take).fwd(_t(x)))
    assert torch.equal(lhs, rhs)


@pytest.mark.parametrize("domain", ["b < q", "b >= q", "any words"])
def test_mont_mul_checked_off_domain(rng, domain):
    """The checked product gives the reference's REDC word and flag for any
    a, b below 2^32, b at or above q included (where the reference's word
    wraps and is not a·b·R^-1 mod q).  The first case is the one the
    roadmap's fault record names: q = 1073731073, a = 3243419750,
    b = 1771810112, which gives 1315141112 with the flag false.  On b < q
    the unchecked `modarith.mont_mul` is the reference's too."""
    q = 1073731073
    qinv = ref_numth.montgomery_constants(q, 32)[1]
    rinv = pow((1 << 32) % q, -1, q)
    a = _words(rng, (4, N))
    lo, hi = {"b < q": (0, q), "b >= q": (q, 1 << 32), "any words": (0, 1 << 32)}[domain]
    b = rng.integers(lo, hi, (4, N), dtype=np.int64)
    if domain == "b >= q":
        a[0, 0], b[0, 0] = 3243419750, 1771810112
        b[0, 1] = (1 << 32) - 1
    # a product whose low word is 0, and one whose low word is q
    a[1, :2], b[1, :2] = (1 << 16, q), (1 << 16, 1 if domain != "b >= q" else q + 1)
    out, ok = tc.mont_mul_checked(_t(a), _t(b), q, rinv)
    r_out, r_ok = rc.mont_mul_checked(_j(a), _j(b), q, qinv)
    _same(out, r_out)
    _same(ok, r_ok)
    if domain == "b >= q":
        assert (int(out[0, 0]), bool(ok[0, 0])) == (1315141112, False)
    if domain == "b < q":
        from rfhe_tpu_torch.ops.modarith import mont_mul
        _same(mont_mul(_t(a), _t(b), q, rinv), u32.mont_mul(_j(a), _j(b), q, qinv))
        assert bool(ok.all())


@pytest.mark.parametrize("q", [15361, 61441, 786433, PRIMES[2]])
def test_barrett_word(rng, q):
    """The reference's Barrett word of any value below 2^62, also of a
    product c·(q_src⁻¹ mod t) far above t² (BGV's t-mode lift), where the
    word is congruent to the value but not reduced."""
    from rfhe_tpu_torch.ops.modarith import barrett_word
    mu, k = ref_numth.barrett_constants(q)
    x = rng.integers(0, 1 << 62, (2, N), dtype=np.int64)
    x[0, :3] = (0, q * q - 1, (1 << 62) - 1)
    x[1] = rng.integers(0, PRIMES[0], N, dtype=np.int64) * pow(PRIMES[0], -1, q)
    want = u32.barrett_reduce64(_j(x >> 32), _j(x & 0xFFFFFFFF), q, mu, k)
    got = barrett_word(_t(x), q, mu, k)
    _same(got, want)
    assert bool(((got[1] - _t(x[1])) % q == 0).all())      # the t-mode range stays congruent
