"""The port's NTT plan and plain versions against rfhe_tpu's MxuNttPlan (the
XLA path on the CPU) and against the Pallas kernel in interpret mode, bit for
bit; the closed-form definitions of the two kernels on a tiny case; and numpy
emulations of the CUDA kernels' arithmetic on the tables they are given, for
the one-block form and for the two passes of the large-ring form (tile and
chunk indexing, twiddle indices, slot scatter).  Tolerance 0 throughout."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

os.environ.setdefault("RFHE_TPU_PALLAS_INTERPRET", "1")

from rfhe_tpu import numth  # noqa: E402
from rfhe_tpu.ops import ntt_fused  # noqa: E402
from rfhe_tpu.ops.ntt_mxu import MxuNttPlan, _galois_perm_mxu  # noqa: E402
from rfhe_tpu_torch import numth as tnumth  # noqa: E402
from rfhe_tpu_torch.ops.ntt import (  # noqa: E402
    NttPlan, ntt_fwd_reference, ntt_inv_reference, split_n,
)
from rfhe_tpu_torch.ops.ntt_cuda import default_split, large_geometry, large_split  # noqa: E402

torch.set_num_threads(1)

_PLANS = {}


def _plans(n, bits):
    """(reference plan, port plan) over three primes, cached per config."""
    if (n, bits) not in _PLANS:
        primes = numth.find_ntt_primes(n, bits, 3)
        _PLANS[n, bits] = (MxuNttPlan.make(n, primes), NttPlan.make(n, primes, "cpu"))
    return _PLANS[n, bits]


def _residues(primes, shape, seed):
    """Random residues with the first two columns at q-1 and 0."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, shape[:-2] + (shape[-1],), dtype=np.uint32)
                  for q in primes], axis=-2)
    x[..., 0] = np.array(primes, dtype=np.uint32) - 1
    x[..., 1] = 0
    return x


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("bits", [30, 31])
@pytest.mark.parametrize("n", [256, 2048, 4096])
def test_plain_matches_mxu_plan(n, bits, batch):
    ref, plan = _plans(n, bits)
    shape = ((batch,) if batch else ()) + (plan.L, n)
    x = _residues(plan.primes, shape, seed=n + bits)
    y_ref = np.asarray(ref.fwd(jnp.asarray(x)))
    y = plan.fwd(_t(x))
    np.testing.assert_array_equal(y.numpy(), y_ref.astype(np.int64))
    x_ref = np.asarray(ref.inv(jnp.asarray(y_ref)))
    np.testing.assert_array_equal(plan.inv(y).numpy(), x_ref.astype(np.int64))
    np.testing.assert_array_equal(x_ref, x)


@pytest.mark.parametrize("n", [256, 2048])
def test_take_non_contiguous(n):
    ref, plan = _plans(n, 30)
    idx = [2, 0]
    sub, sub_ref = plan.take(idx), ref.take(np.array(idx))
    assert sub.primes == tuple(int(q) for q in np.asarray(sub_ref.q_arr))
    assert sub.take([1]).primes == (plan.primes[0],)
    x = _residues(sub.primes, (2, 2, n), seed=5)
    y = sub.fwd(_t(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(sub_ref.fwd(jnp.asarray(x))).astype(np.int64))
    np.testing.assert_array_equal(sub.inv(y).numpy(), x.astype(np.int64))
    assert plan.slice(2) is plan.take([0, 1])          # views are cached


@pytest.mark.parametrize("n", [16, 256, 2048, 4096])
def test_split_slot_order_and_galois_perm(n):
    primes = numth.find_ntt_primes(n, 30, 1)
    ref = MxuNttPlan.make(n, primes) if n <= 256 else None
    plan = NttPlan.make(n, primes, "cpu")
    n1, n2 = split_n(n)
    if ref is not None:
        assert (n1, n2) == (ref.n1, ref.n2)
        np.testing.assert_array_equal(plan.nu, ref.nu)
    for g in (5, 25, pow(5, 7, 2 * n), 2 * n - 1):
        np.testing.assert_array_equal(plan.galois_perm(g), _galois_perm_mxu(n, n1, g))


@pytest.mark.skipif(not ntt_fused._INTERPRET, reason="interpret mode disabled by env")
def test_plain_matches_pallas_kernel_interpret():
    """The Pallas kernels K1/K2 themselves (interpret mode) at n=256."""
    ref, plan = _plans(256, 30)
    x = _residues(plan.primes, (3, plan.L, 256), seed=11)
    y_k = np.asarray(ref.fused.fwd(jnp.asarray(x)))
    y = plan.fwd(_t(x))
    np.testing.assert_array_equal(y.numpy(), y_k.astype(np.int64))
    x_k = np.asarray(ref.fused.inv(jnp.asarray(y_k)))
    np.testing.assert_array_equal(plan.inv(y).numpy(), x_k.astype(np.int64))


def test_closed_form_definitions():
    """K1/K2 as stated: y[p] = R·Σ_t x[t]·ψ^((2nu[p]+1)t), and the inverse with
    n⁻¹·R⁻¹, with Python ints at n=16."""
    n = 16
    primes = numth.find_ntt_primes(n, 30, 2)
    plan = NttPlan.make(n, primes, "cpu")
    x = _residues(primes, (plan.L, n), seed=3)
    y = plan.fwd(_t(x)).numpy()
    back = plan.inv(_t(y)).numpy()
    for l, q in enumerate(primes):
        psi = numth.PrimeCtx.make(q, n).psi
        R = (1 << 32) % q
        for p in range(n):
            e = 2 * int(plan.nu[p]) + 1
            want = R * sum(int(x[l, t]) * pow(psi, e * t, q) for t in range(n)) % q
            assert y[l, p] == want
        scale = pow(n, -1, q) * pow(R, -1, q)
        for t in range(n):
            want = scale * sum(int(y[l, p]) * pow(psi, -(2 * int(plan.nu[p]) + 1) * t, q)
                               for p in range(n)) % q
            assert back[l, t] == want == x[l, t]


_M32 = np.uint64(0xFFFFFFFF)


def _shoup(v, w, ws, q):
    hi = (v * ws) >> np.uint64(32)
    r = (v * w - hi * q) & _M32
    return np.where(r >= q, r - q, r)


def _ct(a, j1, j2, w, ws, q):
    """Cooley-Tukey butterflies in place on the uint32-valued vector a."""
    u, v = a[j1].copy(), _shoup(a[j2], w, ws, q)
    a[j1] = np.where(u + v >= q, u + v - q, u + v)
    a[j2] = np.where(u >= v, u - v, u + q - v)


def _gs(a, j1, j2, w, ws, q):
    """Gentleman-Sande butterflies in place."""
    u, v = a[j1].copy(), a[j2].copy()
    a[j1] = np.where(u + v >= q, u + v - q, u + v)
    a[j2] = _shoup(np.where(u >= v, u - v, u + q - v), w, ws, q)


def _packed(plan):
    t = plan.tables
    return (t.kernel_tw.numpy().view(np.uint32).astype(np.uint64),
            t.kernel_consts.numpy().view(np.uint32).astype(np.uint64))


def _emulate_kernel(x, plan, inverse):
    """The one-block CUDA kernels' arithmetic in numpy: uint32 Shoup
    butterflies on the packed tables kernel_tw/kernel_consts/kernel_pos,
    indexed by limb id."""
    tw, cs = _packed(plan)
    pos = plan.tables.kernel_pos.numpy()
    n, log_n = plan.n, plan.log_n
    k = np.arange(n // 2)
    out = np.empty_like(x)
    for b in range(x.shape[0]):
        for l, lid in enumerate(plan.limb_ids32.numpy()):
            q = cs[lid, 0]
            a = np.empty(n, dtype=np.uint64)
            if inverse:
                a[pos] = x[b, l].astype(np.uint64)
            else:
                a[:] = x[b, l].astype(np.uint64)
            for s in range(log_n):
                if inverse:
                    i, half, widx = k >> s, 1 << s, (1 << (log_n - 1 - s)) + (k >> s)
                else:
                    hs = log_n - 1 - s
                    i, half, widx = k >> hs, 1 << hs, (1 << s) + (k >> hs)
                j1 = i * 2 * half + (k & (half - 1))
                if inverse:
                    _gs(a, j1, j1 + half, tw[lid, 2, widx], tw[lid, 3, widx], q)
                else:
                    _ct(a, j1, j1 + half, tw[lid, 0, widx], tw[lid, 1, widx], q)
            if inverse:
                out[b, l] = _shoup(a, cs[lid, 3], cs[lid, 4], q)
            else:
                out[b, l] = _shoup(a[pos], cs[lid, 1], cs[lid, 2], q)
    return out


def _emulate_col_pass(src, dst, plan, lid, log_na, log_c, inverse):
    """One limb of the large-ring column pass, block by block: a tile of C
    adjacent columns x na rows, a size-na network down each column.  The
    forward pass reads residues and writes the intermediate; the inverse
    reads the intermediate and writes residues scaled by n^-1 R^-1."""
    tw, cs = _packed(plan)
    log_nb = plan.log_n - log_na
    q = cs[lid, 0]
    tile = 1 << (log_na + log_c)
    t = np.arange(tile)
    addr = ((t >> log_c) << log_nb) + (t & ((1 << log_c) - 1))
    k = np.arange(tile // 2)
    kr, cc = k >> log_c, k & ((1 << log_c) - 1)
    for blk in range(1 << (log_nb - log_c)):
        c0 = blk << log_c
        a = src[c0 + addr].astype(np.uint64)
        for s in range(log_na):
            if inverse:                      # stage log_nb + s, half 2^s rows
                i, half, widx = kr >> s, s, (1 << (log_na - 1 - s)) + (kr >> s)
            else:
                hs = log_na - 1 - s
                i, half, widx = kr >> hs, hs, (1 << s) + (kr >> hs)
            r1 = (i << (half + 1)) + (kr & ((1 << half) - 1))
            j1 = (r1 << log_c) + cc
            j2 = j1 + (1 << (half + log_c))
            if inverse:
                _gs(a, j1, j2, tw[lid, 2, widx], tw[lid, 3, widx], q)
            else:
                _ct(a, j1, j2, tw[lid, 0, widx], tw[lid, 1, widx], q)
        dst[c0 + addr] = _shoup(a, cs[lid, 3], cs[lid, 4], q) if inverse else a


def _emulate_row_pass(src, dst, plan, lid, log_na, log_chunk, inverse):
    """One limb of the large-ring row pass, block by block: a chunk of whole
    rows, the stages with half-size < nb on butterfly indices of the whole
    vector.  The forward pass scatters slot pos_inv[j] scaled by R; the
    inverse gathers through pos_inv."""
    tw, cs = _packed(plan)
    pos_inv = plan.tables.kernel_pos_inv.numpy()
    log_n = plan.log_n
    q = cs[lid, 0]
    chunk = 1 << log_chunk
    t, kl = np.arange(chunk), np.arange(chunk // 2)
    for blk in range(1 << (log_n - log_chunk)):
        base = blk << log_chunk
        k = (base >> 1) + kl
        if inverse:
            a = src[pos_inv[base + t]].astype(np.uint64)
            for s in range(log_n - log_na):
                i = k >> s
                j1 = (i << (s + 1)) + (k & ((1 << s) - 1)) - base
                widx = (1 << (log_n - 1 - s)) + i
                _gs(a, j1, j1 + (1 << s), tw[lid, 2, widx], tw[lid, 3, widx], q)
            dst[base + t] = a
        else:
            a = src[base + t].astype(np.uint64)
            for s in range(log_na, log_n):
                hs = log_n - 1 - s
                i = k >> hs
                j1 = (i << (hs + 1)) + (k & ((1 << hs) - 1)) - base
                widx = (1 << s) + i
                _ct(a, j1, j1 + (1 << hs), tw[lid, 0, widx], tw[lid, 1, widx], q)
            dst[pos_inv[base + t]] = _shoup(a, cs[lid, 1], cs[lid, 2], q)


def _emulate_large(x, plan, inverse, log_na):
    """The large-ring form: column pass, uint32 intermediate, row pass
    (mirrored for the inverse), with the wrapper's tile geometry."""
    log_c, log_chunk = large_geometry(plan.log_n, log_na)
    out = np.empty_like(x)
    for b in range(x.shape[0]):
        for l, lid in enumerate(plan.limb_ids32.numpy()):
            tmp = np.empty(plan.n, dtype=np.uint64)
            res = np.empty(plan.n, dtype=np.uint64)
            if inverse:
                _emulate_row_pass(x[b, l], tmp, plan, lid, log_na, log_chunk, True)
                _emulate_col_pass(tmp, res, plan, lid, log_na, log_c, True)
            else:
                _emulate_col_pass(x[b, l], tmp, plan, lid, log_na, log_c, False)
                _emulate_row_pass(tmp, res, plan, lid, log_na, log_chunk, False)
            assert tmp.max() < (1 << 32)
            out[b, l] = res
    return out


@pytest.mark.parametrize("bits", [30, 31])
def test_cuda_kernel_arithmetic_emulated(bits):
    """The kernels' table packing, limb-id indexing and Shoup arithmetic,
    emulated on a non-contiguous take, equal the plain versions."""
    _, plan = _plans(256, bits)
    sub = plan.take([2, 0])
    x = _residues(sub.primes, (2, sub.L, 256), seed=bits)
    y = sub.fwd(_t(x)).numpy()
    np.testing.assert_array_equal(_emulate_kernel(x.astype(np.int64), sub, False), y)
    np.testing.assert_array_equal(_emulate_kernel(y, sub, True), x.astype(np.int64))


@pytest.mark.parametrize("n, bits, log_na", [
    (256, 30, 1), (256, 31, 5), (256, 30, 7),
    (4096, 31, 6), (4096, 30, 9),
])
def test_large_ring_passes_emulated(n, bits, log_na):
    """The two passes of the large-ring kernels (tile/chunk indexing, twiddle
    indices, the slot scatter through pos_inv) emulated on a non-contiguous
    take, against the plain versions and against rfhe_tpu's MxuNttPlan."""
    ref, plan = _plans(n, bits)
    sub, sub_ref = plan.take([2, 0]), ref.take(np.array([2, 0]))
    x = _residues(sub.primes, (2, sub.L, n), seed=n + log_na).astype(np.int64)
    y = ntt_fwd_reference(_t(x), sub).numpy()
    np.testing.assert_array_equal(_emulate_large(x, sub, False, log_na), y)
    np.testing.assert_array_equal(y, np.asarray(sub_ref.fwd(jnp.asarray(x.astype(np.uint32)))))
    back = _emulate_large(y, sub, True, log_na)
    np.testing.assert_array_equal(back, ntt_inv_reference(_t(y), sub).numpy())
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("n, want, large", [(4096, 0, 6), (8192, 0, 7), (16384, 0, 7),
                                            (32768, 8, 8), (65536, 8, 8)])
def test_default_split_and_geometry(n, want, large):
    """Rings up to 16384 take the one-block form by themselves.  The
    large-ring form's own split has nb equal to the slot order's n1, and its
    pass tiles fit 32 KB of shared memory."""
    assert default_split(n) == want and large_split(n) == large
    log_n = n.bit_length() - 1
    if n >= 16384:
        assert n >> large == split_n(n)[0]
    log_c, log_chunk = large_geometry(log_n, large)
    assert (1 << (large + log_c)) * 4 <= 32768 and (1 << log_chunk) * 4 <= 32768
    assert log_c <= log_n - large <= log_chunk <= log_n
    for bad in (0, 14):
        with pytest.raises(ValueError):
            large_geometry(14, bad)


@pytest.mark.parametrize("n, bits", [(1024, 30), (4096, 28), (4096, 31)])
def test_numth_copy_matches_reference(n, bits):
    primes = numth.find_ntt_primes(n, bits, 4)
    assert tnumth.find_ntt_primes(n, bits, 4) == primes
    for q in primes:
        assert tnumth.psi_negacyclic(n, q) == numth.PrimeCtx.make(q, n).psi
        assert tnumth.shoup_precompute(q - 1, q) == numth.shoup_precompute(q - 1, q)
    assert tnumth.crt_constants(primes) == numth.crt_constants(primes)
