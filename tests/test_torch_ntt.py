"""The port's NTT plan and plain versions against rfhe_tpu's MxuNttPlan (the
XLA path on the CPU) and against the Pallas kernel in interpret mode, bit for
bit; the closed-form definitions of the two kernels on a tiny case; and numpy
emulations of the CUDA kernels' arithmetic on the tables they are given, for
the one-block form and, thread by thread, for the large-ring kernels (register
rounds and their twiddle slots, exchange layouts, polynomial groups, the
closed-form slot store, the cluster's exchange).  Tolerance 0 throughout."""
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
from rfhe_tpu_torch.ops.ntt import _bit_reverse, slot_of_position  # noqa: E402
from rfhe_tpu_torch.ops.ntt_cuda import (  # noqa: E402
    CLUSTER, TWO_PASS, cluster_geometry, default_split, large_geometry, large_passes,
    large_split, poly_groups, resident_ctas, resolve_split,
)

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


# ---- the large-ring kernels, thread by thread --------------------------------
# Mirrors of the device functions of csrc/ntt.cu, vectorised over the threads
# of a CTA: `a` is (threads, 16), the registers of every thread.


def _stage_mask(hb, h_lo, h_hi):
    return sum(1 << t for t in range(4) if h_lo <= hb + 3 - t <= h_hi)


def _load_tw(tw, lid, inverse, log_n, j0, hb, mask):
    """(w, w') of the 15 twiddle slots of a round on elements j0 + (e << hb),
    for every j0 of the array: (len(j0), 15) each."""
    j0 = np.asarray(j0)
    w = np.zeros((len(j0), 15), dtype=np.uint64)
    ws = np.zeros_like(w)
    for k in range(15):
        t = (k + 1).bit_length() - 1
        if not (mask >> t) & 1:
            continue
        e = (k + 1 - (1 << t)) << (4 - t)
        h = hb + 3 - t
        idx = (1 << (log_n - 1 - h)) + ((j0 + (e << hb)) >> (h + 1))
        w[:, k], ws[:, k] = tw[lid, 2 * inverse, idx], tw[lid, 2 * inverse + 1, idx]
    return w, ws


def _round(a, tw, mask, q, inverse):
    """Up to four stages on the 16 registers of every thread: Cooley-Tukey at
    distance 8, 4, 2, 1, or Gentleman-Sande at 1, 2, 4, 8.  For q < 2^30 the
    lazy butterflies: 32-bit wrap-around arithmetic, residues in [0, 4q)
    (forward) or [0, 2q) (inverse), no correction after the Shoup product."""
    w, ws = tw
    lazy, q2 = q < (1 << 30), 2 * q
    wrap = lambda v: v & _M32
    lazy_mul = lambda v, slot: wrap(v * w[:, slot] - ((v * ws[:, slot]) >> np.uint64(32)) * q)
    for t in (range(3, -1, -1) if inverse else range(4)):
        if not (mask >> t) & 1:
            continue
        d = 8 >> t
        for k in range(8):
            g = k >> (3 - t)
            e = (g << (4 - t)) + (k & (d - 1))
            slot = (1 << t) - 1 + g
            u, v = a[:, e].copy(), a[:, e + d].copy()
            if lazy and inverse:
                assert max(u.max(), v.max()) < q2
                total = u + v
                a[:, e] = np.minimum(total, wrap(total - q2))
                a[:, e + d] = lazy_mul(wrap(u - v + q2), slot)
            elif lazy:
                assert max(u.max(), v.max()) < 2 * q2
                u = np.minimum(u, wrap(u - q2))
                v = lazy_mul(v, slot)
                a[:, e], a[:, e + d] = u + v, wrap(u - v + q2)
            elif inverse:
                diff = np.where(u >= v, u - v, u + q - v)
                a[:, e + d] = _shoup(diff, w[:, slot], ws[:, slot], q)
                a[:, e] = np.where(u + v >= q, u + v - q, u + v)
            else:
                v = _shoup(v, w[:, slot], ws[:, slot], q)
                a[:, e + d] = np.where(u >= v, u - v, u + q - v)
                a[:, e] = np.where(u + v >= q, u + v - q, u + v)


_E = np.arange(16)
_SENTINEL = np.uint64(1 << 40)


class _Exchange:
    """A shared-memory buffer: every word read must have been written."""

    def __init__(self, words):
        self.words = np.full(words, _SENTINEL)

    def write(self, idx, vals):
        assert len(np.unique(idx)) == idx.size            # no two threads on one word
        self.words[idx] = vals

    def read(self, idx):
        out = self.words[idx]
        assert (out != _SENTINEL).all()
        return out


class _Col:
    """The column phase of one CTA: thread (xr, c), c fastest."""

    def __init__(self, plan, lid, log_na, log_c, inverse):
        tw, cs = _packed(plan)
        self.log_n, self.S, self.log_c, self.inverse = plan.log_n, log_na, log_c, inverse
        self.log_nb = plan.log_n - log_na
        self.q = cs[lid, 0]
        x = np.arange(1 << (log_na + log_c - 4))
        self.xr, self.c = x >> log_c, x & ((1 << log_c) - 1)
        S, log_nb, log_n = log_na, self.log_nb, plan.log_n
        self.mask_hi = _stage_mask(log_nb + S - 4, log_nb + 4, log_n - 1) if inverse else 15
        self.mask_lo = 15 if inverse else _stage_mask(log_nb, log_nb, log_nb + S - 5)
        hi = _load_tw(tw, lid, inverse, log_n, [0], log_nb + S - 4, self.mask_hi)
        reps = np.arange(1 << (S - 4)) * (16 << log_nb)
        lo = _load_tw(tw, lid, inverse, log_n, reps, log_nb, self.mask_lo)
        self.tw_hi = tuple(np.repeat(m, len(x), axis=0) for m in hi)   # one shared round
        self.tw_lo = tuple(m[self.xr] for m in lo)                     # round xr of the table
        self.row_hi = (_E[None, :] << (S - 4)) | self.xr[:, None]
        self.row_lo = self.xr[:, None] * 16 + _E[None, :]

    def _at(self, rows):
        """col_at: a tile narrower than the 32 banks is padded by 16 words
        every 16 rows."""
        pad = (rows >> 4) << 4 if self.log_c < 5 else 0
        return (rows << self.log_c) + self.c[:, None] + pad

    def words(self):
        return (1 << (self.S + self.log_c)) + ((1 << self.S) if self.log_c < 5 else 0)

    def phase(self, a):
        buf = _Exchange(self.words())
        if self.inverse:
            _round(a, self.tw_lo, self.mask_lo, self.q, True)
            buf.write(self._at(self.row_lo), a)
            a[:] = buf.read(self._at(self.row_hi))
            _round(a, self.tw_hi, self.mask_hi, self.q, True)
        else:
            _round(a, self.tw_hi, self.mask_hi, self.q, False)
            buf.write(self._at(self.row_hi), a)
            a[:] = buf.read(self._at(self.row_lo))
            _round(a, self.tw_lo, self.mask_lo, self.q, False)


class _Row:
    """The row phase of one CTA on the words [base, base + chunk)."""

    def __init__(self, plan, lid, log_na, base, chunk, inverse):
        tw, cs = _packed(plan)
        self.q, self.inverse, self.base, self.chunk = cs[lid, 0], inverse, base, chunk
        log_nb, log_n = plan.log_n - log_na, plan.log_n
        x = np.arange(chunk // 16)
        self.mask_hi = _stage_mask(4, 0, log_nb - 1)
        self.mask_lo = _stage_mask(0, 0, log_nb - 1)
        hi = _load_tw(tw, lid, inverse, log_n, base + np.arange(chunk >> 8) * 256, 4, self.mask_hi)
        self.tw_hi = tuple(m[x >> 4] for m in hi)
        self.tw_lo = _load_tw(tw, lid, inverse, log_n, base + x * 16, 0, self.mask_lo)
        self.word_hi = ((x >> 4) << 8)[:, None] + (_E << 4)[None, :] + (x & 15)[:, None]
        self.word_lo = x[:, None] * 16 + _E[None, :]

    def phase(self, a):
        pad = lambda i: i + (i >> 4)
        xb = _Exchange(self.chunk + (self.chunk >> 4))
        if self.inverse:
            _round(a, self.tw_lo, self.mask_lo, self.q, True)
            xb.write(pad(self.word_lo), a)
            a[:] = xb.read(pad(self.word_hi))
            _round(a, self.tw_hi, self.mask_hi, self.q, True)
        else:
            _round(a, self.tw_hi, self.mask_hi, self.q, False)
            xb.write(pad(self.word_hi), a)
            a[:] = xb.read(pad(self.word_lo))
            _round(a, self.tw_lo, self.mask_lo, self.q, False)


def _slot_of(j, log_n, log_n1):
    """slot_of of the kernels: two __brev, no table."""
    brev = lambda v, bits: sum(((v >> i) & 1) << (bits - 1 - i) for i in range(bits))
    return (brev(j >> log_n1, log_n - log_n1) << log_n1) | brev(j & ((1 << log_n1) - 1), log_n1)


def _emulate_large(x, plan, inverse, log_na, kind=TWO_PASS, slots=4):
    """The large-ring kernels, CTA by CTA and polynomial group by group, with
    the wrapper's geometry: two passes through a uint32 intermediate, or the
    cluster kernels with every CTA's receiving buffer held in `recv[rank]`."""
    log_n, n, B = plan.log_n, plan.n, x.shape[0]
    log_nb, log_n1 = log_n - log_na, plan.n1.bit_length() - 1
    log_c, log_chunk = large_geometry(log_n, log_na)
    if kind == CLUSTER:
        log_c = cluster_geometry(log_n, log_na)[0]
    tile, chunk = 1 << (log_na + log_c), 1 << log_chunk
    tiles = 1 << (log_nb - log_c)
    _, cs = _packed(plan)
    out = np.full(x.shape, -1, dtype=np.int64)
    for l, lid in enumerate(plan.limb_ids32.numpy()):
        q = cs[lid, 0]
        scale = lambda v, i: _shoup(v, cs[lid, i], cs[lid, i + 1], q)
        cols = [_Col(plan, lid, log_na, log_c, inverse) for _ in range(tiles)]
        col_addr = [(lambda ct, rows, k=k: (rows << log_nb) + (k << log_c) + ct.c[:, None])
                    for k in range(tiles)]
        if kind == CLUSTER:
            rows_ = [_Row(plan, lid, log_na, k * tile, tile, inverse) for k in range(tiles)]
            G = poly_groups(B, plan.L * tiles, slots)
            rows_pad = lambda i: i + ((i >> 8) << 4)
            for b in (b for g in range(G) for b in range(g, B, G)):
                if inverse:
                    # row phase first; it pushes word (r, col) into the tile buffer
                    # of the CTA that owns the column, as (row, column in tile)
                    recv = [_Exchange(ct.words()) for ct in cols]
                    for rt in rows_:
                        a = x[b, l][_slot_of(rt.base + rt.word_lo, log_n, log_n1)].astype(np.uint64)
                        rt.phase(a)
                        j = rt.base + rt.word_hi
                        r, cc = j >> log_nb, j & ((1 << log_nb) - 1)
                        local = (r << log_c) + (cc & ((1 << log_c) - 1)) \
                            + ((r >> 4) << 4 if log_c < 5 else 0)             # col_at
                        for rk in range(tiles):
                            sel = (cc >> log_c) == rk
                            recv[rk].write(local[sel], a[sel])
                    for k, ct in enumerate(cols):                      # after the barrier
                        a = recv[k].read(ct._at(ct.row_lo))
                        ct.phase(a)
                        out[b, l][col_addr[k](ct, ct.row_hi)] = scale(a, 3)
                else:
                    # column phase first; it pushes row r into the CTA that owns
                    # it, as local words padded by 16 in 256
                    recv = [_Exchange(tile + (tile >> 4)) for _ in range(tiles)]
                    log_rows = log_na - (log_nb - log_c)
                    for k, ct in enumerate(cols):
                        a = x[b, l][col_addr[k](ct, ct.row_hi)].astype(np.uint64)
                        ct.phase(a)
                        r = ct.row_lo
                        local = rows_pad(((r & ((1 << log_rows) - 1)) << log_nb)
                                         + (k << log_c) + ct.c[:, None])
                        for rk in range(tiles):
                            sel = (r >> log_rows) == rk
                            recv[rk].write(local[sel], a[sel])
                    for rk, rt in enumerate(rows_):
                        a = recv[rk].read(rows_pad(rt.word_hi))
                        rt.phase(a)
                        out[b, l][_slot_of(rt.base + rt.word_lo, log_n, log_n1)] = scale(a, 1)
            continue
        rows_ = [_Row(plan, lid, log_na, k * chunk, chunk, inverse) for k in range(n // chunk)]
        g_col = poly_groups(B, plan.L * tiles, slots)
        g_row = poly_groups(B, plan.L * len(rows_), slots)
        tmp = np.full((B, n), _SENTINEL)
        col_pass = [(b, k) for g in range(g_col) for b in range(g, B, g_col) for k in range(tiles)]
        row_pass = [(b, rt) for g in range(g_row) for b in range(g, B, g_row) for rt in rows_]
        if inverse:
            for b, rt in row_pass:
                a = x[b, l][_slot_of(rt.base + rt.word_lo, log_n, log_n1)].astype(np.uint64)
                rt.phase(a)
                tmp[b][rt.base + rt.word_hi] = a
            assert tmp.max() < (1 << 32)
            for b, k in col_pass:
                a = tmp[b][col_addr[k](cols[k], cols[k].row_lo)]
                cols[k].phase(a)
                out[b, l][col_addr[k](cols[k], cols[k].row_hi)] = scale(a, 3)
        else:
            for b, k in col_pass:
                a = x[b, l][col_addr[k](cols[k], cols[k].row_hi)].astype(np.uint64)
                cols[k].phase(a)
                tmp[b][col_addr[k](cols[k], cols[k].row_lo)] = a
            assert tmp.max() < (1 << 32)
            for b, rt in row_pass:
                a = tmp[b][rt.base + rt.word_hi]
                rt.phase(a)
                out[b, l][_slot_of(rt.base + rt.word_lo, log_n, log_n1)] = scale(a, 1)
    assert out.min() >= 0                                  # every output word written
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


_SPLITS = [(256, 30, 4), (256, 31, 5), (256, 30, 7), (2048, 31, 4), (4096, 31, 5),
           (4096, 31, 6), (4096, 30, 8)]


def _hold_emulation(n, bits, log_na, kind, batch=2):
    """The emulated kernels on a non-contiguous take against the plain
    versions and against rfhe_tpu's MxuNttPlan."""
    ref, plan = _plans(n, bits)
    sub, sub_ref = plan.take([2, 0]), ref.take(np.array([2, 0]))
    x = _residues(sub.primes, (batch, sub.L, n), seed=n + log_na).astype(np.int64)
    y = ntt_fwd_reference(_t(x), sub).numpy()
    np.testing.assert_array_equal(_emulate_large(x, sub, False, log_na, kind), y)
    np.testing.assert_array_equal(y, np.asarray(sub_ref.fwd(jnp.asarray(x.astype(np.uint32)))))
    back = _emulate_large(y, sub, True, log_na, kind)
    np.testing.assert_array_equal(back, ntt_inv_reference(_t(y), sub).numpy())
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("n, bits, log_na", _SPLITS)
def test_large_ring_passes_emulated(n, bits, log_na):
    """The two passes of the large-ring kernels: register rounds and their
    twiddle slots, the exchange layouts, the closed-form slot store."""
    _hold_emulation(n, bits, log_na, TWO_PASS)


@pytest.mark.parametrize("n, bits, log_na", _SPLITS)
def test_large_ring_cluster_emulated(n, bits, log_na):
    """The cluster kernels: the same phases with the exchange between them
    through the CTAs' shared memories (who owns which row and column)."""
    _hold_emulation(n, bits, log_na, CLUSTER)


@pytest.mark.parametrize("kind", [TWO_PASS, CLUSTER])
@pytest.mark.parametrize("batch", [1, 11])
def test_large_ring_polynomial_groups_emulated(kind, batch):
    """A batch that the polynomial groups do not divide (11 over 2 groups: six
    trips and five) and a batch of one."""
    assert poly_groups(batch, 2, 4) == min(batch, 2)
    _hold_emulation(256, 30, 4, kind, batch)


@pytest.mark.skipif(not ntt_fused._INTERPRET, reason="interpret mode disabled by env")
@pytest.mark.parametrize("kind", [TWO_PASS, CLUSTER])
def test_large_ring_emulation_matches_pallas_kernel_interpret(kind):
    """The emulated large-ring kernels against the Pallas kernels K1/K2
    (interpret mode) at n=256."""
    ref, plan = _plans(256, 30)
    x = _residues(plan.primes, (2, plan.L, 256), seed=13)
    y_k = np.asarray(ref.fused.fwd(jnp.asarray(x)))
    np.testing.assert_array_equal(_emulate_large(x.astype(np.int64), plan, False, 5, kind),
                                  y_k.astype(np.int64))
    x_k = np.asarray(ref.fused.inv(jnp.asarray(y_k)))
    np.testing.assert_array_equal(_emulate_large(y_k.astype(np.int64), plan, True, 5, kind),
                                  x_k.astype(np.int64))


def slot_rows_contiguous(n: int, n1: int, log_na: int) -> bool:
    """Whether every row of the split n = na·nb (position j = r·nb + c) is one
    contiguous row of slots, slot row brev(r) with its columns bit-reversed:
    slot_of_position(r·nb + c) = brev(r)·nb + brev(c).  It holds when nb = n1."""
    nb = n >> log_na
    j = np.arange(n, dtype=np.int64)
    want = _bit_reverse(n // nb)[j // nb] * nb + _bit_reverse(nb)[j % nb]
    return bool(np.array_equal(slot_of_position(n, n1), want))


@pytest.mark.parametrize("kind", [TWO_PASS, CLUSTER])
def test_large_ring_contiguous_rows_emulated_16384(kind):
    """n = 16384 at the form's own split (128 x 128): the closed-form slot
    store writes whole slot rows, and the result is the plain version's."""
    primes = numth.find_ntt_primes(16384, 30, 1)
    plan = NttPlan.make(16384, primes, "cpu")
    log_na = large_split(16384)
    assert slot_rows_contiguous(16384, plan.n1, log_na)
    j = np.arange(128)[None, :] + 128 * np.arange(128)[:, None]          # rows of the network
    slots = _slot_of(j, 14, 7)
    assert (np.sort(slots, axis=1) == slots.min(axis=1)[:, None] + np.arange(128)).all()
    x = _residues(primes, (1, 1, 16384), seed=14).astype(np.int64)
    y = ntt_fwd_reference(_t(x), plan).numpy()
    np.testing.assert_array_equal(_emulate_large(x, plan, False, log_na, kind), y)
    np.testing.assert_array_equal(_emulate_large(y, plan, True, log_na, kind), x)


@pytest.mark.parametrize("n", [16384, 32768, 65536])
def test_slot_rows_contiguous_at_own_split(n):
    """Tables only: at the form's own split every network row is one slot
    row, row brev(r) with bit-reversed columns; at another split it is not.
    The kernels' slot_of is the closed form the tables are held against."""
    n1 = split_n(n)[0]
    log_na = large_split(n)
    assert n >> log_na == n1
    assert slot_rows_contiguous(n, n1, log_na)
    assert not slot_rows_contiguous(n, n1, log_na - 1)
    j = np.arange(n)
    np.testing.assert_array_equal(_slot_of(j, n.bit_length() - 1, n1.bit_length() - 1),
                                  slot_of_position(n, n1))


@pytest.mark.parametrize("n", [16, 256, 2048, 4096])
def test_slot_of_position_is_the_tables_order(n):
    plan = NttPlan.make(n, numth.find_ntt_primes(n, 30, 1), "cpu")
    np.testing.assert_array_equal(slot_of_position(n, plan.n1), plan.tables.pos_inv.numpy())
    pos = plan.tables.pos.numpy()
    np.testing.assert_array_equal(slot_of_position(n, plan.n1)[pos], np.arange(n))


@pytest.mark.parametrize("batch, ctas, slots, want", [
    (1, 8, 132, 1), (11, 2, 4, 2), (21, 176, 132, 3), (21, 352, 264, 3), (3, 224, 132, 1),
    (3, 448, 264, 1), (2, 336, 264, 1), (21, 88, 264, 3), (23, 96, 264, 5), (70000, 3, 264, 88)])
def test_poly_groups_cover_the_batch(batch, ctas, slots, want):
    """Every polynomial is transformed by exactly one group, and G is the
    smallest count that minimises waves·(trips + 1)."""
    G = poly_groups(batch, ctas, slots)
    assert G == want and 1 <= G <= batch
    seen = sorted(b for g in range(G) for b in range(g, batch, G))
    assert seen == list(range(batch))
    cost = lambda g: -(-ctas * g // slots) * (-(-batch // g) + 1)
    top = min(batch, max(1, 4 * slots // ctas))
    assert all(cost(G) <= cost(g) for g in range(1, top + 1))
    assert all(cost(G) < cost(g) for g in range(1, G))


@pytest.mark.parametrize("kind, inverse, L, batch, log_n, want", [
    (TWO_PASS, False, 22, 21, 16, [("rfhe_ntt_fwd_col", (3, 16, 8, 5)),
                                   ("rfhe_ntt_fwd_row", (3, 16, 8, 12, 8))]),
    (TWO_PASS, True, 22, 21, 15, [("rfhe_ntt_inv_row", (3, 15, 8, 12, 7)),
                                  ("rfhe_ntt_inv_col", (3, 15, 8, 5))]),
    (CLUSTER, False, 28, 3, 16, [("rfhe_ntt_fwd_cluster", (1, 16, 8, 4, 8))]),
    (CLUSTER, True, 1, 2, 14, [("rfhe_ntt_inv_cluster", (2, 14, 7, 4, 7))]),
])
def test_large_passes_plan(kind, inverse, L, batch, log_n, want):
    """The launches of one transform on a card of 132 SMs: entry points in
    order, polynomial groups, split and tile or chunk, the slot order's n1."""
    n = 1 << log_n
    got = large_passes(kind, inverse, L, batch, log_n, large_split(n),
                       split_n(n)[0].bit_length() - 1, 132)
    assert got == want


def test_resident_ctas():
    assert resident_ctas(132, 512) == 132 and resident_ctas(132, 256) == 264
    assert resident_ctas(132, 16) == 8 * 132 and resident_ctas(4, 1024) == 4


@pytest.mark.parametrize("n, want, large", [(4096, 0, 6), (8192, 0, 7), (16384, 7, 7),
                                            (32768, 8, 8), (65536, 8, 8)])
def test_default_split_and_geometry(n, want, large):
    """Rings up to 8192 take the one-block form by themselves, larger ones
    the large-ring form at its own split, whose nb equals the slot order's
    n1.  Its tiles keep 16 elements per thread in at most 512 threads."""
    kind, log_na = resolve_split(n, None, 21 * 22)
    assert log_na == want and (kind == "one_block") == (want == 0)
    assert default_split(n) == want and large_split(n) == large
    by_size = TWO_PASS if n >= 16384 else CLUSTER                      # by the launch's size in words
    assert resolve_split(n, large, 21 * 22) == (by_size, large)
    assert resolve_split(n, large, 3 * 28) == (CLUSTER, large)
    # the crossing follows the launch's size in words, (3, 28, 65536) the last cluster launch
    assert resolve_split(n, large, 5 * 22)[0] == (TWO_PASS if n == 65536 else CLUSTER)
    assert resolve_split(n, large, 10 * 22)[0] == (TWO_PASS if n >= 32768 else CLUSTER)
    assert resolve_split(n, (CLUSTER, large), 21 * 22) == (CLUSTER, large)   # by name
    assert resolve_split(n, (TWO_PASS, large), 2) == (TWO_PASS, large)
    log_n = n.bit_length() - 1
    if n >= 16384:
        assert n >> large == split_n(n)[0]
    log_c, log_chunk = large_geometry(log_n, large)
    assert (1 << (large + log_c)) // 16 <= 512 and (1 << log_chunk) // 16 <= 512
    assert cluster_geometry(log_n, large)[1] <= 16       # CTAs of a cluster
    assert log_c <= log_n - large and 8 <= log_chunk <= log_n
    for bad in (0, 3, 9, 14):
        with pytest.raises(ValueError):
            large_geometry(14, bad)
    with pytest.raises(ValueError):
        large_geometry(7, 4)
    with pytest.raises(ValueError):
        resolve_split(n, ("rows", large), 1)


@pytest.mark.parametrize("n, bits", [(1024, 30), (4096, 28), (4096, 31)])
def test_numth_copy_matches_reference(n, bits):
    primes = numth.find_ntt_primes(n, bits, 4)
    assert tnumth.find_ntt_primes(n, bits, 4) == primes
    for q in primes:
        assert tnumth.psi_negacyclic(n, q) == numth.PrimeCtx.make(q, n).psi
        assert tnumth.shoup_precompute(q - 1, q) == numth.shoup_precompute(q - 1, q)
    assert tnumth.crt_constants(primes) == numth.crt_constants(primes)
