"""rfhe_tpu_torch.ops.modarith against rfhe_tpu.ops.u32, bit for bit, on
random and extreme residues for 30- and 31-bit moduli (mirrors
tests/test_u32_ops.py).  Tolerance 0."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rfhe_tpu import numth
from rfhe_tpu.ops import u32
from rfhe_tpu_torch.ops import modarith

torch.set_num_threads(1)

Q30 = numth.find_ntt_prime(4096, 30)
Q31 = numth.find_ntt_prime(4096, 31)
Q20 = numth.find_ntt_prime(256, 20)
MODULI = [Q30, Q31, Q20]
Q30_TOP, Q31_TOP = 1073741789, 2147483647     # the primes just under 2^30 and 2^31


def _residues(q, n=1000, seed=0):
    """Random residues plus the extremes 0, 1, q-2, q-1."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, q, size=n, dtype=np.uint32)
    r[:4] = [0, 1, q - 2, q - 1]
    return r


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out).astype(np.int64))


@pytest.mark.parametrize("q", MODULI)
def test_add_sub_neg(q):
    a, b = _residues(q, seed=1), _residues(q, seed=2)[::-1].copy()
    _eq(modarith.add_mod(_t(a), _t(b), q), u32.add_mod(jnp.asarray(a), jnp.asarray(b), q))
    _eq(modarith.sub_mod(_t(a), _t(b), q), u32.sub_mod(jnp.asarray(a), jnp.asarray(b), q))
    _eq(modarith.neg_mod(_t(a), q), u32.neg_mod(jnp.asarray(a), q))


@pytest.mark.parametrize("q", MODULI)
def test_mont_mul_full_width_a(q):
    """a spans the full 32 bits, as the reference's mont_mul allows."""
    _, qinv_neg, _ = numth.montgomery_constants(q, 32)
    rinv = numth.mod_inv((1 << 32) % q, q)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, (1 << 32) - 1, q - 1]
    b = _residues(q, seed=4)
    _eq(modarith.mont_mul(_t(a), _t(b), q, rinv),
        u32.mont_mul(jnp.asarray(a), jnp.asarray(b), q, qinv_neg))


@pytest.mark.parametrize("q", MODULI)
def test_mul_mod_and_shoup(q):
    _, qinv_neg, r2 = numth.montgomery_constants(q, 32)
    a, b = _residues(q, seed=5), _residues(q, seed=6)
    _eq(modarith.mul_mod(_t(a), _t(b), q),
        u32.mul_mod(jnp.asarray(a), jnp.asarray(b), q, qinv_neg, r2))
    for w in (0, 1, q - 1, int(np.random.default_rng(7).integers(0, q))):
        ws = numth.shoup_precompute(w, q)
        _eq(modarith.mul_mod_shoup(_t(a), w, ws, q),
            u32.mul_mod_shoup(jnp.asarray(a), w, ws, q))


@pytest.mark.parametrize("q_src, q_dst", [(Q31, Q30), (Q30, Q31), (Q31, Q20)])
def test_reduce_mod_matches_barrett(q_src, q_dst):
    v = _residues(q_src, seed=8)
    mu, k = numth.barrett_constants(q_dst)
    zeros = jnp.zeros_like(jnp.asarray(v))
    _eq(modarith.reduce_mod(_t(v), q_dst),
        u32.barrett_reduce64(zeros, jnp.asarray(v), q_dst, mu, k))


def test_per_limb_moduli_broadcast():
    """Moduli as an (L, 1) tensor against (L, n) data, as the RNS layer calls."""
    qs = np.array(MODULI, dtype=np.uint32)
    qinvs = np.array([numth.montgomery_constants(int(q), 32)[1] for q in qs], dtype=np.uint32)
    rinvs = [numth.mod_inv((1 << 32) % int(q), int(q)) for q in qs]
    a = np.stack([_residues(int(q), 64, seed=9 + i) for i, q in enumerate(qs)])
    b = np.stack([_residues(int(q), 64, seed=19 + i) for i, q in enumerate(qs)])
    qc, qinvc = qs[:, None], qinvs[:, None]
    qt, rinvt = _t(qc), torch.tensor(rinvs, dtype=torch.int64)[:, None]
    _eq(modarith.mont_mul(_t(a), _t(b), qt, rinvt),
        u32.mont_mul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(qc), jnp.asarray(qinvc)))
    _eq(modarith.add_mod(_t(a), _t(b), qt), u32.add_mod(jnp.asarray(a), jnp.asarray(b), jnp.asarray(qc)))
    _eq(modarith.sub_mod(_t(a), _t(b), qt), u32.sub_mod(jnp.asarray(a), jnp.asarray(b), jnp.asarray(qc)))


# ---------------------------------------------------------------------------
# MULTEVK: the word arithmetic of csrc/ntt.cu:rfhe_ks_mac_kernel
# ---------------------------------------------------------------------------

M32 = np.uint64(0xFFFFFFFF)


def _ks_mac_words(dig, kb, ka, table):
    """The kernel's words, emulated in numpy uint64 from its table: per
    product a Montgomery REDC with -q^-1 mod 2^32 (a word below 2q), the
    digit sum in 64 bits, one final reduction mod q.  dig (n_used, n_lim, N)
    below 2^32; kb, ka (key digits, key rows, N) below their q."""
    n_used, n_lim, _ = dig.shape
    tab = np.asarray(table).view(np.uint32).astype(np.uint64)
    rows, q, q_neg_inv, digits = (tab[:n_lim], tab[n_lim:2 * n_lim, None],
                                  tab[2 * n_lim:3 * n_lim, None], tab[3 * n_lim:])
    assert len(digits) == n_used
    out = []
    for key in (kb, ka):
        acc = np.zeros(dig.shape[1:], dtype=np.uint64)
        for d in range(n_used):
            p = (dig[d].astype(np.uint64) & M32) * key[digits[d]][rows].astype(np.uint64)
            m = ((p & M32) * q_neg_inv) & M32
            assert (p < (q << np.uint64(32))).all() and (m * q < (q << np.uint64(32))).all()
            t = (p + m * q) >> np.uint64(32)                 # p + m·q < 2^64: no wrap
            assert (t < 2 * q).all()
            acc += t
        assert (acc < np.uint64(n_used) * 2 * q + 1).all()  # no wrap in the 64-bit sum
        out.append(acc % q)
    return np.stack(out).astype(np.int64)


def _mac_case(case):
    """(dig, ksk, used, lim, ctx) at N = 256 for the wrapper's cases: every
    digit at the top level, or a lower level of grouped digits against a
    key cut to some limbs as a rank of the sharded evaluator holds it."""
    from rfhe_tpu_torch.fhe.keys import KeySwitchKey, digit_basis
    from rfhe_tpu_torch.fhe.rns import RnsContext
    from rfhe_tpu_torch.numth import find_ntt_primes
    L, n = 5, 256
    ctx = RnsContext.make(n, find_ntt_primes(n, 30, 3) + find_ntt_primes(n, 31, 3), "cpu")
    dnum, level, targets = (None, L - 1, None) if case == "top" else (2, 3, [1, 2])
    _, used, lim = digit_basis(level, ctx, L, dnum, targets)
    rng = np.random.default_rng(len(case))
    q = np.array(ctx.moduli, dtype=np.uint64)[None, :, None]
    keys = [_t(rng.integers(0, 1 << 62, (L if dnum is None else dnum, ctx.L, n),
                            dtype=np.uint64) % q) for _ in range(2)]
    ksk = KeySwitchKey(b=keys[0], a=keys[1])
    if case != "top":
        ksk = ksk.cut([0, 1, 2, 3] + list(range(L, ctx.L)))
    dig = _t(rng.integers(0, 1 << 32, (len(used), len(lim), n), dtype=np.uint64))
    return dig, ksk, used, lim, ctx


@pytest.mark.parametrize("case", [(Q30_TOP, 21), (Q30_TOP, 64), (Q31_TOP, 21), (Q31_TOP, 64),
                                  "top", "cut key, lower level, dnum=2"],
                         ids=["q30-21", "q30-64", "q31-21", "q31-64", "wrapper-top",
                              "wrapper-cut-key"])
def test_ks_mac_words(case):
    """The MAC kernel's word arithmetic (`_ks_mac_words`) equals
    `_sum_digits(mont_mul(...))` at the worst words (digits 2^32 - 1, keys
    q - 1) for q just under 2^30 and 2^31 at 21 and 64 digits; and at
    N = 256 the wrapper's CPU path (`multevk`), today's formula written out
    and the emulation from the wrapper's own table agree."""
    from rfhe_tpu_torch.fhe import keys
    if isinstance(case, tuple):
        q, n_used = case
        rng = np.random.default_rng(n_used)
        dig = rng.integers(0, 1 << 32, (n_used, 1, 256), dtype=np.uint64)
        kb, ka = (rng.integers(0, q, (n_used, 1, 256), dtype=np.uint64) for _ in range(2))
        dig[:, :, :128], kb[:, :, :128], ka[:, :, ::2] = (1 << 32) - 1, q - 1, q - 1
        table = np.array([0, q, numth.montgomery_constants(q, 32)[1], *range(n_used)],
                         dtype=np.uint32)
        rinv = numth.mod_inv((1 << 32) % q, q)
        want = [keys._sum_digits(modarith.mont_mul(_t(dig), _t(k), q, rinv), q) for k in (kb, ka)]
        np.testing.assert_array_equal(_ks_mac_words(dig, kb, ka, table),
                                      torch.stack(want).numpy())
        return
    dig, ksk, used, lim, ctx = _mac_case(case)
    got = keys.multevk(dig, ksk, used, lim, ctx)
    key_idx, used_idx = ctx.index(ksk.rows(lim)), ctx.index(used)
    sub_plan = ctx.plan.take(lim)
    q, rinv = sub_plan.qb(1), sub_plan.rinvb(1)
    today = torch.stack([
        keys._sum_digits(modarith.mont_mul(dig, k.index_select(0, used_idx)
                                           .index_select(1, key_idx), q, rinv), q)
        for k in (ksk.b, ksk.a)])
    assert torch.equal(got, today) and got.shape == (2, len(lim), ctx.n)
    table = keys._mac_table(ctx, used, ksk.rows(lim), lim)
    np.testing.assert_array_equal(
        _ks_mac_words(dig.numpy(), ksk.b.numpy(), ksk.a.numpy(), table.numpy()), got.numpy())


# ---------------------------------------------------------------------------
# MODDOWN: the word arithmetic of csrc/ntt.cu:rfhe_md_lift_kernel and
# rfhe_md_scale_kernel, and drop_limb's plain path on the CPU
# ---------------------------------------------------------------------------

def _umulhi(a, b):
    """The high word of a 32 x 32-bit product (both below 2^32: exact in uint64)."""
    return (a * b) >> np.uint64(32)


def _md_words(ck, kept, dnt, table):
    """The two kernels' words, emulated in numpy uint64 from their table as
    the kernels hold them, in 32-bit words: the lift's Barrett reduction by
    ⌊2^32/q⌋ (below 2q, one subtract) and the centring `sub_q`; the scale's
    `sub_q` and `mul_shoup` (wrapping 32-bit words, exact: the value lies in
    [0, 2q))."""
    nk = kept.shape[-2]
    tab = np.asarray(table).view(np.uint32).astype(np.uint64)
    half = tab[0]
    q, qs_mod, m, w, w_shoup = (tab[1 + j * nk:1 + (j + 1) * nk, None] for j in range(5))
    v = ck.astype(np.uint64)[..., None, :]
    r = (v - _umulhi(v, m) * q) & M32
    assert (r < 2 * q).all()
    r = np.where(r >= q, r - q, r)
    centred = np.where(r >= qs_mod, r - qs_mod, r + q - qs_mod)
    delta = np.where(v > half, centred, r)
    x, d = kept.astype(np.uint64), dnt.astype(np.uint64)
    num = np.where(x >= d, x - d, x + q - d)
    s = (num * w - _umulhi(num, w_shoup) * q) & M32
    assert (s < 2 * q).all()
    return delta.astype(np.int64), np.where(s >= q, s - q, s).astype(np.int64)


def _md_context():
    """Two 28-bit, two 30-bit and one 31-bit prime at N = 256: a dropped
    modulus above some kept ones and below others."""
    from rfhe_tpu_torch.fhe.rns import RnsContext
    from rfhe_tpu_torch.numth import find_ntt_primes
    n = 256
    return RnsContext.make(n, find_ntt_primes(n, 28, 2) + find_ntt_primes(n, 30, 2)
                           + find_ntt_primes(n, 31, 1), "cpu")


def _md_data(ctx, src_k, keep, seed):
    """(batch 2) rows for `keep` then the row of src_k, canonical, the first
    words of each row at the edges: kept rows (0, q − 1) paired with the
    δ̂ words 0 and q − 1 in `_md_words`' tests."""
    rng = np.random.default_rng(seed)
    q = np.array([ctx.moduli[i] for i in keep + [src_k]], dtype=np.uint64)[:, None]
    data = rng.integers(0, 1 << 62, (2, len(keep) + 1, ctx.n), dtype=np.uint64) % q
    data[:, :, :4] = np.concatenate([np.zeros_like(q), np.zeros_like(q), q - 1, q - 1], axis=1)
    return _t(data)


@pytest.mark.parametrize("src_k", [0, 2, 4], ids=["src-28-bit", "src-30-bit", "src-31-bit"])
def test_md_words(src_k):
    """The MODDOWN kernels' word arithmetic (`_md_words`, from the wrapper's
    own table) equals the plain versions the CPU runs, `moddown_lift` (the
    centred `lift_to_limbs`) and `moddown_scale` (`moddown_scale_plain`), on
    the edge words (ck at 0, q_src//2, q_src//2 + 1 and q_src − 1; kept and
    δ̂ at 0 and q_i − 1) and random ones, with the dropped modulus below,
    between and above the kept ones, kept read through the strided view
    data[..., :nk, :]."""
    from rfhe_tpu_torch.fhe import rns
    ctx = _md_context()
    keep = [i for i in range(ctx.L) if i != src_k]
    data = _md_data(ctx, src_k, keep, src_k)
    q_src, nk = ctx.moduli[src_k], len(keep)
    ck = data[:, nk].clone()
    ck[:, :4] = torch.tensor([0, q_src // 2, q_src // 2 + 1, q_src - 1])
    kept = data[:, :nk]
    q = torch.tensor([ctx.moduli[i] for i in keep])[:, None]
    dnt = (kept + 12345) % q
    dnt[..., :4] = torch.cat([torch.zeros_like(q), q - 1, torch.zeros_like(q), q - 1], dim=1)
    table = rns._md_table(ctx, src_k, keep)
    delta, scaled = _md_words(ck.numpy(), kept.numpy(), dnt.numpy(), table.numpy())
    np.testing.assert_array_equal(rns.moddown_lift(ck, src_k, keep, ctx).numpy(), delta)
    np.testing.assert_array_equal(rns.moddown_scale(kept, dnt, src_k, keep, ctx).numpy(), scaled)
    assert kept.stride()[:2] == ((nk + 1) * ctx.n, ctx.n)


@pytest.mark.parametrize("t", [None, 65537], ids=["ckks", "bgv-t"])
def test_drop_limb_plain_path_on_the_cpu(monkeypatch, t):
    """On the CPU `drop_limb` keeps the words of the composition it had
    before the kernels (lift, t-shift, δ's NTT, `sub_mod`, `mul_mod_shoup`
    written out), batched and batchless, and no CPU tensor reaches the
    kernels' bindings, which refuse one."""
    from rfhe_tpu_torch.fhe import rns
    from rfhe_tpu_torch.ops import ntt_cuda
    ctx = _md_context()
    src_k, keep = 4, [0, 1, 2, 3]
    data = _md_data(ctx, src_k, keep, 7)
    table, rows = rns._md_table(ctx, src_k, keep), data[:, :4].contiguous()
    with pytest.raises(ValueError, match="on the card"):
        ntt_cuda.md_lift(data[:, 4], table, 4)
    with pytest.raises(ValueError, match="on the card"):
        ntt_cuda.md_scale(rows, rows, table)
    for entry in ("md_lift", "md_scale"):
        monkeypatch.setattr(ntt_cuda, entry, lambda *a: pytest.fail("a CPU tensor reached it"))
    for d in (data, data[1]):
        ck = rns.limb_plan(ctx, src_k).inv(d[..., 4:5, :].contiguous())[..., 0, :]
        keep_idx = ctx.index(keep)
        q = ctx.plan.tables.q[keep_idx][:, None]
        delta = rns.lift_to_limbs(ck, src_k, keep, ctx, centered=True)
        if t is not None:
            shift = rns.bgv_lift_shift(rns.bgv_lift_residue(ck, ctx.moduli[src_k], t),
                                       src_k, keep, t, ctx)
            delta = modarith.sub_mod(delta, shift, q)
        num = modarith.sub_mod(d[..., :4, :], ctx.plan.take(keep).fwd(delta), q)
        want = modarith.mul_mod_shoup(num, ctx.qk_inv[src_k, keep_idx][:, None],
                                      ctx.qk_inv_shoup[src_k, keep_idx][:, None], q)
        assert torch.equal(rns.drop_limb(d, src_k, keep, ctx, t), want)
