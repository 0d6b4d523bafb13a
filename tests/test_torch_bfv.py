"""The port's BFV slice against rfhe_tpu with tests/test_bfv.py's settings
(n=256, 4 primes, t_bits=16, seed 3; dnum=2 at seed 9): keys, every
ciphertext array of the evaluator including the full BEHZ multiply, its
stages alone (extend_to_bsk, rns_floor, conv_sk), the γ-corrected
decryption, and base_conv on random and on all-(q−1) residues.  Tolerance 0.
The reference's evaluator is called eagerly through its `_*_impl` methods."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu.fhe.bfv import BfvContext as RefBfv, GammaDecryptPlan as RefGamma
from rfhe_tpu.fhe.ckks import Ciphertext as RefCiphertext
from rfhe_tpu.fhe.params import BfvParams as RefParams
from rfhe_tpu.fhe.rns import RnsPoly as RefPoly
from rfhe_tpu.ops.baseconv import BaseConvPlan as RefConvPlan, base_conv as ref_base_conv
from rfhe_tpu_torch.fhe import BfvContext, BfvParams
from rfhe_tpu_torch.fhe.bfv import GammaDecryptPlan
from rfhe_tpu_torch.numth import find_ntt_primes
from rfhe_tpu_torch.ops.baseconv import BaseConvPlan, base_conv

torch.set_num_threads(1)

PARAMS = dict(n=256, levels=3, q_bits=30, t_bits=16)
OPS = ["encrypt", "multiply", "relinearize", "square", "rotate_rows", "rotate_columns",
       "multiply_plain", "add", "sub", "dnum2 multiply_relin"]


class RefEager:
    """The reference context's ops through their implementations, eagerly."""

    def __init__(self, rc):
        self.rc = rc

    def __getattr__(self, name):
        return getattr(self.rc, name)

    def multiply(self, a, b):
        lvl = a.level
        out = self.rc._multiply_impl(a.c[0].data, a.c[1].data, b.c[0].data, b.c[1].data,
                                     self.rc.behz(lvl), self.rc.ctx.plan.slice(lvl + 1))
        return RefCiphertext([RefPoly(out[i], True) for i in range(3)], 1.0)

    def square(self, a):
        return self.multiply(a, a)

    def relinearize(self, ct):
        return self.rc._relinearize_impl(ct, self.rc.rlk)

    def multiply_relin(self, a, b):
        return self.relinearize(self.multiply(a, b))

    def apply_galois(self, ct, g):
        return self.rc._apply_galois_impl(ct, self.rc.galois_key(g), g)

    def rotate_rows(self, ct, r):
        n = self.rc.params.n
        return self.apply_galois(ct, pow(5, r % (n // 2), 2 * n))

    def rotate_columns(self, ct):
        return self.apply_galois(ct, 2 * self.rc.params.n - 1)


def _drive(ctx, m1, m2):
    ct1, ct2 = ctx.encrypt(ctx.encode(m1)), ctx.encrypt(ctx.encode(m2))
    out = {"encrypt": ct1, "multiply": ctx.multiply(ct1, ct2)}
    out["relinearize"] = ctx.relinearize(out["multiply"])
    out["square"] = ctx.square(ct1)
    out["rotate_rows"] = ctx.rotate_rows(ct1, 1)
    out["rotate_columns"] = ctx.rotate_columns(ct1)
    out["multiply_plain"] = ctx.multiply_plain(ct1, ctx.encode(m2))
    out["add"], out["sub"] = ctx.add(ct1, ct2), ctx.sub(ct1, ct2)
    return out


def _same(port, ref):
    np.testing.assert_array_equal(np.asarray(port.cpu() if isinstance(port, torch.Tensor) else port),
                                  np.asarray(ref).astype(np.int64))


def _msgs(t, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, t, (2, 128)), rng.integers(0, t, (2, 128))


@pytest.fixture(scope="module")
def pair():
    rc = RefBfv(RefParams.make(**PARAMS), seed=3)
    tc = BfvContext(BfvParams.make(**PARAMS), seed=3, device="cpu")
    m1, m2 = _msgs(tc.t, 7)
    ref, port = _drive(RefEager(rc), m1, m2), _drive(tc, m1, m2)
    # grouped digits (tests/test_bfv.py:test_dnum_multiply)
    rd = RefEager(RefBfv(RefParams.make(**PARAMS), seed=9, dnum=2))
    td = BfvContext(BfvParams.make(**PARAMS), seed=9, dnum=2, device="cpu")
    d1, d2 = _msgs(td.t, 13)
    for ctx, out in ((rd, ref), (td, port)):
        out["dnum2 multiply_relin"] = ctx.multiply_relin(ctx.encrypt(ctx.encode(d1)),
                                                         ctx.encrypt(ctx.encode(d2)))
    return rc, tc, ref, port, (m1, m2, d1, d2, td)


def test_keys(pair):
    rc, tc, *_ = pair
    _same(tc.sk.s_ntt, rc.sk.s_ntt)
    for port, ref in [(tc.pk, rc.pk), (tc.rlk, rc.rlk)] + [(tc._galois[g], k)
                                                             for g, k in rc._galois.items()]:
        _same(port.b, ref.b)
        _same(port.a, ref.a)


@pytest.mark.parametrize("op", OPS)
def test_op_arrays(pair, op):
    _, _, ref, port, _ = pair
    r, p = ref[op], port[op]
    assert (p.size, p.level) == (r.size, r.level)
    for a, b in zip(p.c, r.c):
        _same(a.data, b.data)


def test_encode_decode(pair):
    rc, tc, _, _, (m1, *_) = pair
    coeffs = tc.encode(m1)
    np.testing.assert_array_equal(coeffs, rc.encode(m1))
    np.testing.assert_array_equal(tc.decode(coeffs), m1)


def test_decrypt(pair):
    """The γ-corrected device path, the host path and the reference's
    γ-corrected path agree and give the plaintext results."""
    rc, tc, ref, port, (m1, m2, d1, d2, td) = pair
    t = tc.t
    want = {"encrypt": m1, "relinearize": m1 * m2 % t, "square": m1 * m1 % t,
            "rotate_rows": np.roll(m1, -1, axis=1), "rotate_columns": m1[::-1],
            "multiply_plain": m1 * m2 % t, "add": (m1 + m2) % t, "sub": (m1 - m2) % t}
    for op, m in want.items():
        coeffs = tc.decrypt_coeffs_t(port[op])
        np.testing.assert_array_equal(coeffs, tc.decrypt_coeffs_t(port[op], exact=True))
        np.testing.assert_array_equal(tc.decode(coeffs), m)
    np.testing.assert_array_equal(tc.decrypt_coeffs_t(port["relinearize"]),
                                  rc.decrypt_coeffs_t(ref["relinearize"]))
    np.testing.assert_array_equal(td.decrypt_decode(port["dnum2 multiply_relin"]), d1 * d2 % td.t)


def test_behz_stages(pair):
    """extend_to_bsk, rns_floor and conv_sk alone on random residues, and
    the γ-decryption plan on random residues."""
    rc, tc, *_ = pair
    lvl = tc.L - 1
    rp, tp = rc.behz(lvl), tc.behz(lvl)
    assert (tp.bsk, tp.mtilde) == (tuple(rp.bsk), rp.mtilde)
    rng = np.random.default_rng(11)
    q = np.array(tc.params.moduli, dtype=np.int64)[:, None]
    b = np.array(tp.bsk, dtype=np.int64)[:, None]
    x = rng.integers(0, 1 << 62, (3, len(q), 256)) % q
    y = rng.integers(0, 1 << 62, (3, len(b), 256)) % b
    qj = rc.ctx.plan.q_arr[:len(q)]
    j = lambda a: jnp.asarray(a.astype(np.uint32))
    _same(tp.extend_to_bsk(torch.from_numpy(x)), rp.extend_to_bsk(j(x), qj))
    _same(tp.rns_floor(torch.from_numpy(x), torch.from_numpy(y)), rp.rns_floor(j(x), j(y), qj))
    _same(tp.conv_sk(torch.from_numpy(y)), rp.conv_sk(j(y), qj))
    gp = GammaDecryptPlan.make(tc.params.moduli, tc.t, "cpu")
    _same(gp.decrypt_mod_t(torch.from_numpy(x[0])),
          RefGamma.make(tuple(rc.params.moduli), rc.t).decrypt_mod_t(j(x[0]), qj))


@pytest.mark.parametrize("case", ["random", "all q-1", "words"])
def test_base_conv(case):
    """13 input limbs (the BEHZ B basis at 10 data limbs) to 14 outputs:
    random residues, every residue q−1, and any words below 2^32."""
    q_in = find_ntt_primes(256, 30, 13)
    q_out = find_ntt_primes(256, 31, 13) + [65537]
    rng = np.random.default_rng(5)
    qi = np.array(q_in, dtype=np.int64)[:, None]
    x = {"random": lambda: rng.integers(0, 1 << 62, (2, 13, 256)) % qi,
         "all q-1": lambda: np.broadcast_to(qi - 1, (2, 13, 256)).copy(),
         "words": lambda: rng.integers(0, 1 << 32, (2, 13, 256))}[case]()
    got = base_conv(torch.from_numpy(x), BaseConvPlan.make(q_in, q_out, "cpu"))
    _same(got, ref_base_conv(jnp.asarray(x.astype(np.uint32)), RefConvPlan.make(q_in, q_out)))
