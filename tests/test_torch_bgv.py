"""The port's BGV slice against rfhe_tpu with the reference tests' settings
(n=1024, 3 primes, t_bits=16, seed 5, as tests/test_bgv.py; the dot product
at n=256 as tests/test_models.py): keys, every ciphertext array and its
correction, the decryptions, the t-plan's slot order, and drop_limb /
keyswitch in t-mode alone.  Tolerance 0.  The reference's evaluator is
called eagerly through its `_*_impl` methods (its public ops compile one jit
program per op and level)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu.fhe import bgv as ref_bgv
from rfhe_tpu.fhe.bgv import BgvContext as RefBgv
from rfhe_tpu.fhe.keys import keyswitch as ref_keyswitch
from rfhe_tpu.fhe.params import BgvParams as RefParams
from rfhe_tpu.fhe.rns import drop_limb as ref_drop_limb
from rfhe_tpu.ops.ntt_pease import PeaseNttPlan, negacyclic_ntt
from rfhe_tpu_torch.fhe import BgvContext, BgvParams
from rfhe_tpu_torch.fhe import bgv as port_bgv
from rfhe_tpu_torch.fhe.keys import keyswitch
from rfhe_tpu_torch.fhe.rns import drop_limb
from rfhe_tpu_torch.models.dotprod import dot_product_bgv
from rfhe_tpu_torch.ops.ntt import NttPlan
from rfhe_tpu_torch.numth import find_ntt_primes

torch.set_num_threads(1)

PARAMS = dict(n=1024, levels=2, q_bits=30, t_bits=16)
OPS = ["encrypt", "multiply", "relinearize", "mod_switch", "rotate_rows", "rotate_columns",
       "rotate_low", "multiply_plain", "add", "sub"]


class RefEager:
    """The reference context's ops through their implementations, eagerly."""

    def __init__(self, rc):
        self.rc = rc

    def __getattr__(self, name):
        return getattr(self.rc, name)

    def multiply(self, a, b):
        return self.rc._multiply_impl(a, b)

    def relinearize(self, ct):
        return self.rc._relinearize_impl(ct, self.rc.rlk)

    def mod_switch_to_next(self, ct):
        return self.rc._mod_switch_impl(ct)

    def apply_galois(self, ct, g):
        return self.rc._apply_galois_impl(ct, self.rc.galois_key(g), g)

    def rotate_rows(self, ct, r):
        n = self.rc.params.n
        return self.apply_galois(ct, pow(5, r % (n // 2), 2 * n))

    def rotate_columns(self, ct):
        return self.apply_galois(ct, 2 * self.rc.params.n - 1)


def _drive(ctx, m1, m2):
    """The same ops in the same order on either package (Galois keys are
    drawn lazily from the context's rng)."""
    ct1, ct2 = ctx.encrypt(ctx.encode(m1)), ctx.encrypt(ctx.encode(m2))
    out = {"encrypt": ct1, "multiply": ctx.multiply(ct1, ct2)}
    out["relinearize"] = ctx.relinearize(out["multiply"])
    out["mod_switch"] = ctx.mod_switch_to_next(out["relinearize"])
    out["rotate_rows"] = ctx.rotate_rows(ct1, 1)
    out["rotate_columns"] = ctx.rotate_columns(ct1)
    out["rotate_low"] = ctx.rotate_rows(out["mod_switch"], 3)
    out["multiply_plain"] = ctx.multiply_plain(ct1, ctx.encode(m2))
    out["add"], out["sub"] = ctx.add(ct1, ct2), ctx.sub(ct1, ct2)
    return out


def _same(port, ref):
    np.testing.assert_array_equal(np.asarray(port.cpu() if isinstance(port, torch.Tensor) else port),
                                  np.asarray(ref).astype(np.int64))


@pytest.fixture(scope="module")
def pair():
    rc = RefBgv(RefParams.make(**PARAMS), seed=5)
    tc = BgvContext(BgvParams.make(**PARAMS), seed=5, device="cpu")
    rng = np.random.default_rng(42)
    m1, m2 = (rng.integers(0, rc.t, (2, PARAMS["n"] // 2)) for _ in range(2))
    return rc, tc, _drive(RefEager(rc), m1, m2), _drive(tc, m1, m2), (m1, m2)


def test_keys(pair):
    rc, tc, *_ = pair
    _same(tc.sk.s_ntt, rc.sk.s_ntt)
    for port, ref in ((tc.pk, rc.pk), (tc.rlk, rc.rlk)):
        _same(port.b, ref.b)
        _same(port.a, ref.a)
    assert sorted(tc._galois) == sorted(rc._galois)
    for g, k in rc._galois.items():
        _same(tc._galois[g].b, k.b)
        _same(tc._galois[g].a, k.a)


@pytest.mark.parametrize("op", OPS)
def test_op_arrays(pair, op):
    _, _, ref, port, _ = pair
    r, p = ref[op], port[op]
    assert (p.size, p.level, p.correction) == (r.size, r.level, r.correction)
    for a, b in zip(p.c, r.c):
        assert a.is_ntt == b.is_ntt
        _same(a.data, b.data)


def test_encode_decode(pair):
    rc, tc, _, _, (m1, _) = pair
    pt = tc.encode(m1)
    _same(pt.data, rc.encode(m1).data)
    coeffs = pt.data[0] % tc.t
    np.testing.assert_array_equal(tc.decode(coeffs), m1)
    np.testing.assert_array_equal(tc.decode(coeffs.numpy()), rc.decode(coeffs.numpy()))


def test_decrypt(pair):
    """The device CRT and the host CRT paths equal the reference's host path
    and the plaintext result, the correction of a modulus switch included."""
    rc, tc, ref, port, (m1, m2) = pair
    want = {"encrypt": m1, "relinearize": m1 * m2 % tc.t, "mod_switch": m1 * m2 % tc.t,
            "rotate_low": np.roll(m1 * m2 % tc.t, -3, axis=1), "add": (m1 + m2) % tc.t,
            "rotate_columns": m1[::-1], "multiply_plain": m1 * m2 % tc.t}
    for op, m in want.items():
        coeffs = tc.decrypt_coeffs_t(port[op])
        np.testing.assert_array_equal(coeffs, tc.decrypt_coeffs_t(port[op], exact=True))
        np.testing.assert_array_equal(tc.decode(coeffs), m)
    np.testing.assert_array_equal(tc.decrypt_coeffs_t(port["rotate_low"], exact=True),
                                  rc.decrypt_coeffs_t(ref["rotate_low"], exact=True))


@pytest.mark.parametrize("n", [256, 4096, 16384])
def test_slot_map_names_the_reference_slots(n):
    """The port's slot map names, for every matrix position, the NTT
    coefficient the reference's Pease order names (the same ψ^e)."""
    nu_port = NttPlan.make(n, find_ntt_primes(n, 20, 1), "cpu").nu
    rho = np.arange(n, dtype=np.int64)                 # the Pease layout (`_slot_map`)
    for s in range(n.bit_length() - 1):
        half, va = (n >> s) // 2, rho[: n // 2]
        rho = np.stack([va, va + half], axis=1).reshape(-1)
    log_n = n.bit_length() - 1
    brev = np.array([int(f"{i:0{log_n}b}"[::-1], 2) for i in range(n)])
    nu_ref = brev[rho]
    np.testing.assert_array_equal(nu_port[port_bgv._slot_map(n)], nu_ref[ref_bgv._slot_map(n)])


def test_t_plan_slots_and_montgomery_form(pair):
    """On the t plan itself: the slot the port's map names holds the word the
    reference's Pease plan holds at its own map (both ×2^32 mod t)."""
    rc, tc, *_ = pair
    x = np.random.default_rng(3).integers(0, tc.t, PARAMS["n"])
    y_port = tc.plan_t.fwd(torch.from_numpy(x)[None])[0].numpy()
    y_ref = np.asarray(negacyclic_ntt(jnp.asarray(x.astype(np.uint32))[None],
                                      PeaseNttPlan.make(PARAMS["n"], [tc.t])))[0]
    n = PARAMS["n"]
    np.testing.assert_array_equal(y_port[port_bgv._slot_map(n)], y_ref[ref_bgv._slot_map(n)])


def test_drop_limb_and_keyswitch_in_t_mode(pair):
    """drop_limb(t=) on random NTT-domain words, whose source row lifts to
    values up to q_src (the reference's Barrett word of c·q_src⁻¹ mod t is
    then not reduced), and keyswitch(t=) alone, against the reference."""
    rc, tc, *_ = pair
    rng = np.random.default_rng(7)
    moduli = np.array(tc.ctx.moduli, dtype=np.int64)[:, None]
    data = rng.integers(0, 1 << 62, (2, 4, PARAMS["n"])) % moduli
    keep = [0, 1, 2]
    _same(drop_limb(torch.from_numpy(data), 3, keep, tc.ctx, t=tc.t),
          ref_drop_limb(jnp.asarray(data.astype(np.uint32)), 3, keep, rc.ctx, t=rc.t))
    d = data[0, :3]
    got = keyswitch(torch.from_numpy(d), tc.rlk, 2, tc.ctx, tc.L, t=tc.t)
    want = ref_keyswitch(jnp.asarray(d.astype(np.uint32)), rc.rlk, 2, rc.ctx, rc.L, t=rc.t)
    for g, w in zip(got, want):
        _same(g, w)


def test_dot_product_bgv():
    """dot_product_bgv at n=256 (tests/test_models.py's context): every slot
    holds Σ x_i·y_i mod t, and the arrays are the reference's fold, run
    eagerly."""
    p = dict(n=256, levels=2, q_bits=30, t_bits=16)
    rc = RefEager(RefBgv(RefParams.make(**p), seed=5))
    tc = BgvContext(BgvParams.make(**p), seed=5, device="cpu")
    rng = np.random.default_rng(1)
    x, y = (rng.integers(0, tc.t, (2, 128)) for _ in range(2))
    got = dot_product_bgv(tc, tc.encrypt(tc.encode(x)), tc.encrypt(tc.encode(y)))
    want = int((x.astype(object) * y.astype(object)).sum()) % tc.t
    assert (tc.decrypt_decode(got) == want).all()
    ref = rc.mod_switch_to_next(rc.relinearize(rc.multiply(rc.encrypt(rc.encode(x)),
                                                            rc.encrypt(rc.encode(y)))))
    step = 1
    while step < 128:
        ref = rc.add(ref, rc.rotate_rows(ref, step))
        step <<= 1
    ref = rc.add(ref, rc.rotate_columns(ref))
    assert got.correction == ref.correction
    for a, b in zip(got.c, ref.c):
        _same(a.data, b.data)
