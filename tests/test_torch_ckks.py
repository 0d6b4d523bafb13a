"""The port's CKKS slice against rfhe_tpu with the same parameters and seed
(n=1024, 3 ciphertext primes, a 31-bit special prime, as tests/test_ckks.py):
keys, every ciphertext array and the decrypted 64-bit words are identical.
Keys and ciphertexts made by the reference also carry into a port context of
another seed.  Tolerance 0 for every integer array."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu.fhe import CkksContext as RefContext, CkksParams as RefParams
from rfhe_tpu.ops.crt64 import Crt64Plan as RefCrt64Plan, crt_to_words as ref_crt_to_words
from rfhe_tpu_torch.fhe import Ciphertext, CkksContext, CkksParams
from rfhe_tpu_torch.fhe.keys import compute_digits, keyswitch
from rfhe_tpu_torch.fhe.rns import drop_limb
from rfhe_tpu_torch.ops.crt64 import Crt64Plan, crt_to_words

torch.set_num_threads(1)

PARAMS = dict(n=1024, levels=2, q0_bits=30, scale_bits=26)
OPS = ["encrypt", "rotate", "conjugate", "multiply", "multiply_relin", "rescale",
       "add", "sub", "multiply_plain"]


def _drive(ctx, z1, z2):
    """The same ops in the same order on either package (keys are drawn
    lazily from the context's rng, so the order is part of the contract)."""
    ct1 = ctx.encrypt(*ctx.encode(z1))
    ct2 = ctx.encrypt(*ctx.encode(z2))
    out = {"encrypt": ct1, "rotate": ctx.rotate(ct1, 1), "conjugate": ctx.conjugate(ct1),
           "multiply": ctx.multiply(ct1, ct2)}
    out["multiply_relin"] = ctx.multiply_relin(ct1, ct2)
    out["rescale"] = ctx.rescale(out["multiply_relin"])
    out["add"] = ctx.add(ct1, ct2)
    out["sub"] = ctx.sub(ct1, ct2)
    out["multiply_plain"] = ctx.multiply_plain(ct1, *ctx.encode(z2))
    out["ct2"] = ct2
    return out


def _ref_state(rc):
    """The reference context's key material under `load_keys`' names."""
    st = {"sk_s_ntt": np.asarray(rc.sk.s_ntt), "sk_s_coeff": rc.sk.s_coeff,
          "pk_b": np.asarray(rc.pk.b), "pk_a": np.asarray(rc.pk.a)}
    for g, k in rc._galois.items():
        st[f"galois_{g}_b"], st[f"galois_{g}_a"] = np.asarray(k.b), np.asarray(k.a)
    st["rlk_b"], st["rlk_a"] = np.asarray(rc.rlk.b), np.asarray(rc.rlk.a)
    return st


@pytest.fixture(scope="module")
def pair():
    rc = RefContext(RefParams.make(**PARAMS), special_bits=31, seed=3)
    tc = CkksContext(CkksParams.make(**PARAMS), special_bits=31, seed=3, device="cpu")
    rng = np.random.default_rng(42)
    n2 = PARAMS["n"] // 2
    z1 = rng.uniform(-1, 1, n2) + 1j * rng.uniform(-1, 1, n2)
    z2 = rng.uniform(-1, 1, n2) + 1j * rng.uniform(-1, 1, n2)
    return rc, tc, _drive(rc, z1, z2), _drive(tc, z1, z2), (z1, z2)


def _same(ref_arr, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_arr).astype(np.int64))


def test_params_and_special_prime(pair):
    rc, tc, *_ = pair
    assert tc.params.moduli == rc.params.moduli
    assert tc.special == rc.special and tc.ctx.moduli == rc.ctx.moduli


def test_keys_identical(pair):
    rc, tc, *_ = pair
    _same(rc.sk.s_ntt, tc.sk.s_ntt)
    np.testing.assert_array_equal(tc.sk.s_coeff, rc.sk.s_coeff)
    _same(rc.pk.b, tc.pk.b)
    _same(rc.pk.a, tc.pk.a)
    for g in (rc.rotation_galois_element(1), 2 * PARAMS["n"] - 1):
        _same(rc.galois_key(g).b, tc.galois_key(g).b)
        _same(rc.galois_key(g).a, tc.galois_key(g).a)
    _same(rc.rlk.b, tc.rlk.b)
    _same(rc.rlk.a, tc.rlk.a)


@pytest.mark.parametrize("op", OPS)
def test_ciphertext_identical(pair, op):
    _, _, ref, port, _ = pair
    r, t = ref[op], port[op]
    assert t.size == r.size and t.level == r.level and t.scale == r.scale
    for rp, tp in zip(r.c, t.c):
        assert tp.is_ntt == rp.is_ntt
        _same(rp.data, tp.data)


@pytest.mark.parametrize("op", ["encrypt", "rotate", "multiply_relin", "rescale"])
def test_decrypted_words_identical(pair, op):
    rc, tc, ref, port, _ = pair
    r = ref[op]
    plan = RefCrt64Plan.make(rc.params.moduli[:r.level + 1])
    hi_r, lo_r = ref_crt_to_words(rc.decrypt(r).data, plan)
    hi, lo = tc.decrypt_words(port[op])
    _same(hi_r, hi)
    _same(lo_r, lo)
    np.testing.assert_array_equal(tc.decrypt_decode(port[op]), rc.decrypt_decode(r))


def test_decrypt_decode_values(pair):
    _, tc, _, port, (z1, z2) = pair
    np.testing.assert_allclose(tc.decrypt_decode(port["encrypt"]), z1, atol=1e-3)
    np.testing.assert_allclose(tc.decrypt_decode(port["rotate"]), np.roll(z1, -1), atol=1e-2)
    np.testing.assert_allclose(tc.decrypt_decode(port["conjugate"]), np.conj(z1), atol=1e-2)
    np.testing.assert_allclose(tc.decrypt_decode(port["rescale"]), z1 * z2, atol=1e-2)
    np.testing.assert_allclose(tc.decrypt_decode(port["add"]), z1 + z2, atol=1e-3)
    np.testing.assert_allclose(tc.decrypt_decode(port["rescale"], exact=True), z1 * z2, atol=1e-2)


def test_reference_keys_and_ciphertexts_carry_over(pair):
    """JAX-made keys and ciphertexts in a port context of another seed."""
    rc, _, ref, _, _ = pair
    tc = CkksContext(CkksParams.make(**PARAMS), special_bits=31, seed=11, device="cpu")
    tc.load_keys(_ref_state(rc))
    ct1 = Ciphertext.from_numpy([np.asarray(p.data) for p in ref["encrypt"].c],
                                ref["encrypt"].scale, True, "cpu")
    ct2 = Ciphertext.from_numpy([np.asarray(p.data) for p in ref["ct2"].c],
                                ref["ct2"].scale, True, "cpu")
    out = tc.apply_galois(ct1, rc.rotation_galois_element(1))
    for rp, tp in zip(ref["rotate"].c, out.c):
        _same(rp.data, tp.data)
    out = tc.multiply_relin(ct1, ct2)
    for rp, tp in zip(ref["multiply_relin"].c, out.c):
        _same(rp.data, tp.data)
    np.testing.assert_array_equal(ct1.to_numpy()[0], np.asarray(ref["encrypt"].c[0].data))


def test_export_load_roundtrip(pair):
    _, tc, _, port, _ = pair
    state = tc.export_keys()
    assert {"sk_s_ntt", "pk_b", "rlk_a", f"galois_{tc.rotation_galois_element(1)}_b"} <= set(state)
    other = CkksContext(CkksParams.make(**PARAMS), special_bits=31, seed=5, device="cpu")
    other.load_keys(state)
    again = other.export_keys()
    assert state.keys() == again.keys()
    for k in state:
        np.testing.assert_array_equal(state[k], again[k])
    np.testing.assert_array_equal(other.decrypt_decode(port["rotate"]),
                                  tc.decrypt_decode(port["rotate"]))


def test_crt_to_words_matches_reference():
    moduli = CkksParams.make(**PARAMS).moduli
    rng = np.random.default_rng(4)
    vals = rng.integers(-(1 << 61), 1 << 61, size=(2, 64), dtype=np.int64)
    vals[0, :3] = [0, -1, (1 << 61) - 1]
    x = np.stack([np.mod(vals, q) for q in moduli], axis=-2).astype(np.uint32)
    hi_r, lo_r = ref_crt_to_words(x, RefCrt64Plan.make(moduli))
    hi, lo = crt_to_words(torch.from_numpy(x.astype(np.int64)), Crt64Plan.make(moduli, "cpu"))
    _same(hi_r, hi)
    _same(lo_r, lo)
    signed = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
    np.testing.assert_array_equal(signed.astype(np.int64), vals)


def test_outside_the_slice_raises(pair):
    """What the port refuses (dnum=0, a missing device), and what it no
    longer refuses: the BGV t-mode of drop_limb and keyswitch equal to the
    reference's on the same words, and encrypt_seeded's c1 from the seed."""
    from rfhe_tpu.fhe.keys import keyswitch as ref_keyswitch
    from rfhe_tpu.fhe.rns import drop_limb as ref_drop_limb
    from rfhe_tpu_torch.fhe.serialize import sample_uniform_a
    rc, tc, _, port, _ = pair
    with pytest.raises(ValueError):
        CkksContext(CkksParams.make(**PARAMS), seed=3, dnum=0, device="cpu")
    with pytest.raises(TypeError):
        CkksContext(CkksParams.make(**PARAMS), seed=3)      # no default device
    ct = tc.encrypt_seeded(*tc.encode(np.zeros(PARAMS["n"] // 2)), seed=1)
    np.testing.assert_array_equal(ct.to_numpy()[1],
                                  sample_uniform_a(1, (3, PARAMS["n"]), tc.params.moduli))
    d = port["encrypt"].c[0].data
    dj = jnp.asarray(d.numpy().astype(np.uint32))
    np.testing.assert_array_equal(drop_limb(d, 2, 2, tc.ctx, t=65537).numpy(),
                                  np.asarray(ref_drop_limb(dj, 2, 2, rc.ctx, t=65537)))
    got = keyswitch(d, tc.rlk, 2, tc.ctx, tc.L, t=65537)
    want = ref_keyswitch(dj, rc.rlk, 2, rc.ctx, rc.L, t=65537)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(compute_digits(d, 2, tc.ctx, tc.L, with_ecc=True)) == 4
