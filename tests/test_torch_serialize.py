"""The port's serialization against rfhe_tpu's, byte for byte, with
tests/test_serialize.py's context (CKKS n=64, 3 primes, seed 11): ciphertexts
in the three compression modes, public and keyswitch keys, a BGV ciphertext
with a modulus-switch correction, the seeded wire form of encrypt_seeded,
and the SHAKE-256 stream `sample_uniform_a`.  Tolerance 0."""
import numpy as np
import pytest
import torch

from rfhe_tpu.fhe import CkksContext as RefContext, CkksParams as RefParams
from rfhe_tpu.fhe import serialize as rser
from rfhe_tpu.fhe.bgv import BgvContext as RefBgv
from rfhe_tpu.fhe.params import BgvParams as RefBgvParams
from rfhe_tpu_torch.fhe import BgvContext, BgvParams, CkksContext, CkksParams
from rfhe_tpu_torch.fhe import serialize as ser

torch.set_num_threads(1)

PARAMS = dict(n=64, levels=2, q0_bits=30, scale_bits=26)


@pytest.fixture(scope="module")
def pair():
    """Both contexts of seed 11 with the same draws in the same order: a
    public-key and a seeded encryption of the same slots."""
    rc = RefContext(RefParams.make(**PARAMS), seed=11)
    tc = CkksContext(CkksParams.make(**PARAMS), seed=11, device="cpu")
    z = np.random.default_rng(0).uniform(-1, 1, 32) + 0j
    out = {}
    for name, ctx in (("ref", rc), ("port", tc)):
        pt, sc = ctx.encode(z)
        out[name] = (ctx.encrypt(pt, sc), ctx.encrypt_seeded(pt, sc, seed=1234))
    return rc, tc, out, z


@pytest.mark.parametrize("comp", ["none", "zlib", "lzma"])
def test_ciphertext_bytes(pair, comp):
    rc, tc, out, z = pair
    blob = ser.serialize_ciphertext(out["port"][0], compression=comp)
    assert blob == rser.serialize_ciphertext(out["ref"][0], compression=comp)
    back = ser.deserialize_ciphertext(blob, device="cpu")
    assert (back.scale, back.correction) == (out["port"][0].scale, 1)
    for a, b in zip(back.c, out["port"][0].c):
        assert a.is_ntt == b.is_ntt and torch.equal(a.data, b.data)
    assert np.abs(tc.decrypt_decode(back) - z).max() < 1e-3


@pytest.mark.parametrize("comp", ["none", "zlib"])
def test_key_bytes(pair, comp):
    rc, tc, *_ = pair
    assert ser.serialize_public_key(tc.pk, comp) == rser.serialize_public_key(rc.pk, comp)
    assert ser.serialize_keyswitch_key(tc.rlk, comp) == rser.serialize_keyswitch_key(rc.rlk, comp)
    pk = ser.deserialize_public_key(ser.serialize_public_key(tc.pk, comp), device="cpu")
    ksk = ser.deserialize_keyswitch_key(ser.serialize_keyswitch_key(tc.rlk, comp), device="cpu")
    assert torch.equal(pk.b, tc.pk.b) and torch.equal(pk.a, tc.pk.a)
    assert torch.equal(ksk.b, tc.rlk.b) and torch.equal(ksk.a, tc.rlk.a)
    with pytest.raises(ValueError, match="expected public_key"):
        ser.deserialize_public_key(ser.serialize_keyswitch_key(tc.rlk), device="cpu")


def test_seeded_ciphertext_bytes(pair):
    """encrypt_seeded's arrays, its half-size wire form, the regeneration of
    c1 from the seed, and the refusal of a public-key encryption."""
    rc, tc, out, z = pair
    ct, r_ct = out["port"][1], out["ref"][1]
    for a, b in zip(ct.c, r_ct.c):
        np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data).astype(np.int64))
    moduli = tc.params.moduli
    blob = ser.serialize_ciphertext_seeded(ct, 1234, moduli, "zlib")
    assert blob == rser.serialize_ciphertext_seeded(r_ct, 1234, rc.params.moduli, "zlib")
    back = ser.deserialize_ciphertext_seeded(blob, moduli, device="cpu")
    assert all(torch.equal(a.data, b.data) for a, b in zip(back.c, ct.c))
    assert np.abs(tc.decrypt_decode(back) - z).max() < 1e-3
    assert len(blob) < 0.6 * len(ser.serialize_ciphertext(ct, "zlib"))
    with pytest.raises(ValueError, match="seed does not regenerate"):
        ser.serialize_ciphertext_seeded(out["port"][0], 1234, moduli)


@pytest.mark.parametrize("seed, shape", [(0, (3, 64)), (2 ** 300 + 5, (2, 4, 16)), (7, (1, 4096))])
def test_sample_uniform_a(seed, shape):
    moduli = (1073479681, 65537, 12289)
    np.testing.assert_array_equal(ser.sample_uniform_a(seed, shape, moduli),
                                  rser.sample_uniform_a(seed, shape, moduli))


def test_bgv_ciphertext_with_correction_bytes():
    """A BGV ciphertext after mod_switch_to_next carries its correction in
    the header: the same bytes as the reference's."""
    p = dict(n=256, levels=2, q_bits=30, t_bits=16)
    rc = RefBgv(RefBgvParams.make(**p), seed=5)
    tc = BgvContext(BgvParams.make(**p), seed=5, device="cpu")
    m = np.random.default_rng(2).integers(0, tc.t, (2, 128))
    r_ct = rc._mod_switch_impl(rc.encrypt(rc.encode(m)))
    ct = tc.mod_switch_to_next(tc.encrypt(tc.encode(m)))
    assert ct.correction != 1
    blob = ser.serialize_ciphertext(ct, "lzma")
    assert blob == rser.serialize_ciphertext(r_ct, "lzma")
    np.testing.assert_array_equal(tc.decrypt_decode(ser.deserialize_ciphertext(blob, device="cpu")), m)
