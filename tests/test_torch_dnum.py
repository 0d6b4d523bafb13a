"""Grouped-digit (dnum) keyswitching in the port against rfhe_tpu, with the
parameters and seed of tests/test_dnum.py (n=512, 6 ciphertext primes,
dnum 2 and 3, i.e. 3 and 2 special primes): group layout, base-extension
constants, keys, digits at full level and after two rescales (a partial last
group), every ciphertext array and the decrypted 64-bit words.  The same
numpy inputs go into both packages.  Tolerance 0 for every integer array."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rfhe_tpu.fhe import CkksContext as RefContext, CkksParams as RefParams
from rfhe_tpu.fhe import keys as ref_keys
from rfhe_tpu.fhe import rns as ref_rns
from rfhe_tpu.ops.crt64 import Crt64Plan as RefCrt64Plan, crt_to_words as ref_crt_to_words
from rfhe_tpu_torch.fhe import Ciphertext, CkksContext, CkksParams
from rfhe_tpu_torch.fhe import keys, rns

torch.set_num_threads(1)

PARAMS = dict(n=512, levels=5, q0_bits=30, scale_bits=26)
SEED = 3
OPS = ["encrypt", "rotate", "multiply_relin", "rescale", "rescale2", "rotate_low"]


def _drive(ctx, z):
    """The same ops in the same order on either package; two rescales bring
    the ciphertext to level 3, where the last digit group is partial."""
    ct = ctx.encrypt(*ctx.encode(z))
    out = {"encrypt": ct, "rotate": ctx.rotate(ct, 1)}
    out["multiply_relin"] = ctx.multiply_relin(ct, ct)
    out["rescale"] = ctx.rescale(out["multiply_relin"])
    out["rescale2"] = ctx.rescale(ctx.multiply_relin(out["rescale"], out["rescale"]))
    out["rotate_low"] = ctx.rotate(out["rescale2"], 3)
    return out


def _ref_state(rc):
    st = {"sk_s_ntt": np.asarray(rc.sk.s_ntt), "sk_s_coeff": rc.sk.s_coeff,
          "pk_b": np.asarray(rc.pk.b), "pk_a": np.asarray(rc.pk.a)}
    for g, k in rc._galois.items():
        st[f"galois_{g}_b"], st[f"galois_{g}_a"] = np.asarray(k.b), np.asarray(k.a)
    st["rlk_b"], st["rlk_a"] = np.asarray(rc.rlk.b), np.asarray(rc.rlk.a)
    return st


@pytest.fixture(scope="module", params=[2, 3])
def pair(request):
    dnum = request.param
    rc = RefContext(RefParams.make(**PARAMS), seed=SEED, dnum=dnum)
    tc = CkksContext(CkksParams.make(**PARAMS), seed=SEED, dnum=dnum, device="cpu")
    z = np.random.default_rng(1).uniform(0.3, 1, PARAMS["n"] // 2) + 0j
    return dnum, rc, tc, _drive(rc, z), _drive(tc, z), z


def _same(ref_arr, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_arr).astype(np.int64))


@pytest.mark.parametrize("L, dnum", [(6, 1), (6, 2), (6, 3), (6, 4), (6, 6), (21, 3), (21, 4)])
def test_digit_groups(L, dnum):
    groups = keys._digit_groups(L, dnum)
    assert groups == ref_keys._digit_groups(L, dnum)
    assert [l for g in groups for l in g] == list(range(L))


def test_basis_and_special_primes(pair):
    dnum, rc, tc, *_ = pair
    assert tc.specials == rc.specials and tc.special == rc.special
    assert len(tc.specials) == -(-tc.L // dnum)
    assert tc.ctx.moduli == rc.ctx.moduli


@pytest.mark.parametrize("active", [6, 4, 3])
def test_group_ext_consts(pair, active):
    dnum, rc, *_ = pair
    L = rc.L
    lim = tuple(range(active)) + tuple(range(L, len(rc.ctx.moduli)))
    for grp in keys._digit_groups(L, dnum):
        G = tuple(l for l in grp if l < active)
        if len(G) < 2:
            continue
        got = keys._group_ext_consts(tuple(rc.ctx.moduli), G, lim)
        want = ref_keys._group_ext_consts(tuple(rc.ctx.moduli), G, lim)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_grouped_keys_identical(pair):
    dnum, rc, tc, *_ = pair
    shape = (dnum, rc.L + len(rc.specials), PARAMS["n"])
    for g in (rc.rotation_galois_element(1), rc.rotation_galois_element(3)):
        assert tuple(tc.galois_key(g).b.shape) == shape
        _same(rc.galois_key(g).b, tc.galois_key(g).b)
        _same(rc.galois_key(g).a, tc.galois_key(g).a)
    _same(rc.rlk.b, tc.rlk.b)
    _same(rc.rlk.a, tc.rlk.a)


@pytest.mark.parametrize("level", [5, 3, 2, 0])
def test_compute_digits_identical(pair, level):
    """Full level; level 3 after two rescales (for dnum=2 the last group is
    cut to one limb, which takes the single-limb branch beside a grouped
    one); levels 2 and 0 (a cut group of one; a lone single-limb digit)."""
    dnum, rc, tc, *_ = pair
    rng = np.random.default_rng(level)
    d = np.stack([rng.integers(0, q, PARAMS["n"], dtype=np.uint32)
                  for q in rc.params.moduli[:level + 1]])
    d[:, 0] = np.array(rc.params.moduli[:level + 1], dtype=np.uint32) - 1
    dig_r, used_r, lim_r = ref_keys.compute_digits(jnp.asarray(d), level, rc.ctx, rc.L, dnum)
    dig, used, lim = keys.compute_digits(torch.from_numpy(d.astype(np.int64)), level,
                                         tc.ctx, tc.L, dnum)
    assert (used, lim) == (used_r, lim_r)
    _same(dig_r, dig)


@pytest.mark.parametrize("op", OPS)
def test_ciphertext_identical(pair, op):
    _, _, _, ref, port, _ = pair
    r, t = ref[op], port[op]
    assert t.size == r.size and t.level == r.level and t.scale == r.scale
    for rp, tp in zip(r.c, t.c):
        assert tp.is_ntt == rp.is_ntt
        _same(rp.data, tp.data)


@pytest.mark.parametrize("op", ["rotate", "rescale", "rescale2", "rotate_low"])
def test_decrypted_words_identical(pair, op):
    _, rc, tc, ref, port, _ = pair
    r = ref[op]
    plan = RefCrt64Plan.make(rc.params.moduli[:r.level + 1])
    hi_r, lo_r = ref_crt_to_words(rc.decrypt(r).data, plan)
    hi, lo = tc.decrypt_words(port[op])
    _same(hi_r, hi)
    _same(lo_r, lo)
    np.testing.assert_array_equal(tc.decrypt_decode(port[op]), rc.decrypt_decode(r))


def test_decrypt_decode_values(pair):
    _, _, tc, _, port, z = pair
    np.testing.assert_allclose(tc.decrypt_decode(port["rotate"]), np.roll(z, -1), atol=5e-2)
    np.testing.assert_allclose(tc.decrypt_decode(port["rescale"]), z ** 2, atol=5e-2)
    np.testing.assert_allclose(tc.decrypt_decode(port["rescale2"]), z ** 4, atol=1e-1)
    np.testing.assert_allclose(tc.decrypt_decode(port["rotate_low"]), np.roll(z ** 4, -3), atol=1e-1)


def test_drop_limb_special_source_and_keep(pair):
    """`drop_limb` as the grouped mod-down calls it: the source row is a
    special prime, put last, and the keep list ends in special primes."""
    dnum, rc, tc, *_ = pair
    L, n_sp = rc.L, len(rc.specials)
    active = 4
    keep = list(range(active)) + list(range(L, L + n_sp - 1))
    src = L + n_sp - 1
    rows = keep + [src]
    rng = np.random.default_rng(dnum)
    data = np.stack([np.stack([rng.integers(0, rc.ctx.moduli[i], PARAMS["n"], dtype=np.uint32)
                               for i in rows]) for _ in range(2)])
    want = ref_rns.drop_limb(jnp.asarray(data), src, keep, rc.ctx)
    got = rns.drop_limb(torch.from_numpy(data.astype(np.int64)), src, keep, tc.ctx)
    assert tuple(got.shape) == (2, len(keep), PARAMS["n"])
    _same(want, got)


def test_reference_grouped_keys_and_ciphertexts_carry_over(pair):
    """JAX-made grouped keys and ciphertexts in a port context of another
    seed give the reference's arrays; keys of another dnum are refused."""
    dnum, rc, _, ref, _, _ = pair
    tc = CkksContext(CkksParams.make(**PARAMS), seed=11, dnum=dnum, device="cpu")
    state = _ref_state(rc)
    tc.load_keys(state)
    back = tc.export_keys()
    assert back["rlk_b"].shape == (dnum, rc.L + len(rc.specials), PARAMS["n"])
    for name in state:
        np.testing.assert_array_equal(back[name], state[name])
    load = lambda name: Ciphertext.from_numpy([np.asarray(p.data) for p in ref[name].c],
                                              ref[name].scale, True, "cpu")
    ct, low = load("encrypt"), load("rescale2")
    for out, name in [(tc.rotate(ct, 1), "rotate"), (tc.multiply_relin(ct, ct), "multiply_relin"),
                      (tc.rotate(low, 3), "rotate_low")]:
        for rp, tp in zip(ref[name].c, out.c):
            _same(rp.data, tp.data)
    other = CkksContext(CkksParams.make(**PARAMS), seed=11, dnum=5 - dnum, device="cpu")
    with pytest.raises(ValueError):
        other.load_keys(state)
