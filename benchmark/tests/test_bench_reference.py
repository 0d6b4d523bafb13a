"""The reference against the program's own layout, BFV's encryptions and keys
against the program's, and every cell's circuit decrypted by the reference at
a tiny ring on the CPU."""
import numpy as np
import pytest
import torch

from benchmark import program
from benchmark.reference import ntt as rntt, scheme
from benchmark.tests import tiny
from rfhe_tpu_torch.fhe.bgv import BgvContext
from rfhe_tpu_torch.fhe.ckks import CkksContext
from rfhe_tpu_torch.fhe.keys import KeySwitchKey
from rfhe_tpu_torch.fhe.params import BgvParams, CkksParams, make_prime_chain
from rfhe_tpu_torch.ops.ntt import NttPlan


@pytest.mark.parametrize("n,bits", [(256, [30, 28, 28]), (1024, [31, 30]),
                                    (16384, [30, 31]), (65536, [30, 28])])
def test_transform_is_the_programs(n, bits):
    primes = rntt.prime_chain(n, bits)
    assert primes == make_prime_chain(n, bits)
    tab = rntt.Tables.make(n, primes, "cpu")
    plan = NttPlan.make(n, primes, "cpu")
    g = torch.Generator().manual_seed(n)
    x = torch.stack([torch.randint(0, q, (2, n), generator=g) for q in primes], dim=1)
    y = plan.fwd(x.contiguous())
    assert torch.equal(tab.fwd(x), y)
    assert torch.equal(tab.inv(y), x)


def test_basis_is_the_programs():
    """Each configuration's chain, as stated and with grouped digits (dnum 3:
    7 special primes at 21 limbs, 4 at 10)."""
    for name in ("ckks_n65536_l21", "bgv_n16384_l10"):
        for digits in ("per_limb", 3):
            dep = tiny.harness.load_json(tiny.harness.ROOT / f"benchmark/configs/{name}.json")[
                "deployment"]
            dep = dict(dep, n=1024, digits=digits)
            basis = scheme.Basis.make(dep, "cpu")
            dnum = None if digits == "per_limb" else digits
            if dep["scheme"] == "ckks":
                ctx = CkksContext(CkksParams.make(n=1024, levels=dep["levels"],
                                                  q0_bits=dep["q0_bits"],
                                                  scale_bits=dep["scale_bits"]),
                                  special_bits=dep["special_prime_bits"], dnum=dnum,
                                  device="cpu")
            else:
                ctx = BgvContext(BgvParams.make(n=1024, levels=dep["levels"],
                                                q_bits=dep["q_bits"], t_bits=dep["t_bits"]),
                                 special_bits=dep["special_prime_bits"], dnum=dnum,
                                 device="cpu")
                assert ctx.t == basis.t
            assert tuple(ctx.ctx.moduli) == basis.ct + basis.special
            assert len(basis.special) == (1 if dnum is None else -(-basis.L // dnum))


def test_galois_secret_is_the_programs_permutation():
    dep = {"scheme": "ckks", "n": 256, "levels": 2, "q0_bits": 30, "scale_bits": 28,
           "special_prime_bits": 30, "digits": "per_limb"}
    basis = scheme.Basis.make(dep, "cpu")
    keys = scheme.Keys(basis, torch.Generator().manual_seed(3))
    ctx = CkksContext(CkksParams.make(n=256, levels=2, q0_bits=30, scale_bits=28),
                      special_bits=30, device="cpu")
    for g in (5, 25, 2 * 256 - 1):
        mine = basis.tables.fwd(scheme.residues(scheme.automorphism(keys.s, g), basis.tables))
        theirs = keys.s_slots.index_select(-1, ctx.ctx.galois_perm_t(g))
        assert torch.equal(mine, theirs)


def test_bgv_batching_is_the_programs():
    dep = {"scheme": "bgv", "n": 256, "levels": 2, "q_bits": 30, "t_bits": 16,
           "special_prime_bits": 31, "digits": "per_limb"}
    basis = scheme.Basis.make(dep, "cpu")
    ctx = BgvContext(BgvParams.make(n=256, levels=2, q_bits=30, t_bits=16), device="cpu")
    m = torch.randint(0, basis.t, (2, 128), generator=torch.Generator().manual_seed(1))
    coeffs = scheme.bgv_encode(m, basis)
    assert torch.equal(coeffs, ctx.encode(m.numpy()).data[0])
    assert torch.equal(scheme.bgv_decode(coeffs, basis), m)


def test_ckks_embedding_round_trip():
    g = torch.Generator().manual_seed(2)
    z = torch.complex(torch.rand(128, generator=g, dtype=torch.float64),
                      torch.rand(128, generator=g, dtype=torch.float64))
    v = scheme.ckks_encode(z, 2.0 ** 30)
    assert float((scheme.ckks_decode(v, 2.0 ** 30) - z).abs().max()) < 1e-7


def test_decryption_counts_a_foreign_limb():
    dep = {"scheme": "ckks", "n": 256, "levels": 3, "q0_bits": 30, "scale_bits": 28,
           "special_prime_bits": 30, "digits": "per_limb"}
    basis = scheme.Basis.make(dep, "cpu")
    keys = scheme.Keys(basis, torch.Generator().manual_seed(4))
    m = scheme.residues(torch.arange(256) - 100, basis.level_tables(3))
    c0, c1 = keys.encrypt(m[None], 3)
    v, bad = keys.decrypt(c0[0], c1[0])
    assert bad == 0 and int((v - (torch.arange(256) - 100)).abs().max()) < 1000
    c0[0, 3, 7] ^= 1
    assert keys.decrypt(c0[0], c1[0])[1] > 0


@pytest.mark.parametrize("name", tiny.CELLS)
def test_each_cell_decrypts_to_its_plaintext_circuit(name):
    correct, failed, checks, r = tiny.run(name)
    assert correct and failed == 0, checks
    assert len(r.ends) >= 2
    assert all(v == 0 for k, (v, _) in checks.items() if k not in ("slot_err", "noise_bits"))


# -- BFV: the reference's keys and encryptions are the program's ---------------

def _bfv(seed: int):
    """(basis, reference keys, the program's BfvContext holding them, three
    slot matrices) at n = 256, five 30-bit primes, t of 16 bits."""
    dep = tiny.bfv_parts()[1]["deployment"]
    basis = scheme.Basis.make(dep, "cpu")
    gen = torch.Generator().manual_seed(seed)
    keys = scheme.Keys(basis, gen, dep["sigma"])
    ctx = program.build(dep, keys, [], True, seed, "cpu")
    assert type(ctx).__name__ == "BfvContext" and ctx.t == basis.t
    m = torch.randint(0, basis.t, (3, 2, basis.n // 2), generator=gen)
    return basis, keys, ctx, m


def _ref_encrypt(basis, keys, m):
    top = basis.L - 1
    c0, c1 = keys.encrypt(scheme.bfv_message(scheme.bgv_encode(m, basis), basis, top), top)
    return program.ciphertexts(c0, c1)


def test_bfv_reference_encryption_decrypts_in_the_program():
    basis, keys, ctx, m = _bfv(2 ** 31 + 21)
    for ct, want in zip(_ref_encrypt(basis, keys, m), m):
        assert np.array_equal(ctx.decrypt_decode(ct), want.numpy())
        assert np.array_equal(ctx.decode(ctx.decrypt_coeffs_t(ct, exact=True)), want.numpy())


def test_bfv_program_encryption_decrypts_in_the_reference():
    basis, keys, ctx, m = _bfv(2 ** 31 + 22)
    for want in m:
        ct = ctx.encrypt(ctx.encode(want.numpy()))
        got, noise_bits = keys.decrypt_bfv(ct.c[0].data, ct.c[1].data)
        assert torch.equal(scheme.bgv_decode(got, basis), want)
        assert 0 < noise_bits < 20          # fresh: about log2(n·σ), far under log2(Δ/2)


def test_bfv_reference_keys_relinearise_a_program_multiply():
    basis, keys, ctx, m = _bfv(2 ** 31 + 23)
    a, b, _ = _ref_encrypt(basis, keys, m)
    prod = ctx.multiply_relin(a, b)
    assert prod.size == 2
    want = m[0] * m[1] % basis.t
    got, noise_bits = keys.decrypt_bfv(prod.c[0].data, prod.c[1].data)
    assert torch.equal(scheme.bgv_decode(got, basis), want)
    assert np.array_equal(ctx.decrypt_decode(prod), want.numpy())
    # a wrong secret's relinearisation key leaves the product undecryptable
    ctx.rlk = KeySwitchKey(*scheme.Keys(basis, torch.Generator().manual_seed(5))
                                   .relin_key())
    ctx._jits = {}
    bad = ctx.multiply_relin(a, b)
    assert not torch.equal(scheme.bgv_decode(keys.decrypt_bfv(bad.c[0].data, bad.c[1].data)[0],
                                             basis), want)


def test_bfv_decryption_rounds_exactly_at_the_edge_of_the_noise():
    """x = Δ·m + e over 150 bits, |e| up to Δ/2 − t (Q = t·Δ + r, r < t, so
    t·x = Q·m − r·m + t·e): every m comes back, and noise_bits reads the
    widest |e|."""
    basis = scheme.Basis.make(tiny.bfv_parts()[1]["deployment"], "cpu")
    tab, t = basis.level_tables(basis.L - 1), basis.t
    Q = int(np.prod([int(q) for q in tab.primes], dtype=object))
    delta = Q // t
    m = [0, 1, t - 1, t // 2, 12345] + [7] * (basis.n - 5)
    e = [0, -1, 2 ** 100, -(delta // 2 - t), delta // 2 - t] + [3] * (basis.n - 5)
    x = [(delta * mi + ei) % Q for mi, ei in zip(m, e)]
    res = torch.tensor([[xi % q for xi in x] for q in tab.primes])
    got, noise_bits = scheme.bfv_round(res, tab.primes, t)
    assert got.tolist() == m
    assert noise_bits == pytest.approx(np.log2(float(delta // 2 - t + 1)), abs=1e-9)
