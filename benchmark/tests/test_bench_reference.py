"""The reference against the program's own layout, and every cell's circuit
decrypted by the reference at a tiny ring on the CPU."""
import pytest
import torch

from benchmark.reference import ntt as rntt, scheme
from benchmark.tests import tiny
from rfhe_tpu_torch.fhe.bgv import BgvContext
from rfhe_tpu_torch.fhe.ckks import CkksContext
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
    assert all(v == 0 for k, (v, _) in checks.items() if k != "slot_err")
