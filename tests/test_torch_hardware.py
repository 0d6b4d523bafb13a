"""The device-buffer fault campaigns, the monitor, the sweeps CLI and the atom
overheads of the port, on the CPU: against rfhe_tpu bit for bit (tolerance
0) where the reference has the same function, and against the committed
CSVs the reference's sweeps wrote."""
import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu import numth as ref_numth
from rfhe_tpu.faults import hardware as ref_hw
from rfhe_tpu.fhe.bgv import BgvContext as RefBgv
from rfhe_tpu.fhe.params import BgvParams as RefBgvParams
from rfhe_tpu.ops.ntt import StackedNttPlan, negacyclic_ntt
from rfhe_tpu_torch import prng
from rfhe_tpu_torch.bench import overheads, real_monitor, sweeps
from rfhe_tpu_torch.device import to_numpy_u32, to_torch
from rfhe_tpu_torch.faults import hardware
from rfhe_tpu_torch.fhe.bgv import BgvContext
from rfhe_tpu_torch.fhe.params import BgvParams
from rfhe_tpu_torch.ops.ntt import NttPlan

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_compare_buffers():
    a = np.random.default_rng(0).integers(0, 1 << 32, (4, 64), dtype=np.uint64).astype(np.uint32)
    b = a.copy()
    b[1, 3] ^= 0b101
    b[2, 7] ^= 1 << 31
    want = ref_hw.compare_buffers(jnp.asarray(a), jnp.asarray(b))
    got = hardware.compare_buffers(to_torch(a, "cpu"), to_torch(b, "cpu"))
    assert vars(got) == vars(want)
    assert (got.hamming_bits, got.symbol_errors) == (3, 2)
    assert got.bit_error_rate == want.bit_error_rate
    assert got.symbol_error_rate == want.symbol_error_rate


@pytest.mark.parametrize("index", [0, 5, 32 * 9 + 5, 32 * 15 + 31])
def test_ciphertext_flip(index):
    x = np.random.default_rng(1).integers(0, 1 << 30, (2, 8), dtype=np.uint32)
    want = np.asarray(ref_hw.ciphertext_flip(jnp.asarray(x), index))
    np.testing.assert_array_equal(to_numpy_u32(hardware.ciphertext_flip(to_torch(x, "cpu"), index)),
                                  want)


@pytest.mark.parametrize("flips, symbols, width", [(1, 1, 30), (3, 7, 30), (15, 7, 30),
                                                   (4, 300, 32)])
def test_flip_bits_host_style(flips, symbols, width):
    x = np.random.default_rng(2).integers(0, 1 << 30, (2, 4, 256), dtype=np.uint32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(ref_hw.flip_bits_host_style(jnp.asarray(x), key, flips, symbols, width))
    got = hardware.flip_bits_host_style(to_torch(x, "cpu"), prng.PRNGKey(9), flips, symbols, width)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.fixture(scope="module")
def ntt_plans():
    primes = ref_numth.find_ntt_primes(256, 30, 4)
    return StackedNttPlan.make(256, primes), NttPlan.make(256, primes, "cpu")


@pytest.mark.parametrize("batch, flips, symbols, seed", [(1, 1, 1, 42), (2, 2, 1, 1),
                                                          (2, 5, 9, 3), (1, 15, 7, 42)])
def test_ntt_flip_campaign(ntt_plans, batch, flips, symbols, seed):
    ref, plan = ntt_plans
    want, want_info = ref_hw.ntt_flip_campaign(ref, batch, flips, symbols, seed=seed)
    got, info = hardware.ntt_flip_campaign(plan, batch, flips, symbols, seed=seed)
    assert vars(got) == vars(want)
    assert info == want_info


def test_ntt_real_test(ntt_plans):
    ref, plan = ntt_plans
    got = hardware.ntt_real_test(plan, batch=2, seed=0)
    assert vars(got) == vars(ref_hw.ntt_real_test(ref, batch=2, seed=0))
    assert got.hamming_bits == 0 and got.symbol_errors == 0


def test_ntt_arrays_through_slot_order(ntt_plans):
    """The arrays behind the statistics: the port's slot p is the reference's
    bit-reversed position pos[p], on the campaign's input and on flipped
    words at or above a larger limb's q."""
    ref, plan = ntt_plans
    k_data, k_flip = jax.random.split(jax.random.PRNGKey(42))
    qmax = int(min(plan.primes))
    x = jax.random.randint(k_data, (2, plan.L, plan.n), 0, qmax, dtype=jnp.uint32)
    x_f = ref_hw.flip_bits_host_style(x, k_flip, 6, 40, bitwidth=qmax.bit_length())
    x_f = x_f.at[1, 0, 7].set((1 << qmax.bit_length()) - 1)      # above every q
    pos = plan.tables.pos.numpy()
    for v in (x, x_f):
        want = np.asarray(negacyclic_ntt(v, ref))[..., pos]
        np.testing.assert_array_equal(to_numpy_u32(plan.fwd(to_torch(np.asarray(v), "cpu"))), want)


DOT = dict(n=256, levels=2, q_bits=30, t_bits=16)


@pytest.fixture(scope="module")
def dot_contexts():
    return RefBgv(RefBgvParams.make(**DOT), seed=5), BgvContext(BgvParams.make(**DOT), seed=5,
                                                                device="cpu")


def test_dotprod_fault_campaign(dot_contexts):
    ref, ctx = dot_contexts
    want = ref_hw.dotprod_fault_campaign(ref, 1, 1, seed=42)
    got = hardware.dotprod_fault_campaign(ctx, 1, 1, seed=42)
    assert got == want
    assert got["clean_product_ok"] and got["clean_dot_ok"]


@pytest.mark.parametrize("bits, symbols", [(0, 0), (8, 1), (1, 4)])
def test_dotprod_campaign_grid(dot_contexts, bits, symbols):
    """The sweep's grid on the port: clean checks hold, and a flip corrupts
    the product (no flip leaves it exact)."""
    _, ctx = dot_contexts
    res = hardware.dotprod_fault_campaign(ctx, bits, symbols, seed=42)
    assert res["clean_product_ok"] and res["clean_dot_ok"]
    assert (res["symbol_errors"] == 0) == (bits * symbols == 0)


def test_dotprod_stress(dot_contexts):
    _, ctx = dot_contexts
    assert hardware.dotprod_stress(ctx, iterations=2, seed=0) == {"iterations": 2, "failures": 0}


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_sweep_pbits_against_committed_rows(tmp_path):
    """pbits 6 and 10 at the committed file's settings (T=2000, W=24, N=64,
    seed 42): every row equals results/pbits_W24_N64_T2000.csv."""
    sweeps.main(["pbits", "--trials", "2000", "--pbits-min", "6", "--pbits-max", "10",
                        "--pbits-step", "4", "--out", str(tmp_path), "--device", "cpu"])
    got = _rows(tmp_path / "cpu_pbits_W24_N64_T2000.csv")
    committed = _rows(ROOT / "results" / "pbits_W24_N64_T2000.csv")
    assert got[0] == committed[0] == sweeps.PBITS_HEADER
    assert got[1:] == [r for r in committed[1:] if r[1] in ("6", "10")]


def test_sweep_ntt_err_against_committed_rows(tmp_path):
    """log N = 12 over 8 primes of 30 bits, batch 1, seed 42: the rows equal
    those of results/flipimpact_logN12.csv."""
    sweeps.main(["ntt_err", "--max-flips", "3", "--max-symbols", "2", "--out", str(tmp_path),
                 "--device", "cpu"])
    got = _rows(tmp_path / "cpu_flipimpact_logN12.csv")
    committed = _rows(ROOT / "results" / "flipimpact_logN12.csv")
    assert got[0] == committed[0]
    assert got[1:] == [r for r in committed[1:] if int(r[0]) <= 3 and int(r[1]) <= 2]


def test_sweep_relia_ntt(tmp_path):
    sweeps.main(["relia_ntt", "--trials", "32", "--qbits-min", "10", "--qbits-max", "12",
                 "--out", str(tmp_path), "--device", "cpu"])
    rows = _rows(tmp_path / "cpu_reliaNTT_N64_T32.csv")
    assert rows[0] == sweeps.RELIA_HEADER
    assert [(r[0], r[1]) for r in rows[1:]] == [(b, k) for b in ("10", "12")
                                                for k in ("SBF", "DBF", "MOF1")]


def test_sweep_dotprod(tmp_path):
    sweeps.main(["dotprod", "--N", "64", "--max-bits", "2", "--max-symbols", "3",
                 "--out", str(tmp_path), "--device", "cpu"])
    rows = _rows(tmp_path / "cpu_dotprod_N64.csv")
    assert rows[0] == sweeps.DOTPROD_HEADER
    assert [(r[0], r[1]) for r in rows[1:]] == [("1", "1"), ("2", "1"), ("1", "2"), ("1", "3")]
    assert sweeps.dotprod_grid(8, 4) == [(b, 1) for b in range(1, 9)] + [(1, 2), (1, 3), (1, 4)]


def test_real_monitor(tmp_path):
    out = tmp_path / "monitor.txt"
    res = real_monitor.run(runs=3, log_dim=8, batch=2, dot_every=2, out=str(out), device="cpu",
                           log=None)
    assert res["runs"] == 3 and res["faults"] == 0 and res["captures"] == []
    lines = out.read_text().splitlines()
    assert lines[0].startswith("# real-fault monitor: device=cpu n=256 batch=2 runs=3")
    assert [ln.split("\t")[:2] for ln in lines[2:-1]] == [["0", "ntt"], ["0", "dotprod"],
                                                           ["1", "ntt"], ["2", "ntt"],
                                                           ["2", "dotprod"]]
    assert lines[-1].startswith("# finished: 3 runs, 0 silent faults")


def test_overhead_atoms_agree():
    """The protected atoms return the plain atoms' outputs; the NTT's and
    ModMul's flags hold on clean data (the four-step checks are held against
    the reference in tests/test_torch_four_step.py).  The BaseConv atom's
    check fires on clean data in the reference too: its appended column is
    the sum of each input limb mod p_j, not the exact sum, so the converted
    column does not match; the atom is a timing atom and the port gives the
    reference's flags."""
    import random
    from rfhe_tpu.ops.baseconv import BaseConvPlan, base_conv
    from rfhe_tpu.protect.checks import baseconv_append_checksum, baseconv_ecc_check
    atoms = overheads.atoms(n=256, batch=2, device="cpu")
    assert set(atoms) == set(overheads.ATOMS)
    flags = {}
    for name, (plain, prot) in atoms.items():
        out, ok = prot()
        assert torch.equal(out, plain()), name
        flags[name] = ok.numpy()
    assert flags["NTTCost"].all() and flags["ModmulCost"].all()
    rng = np.random.default_rng(0)
    q = ref_numth.find_ntt_prime(256, 30)
    for _ in range(3):                         # x, a and b, drawn before the residues
        rng.integers(0, q, (2, 256), dtype=np.uint32)
    m_in = ref_numth.generate_crt_primes(8, 28, random.Random(1))
    m_out = ref_numth.generate_crt_primes(4, 30, random.Random(2))
    res = jnp.asarray(np.stack([rng.integers(0, p, 256, dtype=np.uint32) for p in m_in]))
    out = base_conv(baseconv_append_checksum(res, list(m_in)), BaseConvPlan.make(m_in, m_out))
    np.testing.assert_array_equal(atoms["BaseConvCost"][0]().numpy(),
                                  np.asarray(base_conv(res, BaseConvPlan.make(m_in, m_out))))
    assert flags["BaseConvCost"] == np.asarray(baseconv_ecc_check(out, list(m_out)))


def test_dotprod_exact_decrypt_inside_the_window():
    """Where a clean product's noise is inside decrypt_decode's 2^62 window,
    the exact CRT gives the same clean checks and dot products (two fresh
    contexts, same draws).  The faulty product's error is a random value mod
    Q, far outside the window, so its decoded words, and the bit errors
    counted from them, depend on the CRT."""
    runs = [hardware.dotprod_fault_campaign(
        BgvContext(BgvParams.make(**DOT), seed=5, device="cpu"), 2, 2, seed=7, exact_decrypt=e)
        for e in (False, True)]
    assert runs[0]["clean_product_ok"] and runs[0]["clean_dot_ok"]
    for k in runs[0]:
        if k != "bit_errors":
            assert runs[0][k] == runs[1][k], k
