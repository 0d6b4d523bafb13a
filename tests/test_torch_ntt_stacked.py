"""Port parity: rfhe_tpu_torch.ops.ntt_stacked (Radix2NttPlan, StackedNttPlan
and the transforms) against rfhe_tpu.ops.ntt at n=256, L=3, tolerance 0."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu import numth as ref_numth
from rfhe_tpu_torch.ops import ntt_stacked as port

torch.set_num_threads(1)
ref = importlib.import_module("rfhe_tpu.ops.ntt")     # rfhe_tpu.ops.ntt is also a function's name

N = 256
PRIMES = ref_numth.find_ntt_primes(N, 30, 3)
CYCLIC_Q = ref_numth.find_ntt_prime(64, 12, negacyclic=False)     # the control campaign's


@pytest.fixture(scope="module")
def plans():
    return {"stacked": (port.StackedNttPlan.make(N, PRIMES, "cpu"), ref.StackedNttPlan.make(N, PRIMES)),
            "single": (port.Radix2NttPlan.make(N, PRIMES[1], "cpu"), ref.NttPlan.make(N, PRIMES[1])),
            "cyclic": (port.Radix2NttPlan.make(64, CYCLIC_Q, "cpu"), ref.NttPlan.make(64, CYCLIC_Q))}


def inputs(kind, plan, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "stacked":
        q = np.array(PRIMES, dtype=np.uint64)[:, None]
        x = (rng.integers(0, 1 << 62, (batch, len(PRIMES), N), dtype=np.uint64) % q)
    else:
        x = rng.integers(0, plan.q, (batch, plan.n), dtype=np.uint64)
    return torch.from_numpy(x.astype(np.int64)), jnp.asarray(x.astype(np.uint32))


def same(a, b):
    assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("kind", ["stacked", "single", "cyclic"])
def test_tables(plans, kind):
    p, r = plans[kind]
    for s in range(len(r.fwd_w)):
        for a, b in ((p.fwd_w, r.fwd_w), (p.fwd_w_shoup, r.fwd_w_shoup),
                     (p.inv_w, r.inv_w), (p.inv_w_shoup, r.inv_w_shoup)):
            same(a[s], b[s])
    for name in ("psi_mont", "psi_mont_shoup", "psi_inv_n"):
        same(getattr(p, name), getattr(r, name))


@pytest.mark.parametrize("kind", ["stacked", "single", "cyclic"])
@pytest.mark.parametrize("fn", ["ntt", "intt", "negacyclic_ntt", "negacyclic_intt"])
def test_transforms(plans, kind, fn):
    p, r = plans[kind]
    x, jx = inputs(kind, p)
    same(getattr(port, fn)(x, p), getattr(ref, fn)(jx, r))


@pytest.mark.parametrize("kind", ["stacked", "single"])
def test_products(plans, kind):
    p, r = plans[kind]
    (a, ja), (b, jb) = inputs(kind, p, seed=1), inputs(kind, p, seed=2)
    same(port.pointwise_mul(a, b, p), ref.pointwise_mul(ja, jb, r))
    same(port.poly_mul_negacyclic(a, b, p), ref.poly_mul_negacyclic(ja, jb, r))
    # the round trip is the identity
    same(port.negacyclic_intt(port.negacyclic_ntt(a, p), p), ja)


def test_slice_and_bit_reverse(plans):
    p, r = plans["stacked"]
    ps, rs = p.slice(2), r.slice(2)
    assert ps.L == rs.L == 2
    x, jx = inputs("stacked", p, batch=1, seed=3)
    same(port.ntt(x[:, :2], ps), ref.ntt(jx[:, :2], rs))
    assert np.array_equal(port.bit_reverse_indices(N), ref.bit_reverse_indices(N))


def test_grid_audit_on_the_cpu(tmp_path):
    """bench/fused_validate.py on the CPU (the plain versions) at two rings:
    the reference's grid, splits and inputs (results/fused_validate_grid.csv's
    n1, n2 and L), a row per point, all true."""
    import csv
    from pathlib import Path

    from rfhe_tpu_torch.bench import fused_validate as fv
    committed = {(r["n"], r["bits"]): r for r in
                 csv.DictReader(open(Path(__file__).parents[1] / "results" / "fused_validate_grid.csv"))}
    saved = fv.NS
    fv.NS = (512, 2048)
    try:
        assert fv.run(str(tmp_path / "grid.csv"), "cpu") == 0
    finally:
        fv.NS = saved
    rows = list(csv.DictReader(open(tmp_path / "grid.csv")))
    assert len(rows) == 6 and list(rows[0]) == fv.COLUMNS
    for r in rows:
        c = committed[(r["n"], r["bits"])]
        assert (r["n1"], r["n2"], r["L"], r["batch"]) == (c["n1"], c["n2"], c["L"], c["batch"])
        assert r["form"] == "plain" and r["fwd_ok"] == r["inv_ok"] == r["roundtrip_ok"] == "1"
    assert set(fv.forms(8192)) == {"one_block", "two_pass", "cluster"}
    assert set(fv.forms(65536)) == {"two_pass", "cluster"}
    primes = fv.grid_primes(1024, fv.BIT_SETS["31+30"])
    assert [p.bit_length() for p in primes] == [31, 30]
