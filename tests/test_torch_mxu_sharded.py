"""transform/mxu_sharded.py against rfhe_tpu.transform.mxu_sharded and the
port's NttPlan, bit for bit, at n=4096 with 3 limbs over meshes of 8 and 2
ranks: forward, inverse, round trip, a batch dimension, and the guarded
form clean and with one corrupted output word.  The port runs in one world
of 8 gloo processes on the CPU; the reference on conftest's 8-device
virtual CPU mesh, each call under jit (its shard_map run eagerly takes
20-70 s a call there, compiled about 1 s)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rfhe_tpu import numth
from rfhe_tpu.ops.ntt_mxu import MxuNttPlan
from rfhe_tpu.protect.ntt_guard import NttGuard
from rfhe_tpu.transform.mxu_sharded import (
    mxu_intt_sharded, mxu_ntt_sharded, mxu_ntt_sharded_protected)
from rfhe_tpu_torch.ops.ntt import NttPlan
from rfhe_tpu_torch.parallel import worlds
from rfhe_tpu_torch.parallel.mesh import spawn_world
from rfhe_tpu_torch.protect.ntt_guard import NttGuard as PortGuard

torch.set_num_threads(1)

n = 4096
PRIMES = numth.find_ntt_primes(n, 30, 3)
SIZES = (8, 2)
FLIP_Y = (1, 2999, 3)        # limb 1, slot 2999 (k2 = 23: rank 5 of 8) bit 3


@pytest.fixture(scope="module")
def plan():
    return MxuNttPlan.make(n, PRIMES)


@pytest.fixture(scope="module")
def port_plan():
    return NttPlan.make(n, PRIMES, "cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    qmin = min(PRIMES)
    return (rng.integers(0, qmin, (3, n), dtype=np.uint32),
            rng.integers(0, qmin, (4, 3, n), dtype=np.uint32))


@pytest.fixture(scope="module")
def port(inputs):
    x, xb = inputs
    return spawn_world(worlds.mxu_cases, 8, "gloo", args=(n, PRIMES, x, xb, FLIP_Y, SIZES, "cpu"),
                       timeout_s=60, deadline_s=300)[0]


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 CPU devices"
    return {D: Mesh(np.array(devs[:D]), ("fft",)) for D in SIZES}


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("D", SIZES)
def test_sharded_fwd_bit_exact(port, plan, port_plan, meshes, inputs, D):
    x = jnp.asarray(inputs[0])
    ref = jax.jit(lambda v: mxu_ntt_sharded(v, plan, meshes[D]))(x)
    np.testing.assert_array_equal(port[D, "fwd"], np.asarray(ref))
    np.testing.assert_array_equal(port[D, "fwd"], port_plan.fwd(_t(inputs[0])).numpy())


@pytest.mark.parametrize("D", SIZES)
def test_sharded_inv_bit_exact(port, plan, port_plan, meshes, inputs, D):
    y = plan.fwd(jnp.asarray(inputs[0]))
    ref = np.asarray(jax.jit(lambda v: mxu_intt_sharded(v, plan, meshes[D]))(y))
    np.testing.assert_array_equal(port[D, "inv"], ref)
    np.testing.assert_array_equal(port[D, "inv"], port_plan.inv(port_plan.fwd(_t(inputs[0]))).numpy())


@pytest.mark.parametrize("D", SIZES)
def test_sharded_roundtrip(port, inputs, D):
    np.testing.assert_array_equal(port[D, "roundtrip"], inputs[0])


@pytest.mark.parametrize("D", SIZES)
def test_sharded_batch_dim(port, plan, port_plan, meshes, inputs, D):
    xb = inputs[1]
    ref = jax.jit(lambda v: mxu_ntt_sharded(v, plan, meshes[D]))(jnp.asarray(xb))
    np.testing.assert_array_equal(port[D, "fwd_batch"], np.asarray(ref))
    np.testing.assert_array_equal(port[D, "fwd_batch"], port_plan.fwd(_t(xb)).numpy())


@pytest.mark.parametrize("D", SIZES)
def test_sharded_protected_clean(port, plan, meshes, inputs, D):
    guard = NttGuard.make(plan)
    res = jax.jit(lambda v: mxu_ntt_sharded_protected(v, plan, guard, meshes[D]))(
        jnp.asarray(inputs[0]))
    y, ok = port[D, "protected"]
    np.testing.assert_array_equal(y, np.asarray(res.y))
    np.testing.assert_array_equal(ok, np.asarray(res.ok))
    assert ok.all()


@pytest.mark.parametrize("D", SIZES)
def test_sharded_protected_detects_output_fault(port, plan, port_plan, inputs, D):
    """The flipped output word fails its limb's projection, as the
    reference's guard and the port's own judge that output."""
    y_bad, ok = port[D, "flipped"]
    limb, slot, bit = FLIP_Y
    y = port[D, "protected"][0]
    assert np.flatnonzero(y_bad != y).tolist() == [limb * n + slot]
    assert y_bad[limb, slot] == y[limb, slot] ^ (1 << bit)
    guard = NttGuard.make(plan)
    ref_ok = np.asarray(jax.jit(guard.check_fwd)(jnp.asarray(inputs[0]), jnp.asarray(y_bad)))
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(ok, [True, False, True])
    port_ok = PortGuard.make(port_plan).check_fwd(_t(inputs[0]), _t(y_bad)).numpy()
    np.testing.assert_array_equal(port_ok, ok)
