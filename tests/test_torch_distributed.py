"""transform/distributed.py against rfhe_tpu.transform.distributed, bit for
bit: the sharded four-step forward and inverse NTT and the protected form's
output and flags at N=256 over meshes of 1, 2 and 8 ranks, single and
batched.  The port runs in one world of 8 gloo processes on the CPU (a
smaller mesh is its first D ranks); the reference runs on conftest's
8-device virtual CPU mesh, whose first D devices make its mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rfhe_tpu import numth
from rfhe_tpu.transform import FourStepPlan, four_step_ntt
from rfhe_tpu.transform.distributed import (
    four_step_intt_sharded, four_step_ntt_sharded, four_step_ntt_sharded_protected, make_mesh)
from rfhe_tpu_torch.parallel import worlds
from rfhe_tpu_torch.parallel.mesh import spawn_world

N = 256                      # n1 = n2 = 16: divisible by 8 ranks
Q = numth.find_ntt_prime(N, 25)
PLAN = FourStepPlan.make(N, Q)
SIZES = (1, 2, 8)
FLIP_B1 = (3, 13, 7)         # B1[3, 13] bit 7: column 13 lies on rank 6 of 8
KEY_SEED = 0


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    return {"single": rng.integers(0, Q, size=N, dtype=np.uint32),
            "batched": rng.integers(0, Q, size=(3, N), dtype=np.uint32)}


@pytest.fixture(scope="module")
def ranks(inputs):
    calls = [(worlds.four_step_cases, (N, Q, inputs["single"], inputs["batched"], KEY_SEED,
                                       FLIP_B1, SIZES, "cpu")),
             (worlds.mesh_layout, (2, "cpu"))]
    return spawn_world(worlds.sequence, 8, "gloo", args=(calls,), timeout_s=60, deadline_s=300)


@pytest.fixture(scope="module")
def world(ranks):
    return [r[0] for r in ranks]


@pytest.fixture(scope="module")
def port(world):
    return world[0]


def test_mesh_2d_layout(ranks):
    """make_mesh_2d(2, 4): row-major ranks, a group per row and per column."""
    for r, (_, layout) in enumerate(ranks):
        assert layout["names"] == ("limb", "fft") and layout["shape"] == (2, 4)
        assert layout["coord"] == (r // 4, r % 4)
        row = [4 * (r // 4) + j for j in range(4)]
        assert layout["sums"] == {"fft": sum(row), "limb": (r % 4) + (r % 4 + 4)}


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return {D: make_mesh(D) for D in SIZES}


def test_every_rank_returned(world):
    # ranks outside a mesh of D < 8 only took part in building it
    assert len(world) == 8
    for r, out in enumerate(world):
        assert {key[0] for key in out} == {D for D in SIZES if r < D}


@pytest.mark.parametrize("kind", ["single", "batched"])
@pytest.mark.parametrize("D", SIZES)
def test_sharded_forward(port, meshes, inputs, D, kind):
    x = jnp.asarray(inputs[kind])
    sharded = np.asarray(jax.jit(lambda v: four_step_ntt_sharded(v, PLAN, meshes[D]))(x))
    np.testing.assert_array_equal(port[D, "fwd", kind], sharded)
    np.testing.assert_array_equal(port[D, "fwd", kind], np.asarray(four_step_ntt(x, PLAN)))


@pytest.mark.parametrize("kind", ["single", "batched"])
@pytest.mark.parametrize("D", SIZES)
def test_sharded_inverse(port, meshes, inputs, D, kind):
    y = four_step_ntt(jnp.asarray(inputs[kind]), PLAN)
    ref = np.asarray(jax.jit(lambda v: four_step_intt_sharded(v, PLAN, meshes[D]))(y))
    np.testing.assert_array_equal(ref, inputs[kind])
    np.testing.assert_array_equal(port[D, "inv", kind], ref)


@pytest.mark.parametrize("D", SIZES)
def test_sharded_protected_clean(port, meshes, inputs, D):
    res = jax.jit(lambda v, k: four_step_ntt_sharded_protected(v, PLAN, meshes[D], k))(
        jnp.asarray(inputs["single"]), jax.random.PRNGKey(KEY_SEED))
    y, b1, inter, b2 = port[D, "protected"]
    np.testing.assert_array_equal(y, np.asarray(res.y))
    assert (b1, inter, b2) == (bool(res.batch1_ok), bool(res.inter_ok), bool(res.batch2_ok))
    assert b1 and inter and b2


@pytest.mark.parametrize("D", SIZES)
def test_flipped_b1_fails_batch1(port, D):
    b1, inter, b2 = port[D, "flipped"]
    assert not b1
    # the twiddle check reads B1 on both of its sides, stage 2 never sees B1
    assert inter and b2
