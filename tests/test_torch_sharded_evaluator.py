"""parallel/sharded_ckks.py against rfhe_tpu's limb-sharded evaluator, bit
for bit: rotate, multiply_relin + rescale and conjugate on a ciphertext
sharded over 4 ranks (n=512, levels 3, seed 3, as
tests/test_sharded_evaluator.py), and rotate with dnum=2.  Each gathered
result equals the reference's on its 4-device "limb" mesh and unsharded,
and the port's unsharded context.  The port runs in one world of 4 gloo
processes on the CPU; the rescale leaves the last rank's slab empty."""
import numpy as np
import pytest
import torch

from rfhe_tpu.fhe import CkksContext as RefCkks, CkksParams as RefParams
from rfhe_tpu.parallel.mesh import make_mesh, shard_ciphertext
from rfhe_tpu_torch.fhe import CkksContext, CkksParams
from rfhe_tpu_torch.parallel import worlds
from rfhe_tpu_torch.parallel.mesh import slab_bounds, spawn_world

torch.set_num_threads(1)

PARAMS = dict(n=512, levels=3, q0_bits=30, scale_bits=26)
SEED = 3
D = 4
DNUMS = (None, 2)


@pytest.fixture(scope="module")
def z():
    return np.random.default_rng(0).uniform(-1, 1, 256) + 0j


@pytest.fixture(scope="module")
def world(z):
    calls = [(worlds.ckks_cases, (PARAMS, SEED, z, D, dnum, True, "cpu")) for dnum in DNUMS]
    return spawn_world(worlds.sequence, D, "gloo", args=(calls,), timeout_s=60, deadline_s=300)


@pytest.fixture(scope="module")
def port(world):
    return dict(zip(DNUMS, world[0]))


@pytest.fixture(scope="module")
def reference(z):
    """The reference's results, unsharded and sharded, with its keys drawn in
    the port's order (rotate, multiply_relin, conjugate)."""
    mesh = make_mesh(D, axis="limb")
    out = {}
    for dnum in DNUMS:
        ckks = RefCkks(RefParams.make(**PARAMS), seed=SEED, dnum=dnum)
        ct = ckks.encrypt(*ckks.encode(z))
        sh = shard_ciphertext(ct, mesh)
        ops = {"rotate": lambda c: ckks.rotate(c, 1)}
        if dnum is None:
            ops["rescale"] = lambda c: ckks.rescale(ckks.multiply_relin(c, c))
            ops["conjugate"] = ckks.conjugate
        res = {"encrypt": ([np.asarray(p.data) for p in ct.c],) * 2}
        for name, op in ops.items():
            res[name] = tuple([np.asarray(p.data) for p in op(c).c] for c in (ct, sh))
        out[dnum] = res
    return out


@pytest.fixture(scope="module")
def unsharded(z):
    """The port's unsharded context on the same draws."""
    out = {}
    for dnum in DNUMS:
        ckks = CkksContext(CkksParams.make(**PARAMS), seed=SEED, dnum=dnum, device="cpu")
        ct = ckks.encrypt(*ckks.encode(z))
        rot = ckks.rotate(ct, 1)                 # the keys in the ranks' order
        mr = ckks.multiply_relin(ct, ct)
        out[dnum] = {"rotate": rot.to_numpy(), "multiply_relin": mr.to_numpy(),
                     "rescale": ckks.rescale(mr).to_numpy(),
                     "conjugate": ckks.conjugate(ct).to_numpy()}
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("op, dnum", [("encrypt", None), ("rotate", None), ("rescale", None),
                                      ("conjugate", None), ("encrypt", 2), ("rotate", 2)])
def test_equals_reference(port, reference, op, dnum):
    unsharded_ref, sharded_ref = reference[dnum][op]
    _equal(port[dnum][op], unsharded_ref)
    _equal(port[dnum][op], sharded_ref)


@pytest.mark.parametrize("dnum", DNUMS)
@pytest.mark.parametrize("op", ["rotate", "multiply_relin", "rescale", "conjugate"])
def test_equals_unsharded_port(port, unsharded, op, dnum):
    _equal(port[dnum][op], unsharded[dnum][op])


@pytest.mark.parametrize("dnum", DNUMS)
def test_rescale_decrypts(port, z, dnum):
    np.testing.assert_allclose(port[dnum]["square"], z * z, atol=5e-2)


@pytest.mark.parametrize("dnum", DNUMS)
def test_ranks_keep_their_rows(world, dnum):
    """Each rank keeps its slab's key rows and the special ones; after the
    rescale the last rank's slab is empty."""
    L = PARAMS["levels"] + 1
    n_sp = 1 if dnum is None else -(-L // dnum)
    for r, results in enumerate(world):
        out = results[DNUMS.index(dnum)]
        lo, hi = slab_bounds(L, D)[r]
        want = tuple(range(lo, hi)) + tuple(range(L, L + n_sp))
        assert set(out["key_limbs"]) == {"rlk", "galois_5", f"galois_{2 * PARAMS['n'] - 1}"}
        assert all(limbs == want for limbs in out["key_limbs"].values())
        assert all(shape[1] == len(want) for shape in out["key_rows"].values())
        assert out["rescale_limbs"] == [i for i in range(lo, hi) if i < L - 1]
