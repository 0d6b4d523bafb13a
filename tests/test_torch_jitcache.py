"""The port's per-op program cache (rfhe_tpu_torch/utils/jitcache.py)
against rfhe_tpu/utils/jitcache.py, on the CPU, where every op runs eagerly:
the signatures select as many programs as the reference's cache holds, keys
are held by reference, and the BGV and BFV evaluators create the reference's
`_jits` keys for the same op sequence.  The reference's ops run through a
shape-only stand-in for its `hoisted_jit` that traces each op abstractly and
returns zeros of its output shapes: its keys depend only on the op sequence
and the shapes, and each of its jits would compile per op.  The same checks
for CKKS, with `load_keys` after an op, are in tests/test_torch_ckks.py, and
for the protected evaluator, with fault locations as tensors, in
tests/test_torch_protected.py, beside contexts those files build anyway.
The graphs themselves run only on a card (tests/test_torch_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rfhe_tpu.utils.jitcache as ref_jitcache
from rfhe_tpu.fhe.bfv import BfvContext as RefBfv
from rfhe_tpu.fhe.bgv import BgvContext as RefBgv
from rfhe_tpu.fhe.ckks import Ciphertext as RefCiphertext
from rfhe_tpu.fhe.params import BfvParams as RefBfvParams, BgvParams as RefBgvParams
from rfhe_tpu.fhe.rns import RnsPoly as RefPoly
from rfhe_tpu_torch.fhe import (BfvContext, BfvParams, BgvContext, BgvParams, Ciphertext,
                                KeySwitchKey, RnsPoly)
from rfhe_tpu_torch.utils import jitcache

torch.set_num_threads(1)

BATCHED = dict(n=256, levels=1, q_bits=30, t_bits=16)


def _shapes_only(fn):
    """The reference op traced abstractly: zeros of its output shapes."""
    return lambda *args: jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                                jax.eval_shape(fn, *args))


@pytest.fixture
def ref_shapes(monkeypatch):
    monkeypatch.setattr(ref_jitcache, "hoisted_jit", _shapes_only)


def _ct(shape, scale, correction, seed, ref):
    rng = np.random.default_rng(seed)
    comps = [rng.integers(0, 1 << 30, shape, dtype=np.uint32) for _ in range(2)]
    if ref:
        return RefCiphertext([RefPoly(jnp.asarray(c), True) for c in comps], scale, correction)
    return Ciphertext([RnsPoly(torch.from_numpy(c.astype(np.int64)), True) for c in comps],
                      scale, correction)


# (shape, scale, correction, seed): a second seed of one signature, a new
# shape, a new scale, a new correction
CALLS = [((3, 64), 2.0 ** 26, 1, 0), ((3, 64), 2.0 ** 26, 1, 1), ((2, 64), 2.0 ** 26, 1, 2),
         ((3, 64), 2.0 ** 27, 1, 3), ((3, 64), 2.0 ** 26, 5, 4)]


def test_signatures_select_the_reference_programs():
    ref = ref_jitcache.HoistedJit(lambda ct: ct.c[0].data + ct.c[1].data)
    seen, counts = set(), []
    for shape, scale, corr, seed in CALLS:
        ref(_ct(shape, scale, corr, seed, ref=True))
        seen.add(jitcache.signature((_ct(shape, scale, corr, seed, ref=False),)))
        counts.append((len(ref._cache), len(seen)))
    assert counts == [(1, 1), (1, 1), (2, 2), (3, 3), (4, 4)]
    # a tree comes back as it went in
    ct = _ct((3, 64), 2.0 ** 26, 5, 0, ref=False)
    tensors, held, tdef = jitcache.flatten((ct, [ct.c[0].data], {"k": None}))
    back = jitcache.unflatten(tdef, tensors, held)
    assert back[0].scale == ct.scale and back[0].correction == 5
    assert all(torch.equal(a.data, b.data) for a, b in zip(back[0].c, ct.c))
    assert back[1][0] is ct.c[0].data and back[2] == {"k": None}


def test_keys_are_held_by_reference():
    """A key is read where it lies: never among the tensors copied per call;
    the same key keeps its signature, another key of the same shapes does not."""
    b, a = torch.zeros(2, 3, 64, dtype=torch.int64), torch.ones(2, 3, 64, dtype=torch.int64)
    k1, k2 = KeySwitchKey(b=b, a=a), KeySwitchKey(b=b.clone(), a=a.clone())
    ct = _ct((3, 64), 2.0 ** 26, 1, 0, ref=False)
    tensors, held, _ = jitcache.flatten((ct, k1))
    assert len(tensors) == 2 and held == [k1]
    assert jitcache.signature((ct, k1)) == jitcache.signature((ct, k1))
    assert jitcache.signature((ct, k1)) != jitcache.signature((ct, k2))


def _drive_batched(ctx):
    x = np.random.default_rng(4).integers(0, ctx.t, (2, ctx.params.n // 2))
    ct = ctx.encrypt(ctx.encode(x))
    prod = ctx.multiply_relin(ct, ct)
    ctx.relinearize(ctx.multiply(ct, ct))
    if hasattr(ctx, "mod_switch_to_next"):
        prod = ctx.mod_switch_to_next(prod)
    ctx.rotate_rows(prod, 1), ctx.rotate_columns(prod)
    ctx.decrypt_coeffs_t(prod), ctx.decrypt_coeffs_t(prod, exact=True)


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_jits_keys_equal_the_reference(ref_shapes, scheme):
    Ref, RefP, Port, PortP = ((RefBgv, RefBgvParams, BgvContext, BgvParams) if scheme == "bgv"
                              else (RefBfv, RefBfvParams, BfvContext, BfvParams))
    ref = Ref(RefP.make(**BATCHED), seed=5)
    port = Port(PortP.make(**BATCHED), seed=5, device="cpu")
    _drive_batched(ref), _drive_batched(port)
    assert set(port._jits) == set(ref._jits) and len(port._jits) > 4
    assert all(isinstance(j, jitcache.HoistedJit) for j in port._jits.values())
