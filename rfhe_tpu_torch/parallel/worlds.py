"""Rank bodies that drive the sharded paths on whole inputs.

Each function runs inside a process world (`mesh.spawn_world`, or a world
the caller opened), builds its meshes over the first D ranks for each D
asked for, cuts whole numpy inputs into this rank's blocks, runs the sharded
functions and gathers the results back.  A rank outside a mesh only takes
part in building it.  Every rank returns its results as numpy arrays keyed
by (D, what); the tests compare rank 0's with the JAX package's, and
chip_smoke compares them with the unsharded paths on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import prng
from ..device import to_numpy_u32, to_torch
from ..fhe import CkksContext, CkksParams
from ..ops.ntt import NttPlan
from ..protect.ntt_guard import NttGuard
from ..transform import distributed as fs
from ..transform import mxu_sharded as mx
from ..transform.four_step import FourStepPlan
from .mesh import make_mesh, make_mesh_2d, members
from .sharded_ckks import ShardedCkks


def four_step_cases(n: int, q: int, x1: np.ndarray, xb: np.ndarray, key_seed: int,
                    flip_b1: tuple, sizes: Sequence[int], device="cpu") -> Dict:
    """transform/distributed.py on a vector x1 (n,) and a batch xb (B, n) at
    each mesh size: the gathered forward, the inverse of that forward, the
    protected form's output and flags, and its flags with one flipped B1
    word."""
    plan = FourStepPlan.make(n, q, device)
    out = {}
    for D in sizes:
        mesh = make_mesh(D, axis="fft", device=device)
        if not members(mesh):
            continue
        for name, x in (("single", x1), ("batched", xb)):
            xs = fs.shard_coeffs(to_torch(x, device), plan, mesh)
            Y = fs.four_step_ntt_sharded(xs, plan, mesh)
            out[D, "fwd", name] = to_numpy_u32(fs.gather_slots(Y, plan, mesh))
            A = fs.four_step_intt_sharded(Y, plan, mesh)
            out[D, "inv", name] = to_numpy_u32(fs.gather_coeffs(A, plan, mesh))
        xs = fs.shard_coeffs(to_torch(x1, device), plan, mesh)
        key = prng.PRNGKey(key_seed)
        res = fs.four_step_ntt_sharded_protected(xs, plan, mesh, key)
        out[D, "protected"] = (to_numpy_u32(fs.gather_slots(res.y, plan, mesh)),
                               bool(res.batch1_ok), bool(res.inter_ok), bool(res.batch2_ok))
        bad = fs.four_step_ntt_sharded_protected(xs, plan, mesh, key, flip_b1=flip_b1)
        out[D, "flipped"] = (bool(bad.batch1_ok), bool(bad.inter_ok), bool(bad.batch2_ok))
    return out


def mxu_cases(n: int, primes: Sequence[int], x: np.ndarray, xb: np.ndarray,
              flip_y: tuple, sizes: Sequence[int], device="cpu") -> Dict:
    """transform/mxu_sharded.py at each mesh size: forward of x (L, n) and of
    the batch xb (B, L, n), the inverse of `plan.fwd(x)`, the round trip,
    and the protected form clean and with one flipped output word."""
    plan = NttPlan.make(n, primes, device)
    guard = NttGuard.make(plan)
    out = {}
    x_t, xb_t = to_torch(x, device), to_torch(xb, device)
    for D in sizes:
        mesh = make_mesh(D, axis="fft", device=device)
        if not members(mesh):
            continue
        xs = mx.shard_coeffs(x_t, plan, mesh)
        Y = mx.mxu_ntt_sharded(xs, plan, mesh)
        out[D, "fwd"] = to_numpy_u32(mx.gather_slots(Y, plan, mesh))
        out[D, "roundtrip"] = to_numpy_u32(mx.gather_coeffs(mx.mxu_intt_sharded(Y, plan, mesh), plan, mesh))
        ys = mx.shard_slots(plan.fwd(x_t), plan, mesh)
        out[D, "inv"] = to_numpy_u32(mx.gather_coeffs(mx.mxu_intt_sharded(ys, plan, mesh), plan, mesh))
        Yb = mx.mxu_ntt_sharded(mx.shard_coeffs(xb_t, plan, mesh), plan, mesh)
        out[D, "fwd_batch"] = to_numpy_u32(mx.gather_slots(Yb, plan, mesh))
        res = mx.mxu_ntt_sharded_protected(xs, plan, guard, mesh)
        out[D, "protected"] = (to_numpy_u32(mx.gather_slots(res.y, plan, mesh)), res.ok.cpu().numpy())
        bad = mx.mxu_ntt_sharded_protected(xs, plan, guard, mesh, flip_y=flip_y)
        out[D, "flipped"] = (to_numpy_u32(mx.gather_slots(bad.y, plan, mesh)), bad.ok.cpu().numpy())
    return out


def ckks_cases(params: dict, seed: int, z: np.ndarray, D: int, dnum: Optional[int] = None,
               conjugate: bool = True, device="cpu") -> Dict:
    """The limb-sharded evaluator over D ranks: a context from `params` and
    `seed`, the encryption of z, then rotate(1), multiply_relin, rescale and
    (with `conjugate`) conjugate on the sharded ciphertext, each gathered.
    Keys are drawn in that order.  Also each rank's key rows and the limbs
    its slab holds after the rescale."""
    ckks = CkksContext(CkksParams.make(**params), seed=seed, dnum=dnum, device=device)
    ct = ckks.encrypt(*ckks.encode(z))
    mesh = make_mesh(D, axis="limb", device=device)
    out = {"encrypt": ct.to_numpy()}
    if not members(mesh):
        return out
    sh = ShardedCkks(ckks, mesh)
    sct = sh.shard(ct)
    out["rotate"] = sh.gather(sh.rotate(sct, 1)).to_numpy()
    mr = sh.multiply_relin(sct, sct)
    out["multiply_relin"] = sh.gather(mr).to_numpy()
    rs = sh.rescale(mr)
    out["rescale"] = sh.gather(rs).to_numpy()
    out["rescale_limbs"] = rs.limbs
    out["square"] = ckks.decrypt_decode(sh.gather(rs))
    if conjugate:
        out["conjugate"] = sh.gather(sh.conjugate(sct)).to_numpy()
    out["key_limbs"] = {name: key.limbs for name, key in
                        [("rlk", ckks._rlk)] + [(f"galois_{g}", k) for g, k in ckks._galois.items()]}
    out["key_rows"] = {name: tuple(key.b.shape) for name, key in
                       [("rlk", ckks._rlk)] + [(f"galois_{g}", k) for g, k in ckks._galois.items()]}
    return out


def scaling_rows(n: int, limbs: int, n_mxu: int, limbs_mxu: int, iters: int,
                 device="cpu") -> Dict:
    """Both scaling harnesses in this world (rank 0's rows are the ones
    measured)."""
    from ..bench import scaling, scaling_mxu
    return {"scaling": scaling.measure(n, limbs, iters, device),
            "scaling_mxu": scaling_mxu.measure(n_mxu, limbs_mxu, iters, device)}


def mesh_layout(limb: int, device="cpu") -> Dict:
    """This rank's place in a (limb, world/limb) mesh of `make_mesh_2d`, and
    the sum of the ranks along each axis (the axes' groups)."""
    import torch.distributed as dist
    fft = dist.get_world_size() // limb
    mesh = make_mesh_2d(limb, fft, device=device)
    sums = {}
    for axis in ("limb", "fft"):
        t = torch.tensor([dist.get_rank()], dtype=torch.int64, device=device)
        dist.all_reduce(t, group=mesh.get_group(axis))
        sums[axis] = int(t)
    return {"coord": tuple(mesh.get_coordinate()), "names": mesh.mesh_dim_names,
            "shape": tuple(mesh.shape), "sums": sums}


def sequence(calls: Sequence) -> list:
    """Run the rank bodies `calls`, (function, args) pairs, one after the
    other in this world: one world serves several cases."""
    return [fn(*args) for fn, args in calls]
