"""The four-step NTT sharded over a mesh axis, with its cross-shard detectors.

Counterpart of `rfhe_tpu/transform/distributed.py`.  The n2×n1 coefficient
matrix A[t2, t1] = x[t1 + n1·t2] shards its t1 (column) axis: the stage-1
column NTTs and the twiddle product are local, the stage-1 → stage-2
transpose is one all_to_all, and the stage-2 row NTTs are local again.

Each function takes and returns this rank's block, as the reference's
`shard_map` bodies see them; with D ranks on the axis and this rank at
coordinate r:

  forward   in   (..., n2, n1/D)   columns r·n1/D ..        of A
            out  (..., n2/D, n1)   rows    r·n2/D ..        of Y[k2, k1] = y[k1·n2 + k2]
  inverse   the mirror image: Y's row block in, A's column block out

`shard_coeffs` / `gather_slots` and `shard_slots` / `gather_coeffs` cut a
whole vector into these blocks and join them back in natural order.  A
leading batch (limbs, polynomials) rides along; in the reference it may
shard over a second mesh axis (`batch_axis`), and here that is simply the
rank's own batch.

The protected form's three detectors (stage-1 projection, twiddle
inter-check, stage-2 projection) sum per-shard partial checksums across the
mesh (`parallel.mesh.allsum_mod`); its projection vectors are the
reference's `jax.random` draws from the same key (`prng`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import prng
from ..ops.matmul_mod import matmul_mod, matvec_mod
from ..ops.modarith import mul_mod_shoup
from ..ops.modring import sum_mod
from ..parallel.mesh import all_gather_cat, all_to_all_tiled, allsum_mod, axis_rank, axis_size, block
from .four_step import FourStepPlan

__all__ = ["ShardedCheckResult", "four_step_ntt_sharded", "four_step_intt_sharded",
           "four_step_ntt_sharded_protected", "shard_coeffs", "gather_slots", "shard_slots",
           "gather_coeffs"]


class ShardedCheckResult(NamedTuple):
    y: torch.Tensor            # this rank's (n2/D, n1) block of Y
    batch1_ok: torch.Tensor    # 0-d bool, the same on every rank
    inter_ok: torch.Tensor
    batch2_ok: torch.Tensor


def _axis(mesh: DeviceMesh, axis: str, plan) -> Tuple[int, int, object]:
    """(D, this rank's coordinate, the axis's group); the plan's n1 and n2
    (a `FourStepPlan`'s or an `NttPlan`'s) must both split over D."""
    D = axis_size(mesh, axis)
    if plan.n1 % D or plan.n2 % D:
        raise ValueError(f"n1={plan.n1}, n2={plan.n2} do not split over {D} ranks")
    return D, axis_rank(mesh, axis), mesh.get_group(axis)


# ---- layouts ---------------------------------------------------------------

def shard_coeffs(x: torch.Tensor, plan, mesh: DeviceMesh, axis: str = "fft"):
    """(..., n) natural-order coefficients -> this rank's (..., n2, n1/D) block
    of A (also the production NTT's layout, `mxu_sharded`)."""
    D, r, _ = _axis(mesh, axis, plan)
    return block(x.reshape(x.shape[:-1] + (plan.n2, plan.n1)), -1, D, r)


def gather_slots(Y: torch.Tensor, plan: FourStepPlan, mesh: DeviceMesh, axis: str = "fft"):
    """The ranks' (..., n2/D, n1) blocks of Y -> (..., n) natural order."""
    whole = all_gather_cat(Y, mesh.get_group(axis), dim=-2)          # (..., n2, n1)
    return whole.transpose(-1, -2).reshape(Y.shape[:-2] + (plan.n,))


def shard_slots(y: torch.Tensor, plan: FourStepPlan, mesh: DeviceMesh, axis: str = "fft"):
    """(..., n) natural-order NTT values -> this rank's (..., n2/D, n1) block of Y."""
    D, r, _ = _axis(mesh, axis, plan)
    Y = y.reshape(y.shape[:-1] + (plan.n1, plan.n2)).transpose(-1, -2)
    return block(Y, -2, D, r)


def gather_coeffs(A: torch.Tensor, plan, mesh: DeviceMesh, axis: str = "fft"):
    """The ranks' (..., n2, n1/D) blocks of A -> (..., n) natural order."""
    whole = all_gather_cat(A, mesh.get_group(axis), dim=-1)          # (..., n2, n1)
    return whole.reshape(A.shape[:-2] + (plan.n,))


# ---- transforms ------------------------------------------------------------

def four_step_ntt_sharded(x: torch.Tensor, plan: FourStepPlan, mesh: DeviceMesh,
                          axis: str = "fft", batch_axis: Optional[str] = None) -> torch.Tensor:
    """Forward cyclic NTT, t1 sharded over `axis`: this rank's (..., n2, n1/D)
    block of A in, its (..., n2/D, n1) block of Y out.  Gathered, the output
    equals `transform.four_step.four_step_ntt`."""
    D, r, group = _axis(mesh, axis, plan)
    T, Ts = block(plan.T, -1, D, r), block(plan.T_shoup, -1, D, r)
    B = matmul_mod(plan.W2, x, plan.digit)
    B = mul_mod_shoup(B, T, Ts, plan.q)
    B = all_to_all_tiled(B, group, split_axis=-2, concat_axis=-1)   # (..., n2/D, n1)
    return matmul_mod(B, plan.W1T, plan.digit)


def four_step_intt_sharded(Y: torch.Tensor, plan: FourStepPlan, mesh: DeviceMesh,
                           axis: str = "fft", batch_axis: Optional[str] = None) -> torch.Tensor:
    """Inverse of four_step_ntt_sharded (1/n included): this rank's
    (..., n2/D, n1) block of Y in, its (..., n2, n1/D) block of A out, so a
    forward, pointwise, inverse pipeline does two all_to_alls in all."""
    D, r, group = _axis(mesh, axis, plan)
    Ti, Tis = block(plan.Ti, -2, D, r), block(plan.Ti_shoup, -2, D, r)
    B = matmul_mod(Y, plan.W1Ti, plan.digit)
    B = mul_mod_shoup(B, Ti, Tis, plan.q)
    B = all_to_all_tiled(B, group, split_axis=-1, concat_axis=-2)   # (..., n2, n1/D)
    return matmul_mod(plan.W2i, B, plan.digit)


def four_step_ntt_sharded_protected(x: torch.Tensor, plan: FourStepPlan, mesh: DeviceMesh,
                                    key, axis: str = "fft",
                                    flip_b1: Optional[Tuple[int, int, int]] = None
                                    ) -> ShardedCheckResult:
    """The sharded forward NTT of one vector with the three detectors riding
    the collectives: this rank's (n2, n1/D) block of A in.  `key` is a
    `prng` key; the projections w1, φ, w2 are the reference's draws from it.
    `flip_b1` = (k2, t1, bit) flips one bit of the stage-1 output word
    B1[k2, t1] on the rank that holds column t1, before any detector reads
    it (a fault in stage 1)."""
    D, r, group = _axis(mesh, axis, plan)
    q, ar, dev = plan.q, plan.arith, x.device
    k1, k2, k3 = prng.split(np.asarray(key, dtype=np.uint32), 3)
    draw = lambda k, m: torch.from_numpy(prng.randint(k, (m,), 0, q, np.uint32).astype(np.int64)).to(dev)
    w1, phi, w2 = draw(k1, plan.n2), draw(k2, plan.n2), draw(k3, plan.n1)
    w1_hat = matvec_mod(plan.W2, w1, plan.digit)
    w2_hat = matvec_mod(plan.W1T.T, w2, plan.digit)
    T, Ts = block(plan.T, -1, D, r), block(plan.T_shoup, -1, D, r)
    allsum = lambda v: allsum_mod(v, q, group)

    B1 = matmul_mod(plan.W2, x, plan.digit)
    if flip_b1 is not None:
        row, col, bit = flip_b1
        width = plan.n1 // D
        if col // width == r:
            B1[row, col % width] ^= 1 << bit
    # stage-1 projection: row sums are sums over the sharded t1 axis
    s_in = allsum(sum_mod(x, q, axis=-1))
    s_out = allsum(sum_mod(B1, q, axis=-1))
    b1_ok = ar.dot(w1_hat, s_in) == ar.dot(w1, s_out)
    # twiddle (local) and the inter-check's partial sums over local columns
    B2 = mul_mod_shoup(B1, T, Ts, q)
    lhs = allsum(sum_mod(B2, q, axis=-1))
    rhs = allsum(sum_mod(ar.mul(T, B1), q, axis=-1))
    inter_ok = ar.dot(phi, lhs) == ar.dot(phi, rhs)
    # stage 2: transpose, then row NTTs; column sums now span shards of n2
    Bt = all_to_all_tiled(B2, group, split_axis=0, concat_axis=1)    # (n2/D, n1)
    Y = matmul_mod(Bt, plan.W1T, plan.digit)
    r_in = allsum(sum_mod(Bt, q, axis=-2))
    r_out = allsum(sum_mod(Y, q, axis=-2))
    b2_ok = ar.dot(w2_hat, r_in) == ar.dot(w2, r_out)
    return ShardedCheckResult(y=Y, batch1_ok=b1_ok, inter_ok=inter_ok, batch2_ok=b2_ok)
