"""The production negacyclic NTT sharded over a mesh axis.

Counterpart of `rfhe_tpu/transform/mxu_sharded.py`, which shards the
reference's `MxuNttPlan`.  The port's `NttPlan` computes that plan's map bit
for bit (`ops/ntt.py`) but as a butterfly network, which does not split
across ranks; so this module keeps the four-step stage tables of the
reference (`ntt_mxu.py:166-240`), built in numpy from the plan's primes, and
computes both stages as exact modular matmuls (`ops/matmul_mod.py`; the
reference's are XLA int8 digit matmuls, not Pallas kernels).  The outputs
are canonical residues of the same linear map, so they equal `NttPlan.fwd`
and `NttPlan.inv`, that is the kernels K1 and K2 on the card.

Layout (the reference's).  (..., L, n) data is viewed as (..., L, n2, n1),
n1 and n2 from `ops.ntt.split_n`:

  forward   x[t1 + n1·t2] = A[t2, t1].  Stage 1 contracts t2 with
            W2f[k2, t2] = ω_n2^(k2·t2)·ψ^(n1·t2), then multiplies by the
            folded twiddle Tf[k2, t1] = ω^(k2·t1)·ψ^t1·R; one all_to_all
            (split n2, join n1); stage 2 contracts t1 with
            W1Tf[t1, k1] = ω_n1^(t1·k1).  Slot p = k2·n1 + k1 holds Y[k2, k1].
  inverse   the mirror: contract k1 (W1Tif), the folded inverse twiddle
            Ti = ω^-(k2·t1)·ψ^-t1·n⁻¹·R⁻¹, all_to_all back, contract k2
            (W2if[t2, k2] = ω_n2^-(k2·t2)·ψ^-(n1·t2)).

Each function takes and returns this rank's block, with D ranks on the axis
and this rank at coordinate r: the forward takes (..., L, n2, n1/D), columns
r·n1/D .. of A, and gives (..., L, n2/D, n1), rows r·n2/D .. of Y, which are
the n1·n2/D consecutive slots from r·n/D; the inverse the other way round.
`shard_coeffs` / `gather_slots` and `shard_slots` / `gather_coeffs` cut and
join whole arrays.  A fwd, pointwise, inv pipeline does two all_to_alls.

The protected form checks the port's `NttGuard` projection, <φ, y> = <v, x>
per limb, from per-shard partial sums added across the mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..numth import mod_inv, psi_negacyclic
from ..ops.matmul_mod import DigitPlan, matmul_mod
from ..ops.ntt import NttPlan, _pow_table
from ..ops.modring import sum_mod
from ..parallel.mesh import all_gather_cat, all_to_all_tiled, allsum_mod, block
from ..protect.checks import mont_mul_checked
from .distributed import _axis, gather_coeffs, shard_coeffs

__all__ = ["MxuTables", "GuardedShardedResult", "mxu_ntt_sharded", "mxu_intt_sharded",
           "mxu_ntt_sharded_protected", "shard_coeffs", "gather_slots", "shard_slots",
           "gather_coeffs"]

_R = 1 << 32


@dataclass(frozen=True, eq=False)
class MxuTables:
    """The four-step stage tables of a plan's primes, int64 on its device."""

    n1: int
    n2: int
    digits: Tuple[DigitPlan, ...]
    W2f: torch.Tensor      # (L, n2, n2)
    Tf: torch.Tensor       # (L, n2, n1)
    W1Tf: torch.Tensor     # (L, n1, n1)
    W1Tif: torch.Tensor    # (L, n1, n1)
    Ti: torch.Tensor       # (L, n2, n1)
    W2if: torch.Tensor     # (L, n2, n2)
    q_col: torch.Tensor    # (L, 1, 1)

    @classmethod
    def build(cls, n: int, n1: int, primes: Sequence[int], device) -> "MxuTables":
        n2 = n // n1
        k2g, t2g = np.meshgrid(np.arange(n2), np.arange(n2), indexing="ij")
        t1g, k1g = np.meshgrid(np.arange(n1), np.arange(n1), indexing="ij")
        k2t, t1t = np.meshgrid(np.arange(n2), np.arange(n1), indexing="ij")
        tabs = {k: [] for k in ("W2f", "Tf", "W1Tf", "W1Tif", "Ti", "W2if")}
        for q in primes:
            psi = psi_negacyclic(n, q)
            w = psi * psi % q
            wi, psii = mod_inv(w, q), mod_inv(psi, q)
            uq = np.uint64(q)
            pw, pwi = _pow_table(w, n, q), _pow_table(wi, n, q)
            p2, p2i = _pow_table(pow(w, n1, q), n2, q), _pow_table(mod_inv(pow(w, n1, q), q), n2, q)
            p1, p1i = _pow_table(pow(w, n2, q), n1, q), _pow_table(mod_inv(pow(w, n2, q), q), n1, q)
            psi_n1, psii_n1 = _pow_table(pow(psi, n1, q), n2, q), _pow_table(pow(psii, n1, q), n2, q)
            psi_t1, psii_t1 = _pow_table(psi, n1, q), _pow_table(psii, n1, q)
            tabs["W2f"].append(p2[(k2g * t2g) % n2] * psi_n1[t2g] % uq)
            tabs["W1Tf"].append(p1[(t1g * k1g) % n1])
            tabs["Tf"].append(pw[(k2t * t1t) % n] * psi_t1[t1t] % uq * np.uint64(_R % q) % uq)
            tabs["W1Tif"].append(p1i[(t1g * k1g) % n1])
            tabs["W2if"].append(p2i[(k2g * t2g) % n2] * psii_n1[k2g] % uq)
            exit_ = np.uint64(mod_inv(n, q) * mod_inv(_R % q, q) % q)
            tabs["Ti"].append(pwi[(k2t * t1t) % n] * psii_t1[t1t] % uq * exit_ % uq)
        dev = lambda rows: torch.from_numpy(np.stack(rows).astype(np.int64)).to(device)
        return cls(n1=n1, n2=n2, digits=tuple(DigitPlan(int(q)) for q in primes),
                   q_col=torch.tensor(list(primes), dtype=torch.int64, device=device)[:, None, None],
                   **{k: dev(v) for k, v in tabs.items()})


_TABLES: Dict[tuple, MxuTables] = {}


def tables(plan: NttPlan) -> MxuTables:
    """The stage tables of `plan`'s limbs (built once per prime chain)."""
    key = (plan.n, plan.primes, str(plan.device))
    if key not in _TABLES:
        _TABLES[key] = MxuTables.build(plan.n, plan.n1, plan.primes, plan.device)
    return _TABLES[key]


def _left(W: torch.Tensor, X: torch.Tensor, tab: MxuTables) -> torch.Tensor:
    """W[l] @ X[..., l, :, :] mod q_l for every limb."""
    return torch.stack([matmul_mod(W[l], X[..., l, :, :], d) for l, d in enumerate(tab.digits)],
                       dim=-3)


def _right(X: torch.Tensor, W: torch.Tensor, tab: MxuTables) -> torch.Tensor:
    """X[..., l, :, :] @ W[l] mod q_l for every limb."""
    return torch.stack([matmul_mod(X[..., l, :, :], W[l], d) for l, d in enumerate(tab.digits)],
                       dim=-3)


# ---- layouts (the coefficients' are the four-step NTT's) -------------------

def gather_slots(Y: torch.Tensor, plan: NttPlan, mesh: DeviceMesh, axis: str = "fft"):
    """The ranks' (..., L, n2/D, n1) blocks of Y -> (..., L, n) slots."""
    whole = all_gather_cat(Y, mesh.get_group(axis), dim=-2)
    return whole.reshape(Y.shape[:-2] + (plan.n,))


def shard_slots(y: torch.Tensor, plan: NttPlan, mesh: DeviceMesh, axis: str = "fft"):
    """(..., L, n) slots -> this rank's (..., L, n2/D, n1) block of Y."""
    D, r, _ = _axis(mesh, axis, plan)
    return block(y.reshape(y.shape[:-1] + (plan.n2, plan.n1)), -2, D, r)


# ---- transforms ------------------------------------------------------------

def mxu_ntt_sharded(x: torch.Tensor, plan: NttPlan, mesh: DeviceMesh, axis: str = "fft",
                    batch_axis: Optional[str] = None) -> torch.Tensor:
    """Forward negacyclic NTT with t1 sharded over `axis`: this rank's
    (..., L, n2, n1/D) block of A in, its (..., L, n2/D, n1) block of the
    slots (order nu, Montgomery form) out; gathered, `plan.fwd(x)`."""
    D, r, group = _axis(mesh, axis, plan)
    tab = tables(plan)
    B = _left(tab.W2f, x, tab) * block(tab.Tf, -1, D, r) % tab.q_col
    Bt = all_to_all_tiled(B, group, split_axis=-2, concat_axis=-1)
    return _right(Bt, tab.W1Tf, tab)


def mxu_intt_sharded(y: torch.Tensor, plan: NttPlan, mesh: DeviceMesh, axis: str = "fft",
                     batch_axis: Optional[str] = None) -> torch.Tensor:
    """Inverse: this rank's (..., L, n2/D, n1) block of the slots in, its
    (..., L, n2, n1/D) block of the coefficients out; gathered, `plan.inv(y)`."""
    D, r, group = _axis(mesh, axis, plan)
    tab = tables(plan)
    Dm = _right(y, tab.W1Tif, tab) * block(tab.Ti, -2, D, r) % tab.q_col
    Dt = all_to_all_tiled(Dm, group, split_axis=-1, concat_axis=-2)
    return _left(tab.W2if, Dt, tab)


class GuardedShardedResult(NamedTuple):
    y: torch.Tensor          # this rank's (L, n2/D, n1) block of the slots
    ok: torch.Tensor         # (L,) bool, the same on every rank


def mxu_ntt_sharded_protected(x: torch.Tensor, plan: NttPlan, guard, mesh: DeviceMesh,
                              axis: str = "fft",
                              flip_y: Optional[Tuple[int, int, int]] = None
                              ) -> GuardedShardedResult:
    """The sharded forward NTT of (L, n) with the `NttGuard` projection riding
    the collectives: <v, x> and <φ, y> are per-shard partial modular sums
    added across the mesh; ok[l] is their equality for limb l (a fault that
    changes the output is missed with probability about 1/q_l).  x is this
    rank's (L, n2, n1/D) block.  The products take the checked path's REDC
    word (`protect.checks.mont_mul_checked`), the reference's for any word
    below 2^32, so a flipped input word is projected as the reference
    projects it.  `flip_y` = (limb, slot, bit) flips one bit of an output
    word on the rank holding that slot, before the output projection reads
    it (a fault in the transform)."""
    D, r, group = _axis(mesh, axis, plan)
    n1, n2 = plan.n1, plan.n2
    q = guard.q_arr
    qb, rinvb = q[:, None, None], guard.rinv_arr[:, None, None]
    L = guard.L
    vf = block(guard.vf_mont.reshape(L, n2, n1), -1, D, r)
    phi = block(guard.phi_mont.reshape(L, n2, n1), -2, D, r)

    def projection(w, v):
        prod = mont_mul_checked(w, v, qb, rinvb)[0]
        return allsum_mod(sum_mod(sum_mod(prod, q[:, None], axis=-1), q, axis=-1), q, group)

    s_in = projection(vf, x)
    Y = mxu_ntt_sharded(x, plan, mesh, axis)
    if flip_y is not None:
        limb, slot, bit = flip_y
        rows = n2 // D
        k2, k1 = divmod(slot, n1)
        if k2 // rows == r:
            Y[limb, k2 % rows, k1] ^= 1 << bit
    return GuardedShardedResult(y=Y, ok=projection(phi, Y) == s_in)
