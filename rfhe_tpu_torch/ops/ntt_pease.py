"""Pease constant-geometry NTT, and the negacyclic dispatch by plan type.

Counterpart of `rfhe_tpu/ops/ntt_pease.py`.  Every stage is the same
computation: butterfly the first half of the vector against the second half
and write the results interleaved.  Keeping ρ_s (current position → virtual
natural-DIF position), stage s butterflies the pairs (i, i+n/2), whose
virtual indices satisfy vb = va + m/2 (m = n >> s), with the DIF twiddle
ω^((va mod m)·(n/m)); outputs go to (2i, 2i+1), so ρ_{s+1}[2i] = va[i] and
ρ_{s+1}[2i+1] = va[i] + m/2.  Slot p of the output holds NTT coefficient
ν(p) = bitrev(ρ_final[p]).  The inverse runs the mirrored pipeline on the
inverse twiddles; the factor n leaves with the caller's exit table.

The reference composes the pipeline in XLA (a fori_loop); here it is plain
PyTorch on int64 residues, log2(n) stages of add, subtract, Shoup product
and interleave, about 17 device operations a stage.  It is the plain
version of the profiling layer's NTT, not a kernel: `negacyclic_ntt` and
`negacyclic_intt` send a plan that has its own `fwd` / `inv` (the port's
`NttPlan`) there, which on a CUDA tensor launches the hand kernels of
`ops/ntt_cuda.py`.  Only a `PeaseNttPlan` runs the pipeline, and its output
is in the Pease slot order ν, not `NttPlan`'s.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..device import check_residues
from ..numth import mod_inv, psi_negacyclic
from .modarith import add_mod, mont_mul, mul_mod_shoup, sub_mod

__all__ = ["PeaseNttPlan", "bit_reverse_indices", "ntt", "intt", "negacyclic_ntt",
           "negacyclic_intt", "galois_perm"]

_R = 1 << 32


def bit_reverse_indices(n: int) -> np.ndarray:
    """brev over log2(n) bits of 0..n-1 (copy of `rfhe_tpu.ops.ntt.bit_reverse_indices`)."""
    log_n = n.bit_length() - 1
    if (1 << log_n) != n:
        raise ValueError(f"n must be a power of two, got {n}")
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=64)
def _pease_tables(n: int):
    """(twiddle exponents (log n, n/2), final layout ρ (n,)); neither depends
    on the modulus."""
    log_n = n.bit_length() - 1
    rho = np.arange(n, dtype=np.int64)
    exps = np.empty((log_n, n // 2), dtype=np.int64)
    for s in range(log_n):
        m = n >> s
        half = m // 2
        va = rho[: n // 2]
        if not np.array_equal(rho[n // 2:], va + half):
            raise AssertionError(f"pairing broken at stage {s}")
        exps[s] = (va % m) * (n // m)
        new_rho = np.empty_like(rho)
        new_rho[0::2] = va
        new_rho[1::2] = va + half
        rho = new_rho
    return exps, rho


def _powers(base: int, count: int, q: int) -> np.ndarray:
    """base^e mod q for e < count (a power of two), by doubling (products < 2^62)."""
    out = np.ones(count, dtype=np.uint64)
    m = 1
    while m < count:
        out[m:2 * m] = out[:m] * np.uint64(pow(base, m, q)) % np.uint64(q)
        m *= 2
    return out


def _shoup(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w·2^32/q) (`numth.shoup_precompute`) for w < q < 2^31."""
    return (w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)


@dataclass(frozen=True, eq=False)
class PeaseNttPlan:
    """Stacked-limb constant-geometry plan (`rfhe_tpu.ops.ntt_pease.PeaseNttPlan`).
    Tables are int64 tensors on one device with a limb axis; `nu` / `nu_inv`
    are host arrays."""

    n: int
    q_arr: torch.Tensor            # (L,)
    rinv_arr: torch.Tensor         # (L,) R^{-1} mod q, for modarith.mont_mul
    fwd_w: torch.Tensor            # (log n, L, n/2)
    fwd_w_shoup: torch.Tensor
    inv_w: torch.Tensor
    inv_w_shoup: torch.Tensor
    psi_mont: torch.Tensor         # (L, n) ψ^i·R (entry: carries Montgomery R)
    psi_mont_shoup: torch.Tensor
    psi_inv_n: torch.Tensor        # (L, n) ψ^{-i}·n^{-1} (exit)
    nu: np.ndarray                 # (n,) slot -> natural NTT output index
    nu_inv: np.ndarray

    @classmethod
    def make(cls, n: int, primes: Sequence[int], device) -> "PeaseNttPlan":
        primes = [int(q) for q in primes]
        L = len(primes)
        log_n = n.bit_length() - 1
        exps, rho = _pease_tables(n)
        nu = bit_reverse_indices(n)[rho]
        fwd = np.empty((log_n, L, n // 2), dtype=np.uint64)
        inv, fwds, invs = np.empty_like(fwd), np.empty_like(fwd), np.empty_like(fwd)
        psi_m = np.empty((L, n), dtype=np.uint64)
        psi_ms, psi_in = np.empty_like(psi_m), np.empty_like(psi_m)
        rinv = np.empty(L, dtype=np.int64)
        for li, q in enumerate(primes):
            if not (q % 2 == 1 and q < (1 << 31)):
                raise ValueError(f"modulus must be an odd prime < 2^31, got {q}")
            psi = psi_negacyclic(n, q)
            omega = psi * psi % q
            fwd[:, li] = _powers(omega, n, q)[exps]
            inv[:, li] = _powers(mod_inv(omega, q), n, q)[exps]
            fwds[:, li] = _shoup(fwd[:, li], q)
            invs[:, li] = _shoup(inv[:, li], q)
            psi_m[li] = _powers(psi, n, q) * np.uint64(_R % q) % np.uint64(q)
            psi_ms[li] = _shoup(psi_m[li], q)
            psi_in[li] = _powers(mod_inv(psi, q), n, q) * np.uint64(mod_inv(n, q)) % np.uint64(q)
            rinv[li] = mod_inv(_R % q, q)
        nu_inv = np.empty(n, dtype=np.int64)
        nu_inv[nu] = np.arange(n)
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)
        return cls(n=n, q_arr=dev(np.array(primes)), rinv_arr=dev(rinv),
                   fwd_w=dev(fwd), fwd_w_shoup=dev(fwds), inv_w=dev(inv), inv_w_shoup=dev(invs),
                   psi_mont=dev(psi_m), psi_mont_shoup=dev(psi_ms), psi_inv_n=dev(psi_in),
                   nu=nu, nu_inv=nu_inv)

    @property
    def L(self) -> int:
        return int(self.q_arr.shape[0])

    @property
    def device(self) -> torch.device:
        return self.q_arr.device

    def take(self, idx) -> "PeaseNttPlan":
        """Sub-plan of the limbs at positions `idx`."""
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.device)
        limbs = lambda t: t.index_select(0, idx)
        stages = lambda t: t.index_select(1, idx)
        return PeaseNttPlan(
            n=self.n, q_arr=limbs(self.q_arr), rinv_arr=limbs(self.rinv_arr),
            fwd_w=stages(self.fwd_w), fwd_w_shoup=stages(self.fwd_w_shoup),
            inv_w=stages(self.inv_w), inv_w_shoup=stages(self.inv_w_shoup),
            psi_mont=limbs(self.psi_mont), psi_mont_shoup=limbs(self.psi_mont_shoup),
            psi_inv_n=limbs(self.psi_inv_n), nu=self.nu, nu_inv=self.nu_inv)

    def slice(self, k: int) -> "PeaseNttPlan":
        return self.take(range(k))

    def qb(self, ndim: int) -> torch.Tensor:
        return self.q_arr.reshape((self.L,) + (1,) * ndim)

    def rinvb(self, ndim: int) -> torch.Tensor:
        return self.rinv_arr.reshape((self.L,) + (1,) * ndim)


def ntt(x: torch.Tensor, plan: PeaseNttPlan) -> torch.Tensor:
    """Cyclic forward NTT over the last axis of x (..., L, n) (`ntt_pease.ntt`).
    Slot p of the output holds NTT coefficient plan.nu[p].  Domain-agnostic."""
    check_residues(x, plan.L, plan.n, plan.device)
    n, q, shape = plan.n, plan.qb(1), x.shape
    for s in range(n.bit_length() - 1):
        a, b = x[..., : n // 2], x[..., n // 2:]
        u = add_mod(a, b, q)
        t = mul_mod_shoup(sub_mod(a, b, q), plan.fwd_w[s], plan.fwd_w_shoup[s], q)
        x = torch.stack((u, t), dim=-1).reshape(shape)
    return x


def intt(x: torch.Tensor, plan: PeaseNttPlan) -> torch.Tensor:
    """The mirrored inverse pipeline (`ntt_pease.intt`); the result carries a
    factor n."""
    check_residues(x, plan.L, plan.n, plan.device)
    n, q, shape = plan.n, plan.qb(1), x.shape
    log_n = n.bit_length() - 1
    for i in range(log_n):
        s = log_n - 1 - i
        pairs = x.reshape(shape[:-1] + (n // 2, 2))
        tw = mul_mod_shoup(pairs[..., 1], plan.inv_w[s], plan.inv_w_shoup[s], q)
        u = pairs[..., 0]
        x = torch.cat((add_mod(u, tw, q), sub_mod(u, tw, q)), dim=-1)
    return x


def negacyclic_ntt(x: torch.Tensor, plan) -> torch.Tensor:
    """ψ-premultiply (entering the Montgomery domain) and the forward
    pipeline.  A plan with its own `fwd` (the port's `NttPlan`, whose fwd
    launches the hand kernels on a CUDA tensor) goes there instead, as in the
    reference's dispatch (`ntt_pease.negacyclic_ntt`)."""
    fwd = getattr(plan, "fwd", None)
    if fwd is not None:
        return fwd(x)
    check_residues(x, plan.L, plan.n, plan.device)
    return ntt(mul_mod_shoup(x, plan.psi_mont, plan.psi_mont_shoup, plan.qb(1)), plan)


def negacyclic_intt(x: torch.Tensor, plan) -> torch.Tensor:
    """The inverse pipeline and the ψ^{-i}·n^{-1} exit, which also removes
    the Montgomery R; a plan with its own `inv` goes there."""
    inv = getattr(plan, "inv", None)
    if inv is not None:
        return inv(x)
    return mont_mul(intt(x, plan), plan.psi_inv_n, plan.qb(1), plan.rinvb(1))


@lru_cache(maxsize=1024)
def _galois_perm_nu(n: int, g: int) -> np.ndarray:
    """Slot permutation for X -> X^g in Pease slot order (`ntt_pease._galois_perm_nu`):
    slot p evaluates at ψ^(2ν(p)+1); the automorphism pulls from the slot
    holding exponent g·(2ν(p)+1) mod 2n."""
    nu = bit_reverse_indices(n)[_pease_tables(n)[1]]
    nu_inv = np.empty(n, dtype=np.int64)
    nu_inv[nu] = np.arange(n)
    e = (g * (2 * nu + 1)) % (2 * n)
    return nu_inv[(e - 1) // 2].astype(np.int32)


def galois_perm(plan, g: int) -> np.ndarray:
    """Order-aware Galois slot permutation (`ntt_pease.galois_perm`): a plan
    with its own `galois_perm` (`NttPlan`, order nu of the four-step split)
    gives it; otherwise the Pease order."""
    meth = getattr(plan, "galois_perm", None)
    if meth is not None:
        return meth(g)
    return _galois_perm_nu(plan.n, g)
