"""Radix-2 NTT plans: one prime (`Radix2NttPlan`) and a stack of primes
(`StackedNttPlan`), and the transforms that take either.

Counterpart of `rfhe_tpu/ops/ntt.py:42-270`, whose single-prime plan is
`rfhe_tpu.ops.ntt.NttPlan` (the port's `NttPlan` names the negacyclic
four-step map of the hand kernels, so this one is `Radix2NttPlan`).  The
forward transform is decimation in frequency with a Shoup butterfly per
stage, natural order in and bit-reversed order out; the inverse is the
mirror network, bit-reversed in, natural out, leaving a factor n.  The
negacyclic transforms enter the Montgomery domain through the ψ table
(ψ^i·R mod q, R = 2^32) and leave it through ψ^-i·n⁻¹ with a Montgomery
product.  The reference runs these as XLA compositions, so plain torch ops on
int64 residues are their port; every output is the reference's word
(tests/test_torch_ntt_stacked.py).

A StackedNttPlan holds per-limb tables stacked on a leading L axis and
transforms x of shape (..., L, n); a Radix2NttPlan transforms (..., n).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..numth import mod_inv, psi_negacyclic
from .modarith import add_mod, mont_mul, mul_mod_shoup, sub_mod
from .ntt import _bit_reverse, _pow_table

_R = 1 << 32


def bit_reverse_indices(n: int) -> np.ndarray:
    """i -> i with its log2(n) bits reversed: the order of the forward output."""
    return _bit_reverse(n)


def _tables(n: int, q: int) -> dict:
    """The reference's tables of one prime as uint64 numpy arrays: per stage
    s the twiddles ω^(2^s·j), j < n/2^(s+1), and their inverses with Shoup
    companions; the entry table ψ^i·R and the exit table ψ^-i·n⁻¹."""
    psi = psi_negacyclic(n, q)
    omega = psi * psi % q
    qq = np.uint64(q)
    shoup = lambda w: (w << np.uint64(32)) // qq
    fwd, inv = [], []
    for s in range(n.bit_length() - 1):
        half = n >> (s + 1)
        w = _pow_table(pow(omega, 1 << s, q), half, q)
        wi = _pow_table(pow(mod_inv(omega, q), 1 << s, q), half, q)
        fwd.append((w, shoup(w)))
        inv.append((wi, shoup(wi)))
    psi_mont = _pow_table(psi, n, q) * np.uint64(_R % q) % qq
    psi_inv_n = _pow_table(mod_inv(psi, q), n, q) * np.uint64(mod_inv(n, q)) % qq
    return dict(fwd=fwd, inv=inv, psi_mont=psi_mont, psi_mont_shoup=shoup(psi_mont),
                psi_inv_n=psi_inv_n, rinv=mod_inv(_R % q, q))


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)


@dataclass(frozen=True, eq=False)
class Radix2NttPlan:
    """Tables of one (n, q) pair on one device (`rfhe_tpu.ops.ntt.NttPlan`)."""

    n: int
    q: int
    rinv: int                                  # R⁻¹ mod q, for modarith.mont_mul
    fwd_w: Tuple[torch.Tensor, ...]            # stage s: (n/2^(s+1),)
    fwd_w_shoup: Tuple[torch.Tensor, ...]
    inv_w: Tuple[torch.Tensor, ...]
    inv_w_shoup: Tuple[torch.Tensor, ...]
    psi_mont: torch.Tensor                     # (n,) ψ^i·R mod q
    psi_mont_shoup: torch.Tensor
    psi_inv_n: torch.Tensor                    # (n,) ψ^-i·n⁻¹ mod q

    @classmethod
    def make(cls, n: int, q: int, device) -> "Radix2NttPlan":
        t = _tables(n, q)
        dev = lambda a: _t(a, device)
        return cls(n=n, q=q, rinv=t["rinv"],
                   fwd_w=tuple(dev(w) for w, _ in t["fwd"]),
                   fwd_w_shoup=tuple(dev(ws) for _, ws in t["fwd"]),
                   inv_w=tuple(dev(w) for w, _ in t["inv"]),
                   inv_w_shoup=tuple(dev(ws) for _, ws in t["inv"]),
                   psi_mont=dev(t["psi_mont"]), psi_mont_shoup=dev(t["psi_mont_shoup"]),
                   psi_inv_n=dev(t["psi_inv_n"]))

    # broadcast helpers shared with StackedNttPlan (scalars here)
    def qb(self, ndim: int):
        return self.q

    def rinvb(self, ndim: int):
        return self.rinv

    def stage_w(self, s: int, inverse: bool = False):
        return (self.inv_w[s], self.inv_w_shoup[s]) if inverse else \
            (self.fwd_w[s], self.fwd_w_shoup[s])


@dataclass(frozen=True, eq=False)
class StackedNttPlan:
    """Per-limb tables stacked on a leading L axis, so one transform takes
    every RNS limb of x (..., L, n) (`rfhe_tpu.ops.ntt.StackedNttPlan`)."""

    n: int
    q_arr: torch.Tensor                        # (L,)
    rinv_arr: torch.Tensor                     # (L,)
    fwd_w: Tuple[torch.Tensor, ...]            # stage s: (L, n/2^(s+1))
    fwd_w_shoup: Tuple[torch.Tensor, ...]
    inv_w: Tuple[torch.Tensor, ...]
    inv_w_shoup: Tuple[torch.Tensor, ...]
    psi_mont: torch.Tensor                     # (L, n)
    psi_mont_shoup: torch.Tensor
    psi_inv_n: torch.Tensor

    @classmethod
    def make(cls, n: int, primes: Sequence[int], device) -> "StackedNttPlan":
        ts = [_tables(n, int(q)) for q in primes]
        dev = lambda a: _t(a, device)
        stages = range(n.bit_length() - 1)
        stack = lambda key, i: tuple(dev(np.stack([t[key][s][i] for t in ts])) for s in stages)
        return cls(n=n, q_arr=dev(np.array([int(q) for q in primes])),
                   rinv_arr=dev(np.array([t["rinv"] for t in ts])),
                   fwd_w=stack("fwd", 0), fwd_w_shoup=stack("fwd", 1),
                   inv_w=stack("inv", 0), inv_w_shoup=stack("inv", 1),
                   psi_mont=dev(np.stack([t["psi_mont"] for t in ts])),
                   psi_mont_shoup=dev(np.stack([t["psi_mont_shoup"] for t in ts])),
                   psi_inv_n=dev(np.stack([t["psi_inv_n"] for t in ts])))

    @property
    def L(self) -> int:
        return int(self.q_arr.shape[0])

    def slice(self, k: int) -> "StackedNttPlan":
        """The plan of the first k limbs (level-dropped ciphertexts)."""
        cut = lambda ws: tuple(w[:k] for w in ws)
        return StackedNttPlan(
            n=self.n, q_arr=self.q_arr[:k], rinv_arr=self.rinv_arr[:k],
            fwd_w=cut(self.fwd_w), fwd_w_shoup=cut(self.fwd_w_shoup),
            inv_w=cut(self.inv_w), inv_w_shoup=cut(self.inv_w_shoup),
            psi_mont=self.psi_mont[:k], psi_mont_shoup=self.psi_mont_shoup[:k],
            psi_inv_n=self.psi_inv_n[:k])

    def qb(self, ndim: int) -> torch.Tensor:
        """q broadcast against (..., L, *tail) with `ndim` tail axes."""
        return self.q_arr.reshape((self.L,) + (1,) * ndim)

    def rinvb(self, ndim: int) -> torch.Tensor:
        return self.rinv_arr.reshape((self.L,) + (1,) * ndim)

    def stage_w(self, s: int, inverse: bool = False):
        w, ws = ((self.inv_w[s], self.inv_w_shoup[s]) if inverse
                 else (self.fwd_w[s], self.fwd_w_shoup[s]))
        return w[:, None, :], ws[:, None, :]


def ntt(x: torch.Tensor, plan) -> torch.Tensor:
    """Cyclic forward NTT over the last axis, natural in, bit-reversed out.
    Shoup products keep whatever domain x is in."""
    n = plan.n
    shape = x.shape
    if shape[-1] != n:
        raise ValueError(f"expected a last axis of {n}, got {tuple(shape)}")
    q2 = plan.qb(2)
    for s in range(n.bit_length() - 1):
        m = n >> s
        xr = x.reshape(shape[:-1] + (n // m, m))
        a, b = xr[..., :m // 2], xr[..., m // 2:]
        w, ws = plan.stage_w(s)
        v = mul_mod_shoup(sub_mod(a, b, q2), w, ws, q2)
        x = torch.cat([add_mod(a, b, q2), v], dim=-1).reshape(shape)
    return x


def intt(x: torch.Tensor, plan) -> torch.Tensor:
    """Cyclic inverse NTT, bit-reversed in, natural out; the result carries a
    factor n (the caller's exit table or n⁻¹ removes it)."""
    n = plan.n
    shape = x.shape
    q2 = plan.qb(2)
    for s in reversed(range(n.bit_length() - 1)):
        m = n >> s
        xr = x.reshape(shape[:-1] + (n // m, m))
        u, v = xr[..., :m // 2], xr[..., m // 2:]
        w, ws = plan.stage_w(s, inverse=True)
        t = mul_mod_shoup(v, w, ws, q2)
        x = torch.cat([add_mod(u, t, q2), sub_mod(u, t, q2)], dim=-1).reshape(shape)
    return x


def negacyclic_ntt(x: torch.Tensor, plan) -> torch.Tensor:
    """ψ-premultiply into the Montgomery domain, then the cyclic NTT:
    Montgomery form, bit-reversed order."""
    return ntt(mul_mod_shoup(x, plan.psi_mont, plan.psi_mont_shoup, plan.qb(1)), plan)


def negacyclic_intt(x: torch.Tensor, plan) -> torch.Tensor:
    """Cyclic INTT, then the ψ^-i·n⁻¹ exit table by Montgomery product, which
    leaves the Montgomery domain: normal domain, natural order."""
    return mont_mul(intt(x, plan), plan.psi_inv_n, plan.qb(1), plan.rinvb(1))


def pointwise_mul(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """Montgomery product of two NTT-domain vectors (stays in the domain)."""
    return mont_mul(a, b, plan.qb(1), plan.rinvb(1))


def poly_mul_negacyclic(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """The product mod (x^n + 1, q)."""
    A = negacyclic_ntt(a, plan)
    B = negacyclic_ntt(b, plan)
    return negacyclic_intt(pointwise_mul(A, B, plan), plan)
