"""Negacyclic NTT plan over a chain of primes, and its plain PyTorch versions.

Counterpart of `rfhe_tpu/ops/ntt_mxu.py` (`MxuNttPlan`) with the dispatch of
`rfhe_tpu/ops/ntt_pease.py:205-260`.  The transform is the same fixed linear
map, so the output is bit-identical whatever algorithm computes it.  For limb
l with prime q, ψ the primitive 2n-th root of `numth.psi_negacyclic(n, q)`
and R = 2^32 mod q:

  forward  y[..., l, p] = R · Σ_t x[..., l, t] · ψ^((2·nu[p]+1)·t)      mod q
  inverse  x[..., l, t] = n⁻¹ · R⁻¹ · Σ_p y[..., l, p] · ψ^(−(2·nu[p]+1)·t)

with the reference's slot order nu[p] = (p mod n1)·n2 + ⌊p/n1⌋ and its split
rule for n1 (`ntt_mxu.py:175-178`).  Both directions take and return
canonical residues in [0, q).

Both are computed as radix-2 butterfly networks: Cooley-Tukey forward on
bit-reversed ψ powers (output in bit-reversed order), Gentleman-Sande
inverse.  Slot p of the forward output is read from position brev(nu[p]);
`pos` holds that index.  On a CUDA tensor `NttPlan.fwd/inv` launch the
kernels of `ops/ntt_cuda.py` (one block per vector up to n = 8192, the
large-ring form above); on a CPU tensor they run the plain versions below,
which do the same butterflies with `(a*w) % q` on int64 tensors.  The
large-ring kernels compute the slot of a network position in closed form,
`slot_of_position`; the tables are held against it when they are built.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import check_residues
from ..numth import mod_inv, psi_negacyclic
from . import ntt_cuda
from .modarith import add_mod, sub_mod

__all__ = ["NttPlan", "ntt_fwd_reference", "ntt_inv_reference"]

_R = 1 << 32


def split_n(n: int) -> Tuple[int, int]:
    """(n1, n2) by the reference's split rule (`ntt_mxu.py:175-178`)."""
    log_n = n.bit_length() - 1
    if (1 << log_n) != n or n < 4:
        raise ValueError(f"n must be a power of two >= 4, got {n}")
    n1 = 1 << (log_n // 2)
    if n1 < 128:
        n1 = min(128, 1 << (log_n - 1))
    return n1, n // n1


def _slot_order(n: int, n1: int) -> Tuple[np.ndarray, np.ndarray]:
    """(nu, nu_inv): slot p holds NTT coefficient nu[p] (`ntt_mxu.py:237-240`)."""
    n2 = n // n1
    p = np.arange(n, dtype=np.int64)
    nu = (p % n1) * n2 + p // n1
    nu_inv = np.empty(n, dtype=np.int64)
    nu_inv[nu] = p
    return nu, nu_inv


@lru_cache(maxsize=2048)
def _galois_perm_mxu(n: int, n1: int, g: int) -> np.ndarray:
    """Slot permutation for X -> X^g (copy of `ntt_mxu._galois_perm_mxu`):
    slot p evaluates m at ψ^(2·nu[p]+1); the automorphism pulls from the slot
    holding exponent g·(2·nu[p]+1) mod 2n."""
    nu, nu_inv = _slot_order(n, n1)
    e = (g * (2 * nu + 1)) % (2 * n)
    return nu_inv[(e - 1) // 2].astype(np.int32)


def _bit_reverse(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    r = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        r |= ((i >> b) & 1) << (log_n - 1 - b)
    return r


def slot_of_position(n: int, n1: int) -> np.ndarray:
    """Slot p of network position j, in closed form: with j = jh·n1 + jl,
    p = brev(jh)·n1 + brev(jl), each reversal over its own width.  (Position
    brev(nu[p]) of slot p = a·n1 + b is brev(b·n2 + a) = brev(a)·n1 + brev(b).)
    The large-ring kernels compute this with `__brev` and read no slot table."""
    j = np.arange(n, dtype=np.int64)
    return _bit_reverse(n // n1)[j // n1] * n1 + _bit_reverse(n1)[j % n1]


def _pow_table(base: int, count: int, q: int) -> np.ndarray:
    """base^i mod q for i < count (a power of two), by doubling: the upper
    half of each prefix is the lower half times base^len (products < 2^62)."""
    out = np.ones(count, dtype=np.uint64)
    m = 1
    while m < count:
        out[m:2 * m] = out[:m] * np.uint64(pow(base, m, q)) % np.uint64(q)
        m *= 2
    return out


def _shoup(w: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Shoup companions floor(w·2^32/q) of w < q < 2^31 (fits uint64)."""
    return (w.astype(np.uint64) << np.uint64(32)) // q


def _bits32(a: np.ndarray) -> torch.Tensor:
    """uint32 values as an int32 tensor of the same bits (the kernels read
    them as uint32)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@dataclass(frozen=True, eq=False)
class _ChainTables:
    """Tables for a whole prime chain, built once and held on one device.
    Every `NttPlan` view of the chain shares them."""

    n: int
    n1: int
    primes: Tuple[int, ...]
    device: torch.device
    q: torch.Tensor              # (Lf,) int64
    rinv: torch.Tensor           # (Lf,) R^{-1} mod q, for modarith.mont_mul
    r_mod: torch.Tensor          # (Lf,) R mod q: forward exit factor
    ninv_rinv: torch.Tensor      # (Lf,) n^{-1}·R^{-1} mod q: inverse exit factor
    psi_rev: torch.Tensor        # (Lf, n) ψ^brev(i)
    psi_inv_rev: torch.Tensor    # (Lf, n) ψ^-brev(i)
    pos: torch.Tensor            # (n,) int64 brev(nu[p])
    pos_inv: torch.Tensor        # (n,) int64, pos_inv[pos[p]] = p
    # the same tables packed for the CUDA kernels (uint32 bits in int32):
    kernel_tw: torch.Tensor      # (Lf, 4, n) [ψ^brev, Shoup, ψ^-brev, Shoup]
    kernel_consts: torch.Tensor  # (Lf, 8) [q, R, R', n⁻¹R⁻¹, (n⁻¹R⁻¹)', 0, 0, 0]
    kernel_pos: torch.Tensor     # (n,) int32 brev(nu[p]), the one-block kernels'
    views: Dict[Tuple[int, ...], "NttPlan"] = field(default_factory=dict)

    @classmethod
    def build(cls, n: int, primes: Sequence[int], device: torch.device) -> "_ChainTables":
        primes = tuple(int(q) for q in primes)
        n1, _ = split_n(n)
        Lf = len(primes)
        brev = _bit_reverse(n)
        nu, _ = _slot_order(n, n1)
        pos = brev[nu]
        pos_inv = np.empty(n, dtype=np.int64)
        pos_inv[pos] = np.arange(n)
        if not np.array_equal(pos_inv, slot_of_position(n, n1)):
            raise AssertionError(f"slot order of n={n}, n1={n1} is not the closed form "
                                 f"the large-ring kernels compute")
        psi_rev = np.empty((Lf, n), dtype=np.uint64)
        psi_inv_rev = np.empty((Lf, n), dtype=np.uint64)
        consts = np.zeros((Lf, 8), dtype=np.uint64)
        scal = np.empty((Lf, 4), dtype=np.int64)
        for li, q in enumerate(primes):
            if not (q % 2 == 1 and q < (1 << 31)):
                raise ValueError(f"modulus must be an odd prime < 2^31, got {q}")
            psi = psi_negacyclic(n, q)
            psi_rev[li] = _pow_table(psi, n, q)[brev]
            psi_inv_rev[li] = _pow_table(mod_inv(psi, q), n, q)[brev]
            r = _R % q
            rinv = mod_inv(r, q)
            ninv_rinv = mod_inv(n, q) * rinv % q
            scal[li] = (q, rinv, r, ninv_rinv)
            consts[li, :5] = (q, r, (r << 32) // q, ninv_rinv, (ninv_rinv << 32) // q)
        qcol = np.array(primes, dtype=np.uint64)[:, None]
        tw = np.stack([psi_rev, _shoup(psi_rev, qcol),
                       psi_inv_rev, _shoup(psi_inv_rev, qcol)], axis=1)
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        t64 = lambda a: dev(a.astype(np.int64))
        q_t = t64(scal[:, 0])
        return cls(
            n=n, n1=n1, primes=primes, device=q_t.device, q=q_t,
            rinv=t64(scal[:, 1]), r_mod=t64(scal[:, 2]),
            ninv_rinv=t64(scal[:, 3]),
            psi_rev=t64(psi_rev), psi_inv_rev=t64(psi_inv_rev),
            pos=dev(pos), pos_inv=dev(pos_inv),
            kernel_tw=_bits32(tw).to(device), kernel_consts=_bits32(consts).to(device),
            kernel_pos=dev(pos.astype(np.int32)),
        )

    def view(self, limbs: Tuple[int, ...]) -> "NttPlan":
        plan = self.views.get(limbs)
        if plan is None:
            plan = self.views[limbs] = NttPlan(self, limbs)
        return plan


@dataclass(frozen=True, eq=False)
class NttPlan:
    """A view of the chain's tables restricted to the limbs `limbs` (indices
    into the full chain, any order, any subset).  `take` makes a new view
    without copying tables: the CUDA kernels receive the limb ids."""

    tables: _ChainTables
    limbs: Tuple[int, ...]

    @classmethod
    def make(cls, n: int, primes: Sequence[int], device) -> "NttPlan":
        tables = _ChainTables.build(n, primes, torch.device(device))
        return tables.view(tuple(range(len(tables.primes))))

    # ---- shape and views ------------------------------------------------
    @property
    def n(self) -> int:
        return self.tables.n

    @property
    def n1(self) -> int:
        return self.tables.n1

    @property
    def n2(self) -> int:
        return self.tables.n // self.tables.n1

    @property
    def log_n(self) -> int:
        return self.tables.n.bit_length() - 1

    @property
    def L(self) -> int:
        return len(self.limbs)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @property
    def primes(self) -> Tuple[int, ...]:
        return tuple(self.tables.primes[i] for i in self.limbs)

    @property
    def nu(self) -> np.ndarray:
        return _slot_order(self.n, self.n1)[0]

    def galois_perm(self, g: int) -> np.ndarray:
        return _galois_perm_mxu(self.n, self.n1, g)

    def take(self, idx) -> "NttPlan":
        """Sub-plan of the limbs at positions `idx` of this plan."""
        return self.tables.view(tuple(self.limbs[int(i)] for i in idx))

    def slice(self, k: int) -> "NttPlan":
        return self.take(range(k))

    # ---- per-view tables (gathered once per view, on the device) ----------
    @cached_property
    def limb_ids(self) -> torch.Tensor:
        return torch.tensor(self.limbs, dtype=torch.int64, device=self.device)

    @cached_property
    def limb_ids32(self) -> torch.Tensor:
        return self.limb_ids.to(torch.int32)

    @cached_property
    def q_arr(self) -> torch.Tensor:
        return self.tables.q[self.limb_ids]

    @cached_property
    def rinv_arr(self) -> torch.Tensor:
        return self.tables.rinv[self.limb_ids]

    def qb(self, ndim: int) -> torch.Tensor:
        return self.q_arr.reshape((self.L,) + (1,) * ndim)

    def rinvb(self, ndim: int) -> torch.Tensor:
        return self.rinv_arr.reshape((self.L,) + (1,) * ndim)

    # ---- transforms -------------------------------------------------------
    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients (..., L, n) -> slots (order nu, Montgomery form)."""
        check_residues(x, self.L, self.n, self.device)
        if x.device.type == "cpu":
            return ntt_fwd_reference(x, self)
        return ntt_cuda.fwd(x, self)

    def inv(self, y: torch.Tensor) -> torch.Tensor:
        """Slots (order nu, Montgomery form) (..., L, n) -> coefficients."""
        check_residues(y, self.L, self.n, self.device)
        if y.device.type == "cpu":
            return ntt_inv_reference(y, self)
        return ntt_cuda.inv(y, self)


def ntt_fwd_reference(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Plain forward NTT: Cooley-Tukey butterflies on int64, (a*w) % q."""
    n, L = plan.n, plan.L
    lead = x.shape[:-2]
    q = plan.qb(2)
    psi = plan.tables.psi_rev[plan.limb_ids]
    a = x
    for s in range(plan.log_n):
        m = 1 << s                                   # groups; half-size n/2m
        a = a.reshape(*lead, L, m, 2, n >> (s + 1))
        w = psi[:, m:2 * m].reshape(L, m, 1)
        u = a[..., 0, :]
        v = a[..., 1, :] * w % q
        a = torch.stack((add_mod(u, v, q), sub_mod(u, v, q)), dim=-2)
    a = a.reshape(*lead, L, n).index_select(-1, plan.tables.pos)
    return a * plan.tables.r_mod[plan.limb_ids][:, None] % plan.qb(1)


def ntt_inv_reference(y: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Plain inverse NTT: Gentleman-Sande butterflies on int64, (a*w) % q."""
    n, L = plan.n, plan.L
    lead = y.shape[:-2]
    q = plan.qb(2)
    psi_inv = plan.tables.psi_inv_rev[plan.limb_ids]
    a = y.index_select(-1, plan.tables.pos_inv)
    for s in range(plan.log_n):
        h = n >> (s + 1)                             # groups; half-size 2^s
        a = a.reshape(*lead, L, h, 2, 1 << s)
        w = psi_inv[:, h:2 * h].reshape(L, h, 1)
        u = a[..., 0, :]
        v = a[..., 1, :]
        a = torch.stack((add_mod(u, v, q), sub_mod(u, v, q) * w % q), dim=-2)
    a = a.reshape(*lead, L, n)
    return a * plan.tables.ninv_rinv[plan.limb_ids][:, None] % plan.qb(1)
