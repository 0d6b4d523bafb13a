"""Primes, roots and the negacyclic transform in the layout the program keeps.

Plain PyTorch, written from the layout's definition and importing nothing
of the program.  The program states its evaluation domain (the docstring of
`rfhe_tpu_torch/ops/ntt.py`): for limb l with prime q, ψ = g^((q-1)/2n) (g
the smallest generator of (Z/qZ)*) and R = 2^32 mod q,

    F(x)[p] = R · x(ψ^(2·nu[p]+1)) mod q,   nu[p] = (p mod n1)·n2 + ⌊p/n1⌋,

with n1 = 2^⌊log2(n)/2⌋, raised to min(128, n/2) when smaller.  Here the
transform is computed another way: a twist by ψ^t, a cyclic
decimation-in-frequency network over ω = ψ² that leaves the evaluations in
bit-reversed order, a gather into natural order, then the slot order and
the factor R.  Keys and ciphertexts built with `Tables.fwd` are read by the
program as its own, and its outputs are read back with `Tables.inv`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

_R = 1 << 32


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    small = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)
    for p in small:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in small:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def ntt_primes(n: int, bits: int, count: int) -> List[int]:
    """The `count` largest primes q < 2^bits, q > 2^(bits-1), q ≡ 1 (mod 2n)."""
    q = ((1 << bits) - 1) // (2 * n) * (2 * n) + 1
    out = []
    while len(out) < count:
        if q <= 1 << (bits - 1):
            raise ValueError(f"fewer than {count} {bits}-bit primes = 1 mod {2 * n}")
        if is_prime(q):
            out.append(q)
        q -= 2 * n
    return out


def prime_chain(n: int, bit_sizes: Sequence[int]) -> List[int]:
    """One prime per entry of `bit_sizes`, the largest unused of its size first."""
    pools = {b: ntt_primes(n, b, list(bit_sizes).count(b)) for b in set(bit_sizes)}
    taken = {b: 0 for b in pools}
    out = []
    for b in bit_sizes:
        out.append(pools[b][taken[b]])
        taken[b] += 1
    return out


def special_primes(n: int, bits: int, count: int, taken: Sequence[int]) -> List[int]:
    """The `count` largest `bits`-bit NTT primes not in `taken`."""
    return [p for p in ntt_primes(n, bits, count + len(taken)) if p not in taken][:count]


def _factors(m: int) -> List[int]:
    out, d = [], 2
    while d * d <= m:
        if m % d == 0:
            out.append(d)
            while m % d == 0:
                m //= d
        d += 1
    return out + ([m] if m > 1 else [])


def generator(q: int) -> int:
    """The smallest generator of (Z/qZ)*."""
    fs = _factors(q - 1)
    return next(g for g in range(2, q) if all(pow(g, (q - 1) // f, q) != 1 for f in fs))


def psi(n: int, q: int) -> int:
    """The primitive 2n-th root of unity mod q of the program's layout."""
    return pow(generator(q), (q - 1) // (2 * n), q)


def slot_order(n: int) -> np.ndarray:
    """nu: slot p holds the evaluation at ψ^(2·nu[p]+1)."""
    log_n = n.bit_length() - 1
    n1 = 1 << (log_n // 2)
    if n1 < 128:
        n1 = min(128, n // 2)
    n2 = n // n1
    p = np.arange(n)
    return (p % n1) * n2 + p // n1


def _powers(base: int, count: int, q: int) -> np.ndarray:
    """base^i mod q for i < count (a power of two), each half from the last."""
    out = np.ones(count, dtype=np.int64)
    m = 1
    while m < count:
        out[m:2 * m] = out[:m] * pow(base, m, q) % q
        m *= 2
    return out


def _bit_reverse(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@dataclass
class Tables:
    """Per-limb tables of the transform for `primes` on `device`."""
    n: int
    primes: tuple
    q: torch.Tensor            # (L, 1)
    twist: torch.Tensor        # (L, n) ψ^t
    untwist: torch.Tensor      # (L, n) ψ^-t · n^-1 · R^-1
    omega: torch.Tensor        # (L, n/2) ω^j
    omega_inv: torch.Tensor    # (L, n/2) ω^-j
    r: torch.Tensor            # (L, 1) R mod q
    rinv: torch.Tensor         # (L, 1) R^-1 mod q
    to_slots: torch.Tensor     # (n,) network position of slot p: brev(nu[p])
    brev: torch.Tensor         # (n,) bit reversal

    @classmethod
    def make(cls, n: int, primes: Sequence[int], device) -> "Tables":
        rows = {k: [] for k in ("twist", "untwist", "omega", "omega_inv", "r", "rinv")}
        for q in primes:
            if (q - 1) % (2 * n):
                raise ValueError(f"{q} is not 1 mod 2n")
            ps = psi(n, q)
            ps_inv = pow(ps, -1, q)
            rinv = pow(_R % q, -1, q)
            rows["twist"].append(_powers(ps, n, q))
            rows["untwist"].append(_powers(ps_inv, n, q) * (pow(n, -1, q) * rinv % q) % q)
            rows["omega"].append(_powers(ps * ps % q, n // 2, q))
            rows["omega_inv"].append(_powers(ps_inv * ps_inv % q, n // 2, q))
            rows["r"].append([_R % q])
            rows["rinv"].append([rinv])
        dev = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
        # the network leaves evaluation k at position brev(k); slot p wants k = nu[p]
        brev = _bit_reverse(n)
        return cls(n=n, primes=tuple(int(q) for q in primes),
                   q=dev(np.array(primes)[:, None]), **{k: dev(v) for k, v in rows.items()},
                   to_slots=dev(brev[slot_order(n)]), brev=dev(brev))

    def take(self, limbs: Sequence[int]) -> "Tables":
        """The tables of the limbs at positions `limbs`."""
        idx = torch.as_tensor(list(limbs), device=self.q.device)
        pick = lambda t: t.index_select(0, idx)
        return Tables(n=self.n, primes=tuple(self.primes[i] for i in limbs), q=pick(self.q),
                      twist=pick(self.twist), untwist=pick(self.untwist),
                      omega=pick(self.omega), omega_inv=pick(self.omega_inv),
                      r=pick(self.r), rinv=pick(self.rinv),
                      to_slots=self.to_slots, brev=self.brev)

    def _network(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Cyclic DFT over Z_q of natural-order (..., L, n), evaluations left
        in bit-reversed order (decimation in frequency)."""
        n = self.n
        lead = a.shape[:-1]
        q = self.q[:, :, None]
        h, stride = n // 2, 1
        while h >= 1:
            a = a.reshape(*lead, n // (2 * h), 2, h)
            u, v = a[..., 0, :], a[..., 1, :]
            tw = w[:, ::stride][:, None, :h]
            a = torch.stack(((u + v) % q, (u - v) % q * tw % q), dim=-2)
            h //= 2
            stride *= 2
        return a.reshape(*lead, n)

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients in [0, q) (..., L, n) -> the program's slots."""
        y = self._network(x * self.twist % self.q, self.omega)
        return y.index_select(-1, self.to_slots) * self.r % self.q

    def inv(self, y: torch.Tensor) -> torch.Tensor:
        """The program's slots (..., L, n) -> coefficients in [0, q)."""
        # y[..., p] holds evaluation nu[p]; the inverse network wants natural order
        held = torch.empty_like(y)
        held[..., self.to_slots] = y          # evaluation k at position brev(k)
        return self.interpolate(held.index_select(-1, self.brev)) * self.rinv % self.q

    def evaluations(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients (..., L, n) -> x(ψ^(2k+1)) in natural order k, no R."""
        y = self._network(x * self.twist % self.q, self.omega)
        return y.index_select(-1, self.brev)

    def interpolate(self, ev: torch.Tensor) -> torch.Tensor:
        """x(ψ^(2k+1)) in natural order k (..., L, n) -> coefficients."""
        a = self._network(ev, self.omega_inv).index_select(-1, self.brev)
        return a * self.untwist % self.q * self.r % self.q

    def mont(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a·b·R^-1 mod q: the product of two slot vectors is F of the
        product of their polynomials."""
        return a * b % self.q * self.rinv % self.q
