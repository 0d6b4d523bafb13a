"""Keys, encryption, encoding and decryption of CKKS and BGV, in plain PyTorch.

The keys come out in the program's layout (the docstring of
`rfhe_tpu_torch/fhe/keys.py`): the secret s ternary, its slots over every
prime of the basis; a public key (b, a) = (t·e − a·s, a) over the
ciphertext primes (t = 1 in CKKS); and for a key switching s' -> s, one
pair per digit group j over the whole basis,

    b_j = t·e_j − a_j·s + [P·s' on the limbs of group j],

P the special primes' product.  The configuration's `digits` sets the
groups: "per_limb" is one limb a group over one special prime; an integer
dnum is ⌈L/dnum⌉ contiguous limbs a group over as many special primes.

Everything is drawn on the device from one `torch.Generator`, in a few large
calls.  Decryption reads a ciphertext's slots back with `Tables.inv`, takes
the small integer that its first two limbs determine (Garner), and counts
the other limbs that disagree with it: a sound ciphertext decrypts to one
small integer in every limb.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .ntt import Tables, prime_chain, special_primes


def dnum(deployment: dict) -> Optional[int]:
    """The digit groups of a configuration's `digits`: None for "per_limb",
    else the integer dnum ≥ 1."""
    d = deployment["digits"]
    if d == "per_limb":
        return None
    if type(d) is int and d >= 1:
        return d
    raise ValueError(f"digits {d!r}: \"per_limb\" or an integer dnum >= 1")


@dataclass
class Basis:
    """The deployment's primes: ciphertext primes, special primes, t (BGV),
    and the keyswitch's digit groups."""
    n: int
    ct: tuple
    special: tuple
    t: Optional[int]
    tables: Tables                  # ciphertext primes, then special primes
    t_tables: Optional[Tables]      # the plaintext prime t (BGV)
    dnum: Optional[int]             # digit groups; None: per-limb digits

    @classmethod
    def make(cls, deployment: dict, device) -> "Basis":
        """From a configuration's `deployment` group."""
        n, levels = deployment["n"], deployment["levels"]
        d = dnum(deployment)
        if deployment["scheme"] == "ckks":
            bits = [deployment["q0_bits"]] + [deployment["scale_bits"]] * levels
        else:
            bits = [deployment["q_bits"]] * (levels + 1)
        ct = prime_chain(n, bits)
        t = None
        taken = list(ct)
        if deployment["scheme"] == "bgv":
            t = prime_chain(n, [deployment["t_bits"]])[0]
            taken.append(t)
        count = 1 if d is None else -(-len(ct) // d)
        sp = special_primes(n, deployment["special_prime_bits"], count, taken)
        return cls(n=n, ct=tuple(ct), special=tuple(sp), t=t,
                   tables=Tables.make(n, ct + sp, device),
                   t_tables=Tables.make(n, [t], device) if t else None, dnum=d)

    @property
    def L(self) -> int:
        return len(self.ct)

    def groups(self) -> list:
        """The digit groups: contiguous runs of α = ⌈L/dnum⌉ limbs."""
        alpha = 1 if self.dnum is None else -(-self.L // self.dnum)
        return [list(range(j, min(j + alpha, self.L))) for j in range(0, self.L, alpha)]

    def level_tables(self, level: int) -> Tables:
        return self.tables.take(range(level + 1))


def residues(v: torch.Tensor, tab: Tables) -> torch.Tensor:
    """Signed integers (..., n) -> residues (..., L, n) for the limbs of `tab`."""
    return v.unsqueeze(-2) % tab.q


def ternary(gen, shape, device) -> torch.Tensor:
    return torch.randint(-1, 2, shape, generator=gen, device=device)


def gaussian(gen, shape, device, sigma: float = 3.2) -> torch.Tensor:
    return torch.round(torch.randn(shape, generator=gen, device=device,
                                   dtype=torch.float64) * sigma).to(torch.int64)


def uniform(gen, shape, tab: Tables) -> torch.Tensor:
    """Uniform residues (..., L, n); the bias of a 62-bit word mod q < 2^31 is 2^-31."""
    return torch.randint(0, 1 << 62, shape, generator=gen, device=tab.q.device) % tab.q


def automorphism(s: torch.Tensor, g: int) -> torch.Tensor:
    """s(X^g) mod X^n + 1 for signed coefficients s (n,)."""
    n = s.shape[-1]
    e = torch.arange(n, device=s.device) * g % (2 * n)
    out = torch.zeros_like(s)
    out[e % n] = torch.where(e < n, s, -s)
    return out


class Keys:
    """A secret key and what is made from it, in the program's layout."""

    def __init__(self, basis: Basis, gen: torch.Generator, sigma: float = 3.2):
        self.basis, self.gen, self.sigma = basis, gen, sigma
        self.nf = basis.t or 1                      # noise factor: t in BGV
        dev = basis.tables.q.device
        self.s = ternary(gen, (basis.n,), dev)
        self.s_slots = basis.tables.fwd(residues(self.s, basis.tables))
        ct = basis.tables.take(range(basis.L))
        a = uniform(gen, (basis.L, basis.n), ct)
        e = ct.fwd(residues(self.nf * gaussian(gen, (basis.n,), dev, sigma), ct))
        self.pk_a = a
        self.pk_b = (e - ct.mont(a, self.s_slots[:basis.L])) % ct.q

    def switching_key(self, s_prime_slots: torch.Tensor):
        """(b, a), each (groups, L + S, n): one pair per digit group, s' -> s."""
        b_, tab = self.basis, self.basis.tables
        groups = b_.groups()
        L, G, n, dev = b_.L, len(groups), b_.n, tab.q.device
        a = uniform(self.gen, (G, len(tab.primes), n), tab)
        e = tab.fwd(residues(self.nf * gaussian(self.gen, (G, n), dev, self.sigma), tab))
        b = (e - tab.mont(a, self.s_slots)) % tab.q
        del e
        P = math.prod(b_.special)
        p_mod = torch.tensor([P % q for q in b_.ct], device=dev)
        j = torch.tensor([g for g, grp in enumerate(groups) for _ in grp], device=dev)
        l = torch.arange(L, device=dev)             # limb l lies in group j[l]
        b[j, l] = (b[j, l] + p_mod[:, None] * s_prime_slots[:L] % tab.q[:L]) % tab.q[:L]
        return b, a

    def galois_key(self, g: int):
        return self.switching_key(
            self.basis.tables.fwd(residues(automorphism(self.s, g), self.basis.tables)))

    def relin_key(self):
        return self.switching_key(self.basis.tables.mont(self.s_slots, self.s_slots))

    def encrypt(self, m: torch.Tensor, level: int):
        """Public-key encryptions of coefficient residues m (B, level+1, n):
        (c0, c1) = (b·u + F(t·e0 + m), a·u + F(t·e1)), each (B, level+1, n)."""
        tab = self.basis.level_tables(level)
        B, n, dev = m.shape[0], self.basis.n, m.device
        u = tab.fwd(residues(ternary(self.gen, (B, n), dev), tab))
        e0 = residues(self.nf * gaussian(self.gen, (B, n), dev, self.sigma), tab)
        e1 = residues(self.nf * gaussian(self.gen, (B, n), dev, self.sigma), tab)
        k = level + 1
        c0 = (tab.mont(self.pk_b[:k], u) + tab.fwd((e0 + m) % tab.q)) % tab.q
        c1 = (tab.mont(self.pk_a[:k], u) + tab.fwd(e1)) % tab.q
        return c0, c1

    def decrypt(self, c0: torch.Tensor, c1: torch.Tensor):
        """(the small integer each coefficient decrypts to (..., n), the number
        of (limb, coefficient) residues beyond the first two that disagree
        with it)."""
        tab = self.basis.level_tables(c0.shape[-2] - 1)
        k = c0.shape[-2]
        res = tab.inv((c0 + tab.mont(c1, self.s_slots[:k])) % tab.q)
        return small_value(res, tab)


def small_value(res: torch.Tensor, tab: Tables):
    """Garner on limbs 0 and 1: the integer v in (-q0·q1/2, q0·q1/2] with
    v ≡ res (mod q0, q1), and how many residues of the other limbs differ
    from v mod q."""
    q0, q1 = tab.primes[0], tab.primes[1]
    a0, a1 = res[..., 0, :], res[..., 1, :]
    h = (a1 - a0) % q1 * pow(q0, -1, q1) % q1
    v = a0 + q0 * h
    v = torch.where(v > q0 * q1 // 2, v - q0 * q1, v)
    rest = tab.q[2:]
    bad = (v.unsqueeze(-2) % rest != res[..., 2:, :]).sum()
    return v, int(bad)


# -- CKKS: the canonical embedding -------------------------------------------

def _slot_exponents(n: int, device) -> torch.Tensor:
    """5^j mod 2n for j < n/2: slot j is the evaluation at ζ^(5^j), ζ = e^(iπ/n)."""
    out = np.empty(n // 2, dtype=np.int64)
    k = 1
    for j in range(n // 2):
        out[j] = k
        k = k * 5 % (2 * n)
    return torch.as_tensor(out, device=device)


def ckks_encode(z: torch.Tensor, scale: float) -> torch.Tensor:
    """Complex slots (..., n/2) -> rounded integer coefficients (..., n) of
    the polynomial whose evaluation at ζ^(5^j) is scale·z_j."""
    n = 2 * z.shape[-1]
    ks = _slot_exponents(n, z.device)
    ev = torch.zeros(z.shape[:-1] + (n,), dtype=torch.complex128, device=z.device)
    ev[..., (ks - 1) // 2] = z
    ev[..., (2 * n - ks - 1) // 2] = z.conj()
    t = torch.arange(n, device=z.device)
    untwist = torch.exp(-1j * math.pi * t / n)
    coeffs = (untwist * torch.fft.fft(ev)).real / n * scale
    return torch.round(coeffs).to(torch.int64)


def ckks_decode(v: torch.Tensor, scale: float) -> torch.Tensor:
    """Integer coefficients (..., n) -> complex slots (..., n/2)."""
    n = v.shape[-1]
    t = torch.arange(n, device=v.device)
    ev = n * torch.fft.ifft(v.to(torch.float64) * torch.exp(1j * math.pi * t / n))
    return ev[..., (_slot_exponents(n, v.device) - 1) // 2] / scale


# -- BGV: batching over the slots mod t ----------------------------------------

def _bgv_points(n: int, device) -> torch.Tensor:
    """(2, n/2) natural evaluation index k (point ψ^(2k+1)) of matrix
    position (r, j): exponent 5^j in row 0, 2n - 5^j in row 1."""
    e = _slot_exponents(n, device)
    return torch.stack(((e - 1) // 2, (2 * n - e - 1) // 2))


def bgv_encode(matrix: torch.Tensor, basis: Basis) -> torch.Tensor:
    """(..., 2, n/2) values mod t -> the coefficients mod t (..., n)."""
    n = basis.n
    ev = torch.zeros(matrix.shape[:-2] + (n,), dtype=torch.int64, device=matrix.device)
    ev[..., _bgv_points(n, matrix.device).reshape(-1)] = matrix.reshape(
        matrix.shape[:-2] + (n,)) % basis.t
    return basis.t_tables.interpolate(ev.unsqueeze(-2))[..., 0, :]


def bgv_decode(coeffs_t: torch.Tensor, basis: Basis) -> torch.Tensor:
    """Coefficients mod t (..., n) -> the (..., 2, n/2) slot matrix."""
    ev = basis.t_tables.evaluations(coeffs_t.unsqueeze(-2))[..., 0, :]
    return ev[..., _bgv_points(basis.n, ev.device)]
