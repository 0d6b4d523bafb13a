"""Keys, encryption, encoding and decryption of CKKS, BGV and BFV, in plain PyTorch.

The keys come out in the program's layout (the docstring of
`rfhe_tpu_torch/fhe/keys.py`): the secret s ternary, its slots over every
prime of the basis; a public key (b, a) = (f·e − a·s, a) over the
ciphertext primes, f = t in BGV and 1 in CKKS and BFV; and for a key
switching s' -> s, one pair per digit group j over the whole basis,

    b_j = f·e_j − a_j·s + [P·s' on the limbs of group j],

P the special primes' product.  The configuration's `digits` sets the
groups: "per_limb" is one limb a group over one special prime; an integer
dnum is ⌈L/dnum⌉ contiguous limbs a group over as many special primes.

Everything is drawn on the device from one `torch.Generator`, in a few large
calls.  Decryption reads a ciphertext's slots back with `Tables.inv`.  CKKS
and BGV take the small integer that its first two limbs determine (Garner),
and count the other limbs that disagree with it: a sound ciphertext decrypts
to one small integer in every limb.  A BFV ciphertext decrypts to Δ·m + e,
Δ = ⌊Q/t⌋, as wide as Q: it is rounded to m exactly, by the CRT over every
limb in Python integers (`bfv_round`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .ntt import Tables, prime_chain, special_primes


SCHEMES = ("bfv", "bgv", "ckks")


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
    """The deployment's primes: ciphertext primes, special primes, t (BGV
    and BFV), and the keyswitch's digit groups."""
    n: int
    ct: tuple
    special: tuple
    t: Optional[int]
    tables: Tables                  # ciphertext primes, then special primes
    t_tables: Optional[Tables]      # the plaintext prime t (BGV and BFV)
    dnum: Optional[int]             # digit groups; None: per-limb digits
    scheme: str                     # "ckks", "bgv" or "bfv"

    @classmethod
    def make(cls, deployment: dict, device) -> "Basis":
        """From a configuration's `deployment` group."""
        n, levels, kind = deployment["n"], deployment["levels"], deployment["scheme"]
        d = dnum(deployment)
        if kind not in SCHEMES:
            raise ValueError(f"unknown scheme {kind!r}; known: {', '.join(SCHEMES)}")
        if kind == "ckks":
            bits = [deployment["q0_bits"]] + [deployment["scale_bits"]] * levels
        else:
            bits = [deployment["q_bits"]] * (levels + 1)
        ct = prime_chain(n, bits)
        t = None
        taken = list(ct)
        if kind != "ckks":
            t = prime_chain(n, [deployment["t_bits"]])[0]
            taken.append(t)
        count = 1 if d is None else -(-len(ct) // d)
        sp = special_primes(n, deployment["special_prime_bits"], count, taken)
        return cls(n=n, ct=tuple(ct), special=tuple(sp), t=t,
                   tables=Tables.make(n, ct + sp, device),
                   t_tables=Tables.make(n, [t], device) if t else None, dnum=d,
                   scheme=kind)

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
        self.nf = basis.t if basis.scheme == "bgv" else 1     # noise factor: t in BGV
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
        (c0, c1) = (b·u + F(f·e0 + m), a·u + F(f·e1)), each (B, level+1, n)."""
        tab = self.basis.level_tables(level)
        B, n, dev = m.shape[0], self.basis.n, m.device
        u = tab.fwd(residues(ternary(self.gen, (B, n), dev), tab))
        e0 = residues(self.nf * gaussian(self.gen, (B, n), dev, self.sigma), tab)
        e1 = residues(self.nf * gaussian(self.gen, (B, n), dev, self.sigma), tab)
        k = level + 1
        c0 = (tab.mont(self.pk_b[:k], u) + tab.fwd((e0 + m) % tab.q)) % tab.q
        c1 = (tab.mont(self.pk_a[:k], u) + tab.fwd(e1)) % tab.q
        return c0, c1

    def _phase(self, c0: torch.Tensor, c1: torch.Tensor) -> tuple:
        """(x = c0 + c1·s in coefficients (..., level+1, n), the level's tables)."""
        tab = self.basis.level_tables(c0.shape[-2] - 1)
        k = c0.shape[-2]
        return tab.inv((c0 + tab.mont(c1, self.s_slots[:k])) % tab.q), tab

    def decrypt(self, c0: torch.Tensor, c1: torch.Tensor):
        """(the small integer each coefficient decrypts to (..., n), the number
        of (limb, coefficient) residues beyond the first two that disagree
        with it)."""
        return small_value(*self._phase(c0, c1))

    def decrypt_bfv(self, c0: torch.Tensor, c1: torch.Tensor):
        """BFV: (m (n,) in [0, t), noise_bits) of one ciphertext (level+1, n);
        see `bfv_round`."""
        res, tab = self._phase(c0, c1)
        return bfv_round(res, tab.primes, self.basis.t)


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


def crt(res: torch.Tensor, primes) -> np.ndarray:
    """Residues (k, n) -> the integers x in [0, Q) (n,), Q the primes'
    product, as Python integers in an object array: exact at any width."""
    Q = math.prod(primes)
    x = np.zeros(res.shape[-1], dtype=object)
    for r, q in zip(res.cpu().numpy(), primes):
        x += r.astype(object) * (Q // q * pow(Q // q, -1, q))   # 1 mod q, 0 mod the rest
    return x % Q


def bfv_round(res: torch.Tensor, primes, t: int) -> tuple:
    """BFV's decryption of x = [c0 + c1·s]_Q from its residues (k, n):
    (m = ⌊t·x/Q⌉ mod t (n,) in [0, t), noise_bits = log2(max|e| + 1) of the
    invariant noise e = [x − Δ·m]_Q, centred, Δ = ⌊Q/t⌋).  m is exact while
    |e| < Δ/2 − t (t·x = Q·m − (Q mod t)·m + t·e): noise_bits has to stay
    under log2(Δ/2)."""
    Q = math.prod(primes)
    x = crt(res, primes)
    m = (2 * t * x + Q) // (2 * Q) % t
    e = (x - Q // t * m) % Q
    worst = max(min(v, Q - v) for v in e)
    return torch.as_tensor(m.astype(np.int64), device=res.device), math.log2(worst + 1)


# -- BFV: the message as Δ·m ----------------------------------------------------

def bfv_message(m: torch.Tensor, basis: Basis, level: int) -> torch.Tensor:
    """Coefficients mod t (..., n) in [0, t) -> the residues (..., level+1, n)
    of Δ·m, Δ = ⌊Q_level/t⌋, as `Keys.encrypt` takes its message."""
    tab = basis.level_tables(level)
    delta = math.prod(tab.primes) // basis.t
    d = torch.tensor([delta % q for q in tab.primes], device=m.device)[:, None]
    return m.unsqueeze(-2) % tab.q * d % tab.q


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
