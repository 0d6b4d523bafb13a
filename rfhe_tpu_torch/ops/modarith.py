"""Modular arithmetic on int64 residue tensors.

Counterpart of `rfhe_tpu/ops/u32.py`.  The TPU has no 64-bit integer ALU, so
the reference emulates 32x32->64 products in uint32 half-words; here residues
are int64 and q < 2^31, so a product of two residues (< 2^62) is exact and
most ops are one or two native tensor ops.  Every function but
`barrett_word` returns canonical residues in [0, q), and each agrees bit for
bit with its u32.py namesake on the inputs that namesake accepts
(tests/test_torch_modarith.py, tests/test_torch_protect.py).

`q` (and the other per-modulus constants) may be Python ints or int64
tensors that broadcast against the data, e.g. shape (L, 1) for (L, n) data.
"""
from __future__ import annotations

import torch

from ..protect.fold import mul32_parts

M32 = 0xFFFFFFFF


def add_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """(a + b) mod q for a, b in [0, q)."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """(a - b) mod q for a, b in [0, q)."""
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a: torch.Tensor, q) -> torch.Tensor:
    """(-a) mod q for a in [0, q)."""
    return torch.where(a == 0, a, q - a)


def mont_mul(a: torch.Tensor, b: torch.Tensor, q, rinv) -> torch.Tensor:
    """Montgomery product a·b·R^{-1} mod q, R = 2^32, for a < 2^32 and
    b < q.  The reference (`u32.mont_mul`) takes -q^{-1} mod R and runs REDC
    in half-words; here a·b < 2^63 is exact, so the same value is
    (a·b mod q)·(R^{-1} mod q) mod q, with `rinv` = R^{-1} mod q.  Off
    that domain (b ≥ q) the reference's REDC word wraps and is not this one;
    `protect.checks.mont_mul_checked` emulates REDC for such words
    (tests/test_torch_protect.py pins both)."""
    return (a * b) % q * rinv % q


def mul_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """a·b mod q in the normal domain (`u32.mul_mod`), for a, b < q."""
    return (a * b) % q


def mul_mod_shoup(x: torch.Tensor, w, w_shoup, q) -> torch.Tensor:
    """x·w mod q with Shoup's w' = floor(w·2^32/q) (`u32.mul_mod_shoup`),
    for x < 2^31 and w < q: x·w' < 2^63 and x·w − ⌊x·w'/2^32⌋·q lies in
    [0, 2q), so one conditional subtract finishes it."""
    hi = (x * w_shoup) >> 32
    r = x * w - hi * q
    return torch.where(r >= q, r - q, r)


def reduce_mod(v: torch.Tensor, q) -> torch.Tensor:
    """v mod q for a residue v of another prime: the reference's
    `barrett_reduce64(zeros, v, q, mu, k)`."""
    return v % q


def barrett_word(x: torch.Tensor, q: int, mu: int, k: int) -> torch.Tensor:
    """The word the reference's Barrett reduction (`u32.barrett_reduce64`,
    mu = ⌊2^2k/q⌋, k = bitlen(q) < 32) returns for a value 0 <= x < 2^62
    held whole: s = ⌊x·mu/2^2k⌋ mod 2^32 (its 32-bit quotient word),
    c = x − s·q, two conditional subtracts, the low word.  For x < q² that
    is x mod q; above it the quotient is underestimated and the word is
    congruent to x but not reduced, as the reference's is (BGV's t-mode lift
    takes x = c·q_src⁻¹ up to 2^31·t).  x·mu may pass 2^63, so the quotient
    is formed from x = x1·2^k + x0: ⌊x·mu/2^2k⌋ = ⌊(x1·mu + ⌊x0·mu/2^k⌋)/2^k⌋,
    every term below 2^63."""
    assert k < 32 and mu < (1 << (k + 1))
    s = (((x >> k) * mu + (((x & ((1 << k) - 1)) * mu) >> k)) >> k) & M32
    c = x - s * q
    for _ in range(2):
        c = torch.where(c >= q, c - q, c)
    return c & M32


def mulhi32(a: torch.Tensor, b) -> torch.Tensor:
    """The high word of the 64-bit product of two words below 2^32
    (`u32.mulhi32`); a·b may pass 2^63, so it is formed by `mul32_parts`."""
    return mul32_parts(a, b)[0]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per word, for int64 words below 2^32 (`u32.popcount32`'s SWAR
    steps; torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def mod_u64(hi: torch.Tensor, lo: torch.Tensor, m: int) -> torch.Tensor:
    """(hi·2^32 + lo) mod m for any m < 2^31, prime or not (the injectors'
    m = 2^W - 1): the low word of the reference's `inject._mod_u64`, whose
    33 shift-subtract steps end in this residue for (hi:lo) < m·2^33, as
    every caller's value is (the product of two words below 2^24).  Here
    the residue is formed directly, (hi mod m)·(2^32 mod m) + lo below 2^63."""
    return ((hi % m) * ((1 << 32) % m) + lo) % m
