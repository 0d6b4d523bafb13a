"""Modular sums and the arithmetic of one prime, on int64 residue tensors.

Counterpart of `rfhe_tpu/ops/modring.py`.  The reference assembles an exact
sum from two uint32 reductions over the 16-bit planes of its words and folds
it mod q; here a sum of up to 2^31 words below 2^32 is exact in int64, so
`sum_mod` is one `sum` and one `%`, exact for any words below 2^32, canonical
or not (a fault campaign's flipped words reach these sums).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..numth import mod_inv
from .modarith import add_mod, mont_mul, mul_mod, neg_mod, sub_mod


def sum_mod(x: torch.Tensor, q, axis: int = -1) -> torch.Tensor:
    """Σ x mod q along `axis`, for words below 2^32.  `q` is an int or an
    int64 tensor that broadcasts against the result.  An axis of length 1
    gives its element as it is, unreduced, as the reference's does."""
    x = x.movedim(axis, -1)
    if x.shape[-1] == 1:
        return x[..., 0]
    return x.sum(dim=-1) % q


@dataclass(frozen=True)
class ModArith:
    """One prime q < 2^31 and its Montgomery constant R^-1 mod q (R = 2^32)
    (`rfhe_tpu.ops.modring.ModArith`, whose constants are -q^-1 mod R and R^2)."""

    q: int
    rinv: int

    @classmethod
    def make(cls, q: int) -> "ModArith":
        return cls(q=q, rinv=mod_inv((1 << 32) % q, q))

    def add(self, a, b):
        return add_mod(a, b, self.q)

    def sub(self, a, b):
        return sub_mod(a, b, self.q)

    def neg(self, a):
        return neg_mod(a, self.q)

    def mul(self, a, b):
        return mul_mod(a, b, self.q)

    def mont_mul(self, a, b):
        return mont_mul(a, b, self.q, self.rinv)

    def sum(self, x, axis: int = -1):
        return sum_mod(x, self.q, axis=axis)

    def dot(self, a, b, axis: int = -1):
        """<a, b> mod q along `axis`."""
        return self.sum(self.mul(a, b), axis=axis)
