"""Exact modular matrix products: (a @ b) mod q.

Counterpart of `rfhe_tpu/ops/matmul_mod.py`, whose matmuls run on the MXU as
int8 (or float32) digit products recombined with Montgomery weights.  That
recombination ends in the canonical residue of the product of the words as
the digits read them, (trunc(a) @ trunc(b)) mod q with trunc the low
digit_bits·n_digits bits of a word; every word the reference hands it is
below that width, canonical or not.  This module gives the same residue.

cuBLAS has no int64 matmul, so the product is split into float64 matmuls
that are exact: each word is first reduced mod q (< 2^31), then split into
16-bit halves, a = a1·2^16 + a0 with a1 < 2^15.  A half-product matmul sums
k terms below 2^32, exact in float64 (53 bits) for k < 2^21, on the CPU and
on the card's FP64 units alike; the four half-products are recombined in
int64 with one `%` each.  The reference computes this product with XLA dots
outside any Pallas kernel; a library matmul is its counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

MAX_K = (1 << 21) - 1     # k terms below 2^32 stay exact in float64
DIGIT_BITS = 7            # the reference's int8 path


@dataclass(frozen=True)
class DigitPlan:
    """Prime q and the word width the reference's digits read: its int8 path
    splits a word into 7-bit digits, ceil(bits(q) / 7) of them, and drops the
    bits above (`rfhe_tpu.ops.matmul_mod.DigitPlan`)."""

    q: int

    @property
    def word_mask(self) -> int:
        """The bits of a word the reference's digits read."""
        n_digits = -(-self.q.bit_length() // DIGIT_BITS)
        return (1 << min(32, DIGIT_BITS * n_digits)) - 1


def _halves(x: torch.Tensor, plan: DigitPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    x = (x & plan.word_mask) % plan.q
    return (x >> 16).double(), (x & 0xFFFF).double()


def matmul_mod(a: torch.Tensor, b: torch.Tensor, plan: DigitPlan) -> torch.Tensor:
    """(a @ b) mod q for int64 words below 2^32, a (..., m, k), b (..., k, n);
    leading dims broadcast as in torch.matmul.  Canonical residues."""
    if a.shape[-1] > MAX_K:
        raise ValueError(f"contraction of {a.shape[-1]} terms exceeds float64's exact range")
    q = plan.q
    a1, a0 = _halves(a, plan)
    b1, b0 = _halves(b, plan)
    hh = torch.matmul(a1, b1).long() % q
    mid = (torch.matmul(a1, b0).long() + torch.matmul(a0, b1).long()) % q
    ll = torch.matmul(a0, b0).long()
    return (hh * ((1 << 32) % q) + (mid << 16) + ll) % q


def matvec_mod(mat: torch.Tensor, vec: torch.Tensor, plan: DigitPlan) -> torch.Tensor:
    """(mat @ vec) mod q for vec (..., k)."""
    return matmul_mod(mat, vec[..., None], plan)[..., 0]
