"""Fold checksums: x mod (2^w - 1) and the alternating fold x mod (2^s + 1),
of 32-bit words and of 64-bit values given as (hi, lo) word pairs.

Counterpart of `rfhe_tpu/protect/fold.py`, with the same signatures: every
word is an int64 tensor holding a value below 2^32.  The reference sums the
w-bit chunks of a value on uint32 lanes with running reductions, which ends
in the canonical residue of the value (its running sum stays at most 2^w
before the last fold, and the alternating sum stays in [0, 2^s + 1)); int64
holds the residue of each word exactly, so each fold here is that residue,
taken with `%`.  Widths 2 <= w <= 24.
"""
from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF


def mul32_parts(a: torch.Tensor, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit product of two words below 2^32 as its (hi, lo) words
    (`rfhe_tpu.ops.u32.mul32_parts`).  a·b may pass 2^63, so b is split into
    16-bit halves: a·b = a·b_lo + (a·b_hi)·2^16, each part below 2^48."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    low = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (low >> 32), low & M32


def _mod64(hi: torch.Tensor, lo: torch.Tensor, M: int) -> torch.Tensor:
    """(hi·2^32 + lo) mod M for M < 2^25: every partial product < 2^50."""
    return ((hi % M) * ((1 << 32) % M) + lo % M) % M


def fold_u64(hi: torch.Tensor, lo: torch.Tensor, w: int) -> torch.Tensor:
    """(hi·2^32 + lo) mod (2^w - 1), 2 <= w <= 24."""
    assert 2 <= w <= 24
    return _mod64(hi, lo, (1 << w) - 1)


def fold_u32(x: torch.Tensor, w: int) -> torch.Tensor:
    """x mod (2^w - 1) for a word x."""
    assert 2 <= w <= 24
    return x % ((1 << w) - 1)


def fold_2s1_u64(hi: torch.Tensor, lo: torch.Tensor, s: int) -> torch.Tensor:
    """(hi·2^32 + lo) mod (2^s + 1)."""
    assert 2 <= s <= 24
    return _mod64(hi, lo, (1 << s) + 1)


def fold_2s1_u32(x: torch.Tensor, s: int) -> torch.Tensor:
    """x mod (2^s + 1) for a word x."""
    assert 2 <= s <= 24
    return x % ((1 << s) + 1)
