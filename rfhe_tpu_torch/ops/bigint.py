"""Fixed-width multi-limb integers in 32-bit words (little-endian limbs).

Counterpart of `rfhe_tpu/ops/bigint.py`: a value is an int64 tensor of shape
(..., L) whose last axis holds its 32-bit words, least significant first.
The reduction campaigns (`faults/reduction_campaigns.py`) work with 37-bit
primes and intermediates up to about 112 bits in these words, batched over
trials and the working vector.

Every function returns the words the reference's uint32 version returns,
truncations included: `add`, `sub` and a `mul` with fewer output limbs than
La + Lb wrap modulo 2^(32·limbs) as its column-carry chains do (an int64
column sum holds a whole column, so its carry is the column's high bits);
`_fit` truncates; `barrett_reduce_big` does exactly two conditional
subtracts, so above x < q² its word is not reduced, as the reference's is
not.  The folds return the canonical residue of the value, which is what the
reference's chunked running sums end in (tests/test_torch_bigint.py holds
each function against rfhe_tpu on random words).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..numth import barrett_constants
from ..protect.fold import mul32_parts
from .modarith import M32, barrett_word


def from_int(x: int, limbs: int, device="cpu") -> torch.Tensor:
    """The (limbs,) words of a Python int, as an int64 tensor on `device`."""
    if x < 0 or x >> (32 * limbs):
        raise ValueError(f"{x} does not fit {limbs} limbs")
    words = [(x >> (32 * i)) & M32 for i in range(limbs)]
    return torch.tensor(words, dtype=torch.int64, device=device)


def to_int(x) -> int:
    """The Python int of one (L,) word vector (a tensor or an array)."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return sum(int(v) << (32 * i) for i, v in enumerate(x))


def to_ints(x) -> list:
    """(..., L) -> the Python ints over the flattened leading axes."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return [to_int(row) for row in x.reshape(-1, x.shape[-1])]


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., L) + (..., L) mod 2^(32L), the carries chained limb by limb."""
    out, carry = [], 0
    for i in range(a.shape[-1]):
        s = a[..., i] + b[..., i] + carry
        out.append(s & M32)
        carry = s >> 32
    return torch.stack(out, dim=-1)


def sub(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a − b mod 2^(32L) and the borrow out (1 where a < b)."""
    out, borrow = [], torch.zeros((), dtype=torch.int64, device=a.device)
    for i in range(a.shape[-1]):
        d = a[..., i] - b[..., i] - borrow
        out.append(d & M32)
        borrow = (d < 0).long()
    return torch.stack(out, dim=-1), borrow


def cmp_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b, both (..., L)."""
    return sub(a, b)[1] == 0


def mul(a: torch.Tensor, b: torch.Tensor, out_limbs: int | None = None) -> torch.Tensor:
    """Schoolbook product (..., La) × (..., Lb) -> (..., out_limbs), exact for
    out_limbs >= La + Lb (the default) and modulo 2^(32·out_limbs) below it.
    Column k sums the low words of the products with i + j = k, the high
    words of those with i + j = k − 1 and the carry of column k − 1; the
    32×32 products come from `mul32_parts`, as a·b may pass 2^63."""
    La, Lb = a.shape[-1], b.shape[-1]
    Lo = La + Lb if out_limbs is None else out_limbs
    parts = {(i, j): mul32_parts(a[..., i], b[..., j])
             for i in range(La) for j in range(Lb) if i + j < Lo}
    out, carry = [], 0
    for k in range(Lo):
        s = carry
        for i in range(max(0, k - Lb + 1), min(La, k + 1)):
            s = s + parts[(i, k - i)][1]
        for i in range(max(0, k - Lb), min(La, k)):
            s = s + parts[(i, k - 1 - i)][0]
        out.append(s & M32)
        carry = s >> 32
    return torch.stack(out, dim=-1)


def shift_right(x: torch.Tensor, bits: int, out_limbs: int | None = None) -> torch.Tensor:
    """x >> bits (a static shift), keeping out_limbs limbs."""
    L = x.shape[-1]
    Lo = L if out_limbs is None else out_limbs
    word, rem = divmod(bits, 32)
    zero = torch.zeros_like(x[..., 0])
    limb = lambda j: x[..., j] if j < L else zero
    out = []
    for i in range(Lo):
        lo = limb(i + word)
        out.append(lo if rem == 0 else (lo >> rem) | ((limb(i + word + 1) << (32 - rem)) & M32))
    return torch.stack(out, dim=-1)


def xor_bit(x: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """Flip bit `bitpos` (a tensor broadcast over the leading axes) of each
    (..., L) value; a position beyond 32L flips nothing."""
    idx = torch.arange(x.shape[-1], device=x.device)
    word, bit = bitpos // 32, bitpos % 32
    return x ^ torch.where(idx == word[..., None], 1 << bit[..., None], 0)


def _bit_length32(w: torch.Tensor) -> torch.Tensor:
    r = torch.zeros_like(w)
    for shift in (16, 8, 4, 2, 1):
        big = w >= (1 << shift)
        r = torch.where(big, r + shift, r)
        w = torch.where(big, w >> shift, w)
    return r + (w > 0).long()


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of each (..., L) value (0 for 0)."""
    res = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for i in range(x.shape[-1]):
        w = x[..., i]
        res = torch.where(w != 0, _bit_length32(w) + 32 * i, res)
    return res


def _residue(x: torch.Tensor, M: int) -> torch.Tensor:
    """The value of (..., L) words mod M < 2^31: Σ (w_i mod M)·(2^32i mod M)."""
    acc = 0
    for i in range(x.shape[-1]):
        acc = acc + (x[..., i] % M) * pow(2, 32 * i, M) % M
    return acc % M


def fold_mod(x: torch.Tensor, w: int) -> torch.Tensor:
    """Value mod 2^w − 1 (2 <= w <= 32): the canonical residue the
    reference's w-bit chunk sum ends in."""
    if not 2 <= w <= 32:
        raise ValueError(f"fold width {w} out of supported range [2, 32]")
    if w == 32:                           # 2^32 ≡ 1: the words' sum
        return x.sum(dim=-1) % M32
    return _residue(x, (1 << w) - 1)


def fold_2s1(x: torch.Tensor, s: int) -> torch.Tensor:
    """Value mod 2^s + 1 (2 <= s <= 30): the canonical residue of the
    reference's alternating s-bit chunk sum."""
    if not 2 <= s <= 30:
        raise ValueError(f"fold width {s} out of supported range [2, 30]")
    return _residue(x, (1 << s) + 1)


def mod_small(x: torch.Tensor, m: int) -> torch.Tensor:
    """Value mod m < 2^31 by Horner over the limbs with the reference's
    Barrett word (`modarith.barrett_word`) and its uint32 add: a limb above
    m² (m < 2^16) leaves its word unreduced, as in the reference."""
    mu, k = barrett_constants(m)
    w32 = (1 << 32) % m
    r = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for i in range(x.shape[-1] - 1, -1, -1):
        r = barrett_word(r * w32, m, mu, k)
        s = (r + barrett_word(x[..., i], m, mu, k)) & M32
        r = torch.where(s >= m, s - m, s)
    return r


def cond_sub_big(c: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """One conditional subtract: c − m where c >= m."""
    d, borrow = sub(c, m.expand(c.shape))
    return torch.where((borrow == 0)[..., None], d, c)


def _fit(x: torch.Tensor, limbs: int) -> torch.Tensor:
    L = x.shape[-1]
    if L >= limbs:
        return x[..., :limbs]
    pad = torch.zeros(x.shape[:-1] + (limbs - L,), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=-1)


def barrett_reduce_big(x: torch.Tensor, q: int, mu: int, k: int, out_limbs: int) -> torch.Tensor:
    """x mod q by Barrett (mu = ⌊2^2k/q⌋, k = bitlen q), exact for x < q²;
    above it, the reference's word (two conditional subtracts after
    truncated products)."""
    Lq = -(-(k + 1) // 32)
    Lmu = -(-mu.bit_length() // 32)
    mu_l = from_int(mu, Lmu, x.device)
    q_l = from_int(q, max(Lq, out_limbs), x.device)
    s = shift_right(mul(x, mu_l), 2 * k, Lq + 1)
    sn = mul(s, q_l[:Lq], out_limbs + 1)
    c, _ = sub(_fit(x, out_limbs + 1), sn)
    qv = _fit(q_l, out_limbs + 1)
    return cond_sub_big(cond_sub_big(c, qv), qv)[..., :out_limbs]


def sum_mod_big(x: torch.Tensor, q: int, axis: int = -2) -> torch.Tensor:
    """Modular sum of (..., n, L) values (each < q) along `axis`: the exact
    sum modulo 2^(32(L+1)) (the reference's tree of full adds one limb
    wider), then one Barrett reduction."""
    x = x.movedim(axis, -2)
    sums = x.sum(dim=-2)                  # each limb's column sum < n·2^32
    out, carry = [], 0
    for i in range(x.shape[-1] + 1):
        v = (sums[..., i] if i < x.shape[-1] else 0) + carry
        out.append(v & M32)
        carry = v >> 32
    mu, k = barrett_constants(q)
    return barrett_reduce_big(torch.stack(out, dim=-1), q, mu, k, -(-q.bit_length() // 32))


def mask_to_bits(x: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Keep the low `nbits` (a tensor broadcast over the leading axes) of
    each (..., L) value."""
    out = []
    for i in range(x.shape[-1]):
        here = torch.clamp(nbits - 32 * i, 0, 32)
        out.append(x[..., i] & ((1 << here) - 1))
    return torch.stack(out, dim=-1)
