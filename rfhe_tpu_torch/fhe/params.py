"""Scheme parameter sets: copy of `rfhe_tpu/fhe/params.py`
(`make_prime_chain`, `CkksParams`, `BfvParams`, `BgvParams`), so the chains
and plaintext moduli are the same primes in the same order."""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..numth import find_ntt_primes


def make_prime_chain(n: int, bit_sizes: Sequence[int]) -> List[int]:
    """Distinct NTT primes (q ≡ 1 mod 2n) of the requested bit sizes, largest
    first within each size (`rfhe_tpu.fhe.params.make_prime_chain`)."""
    need = Counter(bit_sizes)
    pool = {bits: find_ntt_primes(n, bits, count) for bits, count in need.items()}
    used = {bits: 0 for bits in need}
    out = []
    for bits in bit_sizes:
        out.append(pool[bits][used[bits]])
        used[bits] += 1
    if len(set(out)) != len(out):
        raise ValueError("duplicate primes in chain")
    return out


@dataclass(frozen=True)
class CkksParams:
    """`rfhe_tpu.fhe.params.CkksParams`: moduli q_0..q_L, scale, noise σ and
    the number of primes one rescale drops (2 for a composite scale)."""

    n: int
    moduli: Tuple[int, ...]
    scale: float
    sigma: float = 3.2
    alpha: int = 1

    @classmethod
    def make(cls, n: int = 4096, levels: int = 3,
             q0_bits: Optional[int] = None,
             scale_bits: int = 28) -> "CkksParams":
        """scale_bits <= 30: one prime per level; above 30, a composite scale
        of two primes per level and a 31+30-bit base pair (the reference's
        rule, including its 30-bit default base at n >= 65536)."""
        if q0_bits is None:
            q0_bits = 30 if n >= 65536 else 31
        if scale_bits <= 30:
            bits = [q0_bits] + [scale_bits] * levels
            alpha = 1
        else:
            hb = scale_bits // 2
            lb = scale_bits - hb
            if max(hb, lb) > 30:
                raise ValueError("composite scale supports up to 60 bits")
            bits = [q0_bits, 30] + [hb, lb] * levels
            alpha = 2
        return cls(n=n, moduli=tuple(make_prime_chain(n, bits)),
                   scale=float(2 ** scale_bits), alpha=alpha)

    @property
    def L(self) -> int:
        return len(self.moduli)


@dataclass(frozen=True)
class _IntegerParams:
    """Chain of levels+1 primes of q_bits and a plaintext prime t ≡ 1 (mod
    2n) of t_bits, for batching (`rfhe_tpu.fhe.params.BgvParams/BfvParams`)."""

    n: int
    moduli: Tuple[int, ...]
    t: int
    sigma: float = 3.2

    @classmethod
    def make(cls, n: int = 4096, levels: int = 2, q_bits: int = 30, t_bits: int = 16):
        moduli = make_prime_chain(n, [q_bits] * (levels + 1))
        t = find_ntt_primes(n, t_bits, 1)[0]
        return cls(n=n, moduli=tuple(moduli), t=t)

    @property
    def L(self) -> int:
        return len(self.moduli)


class BgvParams(_IntegerParams):
    """BGV: the message rides the low bits, noise is a multiple of t."""


class BfvParams(_IntegerParams):
    """BFV (scale-invariant): the message rides the high bits as Δ·m,
    Δ = ⌊Q/t⌋."""
