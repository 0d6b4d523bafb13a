"""Host-side number theory (exact Python integers).

Copy of the parts of `rfhe_tpu/numth.py` the port needs (primes, roots of
unity, Shoup, Montgomery and CRT constants), so the port loads nothing of the
JAX package.  tests/test_torch_ntt.py and tests/test_torch_four_step.py hold
the two copies equal on the chains and primes in use.
"""
from __future__ import annotations

import math
import random
from functools import lru_cache
from typing import List, Sequence, Tuple

_MR_BASES_32 = (2, 7, 61)
_MR_BASES_64 = (2, 325, 9375, 28178, 450775, 9780504, 1795265022)
_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64 (`rfhe_tpu.numth.is_prime`)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    bases = _MR_BASES_32 if n < (1 << 32) else _MR_BASES_64
    for a in bases:
        if a % n == 0:
            continue
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def next_prime_ge(n: int) -> int:
    """The least prime >= n (`rfhe_tpu.numth.next_prime_ge`)."""
    if n <= 2:
        return 2
    if n % 2 == 0:
        n += 1
    while not is_prime(n):
        n += 2
    return n


def find_prime_with_bitlen(bitlen: int, rng: random.Random) -> int:
    """A random prime of exact bit length, drawn from `rng` as
    `rfhe_tpu.numth.find_prime_with_bitlen` draws it."""
    if bitlen < 2:
        raise ValueError("bitlen must be >= 2")
    while True:
        n = (1 << (bitlen - 1)) | rng.getrandbits(bitlen - 1) | 1
        if is_prime(n):
            return n


def generate_crt_primes(limbs: int, bitwidth: int, rng: random.Random) -> List[int]:
    """Distinct random primes of exact bit width (`rfhe_tpu.numth.generate_crt_primes`)."""
    primes: List[int] = []
    while len(primes) < limbs:
        p = next_prime_ge(rng.getrandbits(bitwidth) | (1 << (bitwidth - 1)) | 1)
        if p.bit_length() == bitwidth and p not in primes:
            primes.append(p)
    return primes


def find_ntt_primes(n: int, bit_width: int, count: int = 1,
                    negacyclic: bool = True) -> List[int]:
    """Largest `count` primes q < 2^bit_width with q ≡ 1 (mod 2n), or
    (mod n) for a cyclic transform (`rfhe_tpu.numth.find_ntt_primes`)."""
    step = 2 * n if negacyclic else n
    start = (((1 << bit_width) - 1) // step) * step + 1
    out: List[int] = []
    q = start
    while q > (1 << (bit_width - 1)) and len(out) < count:
        if is_prime(q):
            out.append(q)
        q -= step
    if len(out) < count:
        raise ValueError(f"not enough NTT primes: n={n} bits={bit_width} need={count}")
    return out


def find_ntt_prime(n: int, bit_width: int, negacyclic: bool = True) -> int:
    return find_ntt_primes(n, bit_width, 1, negacyclic)[0]


def _factorize(n: int) -> List[int]:
    """Unique prime factors by trial division (`rfhe_tpu.numth._factorize`)."""
    fs = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.add(d)
            n //= d
        d += 1 if d == 2 else 2
        if d > 10_000_000 and n > 1:
            if is_prime(n):
                fs.add(n)
                n = 1
            break
    if n > 1:
        fs.add(n)
    return sorted(fs)


@lru_cache(maxsize=None)
def primitive_root(q: int) -> int:
    """Smallest generator of (Z/qZ)* (`rfhe_tpu.numth.primitive_root`)."""
    factors = _factorize(q - 1)
    for g in range(2, 1000):
        if all(pow(g, (q - 1) // f, q) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root found for {q}")


def root_of_unity(order: int, q: int) -> int:
    """Primitive `order`-th root of unity mod q (`rfhe_tpu.numth.root_of_unity`)."""
    if (q - 1) % order != 0:
        raise ValueError(f"order {order} does not divide q-1 for q={q}")
    w = pow(primitive_root(q), (q - 1) // order, q)
    if pow(w, order, q) != 1 or any(pow(w, order // f, q) == 1 for f in _factorize(order)):
        raise ArithmeticError(f"{w} is not a primitive {order}-th root mod {q}")
    return w


def psi_negacyclic(n: int, q: int) -> int:
    """Primitive 2n-th root ψ with ψ^n ≡ -1 (mod q): the same ψ as
    `rfhe_tpu.numth.PrimeCtx.make(q, n).psi`."""
    if (q - 1) % (2 * n) != 0:
        raise ValueError(f"2n={2 * n} does not divide q-1 for q={q}")
    psi = pow(primitive_root(q), (q - 1) // (2 * n), q)
    if pow(psi, n, q) != q - 1:
        raise ValueError(f"no negacyclic root for n={n}, q={q}")
    return psi


def barrett_constants(q: int) -> Tuple[int, int]:
    """(mu, k): k = bitlen(q), mu = ⌊2^2k / q⌋ (`rfhe_tpu.numth.barrett_constants`)."""
    k = q.bit_length()
    return (1 << (2 * k)) // q, k


def mod_inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def montgomery_constants(q: int, word_bits: int = 32) -> Tuple[int, int, int]:
    """(R, -q^-1 mod R, R^2 mod q) for R = 2^word_bits
    (`rfhe_tpu.numth.montgomery_constants`); odd q < R."""
    if q % 2 == 0 or q >= (1 << word_bits):
        raise ValueError("Montgomery requires odd q < R")
    R = 1 << word_bits
    return R, (-pow(q, -1, R)) % R, (R * R) % q


def shoup_precompute(w: int, q: int) -> int:
    """Shoup constant w' = floor(w·2^32 / q) (`rfhe_tpu.numth.shoup_precompute`)."""
    return (w << 32) // q


def crt_constants(moduli: Sequence[int]) -> Tuple[int, List[int], List[int]]:
    """(P, hat_p, inv_hat_p) (`rfhe_tpu.numth.crt_constants`)."""
    P = math.prod(moduli)
    hat_p = [P // p for p in moduli]
    inv_hat_p = [pow(hat_p[j], -1, moduli[j]) for j in range(len(moduli))]
    return P, hat_p, inv_hat_p
