"""Golden models over Python ints (host only): the port's copy of the parts
of `rfhe_tpu/oracle` that `models/motivation.py` runs (`ntt`, `intt`, the
negacyclic transforms, `base_conv`), written as the reference writes them.
"""
from __future__ import annotations

from typing import List, Sequence

from .numth import crt_constants, mod_inv


def ntt(a: Sequence[int], omega: int, q: int) -> List[int]:
    """Iterative radix-2 Cooley-Tukey NTT, natural order in and out; `omega`
    a primitive n-th root of unity mod q."""
    n = len(a)
    assert n & (n - 1) == 0, "n must be a power of two"
    A = [x % q for x in a]
    j = 0
    for i in range(1, n):                      # bit-reverse permutation
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j ^= bit
        if i < j:
            A[i], A[j] = A[j], A[i]
    length = 2
    while length <= n:
        wlen = pow(omega, n // length, q)
        half = length // 2
        for start in range(0, n, length):
            w = 1
            for j in range(start, start + half):
                u = A[j]
                v = (A[j + half] * w) % q
                A[j] = (u + v) % q
                A[j + half] = (u - v) % q
                w = (w * wlen) % q
        length <<= 1
    return A


def intt(A: Sequence[int], omega: int, q: int) -> List[int]:
    """Inverse of `ntt` (same omega), the 1/n scaling included."""
    n_inv = mod_inv(len(A), q)
    return [(x * n_inv) % q for x in ntt(A, mod_inv(omega, q), q)]


def negacyclic_ntt(a: Sequence[int], psi: int, q: int) -> List[int]:
    """ψ^i premultiply, then the cyclic NTT with ψ²."""
    return ntt([(a[i] * pow(psi, i, q)) % q for i in range(len(a))], (psi * psi) % q, q)


def negacyclic_intt(A: Sequence[int], psi: int, q: int) -> List[int]:
    inv = intt(A, (psi * psi) % q, q)
    psi_inv = mod_inv(psi, q)
    return [(inv[i] * pow(psi_inv, i, q)) % q for i in range(len(A))]


def base_conv(residues: Sequence[Sequence[int]], moduli_in: Sequence[int],
              moduli_out: Sequence[int], reduce_out: bool = True) -> List[List[int]]:
    """RNS base conversion, the reference's unreduced CRT interpolation:
    y[i][k] = Σ_j r_j[i]·((P/p_j)·((P/p_j)⁻¹ mod p_j) mod q_k), reduced mod
    q_k unless reduce_out is False.  residues[j][i] is element i mod p_j."""
    _, hat_p, inv_hat_p = crt_constants(moduli_in)
    W = [[(hat_p[j] * inv_hat_p[j]) % qk for qk in moduli_out] for j in range(len(moduli_in))]
    out: List[List[int]] = []
    for i in range(len(residues[0])):
        row = []
        for k, qk in enumerate(moduli_out):
            tot = sum(int(residues[j][i]) * W[j][k] for j in range(len(moduli_in)))
            row.append(tot % qk if reduce_out else tot)
        out.append(row)
    return out
