"""BSGS diagonal matrix-vector product under CKKS (counterpart of
`rfhe_tpu/models/bsgs.py`, on the port's `CkksContext`): the rotation-heavy
workload of the reference's profiling layer
(profile_framewk/src/matmul_ckks.cpp:18-113: pack_diagonals +
compute_matvec_bsgs with B = ⌈√d⌉ giant steps), plus a plain (non-BSGS)
variant for comparison.

y = M·x with M packed as d diagonals diag_k[i] = M[i, (i+k) mod d]:
    y = Σ_k diag_k ⊙ rot(x, k)
BSGS: k = g·B + b; pre-rotate the diagonals by −g·B so only B baby
rotations of x and G−1 giant rotations of partial sums are needed:
    y = Σ_g rot( Σ_b rot⁻ᵍᴮ(diag_{gB+b}) ⊙ rot(x, b), gB )
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..fhe.ckks import Ciphertext, CkksContext


def pack_diagonals(M: np.ndarray) -> List[np.ndarray]:
    """d×d (complex) matrix -> list of d generalized diagonals
    (matmul_ckks.cpp:18-40)."""
    d = M.shape[0]
    assert M.shape == (d, d)
    return [np.array([M[i, (i + k) % d] for i in range(d)]) for k in range(d)]


def _embed(ctx: CkksContext, vec: np.ndarray) -> np.ndarray:
    """Tile a length-d vector into the n/2 slots (d must divide n/2)."""
    slots = ctx.params.n // 2
    d = len(vec)
    assert slots % d == 0
    return np.tile(vec, slots // d)


def matvec_naive(ctx: CkksContext, M: np.ndarray, ct_x: Ciphertext
                 ) -> Ciphertext:
    """y = Σ_k diag_k ⊙ rot(x, k): d rotations (baseline for BSGS)."""
    d = M.shape[0]
    diags = pack_diagonals(M)
    acc = None
    for k in range(d):
        xr = ctx.rotate(ct_x, k) if k else ct_x
        pt, psc = ctx.encode(_embed(ctx, diags[k]), level=ct_x.level)
        term = ctx.multiply_plain(xr, pt, psc)
        acc = term if acc is None else ctx.add(acc, term)
    return ctx.rescale(acc)


def matvec_bsgs(ctx: CkksContext, M: np.ndarray, ct_x: Ciphertext
                ) -> Ciphertext:
    """Baby-step/giant-step: B=⌈√d⌉ baby rotations + G−1 giant rotations
    (matmul_ckks.cpp:45-113)."""
    d = M.shape[0]
    diags = pack_diagonals(M)
    B = math.isqrt(d)
    if B * B < d:
        B += 1
    G = -(-d // B)
    # baby rotations of x
    baby = [ct_x]
    for b in range(1, B):
        baby.append(ctx.rotate(ct_x, b))
    acc = None
    for g in range(G):
        inner = None
        for b in range(B):
            k = g * B + b
            if k >= d:
                break
            # pre-rotate diagonal by −gB (plaintext-side, free)
            diag = np.roll(diags[k], g * B)
            pt, psc = ctx.encode(_embed(ctx, diag), level=ct_x.level)
            term = ctx.multiply_plain(baby[b], pt, psc)
            inner = term if inner is None else ctx.add(inner, term)
        if g:
            inner = ctx.rotate(inner, g * B)
        acc = inner if acc is None else ctx.add(acc, inner)
    return ctx.rescale(acc)
