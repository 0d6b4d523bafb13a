"""ABFT detectors: invariants of a computation, returned as bool tensors.

Counterpart of `rfhe_tpu/protect/checks.py`, on int64 tensors holding words
below 2^32; each detector returns what the reference's returns on the same
inputs:

  matmul_check              col·row checksum of a modular matmul
  elementwise_fold_check    Σ fold(x)·fold(t) == Σ fold(y)  (mod 2^w - 1)
  stage1_projection_check / stage2_projection_check
                            random-weight projections over the four-step
                            NTT's matmul stages
  twiddle_inter_check       random-φ checksum across its twiddle stage
  twiddle_collision_model   the collision model of a fold of width w
  intra_fold_product_check  fold(a)·fold(b) == fold(a·b)  (mod 2^s + 1)
  barrett_range_protected   Barrett reduction with pre/post range windows
  mont_mul_checked          the dyadic product with the fold check and the
                            range window (the protected evaluator's multiply)
  sum_u64_exact             the exact sum of words, as a (hi, lo) pair
  baseconv_append_checksum / baseconv_ecc_check
                            the appended checksum of a base conversion

The three probe checks take a key of `prng` (the port's copy of the
reference's `jax.random` draws) and draw the same probe vector as the
reference does from the same key.  A key with leading axes (one per trial)
draws one probe per trial; the stage tensors then carry the same leading axes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import prng
from ..ops.matmul_mod import DigitPlan, matmul_mod
from ..ops.modring import ModArith, sum_mod
from .fold import M32, fold_2s1_u32, fold_2s1_u64, fold_u32, fold_u64, mul32_parts


def matmul_check(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                 arith: ModArith) -> torch.Tensor:
    """sum(C) == col_sums(A) · row_sums(B)  (mod q), batched over leading dims."""
    col = sum_mod(A, arith.q, axis=-2)
    row = sum_mod(B, arith.q, axis=-1)
    lhs = arith.dot(col, row, axis=-1)
    rhs = sum_mod(sum_mod(C, arith.q, axis=-1), arith.q, axis=-1)
    return lhs == rhs


def _rand_mod(key, shape, q: int, device) -> torch.Tensor:
    """randint(key, shape, 0, q) in uint32 (`checks._rand_mod`), as an int64
    tensor on `device`: (*key.shape[:-1], *shape)."""
    return torch.from_numpy(prng.randint(key, shape, 0, q, np.uint32).astype(np.int64)).to(device)


def elementwise_fold_check(X: torch.Tensor, T: torch.Tensor, Y: torch.Tensor,
                           w: int) -> torch.Tensor:
    """Under M = 2^w - 1: Σ fold(X_i)·fold(T_i) == Σ fold(Y_i), Y = X·T mod M."""
    M = (1 << w) - 1
    p_hi, p_lo = mul32_parts(fold_u32(X, w), fold_u32(T, w))
    s_in = sum_mod(fold_u64(p_hi, p_lo, w), M, axis=-1)
    s_out = sum_mod(fold_u32(Y, w), M, axis=-1)
    return s_in == s_out


def stage1_projection_check(A: torch.Tensor, B: torch.Tensor, W2: torch.Tensor,
                            digit: DigitPlan, arith: ModArith, key) -> torch.Tensor:
    """Stage 1 (B = W2 @ A) of the four-step NTT, a random w over rows:
    <W2·w, rowsums(A)> == <w, rowsums(B)>  (W2 symmetric)."""
    w = _rand_mod(key, (A.shape[-2],), arith.q, A.device)
    w_hat = matmul_mod(W2, w[..., None], digit)[..., 0]
    lhs = arith.dot(w_hat, sum_mod(A, arith.q, axis=-1), axis=-1)
    return lhs == arith.dot(w, sum_mod(B, arith.q, axis=-1), axis=-1)


def stage2_projection_check(B: torch.Tensor, Y: torch.Tensor, W1T: torch.Tensor,
                            digit: DigitPlan, arith: ModArith, key) -> torch.Tensor:
    """Stage 2 (Y = B @ W1ᵀ), a random w over columns:
    <W1·w, colsums(B)> == <w, colsums(Y)>."""
    w = _rand_mod(key, (B.shape[-1],), arith.q, B.device)
    w_hat = matmul_mod(W1T.T, w[..., None], digit)[..., 0]
    lhs = arith.dot(w_hat, sum_mod(B, arith.q, axis=-2), axis=-1)
    return lhs == arith.dot(w, sum_mod(Y, arith.q, axis=-2), axis=-1)


def twiddle_inter_check(B_before: torch.Tensor, B_after: torch.Tensor, T: torch.Tensor,
                        arith: ModArith, key) -> torch.Tensor:
    """The random-φ checksum across the twiddle stage:
    <φ, rowsums(B_after)> == <φ, rowsums(T ⊙ B_before)>."""
    phi = _rand_mod(key, (B_before.shape[-2],), arith.q, B_before.device)
    lhs = arith.dot(phi, sum_mod(B_after, arith.q, axis=-1), axis=-1)
    weighted = arith.mul(T, B_before)
    return lhs == arith.dot(phi, sum_mod(weighted, arith.q, axis=-1), axis=-1)


def twiddle_collision_model(B_true: torch.Tensor, B_faulty: torch.Tensor,
                            fold_width: int = 24) -> torch.Tensor:
    """A fault is caught iff the corrupted value differs from the true one
    modulo 2^fold_width + 1: the 'detected' bool per (..., rows, cols) array."""
    diff = fold_2s1_u32(B_true, fold_width) != fold_2s1_u32(B_faulty, fold_width)
    return torch.any((diff & (B_true != B_faulty)).flatten(-2), dim=-1)


def intra_fold_product_check(a: torch.Tensor, b: torch.Tensor,
                             c_unreduced_hi: torch.Tensor, c_unreduced_lo: torch.Tensor,
                             s_bits: int) -> torch.Tensor:
    """fold(a)·fold(b) == fold(a·b) over mod 2^s + 1, where (hi, lo) is the
    full 64-bit product a·b; ok per element."""
    p_hi, p_lo = mul32_parts(fold_2s1_u32(a, s_bits), fold_2s1_u32(b, s_bits))
    return fold_2s1_u64(p_hi, p_lo, s_bits) == fold_2s1_u64(c_unreduced_hi, c_unreduced_lo, s_bits)


def barrett_range_protected(x_hi: torch.Tensor, x_lo: torch.Tensor, q: int, mu: int, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Barrett reduction of the 64-bit x = (hi, lo) with mu = ⌊2^2k/q⌋ and the
    reference's range windows: the value before the subtraction must lie in
    [0, 2q), the result in [0, q).  Returns (reduced, ok).  The quotient is
    formed in the reference's 32-bit limbs with their wrap-around, so a
    corrupted x gives the reference's result too."""
    assert q < (1 << 31)
    mu_lo, mu_hi = mu & M32, (mu >> 32) & M32
    t0_hi, t0_lo = mul32_parts(x_lo, mu_lo)
    t1_hi, t1_lo = mul32_parts(x_hi, mu_lo)
    t2_hi, t2_lo = mul32_parts(x_lo, mu_hi)
    t3_hi, t3_lo = mul32_parts(x_hi, mu_hi)
    L1 = (t0_hi + t1_lo) & M32
    c1 = (L1 < t0_hi).long()
    L1b = (L1 + t2_lo) & M32
    c1 = c1 + (L1b < L1).long()
    L2 = (t1_hi + t2_hi) & M32
    c2 = (L2 < t1_hi).long()
    L2b = (L2 + t3_lo) & M32
    c2 = c2 + (L2b < L2).long()
    L2c = (L2b + c1) & M32
    c2 = c2 + (L2c < L2b).long()
    L3 = (t3_hi + c2) & M32
    word, rem = divmod(2 * k, 32)
    limbs = [t0_lo, L1b, L2c, L3, torch.zeros_like(t0_lo)]
    s = limbs[word] if rem == 0 else ((limbs[word] >> rem) | (limbs[word + 1] << (32 - rem))) & M32
    sq_hi, sq_lo = mul32_parts(s, q)
    borrow = (sq_lo > x_lo).long()
    c_lo = (x_lo - sq_lo) & M32
    c_hi = (x_hi - sq_hi - borrow) & M32
    pre_ok = (c_hi == 0) & (c_lo < 2 * q)
    c_red = torch.where(c_lo >= q, c_lo - q, c_lo)
    return c_red, pre_ok & (c_red < q)


def mont_mul_checked(a: torch.Tensor, b: torch.Tensor, q, rinv,
                     s_bits: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Montgomery product a·b·R^-1 mod q with the reference's checks:
    the 64-bit product a·b against fold(a)·fold(b) mod 2^s + 1, and the
    output against the range window [0, q).  The product is formed once, as
    a (hi, lo) word pair, and read by both the reduction and the check, so a
    fault in it corrupts the output and is caught by the folded
    re-multiplication.  Any words a, b < 2^32 give the reference's word and
    flag (`checks.py:214-219`), also off the domain b < q.  Returns (out, ok)
    per element."""
    return mont_mul_checked_product(a, b, mul32_parts(a, b), q, rinv, s_bits)


def mont_mul_checked_product(a: torch.Tensor, b: torch.Tensor, prod, q, rinv,
                             s_bits: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """`mont_mul_checked` on a given 64-bit product of a and b, which a test
    may corrupt: a (hi, lo) word pair, or one int64 tensor below 2^63.

    The reference reduces (hi, lo) in uint32 words: m = lo·q' mod 2^32 with
    q' = -q^-1 mod 2^32, t = hi + ⌊m·q/2^32⌋ + [lo ≠ 0] mod 2^32, one
    conditional subtract.  Its last two terms are c = (lo + m·q)/2^32, the
    value in [0, q] that is ≡ lo·R^-1 (mod q) and 0 only for lo = 0, so
    c = lo·rinv mod q, or q where that is 0 and lo is not; t = hi + c wraps
    as the reference's does when the product passes q·2^32.  The fold check
    compares fold(a)·fold(b) with the product's words mod 2^s + 1
    (`intra_fold_product_check`, with the folds' product formed whole)."""
    hi, lo = prod if isinstance(prod, tuple) else (prod >> 32, prod & M32)
    c = lo * rinv % q
    c = torch.where((c == 0) & (lo != 0), q, c)
    t = (hi + c) & M32
    out = torch.where(t >= q, t - q, t)
    M = (1 << s_bits) + 1
    ok = (a % M * (b % M) % M == fold_2s1_u64(hi, lo, s_bits)) & (out < q)
    return out, ok


def sum_u64_exact(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact sum along the last axis of words below 2^32 as a (hi, lo)
    word pair (exact in int64 for up to 2^31 terms)."""
    s = v.sum(dim=-1)
    return s >> 32, s & M32


def baseconv_append_checksum(residues: torch.Tensor, moduli_in) -> torch.Tensor:
    """Append Σ_i r_j[i] mod p_j as column N: (..., m, N) -> (..., m, N+1)."""
    q = torch.as_tensor(moduli_in, dtype=torch.int64, device=residues.device)
    return torch.cat([residues, sum_mod(residues, q, axis=-1)[..., None]], dim=-1)


def baseconv_ecc_check(converted: torch.Tensor, moduli_out) -> torch.Tensor:
    """After converting an (m, N+1) residue matrix: column N equals the sum of
    columns 0..N-1 mod each output modulus, for every output limb."""
    q = torch.as_tensor(moduli_out, dtype=torch.int64, device=converted.device)
    return torch.all(sum_mod(converted[..., :-1], q, axis=-1) == converted[..., -1], dim=-1)
