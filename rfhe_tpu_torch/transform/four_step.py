"""The cyclic four-step NTT as two modular matmuls and a twiddle product.

Counterpart of `rfhe_tpu/transform/four_step.py`, the reference's flagship
protected pipeline (matmul, elementwise, matmul):

  a[t1 + n1*t2]  ->  A[t2, t1]                (reshape)
  stage 1:  B = W2 @ A                       (n2-point NTTs down columns)
  twiddle:  B *= T,  T[k2, t1] = ω^(t1·k2)   (Shoup products)
  stage 2:  Y = B @ W1ᵀ                      (n1-point NTTs along rows)
  y[k1*n2 + k2] = Y[k2, k1]                  (transpose + reshape)

Natural order in and out.  The tables are the reference's, built from power
tables by index arithmetic (the reference loops over elements with `pow`);
tests/test_torch_four_step.py holds them equal.  Tensors are int64 residues
on the plan's device; the matmuls are `ops/matmul_mod.py`'s.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..numth import root_of_unity
from ..ops.matmul_mod import DigitPlan, matmul_mod
from ..ops.modarith import mul_mod_shoup
from ..ops.modring import ModArith
from ..ops.ntt import _pow_table


def _ntt_matrix(m: int, root: int, q: int) -> np.ndarray:
    """W[r, c] = root^(r·c) mod q, root of order m."""
    rc = np.arange(m, dtype=np.int64)[:, None] * np.arange(m, dtype=np.int64)[None, :]
    return _pow_table(root, m, q)[rc % m]


def _shoup(w: np.ndarray, q: int) -> np.ndarray:
    return (w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)


@dataclass(frozen=True)
class FourStepPlan:
    n: int
    n1: int
    n2: int
    q: int
    arith: ModArith
    digit: DigitPlan
    W2: torch.Tensor        # (n2, n2) stage-1 NTT matrix (root of order n2)
    W1T: torch.Tensor       # (n1, n1) stage-2 NTT matrix, transposed
    T: torch.Tensor         # (n2, n1) twiddle ω^(t1·k2)
    T_shoup: torch.Tensor
    W2i: torch.Tensor       # inverse-path tables
    W1Ti: torch.Tensor
    Ti: torch.Tensor        # inverse twiddle with n^-1 folded in
    Ti_shoup: torch.Tensor

    @classmethod
    def make(cls, n: int, q: int, device="cuda") -> "FourStepPlan":
        log_n = n.bit_length() - 1
        if (1 << log_n) != n:
            raise ValueError(f"n must be a power of two, got {n}")
        n1 = 1 << (log_n // 2)
        n2 = n // n1
        omega = root_of_unity(n, q)
        omega_inv = pow(omega, q - 2, q)
        w_n1 = pow(omega, n1, q)   # order n2
        w_n2 = pow(omega, n2, q)   # order n1
        n_inv = pow(n, q - 2, q)
        e = (np.arange(n1, dtype=np.int64)[None, :] * np.arange(n2, dtype=np.int64)[:, None]) % n
        T = _pow_table(omega, n, q)[e]
        Ti = _pow_table(omega_inv, n, q)[e] * np.uint64(n_inv) % np.uint64(q)
        W1 = _ntt_matrix(n1, w_n2, q)
        W1i = _ntt_matrix(n1, pow(w_n2, q - 2, q), q)
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)
        return cls(
            n=n, n1=n1, n2=n2, q=q, arith=ModArith.make(q),
            digit=DigitPlan(q),
            W2=dev(_ntt_matrix(n2, w_n1, q)), W1T=dev(W1.T), T=dev(T), T_shoup=dev(_shoup(T, q)),
            W2i=dev(_ntt_matrix(n2, pow(w_n1, q - 2, q), q)), W1Ti=dev(W1i.T),
            Ti=dev(Ti), Ti_shoup=dev(_shoup(Ti, q)),
        )


def _to_matrix(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (plan.n2, plan.n1))


def _from_matrix(Y: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    out = Y.transpose(-1, -2)          # (n1, n2): out[k1, k2]
    return out.reshape(out.shape[:-2] + (plan.n,))


def four_step_ntt(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """Forward cyclic NTT over the last axis (natural order in and out)."""
    return _from_matrix(four_step_ntt_stages(x, plan)[3], plan)


def four_step_intt(y: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """Inverse of four_step_ntt (the 1/n scaling rides in the Ti table)."""
    Y = y.reshape(y.shape[:-1] + (plan.n1, plan.n2)).transpose(-1, -2)
    B = matmul_mod(Y, plan.W1Ti, plan.digit)
    B = mul_mod_shoup(B, plan.Ti, plan.Ti_shoup, plan.q)
    A = matmul_mod(plan.W2i, B, plan.digit)
    return A.reshape(y.shape[:-1] + (plan.n,))


def four_step_ntt_stages(x: torch.Tensor, plan: FourStepPlan):
    """The forward transform's stage tensors (A, B1, B2, Y), for the
    detectors (protect/checks.py) and the fault campaigns (faults/)."""
    A = _to_matrix(x, plan)
    B1 = matmul_mod(plan.W2, A, plan.digit)
    B2 = mul_mod_shoup(B1, plan.T, plan.T_shoup, plan.q)
    Y = matmul_mod(B2, plan.W1T, plan.digit)
    return A, B1, B2, Y
