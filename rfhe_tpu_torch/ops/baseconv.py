"""RNS base conversion: out[k] = Σ_j r_j · W[j, k] mod q_k.

Counterpart of `rfhe_tpu/ops/baseconv.py`.  The reference forms the sum as
int8-digit matmuls for the MXU, an XLA composition; cuBLAS has no int64
matmul, and with up to 13 input limbs an unreduced sum of 2^63 products
overflows int64, so here each product is reduced before the sum: a residue
(below 2^32) times W[j, k] (< q_k < 2^31) is below 2^63, its `%` below
2^31, and the sum over the input limbs stays far below 2^63.  The
reference's sum is exact and canonical too, so the words agree
(tests/test_torch_bfv.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..numth import crt_constants


def base_conv_matrix(moduli_in: Sequence[int], moduli_out: Sequence[int]) -> np.ndarray:
    """W[j, k] = (P/p_j)·((P/p_j)^{-1} mod p_j) mod q_k
    (`rfhe_tpu.numth.base_conv_matrix`)."""
    P, hat_p, inv_hat_p = crt_constants(list(moduli_in))
    return np.array([[(hat_p[j] * inv_hat_p[j]) % qk for qk in moduli_out]
                     for j in range(len(moduli_in))], dtype=np.int64)


@dataclass(frozen=True)
class BaseConvPlan:
    moduli_in: Tuple[int, ...]
    moduli_out: Tuple[int, ...]
    weights: torch.Tensor        # (m_in, m_out, 1) int64, W[j, k] < q_k
    q_out: torch.Tensor          # (m_out, 1) int64

    @classmethod
    def make(cls, moduli_in: Sequence[int], moduli_out: Sequence[int], device) -> "BaseConvPlan":
        return cls.from_matrix(base_conv_matrix(moduli_in, moduli_out), moduli_in, moduli_out,
                               device)

    @classmethod
    def from_matrix(cls, W: np.ndarray, moduli_in: Sequence[int], moduli_out: Sequence[int],
                    device) -> "BaseConvPlan":
        """Plan for an explicit weight matrix, entries already reduced mod q_k
        (`BaseConvPlan.from_matrix`; the BEHZ conversions pre-scale residues
        by Q̂_j^{-1} mod q_j and take W[j, k] = Q̂_j mod q_k)."""
        W = torch.from_numpy(np.asarray(W, dtype=np.int64))
        return cls(moduli_in=tuple(int(p) for p in moduli_in),
                   moduli_out=tuple(int(q) for q in moduli_out),
                   weights=W[:, :, None].to(device),
                   q_out=torch.tensor(moduli_out, dtype=torch.int64, device=device)[:, None])


def base_conv(residues: torch.Tensor, plan: BaseConvPlan) -> torch.Tensor:
    """residues (..., m_in, N) with words below 2^32 -> (..., m_out, N),
    out[..., k, i] = Σ_j residues[..., j, i]·W[j, k] mod q_k."""
    q = plan.q_out
    return (residues.unsqueeze(-2) * plan.weights % q).sum(dim=-3) % q   # (..., m_in, m_out, N)
