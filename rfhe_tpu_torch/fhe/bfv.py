"""BFV scheme layer: scale-invariant FV with the full-RNS (BEHZ) multiply.

Counterpart of `rfhe_tpu/fhe/bfv.py`: batch encode/decode, encrypt/decrypt,
add, multiply, square, relinearize, multiply_plain, rotate rows and columns.
With the same parameters and seed, keys and every ciphertext array equal the
reference's (tests/test_torch_bfv.py).

The BEHZ multiply: extend both inputs from Q to Bsk = B ∪ {m_sk} with the
m̃ correction (u ∈ {0, ±1}), the tensor product in Q and in Bsk, ⌊t·d/Q⌋
in Bsk, and the exact Shenoy–Kumaresan conversion back to Q.  The three
base conversions are `ops/baseconv.py`; the reference's Shoup constant
products become `(x·w) % q` on int64, which is the same residue for every
word below 2^32 that it takes.  The Bsk basis has its own NTT plan, which
launches the CUDA kernels on a card; it is used only for forward/inverse
pairs and pointwise products, so its slot order does not show.  Batching is
BGV's (`fhe/bgv.py`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import to_numpy_u32, to_torch
from ..numth import find_ntt_primes, is_prime, mod_inv
from ..ops.baseconv import BaseConvPlan, base_conv
from ..ops.modarith import add_mod, mont_mul, sub_mod
from ..ops.ntt import NttPlan
from .bgv import BatchedContext
from .ckks import Ciphertext, encrypt_public, rns_to_signed
from .rns import RnsPoly, poly_mul_pointwise, poly_ntt


def _col(vals: Sequence[int], device) -> torch.Tensor:
    """Per-limb constants as an int64 column (len, 1) on the device."""
    return torch.tensor([int(v) for v in vals], dtype=torch.int64, device=device)[:, None]


@dataclass(frozen=True)
class BehzPlan:
    """Tables of the BEHZ multiply at one level, k data limbs
    (`rfhe_tpu.fhe.bfv.BehzPlan`).  Bases: Q = q_0..q_{k-1}, B = b_1..b_{k+2},
    Bsk = B ∪ {m_sk} (NTT primes), m̃ the correction channel (never
    transformed).  Every constant is an int64 column (len, 1)."""

    k: int
    moduli: Tuple[int, ...]
    bsk: Tuple[int, ...]
    mtilde: int
    bsk_plan: NttPlan
    q_col: torch.Tensor
    bsk_col: torch.Tensor
    # extend: y_j = |x·m̃·Q̂_j^{-1}|_{q_j}, converted by W1[j, c] = Q̂_j mod c
    ext_mul: torch.Tensor
    conv_q_to_bskm: BaseConvPlan
    neg_qinv_mt: int
    q_mod_bsk: torch.Tensor
    qmt_mod_bsk: torch.Tensor
    mt_inv_bsk: torch.Tensor
    # floor: u_j = |t·d·Q̂_j^{-1}|_{q_j}; w = (t·d − conv)·Q^{-1} in Bsk
    t_mod_q: torch.Tensor
    t_mod_bsk: torch.Tensor
    qhat_inv: torch.Tensor
    q_inv_bsk: torch.Tensor
    # Shenoy–Kumaresan conversion B -> Q with m_sk
    bhat_inv: torch.Tensor
    conv_b_to_qmsk: BaseConvPlan
    b_inv_msk: int
    b_mod_q: torch.Tensor
    bmsk_mod_q: torch.Tensor

    @classmethod
    def make(cls, n: int, moduli: Tuple[int, ...], t: int, avoid: Tuple[int, ...],
             device) -> "BehzPlan":
        k = len(moduli)
        Q = math.prod(moduli)
        taken = set(moduli) | set(avoid) | {t}
        pool = [p for p in find_ntt_primes(n, 30, k + 3 + len(taken)) if p not in taken]
        bsk = tuple(pool[:k + 3])
        B_primes, msk = bsk[:-1], bsk[-1]
        B = math.prod(B_primes)
        mt = 65537
        while mt in taken or mt in bsk or not is_prime(mt):
            mt += 2
        qhat = [Q // q for q in moduli]
        bhat = [B // b for b in B_primes]
        W1 = [[qhat[j] % c for c in bsk + (mt,)] for j in range(k)]
        W2 = [[bhat[i] % c for c in moduli + (msk,)] for i in range(len(B_primes))]
        col = lambda vals: _col(vals, device)
        return cls(
            k=k, moduli=tuple(moduli), bsk=bsk, mtilde=mt,
            bsk_plan=NttPlan.make(n, bsk, device), q_col=col(moduli), bsk_col=col(bsk),
            ext_mul=col([mt * mod_inv(qhat[j] % q, q) % q for j, q in enumerate(moduli)]),
            conv_q_to_bskm=BaseConvPlan.from_matrix(W1, moduli, bsk + (mt,), device),
            neg_qinv_mt=mod_inv((-Q) % mt, mt),
            q_mod_bsk=col([Q % b for b in bsk]),
            qmt_mod_bsk=col([Q * mt % b for b in bsk]),
            mt_inv_bsk=col([mod_inv(mt % b, b) for b in bsk]),
            t_mod_q=col([t % q for q in moduli]),
            t_mod_bsk=col([t % b for b in bsk]),
            qhat_inv=col([mod_inv(qhat[j] % q, q) for j, q in enumerate(moduli)]),
            q_inv_bsk=col([mod_inv(Q % b, b) for b in bsk]),
            bhat_inv=col([mod_inv(bhat[i] % b, b) for i, b in enumerate(B_primes)]),
            conv_b_to_qmsk=BaseConvPlan.from_matrix(W2, B_primes, moduli + (msk,), device),
            b_inv_msk=mod_inv(B % msk, msk),
            b_mod_q=col([B % q for q in moduli]),
            bmsk_mod_q=col([B * msk % q for q in moduli]),
        )

    # ---- stages on (..., limbs, n) tensors, coefficient domain -------------
    def extend_to_bsk(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., k, n) mod Q -> a representative mod Bsk (..., k+3, n)
        equal to x + u·Q, u ∈ {0, ±1} (the small Montgomery correction)."""
        mt, qb = self.mtilde, self.bsk_col
        conv = base_conv(x * self.ext_mul % self.q_col, self.conv_q_to_bskm)
        xb, xm = conv[..., :-1, :], conv[..., -1, :]
        r = (xm * self.neg_qinv_mt % mt).unsqueeze(-2)          # |−x·Q^{-1}|_m̃
        v = add_mod(xb, r * self.q_mod_bsk % qb, qb)
        v = sub_mod(v, torch.where(r > mt // 2, self.qmt_mod_bsk, 0), qb)
        return v * self.mt_inv_bsk % qb

    def rns_floor(self, td_q: torch.Tensor, td_bsk: torch.Tensor) -> torch.Tensor:
        """⌊t·d/Q⌋ (+ an error below k) in Bsk from t·d in Q and in Bsk."""
        qb = self.bsk_col
        conv = base_conv(td_q * self.qhat_inv % self.q_col, self.conv_q_to_bskm)[..., :-1, :]
        return sub_mod(td_bsk, conv, qb) * self.q_inv_bsk % qb

    def conv_sk(self, w: torch.Tensor) -> torch.Tensor:
        """The exact Shenoy–Kumaresan conversion Bsk -> Q: m_sk corrects the
        B-overflow."""
        msk, q = self.bsk[-1], self.q_col
        conv = base_conv(w[..., :-1, :] * self.bhat_inv % self.bsk_col[:-1], self.conv_b_to_qmsk)
        cq, cmsk = conv[..., :-1, :], conv[..., -1, :]
        alpha = (sub_mod(cmsk, w[..., -1, :], msk) * self.b_inv_msk % msk).unsqueeze(-2)
        out = sub_mod(cq, alpha * self.b_mod_q % q, q)
        return add_mod(out, torch.where(alpha > msk // 2, self.bmsk_mod_q, 0), q)


@dataclass(frozen=True)
class GammaDecryptPlan:
    """BEHZ γ-corrected decryption tables (`rfhe_tpu.fhe.bfv.GammaDecryptPlan`):
    m = ⌊t·x/Q⌉ mod t on the device.  With t·x = Q·m + v and γ coprime,
    s_{t,γ} = |FastBConv(|γ·t·x|_Q)·(−Q^{-1})|_{t,γ} = γ·m + r − e, so the
    centered s_γ gives r − e and m = (s_t − [s_γ]_c)·γ^{-1} mod t."""

    gamma: int
    t: int
    w: torch.Tensor                 # (k, 1) |γ·t·Q̂_j^{-1}|_{q_j}
    q_col: torch.Tensor
    conv: BaseConvPlan              # Q -> (t, γ)
    neg_qinv: torch.Tensor          # (2, 1) −Q^{-1} mod (t, γ)
    tg: torch.Tensor                # (2, 1) (t, γ)
    gamma_mod_t: int
    gamma_inv_t: int

    @classmethod
    def make(cls, moduli: Tuple[int, ...], t: int, device) -> "GammaDecryptPlan":
        k = len(moduli)
        gamma = 257
        while gamma in moduli or gamma == t or not is_prime(gamma) or gamma <= 4 * (k + 1):
            gamma += 2
        Q = math.prod(moduli)
        qhat = [Q // q for q in moduli]
        W = [[qhat[j] % c for c in (t, gamma)] for j in range(k)]
        return cls(gamma=gamma, t=t,
                   w=_col([gamma * t * mod_inv(qhat[j] % q, q) % q for j, q in enumerate(moduli)],
                          device),
                   q_col=_col(moduli, device),
                   conv=BaseConvPlan.from_matrix(W, moduli, (t, gamma), device),
                   neg_qinv=_col([(-mod_inv(Q % c, c)) % c for c in (t, gamma)], device),
                   tg=_col((t, gamma), device),
                   gamma_mod_t=gamma % t, gamma_inv_t=mod_inv(gamma % t, t))

    def decrypt_mod_t(self, x: torch.Tensor) -> torch.Tensor:
        """x (k, n) coefficient-domain residues of [c(s)]_Q -> (n,) m mod t."""
        t = self.t
        s = base_conv(x * self.w % self.q_col, self.conv) * self.neg_qinv % self.tg
        s_t, s_g = s[0], s[1]
        d = add_mod(sub_mod(s_t, s_g, t),
                    torch.where(s_g > self.gamma // 2, self.gamma_mod_t, 0), t)
        return d * self.gamma_inv_t % t


class BfvContext(BatchedContext):
    """BFV (`rfhe_tpu.fhe.bfv.BfvContext`): keys, batching and the evaluator
    on one device; `device` is required."""

    def __init__(self, params, special_bits: Optional[int] = None, seed: int = 13,
                 dnum: Optional[int] = None, *, device):
        super().__init__(params, special_bits, seed, dnum, device)
        self._behz: Dict[int, BehzPlan] = {}
        self._gamma_plans: Dict[int, GammaDecryptPlan] = {}

    def behz(self, level: int) -> BehzPlan:
        if level not in self._behz:
            self._behz[level] = BehzPlan.make(self.params.n, self.params.moduli[:level + 1],
                                              self.t, self.ctx.moduli, self.device)
        return self._behz[level]

    # -- batch encode -----------------------------------------------------------
    def encode(self, matrix: np.ndarray) -> np.ndarray:
        """(2, n/2) ints mod t -> coefficient-domain plaintext (n,) uint32 mod t."""
        return to_numpy_u32(self._slots_to_coeffs(matrix))

    # -- encrypt / decrypt --------------------------------------------------------
    def encrypt(self, pt_coeffs_t: np.ndarray, level: Optional[int] = None) -> Ciphertext:
        """Public-key encryption of Δ·m, Δ = ⌊Q_level/t⌋."""
        lvl = self.L - 1 if level is None else level
        mods = self.params.moduli[:lvl + 1]
        delta = math.prod(mods) // self.t
        q = self.ctx.plan_at(lvl).qb(1)
        dm = to_torch(pt_coeffs_t, self.device)[None, :] * _col([delta % p for p in mods],
                                                                 self.device) % q
        c0, c1 = encrypt_public(self.ctx, self.pk, self.rng, dm, self.params.sigma)
        return Ciphertext([RnsPoly(c0, True), RnsPoly(c1, True)], 1.0)

    def decrypt_coeffs_t(self, ct: Ciphertext, exact: bool = False) -> np.ndarray:
        """m = ⌊t·[c(s)]_Q/Q⌉ mod t, (n,) uint32.  The default is the BEHZ
        γ-correction on the device; exact=True rounds the host's CRT."""
        lvl = ct.level
        x = self._decrypt_coeffs(ct)
        if exact:
            moduli = [int(q) for q in self.params.moduli[:lvl + 1]]
            Q = math.prod(moduli)
            signed = rns_to_signed(to_numpy_u32(x), moduli)
            m = (signed * self.t * 2 + Q) // (2 * Q)
            return (m % self.t).astype(np.uint32)
        if lvl not in self._gamma_plans:
            self._gamma_plans[lvl] = GammaDecryptPlan.make(self.params.moduli[:lvl + 1], self.t,
                                                           self.device)
        return to_numpy_u32(self._gamma_plans[lvl].decrypt_mod_t(x))

    # -- evaluator ----------------------------------------------------------------
    def _multiply_impl(self, a0, a1, b0, b1, bp: BehzPlan) -> torch.Tensor:
        """The BEHZ multiply of NTT-domain (k, n) components mod Q: the three
        NTT-domain components of ⌊t/Q·(ct_a ⊗ ct_b)⌉ mod Q, (3, k, n)."""
        plan = self.ctx.plan_at(bp.k - 1)
        q, rinv = plan.qb(1), plan.rinvb(1)
        d_q = torch.stack([mont_mul(a0, b0, q, rinv),
                           add_mod(mont_mul(a0, b1, q, rinv), mont_mul(a1, b0, q, rinv), q),
                           mont_mul(a1, b1, q, rinv)])
        ext = bp.extend_to_bsk(plan.inv(torch.stack([a0, a1, b0, b1])))
        en = bp.bsk_plan.fwd(ext)
        bq, brinv = bp.bsk_plan.qb(1), bp.bsk_plan.rinvb(1)
        d_bsk = torch.stack([mont_mul(en[0], en[2], bq, brinv),
                             add_mod(mont_mul(en[0], en[3], bq, brinv),
                                     mont_mul(en[1], en[2], bq, brinv), bq),
                             mont_mul(en[1], en[3], bq, brinv)])
        td_q = plan.inv(d_q) * bp.t_mod_q % bp.q_col
        td_b = bp.bsk_plan.inv(d_bsk) * bp.t_mod_bsk % bp.bsk_col
        return plan.fwd(bp.conv_sk(bp.rns_floor(td_q, td_b)))

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.size == 2 and b.size == 2 and a.level == b.level
        out = self._multiply_impl(a.c[0].data, a.c[1].data, b.c[0].data, b.c[1].data,
                                  self.behz(a.level))
        return Ciphertext([RnsPoly(o, True) for o in out], 1.0)

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.multiply(a, a)

    def multiply_plain(self, ct: Ciphertext, pt_coeffs_t: np.ndarray) -> Ciphertext:
        """ct·pt with pt an unscaled batch plaintext (coefficients mod t)."""
        q = self.ctx.plan_at(ct.level).qb(1)
        lifted = to_torch(pt_coeffs_t, self.device)[None, :] % q
        pt_ntt = poly_ntt(RnsPoly(lifted, False), self.ctx)
        return Ciphertext([poly_mul_pointwise(c, pt_ntt, self.ctx) for c in ct.c], 1.0)
