"""RNS polynomial arithmetic over the moduli chain.

Counterpart of `rfhe_tpu/fhe/rns.py`, with the BGV t-mode of `drop_limb`.
An RnsPoly holds an int64 tensor of shape (level+1, N): limb j holds the
coefficients (or the NTT-domain slots, order nu, Montgomery form) of the
polynomial mod q_j.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..numth import barrett_constants, mod_inv, shoup_precompute
from ..ops.modarith import (
    add_mod, barrett_word, mont_mul, mul_mod_shoup, neg_mod, reduce_mod, sub_mod,
)
from ..ops.ntt import NttPlan
from ..trace import spans


@dataclass(frozen=True, eq=False)
class RnsContext:
    """Tables for one moduli chain (all levels), on one device."""

    n: int
    moduli: Tuple[int, ...]
    plan: NttPlan                   # full-chain NTT plan
    # cross-limb constants, indexed [k, i]: q_k mod q_i, q_k^{-1} mod q_i
    # (0 on the diagonal) and its Shoup companion
    qk_mod: torch.Tensor
    qk_inv: torch.Tensor
    qk_inv_shoup: torch.Tensor
    _index: Dict[Tuple[int, ...], torch.Tensor] = field(default_factory=dict)
    _perms: Dict[int, torch.Tensor] = field(default_factory=dict)
    _consts: Dict[tuple, object] = field(default_factory=dict)

    @classmethod
    def make(cls, n: int, moduli: Sequence[int], device) -> "RnsContext":
        moduli = tuple(int(q) for q in moduli)
        plan = NttPlan.make(n, moduli, device)
        Lf = len(moduli)
        qk_mod = np.zeros((Lf, Lf), dtype=np.int64)
        qk_inv = np.zeros((Lf, Lf), dtype=np.int64)
        qk_inv_s = np.zeros((Lf, Lf), dtype=np.int64)
        for k, qk in enumerate(moduli):
            for i, qi in enumerate(moduli):
                qk_mod[k, i] = qk % qi
                if i != k:
                    qk_inv[k, i] = mod_inv(qk % qi, qi)
                    qk_inv_s[k, i] = shoup_precompute(int(qk_inv[k, i]), qi)
        dev = lambda a: torch.from_numpy(a).to(plan.device)
        return cls(n=n, moduli=moduli, plan=plan, qk_mod=dev(qk_mod),
                   qk_inv=dev(qk_inv), qk_inv_shoup=dev(qk_inv_s))

    @property
    def L(self) -> int:
        return len(self.moduli)

    @property
    def device(self) -> torch.device:
        return self.plan.device

    def index(self, idx: Sequence[int]) -> torch.Tensor:
        """Limb indices as an int64 tensor on the device (cached)."""
        key = tuple(int(i) for i in idx)
        t = self._index.get(key)
        if t is None:
            t = self._index[key] = torch.tensor(key, dtype=torch.int64, device=self.device)
        return t

    def cached(self, key: tuple, make):
        """Tables on the device, built by `make()` at first use of `key`."""
        hit = self._consts.get(key)
        if hit is None:
            hit = self._consts[key] = make()
        return hit

    def plan_at(self, level: int) -> NttPlan:
        return self.plan.slice(level + 1)

    def galois_perm(self, g: int) -> np.ndarray:
        return self.plan.galois_perm(g)

    def galois_perm_t(self, g: int) -> torch.Tensor:
        """`galois_perm(g)` as an int64 tensor on the device (cached)."""
        t = self._perms.get(g)
        if t is None:
            t = self._perms[g] = torch.from_numpy(
                self.galois_perm(g).astype(np.int64)).to(self.device)
        return t


@dataclass
class RnsPoly:
    data: torch.Tensor     # (level+1, N) int64
    is_ntt: bool           # True: NTT/Montgomery domain, slot order nu

    def tree_flatten(self):
        return (self.data,), (self.is_ntt,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(data=children[0], is_ntt=aux[0])

    @property
    def level(self) -> int:
        return self.data.shape[0] - 1


def poly_ntt(p: RnsPoly, ctx: RnsContext) -> RnsPoly:
    assert not p.is_ntt
    return RnsPoly(ctx.plan_at(p.level).fwd(p.data), True)


def poly_intt(p: RnsPoly, ctx: RnsContext) -> RnsPoly:
    assert p.is_ntt
    return RnsPoly(ctx.plan_at(p.level).inv(p.data), False)


def poly_add(a: RnsPoly, b: RnsPoly, ctx: RnsContext) -> RnsPoly:
    assert a.is_ntt == b.is_ntt and a.level == b.level
    return RnsPoly(add_mod(a.data, b.data, ctx.plan_at(a.level).qb(1)), a.is_ntt)


def poly_sub(a: RnsPoly, b: RnsPoly, ctx: RnsContext) -> RnsPoly:
    assert a.is_ntt == b.is_ntt and a.level == b.level
    return RnsPoly(sub_mod(a.data, b.data, ctx.plan_at(a.level).qb(1)), a.is_ntt)


def poly_neg(a: RnsPoly, ctx: RnsContext) -> RnsPoly:
    return RnsPoly(neg_mod(a.data, ctx.plan_at(a.level).qb(1)), a.is_ntt)


def poly_mul_pointwise(a: RnsPoly, b: RnsPoly, ctx: RnsContext) -> RnsPoly:
    """Dyadic product of two NTT-domain (Montgomery) polys."""
    assert a.is_ntt and b.is_ntt and a.level == b.level
    plan = ctx.plan_at(a.level)
    return RnsPoly(mont_mul(a.data, b.data, plan.qb(1), plan.rinvb(1)), True)


def poly_automorphism(a: RnsPoly, g: int, ctx: RnsContext) -> RnsPoly:
    """Apply X -> X^g.  NTT domain: a slot permutation (gather)."""
    assert a.is_ntt, "apply automorphisms in the NTT domain"
    return RnsPoly(a.data.index_select(-1, ctx.galois_perm_t(g)), True)


def lift_to_limbs(v: torch.Tensor, src_k: int, dst: Sequence[int],
                  ctx: RnsContext, centered: bool) -> torch.Tensor:
    """Lift coefficients v ∈ [0, q_src)^(..., N) to residues mod each q_i,
    i ∈ dst, optionally via the centered representative (-q_src/2, q_src/2].
    Returns (..., len(dst), N).  `v % q_i` is v itself where q_src <= q_i,
    which is the reference's per-limb case split."""
    dst_idx = ctx.index(dst)
    q_dst = ctx.plan.tables.q[dst_idx][:, None]
    r = reduce_mod(v.unsqueeze(-2), q_dst)
    if centered:
        over = (v > ctx.moduli[src_k] // 2).unsqueeze(-2)
        r = torch.where(over, sub_mod(r, ctx.qk_mod[src_k, dst_idx][:, None], q_dst), r)
    return r


def limb_plan(ctx: RnsContext, i: int) -> NttPlan:
    """Single-limb view of the chain's plan (for per-limb inverse NTTs)."""
    return ctx.plan.take([i])


def bgv_lift_residue(ck: torch.Tensor, q_src: int, t: int) -> torch.Tensor:
    """r ≡ [ck]_c·q_src⁻¹ (mod t), the reference's word (`rns.py:244-250`):
    the Barrett reduction of ck·(q_src⁻¹ mod t), minus one mod t where ck
    lifts to ck − q_src.  The product reaches 2^31·t, above t², where that
    Barrett word is congruent but not reduced; every later step takes it as
    it is, so the port does too (`modarith.barrett_word`)."""
    mu, k = barrett_constants(t)
    r = barrett_word(ck * mod_inv(q_src, t), t, mu, k)
    return torch.where(ck > q_src // 2, sub_mod(r, 1, t), r)


def bgv_lift_shift(r: torch.Tensor, src_k: int, keep: Sequence[int], t: int,
                   ctx: RnsContext) -> torch.Tensor:
    """q_src·[r]_c mod q_i for each kept modulus (..., len(keep), N): [r]_c
    is r − t where r > t/2 (`rns.py:251-256`).  r may pass q_i; the
    reference's Montgomery product of q_src mod q_i by it is still exact."""
    keep_idx = ctx.index(keep)
    q = ctx.plan.tables.q[keep_idx][:, None]
    r_ = r.unsqueeze(-2)
    r_c = torch.where((r > t // 2).unsqueeze(-2), sub_mod(r_, t % q, q), r_)
    return ctx.qk_mod[src_k, keep_idx][:, None] * r_c % q


def drop_limb(data: torch.Tensor, src_k: int, n_keep,
              ctx: RnsContext, t: Optional[int] = None,
              phase: Callable[[str], None] = spans.OFF) -> torch.Tensor:
    """Exact RNS divide-and-round (`rfhe_tpu.fhe.rns.drop_limb`): given
    NTT-domain limbs data = [rows for the kept moduli] + [row for modulus
    src_k] with optional leading batch dims (..., nk+1, N), return
    ((data − δ)·q_src^{-1}) mod q_i for each kept modulus.  `n_keep` is an
    int (moduli 0..n_keep-1) or a list of modulus indices.  CKKS (t=None):
    δ is the centered lift of the src row.  BGV (t given): δ also satisfies
    δ ≡ 0 (mod t), δ = [c]_c − q_src·[r]_c with r of `bgv_lift_residue`,
    so the message mod t survives up to the factor q_src⁻¹ the caller's
    correction tracks.  `phase` (a `spans.phases` of the caller's) is
    called with each of `spans.MODDOWN_PHASES` as its step begins: the src
    row's inverse NTT, the lift, δ's forward NTT, the subtract and scale."""
    keep = list(range(n_keep)) if isinstance(n_keep, int) else list(n_keep)
    nk = len(keep)
    phase("MD_INTT")
    src_row = limb_plan(ctx, src_k).inv(data[..., nk:nk + 1, :].contiguous())
    return drop_limb_lifted(data[..., :nk, :], src_row[..., 0, :], src_k, keep, ctx, t, phase)


def drop_limb_lifted(kept: torch.Tensor, ck: torch.Tensor, src_k: int, keep: Sequence[int],
                     ctx: RnsContext, t: Optional[int] = None,
                     phase: Callable[[str], None] = spans.OFF) -> torch.Tensor:
    """`drop_limb` given the dropped row's coefficients ck (..., N) and the
    kept rows (..., len(keep), N): what each kept limb needs of the dropped
    one, so that a rank holding some of the limbs computes their rows alone
    (parallel/sharded_ckks.py).  `phase` as in `drop_limb`, from MD_LIFT on."""
    phase("MD_LIFT")
    delta = lift_to_limbs(ck, src_k, keep, ctx, centered=True)
    keep_idx = ctx.index(keep)
    q_lo = ctx.plan.tables.q[keep_idx][:, None]
    if t is not None:
        shift = bgv_lift_shift(bgv_lift_residue(ck, ctx.moduli[src_k], t), src_k, keep, t, ctx)
        delta = sub_mod(delta, shift, q_lo)
    phase("MD_NTT")
    delta_ntt = ctx.plan.take(keep).fwd(delta)
    phase("MD_SCALE")
    num = sub_mod(kept, delta_ntt, q_lo)
    return mul_mod_shoup(num, ctx.qk_inv[src_k, keep_idx][:, None],
                         ctx.qk_inv_shoup[src_k, keep_idx][:, None], q_lo)


def rescale(p: RnsPoly, ctx: RnsContext) -> RnsPoly:
    """Drop the top limb k = level: c'_i = (c_i − [c_k])·q_k^{-1} mod q_i."""
    assert p.is_ntt
    k = p.level
    return RnsPoly(drop_limb(p.data, k, k, ctx), True)
