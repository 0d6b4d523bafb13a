"""Key generation and hybrid keyswitching, per-limb and grouped digits.

Counterpart of `rfhe_tpu/fhe/keys.py`.  The L ciphertext limbs partition
into dnum contiguous groups of α = ⌈L/dnum⌉; the basis carries α special
primes with product P after the ciphertext primes.  Digit j is [c]_{Q_j}
(Q_j the product of group j's primes) and key j over the full basis is
    b_j = −a_j·s + e_j + P·ẽ_j·s'   with [P·ẽ_j]_{q_i} = P for i in group j,
                                                          0 elsewhere.
dnum=None is per-limb digits (α = 1, one special prime).  Every random draw
is made on the host from the caller's np.random.Generator in the reference's
order, so keys come out identical.  A cached program reads the keys where
they lie (`utils.jitcache.by_reference`): they are never copied per call.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import to_torch
from ..numth import montgomery_constants, mod_inv, shoup_precompute
from ..ops import ntt_cuda
from ..ops.modarith import add_mod, mont_mul, mul_mod, mul_mod_shoup, sub_mod
from ..trace import spans
from ..utils.jitcache import by_reference
from .rns import RnsContext, drop_limb


@by_reference
@dataclass
class SecretKey:
    s_ntt: torch.Tensor      # (L_full, N) NTT/Montgomery domain incl. special
    s_coeff: np.ndarray      # (N,) ternary in {-1, 0, 1}, host


@by_reference
@dataclass
class PublicKey:
    b: torch.Tensor          # (L_ct, N) NTT domain (ciphertext primes only)
    a: torch.Tensor


@by_reference
@dataclass
class KeySwitchKey:
    """b, a: (n_digits, L_full, N) NTT domain over the ciphertext primes
    followed by the special primes.  A key cut to some of its rows (a rank
    of the limb-sharded evaluator keeps its own limbs and the special ones)
    names the basis index of each row in `limbs`; None is the whole basis."""
    b: torch.Tensor
    a: torch.Tensor
    limbs: Optional[Tuple[int, ...]] = None

    def rows(self, basis: Sequence[int]) -> List[int]:
        """The rows of b and a that hold the basis limbs `basis`."""
        if self.limbs is None:
            return list(basis)
        missing = [i for i in basis if i not in self.limbs]
        if missing:
            raise ValueError(f"this key holds limbs {self.limbs}, not {missing}")
        return [self.limbs.index(i) for i in basis]

    def cut(self, basis: Sequence[int]) -> "KeySwitchKey":
        """The key restricted to the basis limbs `basis`."""
        idx = torch.tensor(self.rows(basis), dtype=torch.int64, device=self.b.device)
        return KeySwitchKey(b=self.b.index_select(1, idx), a=self.a.index_select(1, idx),
                            limbs=tuple(int(i) for i in basis))


def _rns_from_signed(coeffs: np.ndarray, moduli) -> np.ndarray:
    """Signed integer coefficients -> (L, N) uint32 residues."""
    out = np.empty((len(moduli), coeffs.shape[-1]), dtype=np.uint32)
    for i, q in enumerate(moduli):
        out[i] = np.mod(coeffs.astype(np.int64), q).astype(np.uint32)
    return out


def _sample_ternary(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(-1, 2, size=n).astype(np.int64)


def _sample_gaussian(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    return np.round(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def _sample_uniform_rns(rng: np.random.Generator, moduli, n: int) -> np.ndarray:
    return np.stack([
        rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
        for q in moduli
    ])


@dataclass
class KeyGen:
    ctx: RnsContext              # full basis: ciphertext primes + special
    n_ct_limbs: int              # number of ciphertext primes (excl. special)
    sigma: float = 3.2

    def gen_secret(self, rng: np.random.Generator) -> SecretKey:
        s = _sample_ternary(rng, self.ctx.n)
        s_rns = to_torch(_rns_from_signed(s, self.ctx.moduli), self.ctx.device)
        return SecretKey(s_ntt=self.ctx.plan.fwd(s_rns), s_coeff=s)

    def gen_public(self, sk: SecretKey, rng: np.random.Generator,
                   noise_factor: int = 1) -> PublicKey:
        """b = e − a·s over the ciphertext primes, the gaussian e scaled by
        `noise_factor` (t for the BGV key, `bgv.py:_gen_public_bgv`)."""
        L = self.n_ct_limbs
        dev = self.ctx.device
        moduli = self.ctx.moduli[:L]
        a = to_torch(_sample_uniform_rns(rng, moduli, self.ctx.n), dev)
        e = _rns_from_signed(noise_factor * _sample_gaussian(rng, self.ctx.n, self.sigma), moduli)
        plan = self.ctx.plan.slice(L)
        e_ntt = plan.fwd(to_torch(e, dev))
        q, rinv = plan.qb(1), plan.rinvb(1)
        b = sub_mod(e_ntt, mont_mul(a, sk.s_ntt[:L], q, rinv), q)
        return PublicKey(b=b, a=a)

    def gen_keyswitch(self, sk: SecretKey, s_prime_ntt: torch.Tensor,
                      rng: np.random.Generator, noise_factor: int = 1,
                      dnum: Optional[int] = None) -> KeySwitchKey:
        """Key switching s' -> s (`rfhe_tpu.fhe.keys.KeyGen.gen_keyswitch`):
        one key per digit group, all the a's drawn first, then all the e's,
        each gaussian scaled by `noise_factor` (t for BGV keys).  dnum=None
        means ⌈L / n_special⌉ groups here, which is per-limb digits with one
        special prime."""
        ctx = self.ctx
        L = self.n_ct_limbs
        n_sp = len(ctx.moduli) - L
        if dnum is None:
            dnum = -(-L // max(1, n_sp))
        groups = _digit_groups(L, dnum)
        P_sp = math.prod(ctx.moduli[L:])
        a = np.stack([_sample_uniform_rns(rng, ctx.moduli, ctx.n) for _ in groups])
        e = np.stack([
            _rns_from_signed(noise_factor * _sample_gaussian(rng, ctx.n, self.sigma), ctx.moduli)
            for _ in groups
        ])
        plan = ctx.plan
        q, rinv = plan.qb(1), plan.rinvb(1)
        a_t = to_torch(a, ctx.device)
        b = sub_mod(plan.fwd(to_torch(e, ctx.device)), mont_mul(a_t, sk.s_ntt, q, rinv), q)
        # + P·ẽ_g·s' on the limbs l of each group g
        gi_idx = ctx.index([gi for gi, grp in enumerate(groups) for _ in grp])
        l_idx = ctx.index([l for grp in groups for l in grp])
        pl = [P_sp % ctx.moduli[l] for l in range(L)]
        col = lambda vals: torch.tensor(vals, dtype=torch.int64, device=ctx.device)[:, None]
        ql = col(ctx.moduli[:L])
        add_d = mul_mod_shoup(s_prime_ntt[l_idx], col(pl),
                              col([shoup_precompute(v, ctx.moduli[l]) for l, v in enumerate(pl)]),
                              ql)
        b[gi_idx, l_idx] = add_mod(b[gi_idx, l_idx], add_d, ql)
        return KeySwitchKey(b=b, a=a_t)


def _digit_groups(L: int, dnum: int) -> List[List[int]]:
    """Partition limbs 0..L-1 into dnum contiguous groups of α = ceil(L/dnum)."""
    alpha = -(-L // dnum)
    return [list(range(g * alpha, min((g + 1) * alpha, L)))
            for g in range(dnum) if g * alpha < L]


@lru_cache(maxsize=4096)
def _group_ext_consts(moduli: tuple, G: tuple, lim: tuple):
    """Fast-base-extension constants for digit group G at the active basis
    `lim` (`rfhe_tpu.fhe.keys._group_ext_consts`): tilde_l = (Q_G/q_l)^{-1}
    mod q_l and W[l][i] = (Q_G/q_l) mod q_i, each with Shoup companions, as
    uint32 arrays (tilde, tilde_s (α,); W, W_s (α, len(lim)))."""
    QG = math.prod(moduli[l] for l in G)
    tilde, tilde_s = [], []
    W, W_s = [], []
    for l in G:
        hat = QG // moduli[l]
        tl = mod_inv(hat % moduli[l], moduli[l])
        tilde.append(tl)
        tilde_s.append(shoup_precompute(tl, moduli[l]))
        W.append([hat % moduli[i] for i in lim])
        W_s.append([shoup_precompute(hat % moduli[i], moduli[i]) for i in lim])
    return (np.array(tilde, dtype=np.uint32), np.array(tilde_s, dtype=np.uint32),
            np.array(W, dtype=np.uint32), np.array(W_s, dtype=np.uint32))


def _extend_group(d_coeff: torch.Tensor, G: List[int], lim: List[int],
                  ctx: RnsContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast base extension of the grouped digit [d]_{Q_G} to the basis `lim`
    (`keys.py:268-295`): r'_l = d_l·tilde_l mod q_l, then for each target
    limb i the sum Σ_l (r'_l mod q_i)·W[l,i] mod q_i.  As in the reference
    the sum is not corrected for its multiple of Q_G.  Returns the digit
    (len(lim), N) and r' (α, N).  Every factor is < 2^31 (d_l < 2^32), so the
    products are exact in int64 and one `%` reduces each; the Shoup
    companions of the constants are not needed."""
    tilde, W = _group_tables(ctx, G, lim)
    q = ctx.plan.tables.q
    q_lim = q[ctx.index(lim)][:, None]
    rprime = mul_mod(d_coeff[G[0]:G[-1] + 1], tilde[:, None], q[ctx.index(G)][:, None])
    terms = mul_mod(rprime[:, None, :], W[:, :, None], q_lim)       # (α, n_lim, N)
    return _sum_digits(terms, q_lim), rprime


def _group_tables(ctx: RnsContext, G: List[int], lim: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """tilde (α,) and W (α, len(lim)) of `_group_ext_consts` on the device."""
    def make():
        tilde, _, W, _ = _group_ext_consts(tuple(ctx.moduli), tuple(G), tuple(lim))
        return to_torch(tilde, ctx.device), to_torch(W, ctx.device)
    return ctx.cached(("group_ext", tuple(G), tuple(lim)), make)


def _single_moduli(moduli: tuple, limbs: tuple, lim: tuple) -> np.ndarray:
    """(len(limbs), len(lim)) moduli that extend the single-limb digit of limb
    l to limb i of `lim`: q_i where the reference reduces (`keys.py:255-263`),
    2^32 where it passes the word through (i == l or q_i > q_l), so that one
    broadcast `%` of words below 2^32 gives the reference's digits, also for
    a word at or above q_l."""
    return np.array([[1 << 32 if i == l or moduli[i] > moduli[l] else moduli[i] for i in lim]
                     for l in limbs], dtype=np.int64)


def digit_basis(level: int, ctx: RnsContext, n_ct_limbs: int, dnum: Optional[int] = None,
                targets: Optional[Sequence[int]] = None) -> tuple:
    """The layout `compute_digits` decomposes into: ([(group index, its active
    limbs)], the used group indices, the lim basis: the target limbs, then
    the special limbs)."""
    L = n_ct_limbs
    active = level + 1
    lim = (list(range(active)) if targets is None else list(targets)) + list(range(L, len(ctx.moduli)))
    groups = [(gi, G) for gi, grp in enumerate(_digit_groups(L, L if dnum is None else dnum))
              if (G := [l for l in grp if l < active])]
    return groups, [gi for gi, _ in groups], lim


def compute_digits(d_coeff: torch.Tensor, level: int, ctx: RnsContext,
                   n_ct_limbs: int, dnum: Optional[int] = None,
                   with_ecc: bool = False,
                   targets: Optional[Sequence[int]] = None) -> tuple:
    """Digit decomposition + base extension for the hybrid keyswitch
    (`rfhe_tpu.fhe.keys.compute_digits`).  Returns (dig (n_used, n_lim, N)
    coefficient domain, used group indices, lim basis); with_ecc=True also
    refs (n_used, n_lim), the appended-checksum references Σ_N dig[g, i] mod
    q_i predicted from exact sums of the inputs, which the protected evaluator
    holds the digits against.  dnum=None means per-limb digits here.  A group
    with one active limb l extends v = d[l] to every limb of lim by one
    broadcast `%` (`_single_moduli`); a group with several active limbs takes
    the fast base extension of `_extend_group`, and its reference is
    Σ_l W[l,i]·(Σ_N r'_l mod q_i) mod q_i over the same r'.

    `targets` restricts the ciphertext limbs the digits are extended to
    (all active limbs by default; the special limbs always follow): every
    digit still reads all of d, and each target limb's row is the one the
    whole basis gives it."""
    active = level + 1
    groups, used, lim = digit_basis(level, ctx, n_ct_limbs, dnum, targets)
    q_lim = ctx.plan.tables.q[ctx.index(lim)]
    single_q = lambda limbs: ctx.cached(
        ("single", tuple(limbs), tuple(lim)),
        lambda: to_torch(_single_moduli(tuple(ctx.moduli), tuple(limbs), tuple(lim)), ctx.device))
    if all(len(G) == 1 for _, G in groups):
        # α = 1 or one active limb: the digits are limbs 0..active-1 in order
        dig = d_coeff[:active, None, :] % single_q(range(active))[:, :, None]
        if not with_ecc:
            return dig, used, lim
        return dig, used, lim, d_coeff[:active].sum(dim=-1)[:, None] % q_lim
    digits, refs = [], []
    for _, G in groups:
        if len(G) == 1:
            v = d_coeff[G[0]]
            digits.append(v[None, :] % single_q(G)[0][:, None])
            if with_ecc:
                refs.append(v.sum() % q_lim)
        else:
            dig, rprime = _extend_group(d_coeff, G, lim, ctx)
            digits.append(dig)
            if with_ecc:
                s_red = rprime.sum(dim=-1)[:, None] % q_lim                # (α, n_lim)
                refs.append((s_red * _group_tables(ctx, G, lim)[1] % q_lim).sum(dim=0) % q_lim)
    if not with_ecc:
        return torch.stack(digits), used, lim
    return torch.stack(digits), used, lim, torch.stack(refs)


def keyswitch(d_coeff: torch.Tensor, ksk: KeySwitchKey, level: int,
              ctx: RnsContext, n_ct_limbs: int, t: Optional[int] = None,
              dnum: Optional[int] = None,
              targets: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a keyswitch key to a coefficient-domain poly d (level+1, N).
    Returns (c0_delta, c1_delta) in the NTT domain over limbs 0..level
    (`rfhe_tpu.fhe.keys.keyswitch`): digits, one batched NTT, the dyadic MAC
    against the key, the digit sum, then mod-down by the special primes, last
    to first, both accumulators in one batched `drop_limb` each (t-aware in
    BGV: the mod-down keeps the message mod t).  `targets` (the active
    limbs by default) are the ciphertext limbs the result is computed for,
    (len(targets), N) each: every step after the digits is limb-local, so a
    rank of the limb-sharded evaluator computes its own limbs and the special
    ones only, from the whole d.

    Traced (`trace/spans.py`), the keyswitch is the span KEYSWITCH and its
    phases BASECONV (the digits), NTT, MULTEVK (`multevk`: the MAC against
    the key's rows and the digit sum) and MODDOWN; inside MODDOWN each
    `drop_limb` records `spans.MODDOWN_PHASES`: MD_INTT (the special limb's
    inverse NTT), MD_LIFT (`lift_to_limbs`, and BGV's t-shift), MD_NTT (δ's
    forward NTT) and MD_SCALE (`sub_mod` and `mul_mod_shoup`), read by the
    benchmark's `ks_moddown_ntt_device_ms_per_circuit` (MD_INTT + MD_NTT)
    and `ks_moddown_residue_device_ms_per_circuit` (MD_LIFT + MD_SCALE)."""
    L = n_ct_limbs
    sp_idx = list(range(L, len(ctx.moduli)))
    keep = list(range(level + 1)) if targets is None else list(targets)
    with spans.phases(spans.KEYSWITCH) as phase:
        phase("BASECONV")
        dig, used, lim = compute_digits(d_coeff, level, ctx, L, dnum, targets=keep)
        phase("NTT")
        sub_plan = ctx.plan.take(lim)
        dig_ntt = sub_plan.fwd(dig)
        phase("MULTEVK")
        out = multevk(dig_ntt, ksk, used, lim, ctx)
        phase("MODDOWN")
        with spans.phases() as md:
            for k_i in range(len(sp_idx) - 1, -1, -1):
                out = drop_limb(out, sp_idx[k_i], keep + sp_idx[:k_i], ctx, t, md)
    return out[0], out[1]


def multevk(dig_ntt: torch.Tensor, ksk: KeySwitchKey, used: Sequence[int],
            lim: Sequence[int], ctx: RnsContext) -> torch.Tensor:
    """MULTEVK: the digits (n_used, len(lim), N) in the NTT domain against
    the key's rows, summed over the digits, for b then a: (2, len(lim), N),
    out[p, i] = Σ_d dig_ntt[d, i]·key_p[used[d], row of lim[i]]·R⁻¹ mod q_i.
    On the card one launch of `rfhe_ks_mac_kernel` (`ntt_cuda.ks_mac`), which
    reads the key's rows in place; on the CPU `multevk_plain`.  Both give the
    same words for digit words below 2^32 and key words below q (the keys'
    are), `mont_mul`'s domain."""
    if dig_ntt.device.type != "cuda":
        return multevk_plain(dig_ntt, ksk, used, lim, ctx)
    rows = ksk.rows(lim)
    if max(used) >= ksk.b.shape[0]:
        raise ValueError(f"digits {list(used)} of a key with {ksk.b.shape[0]}")
    table = ctx.cached(("ks_mac", tuple(used), tuple(rows), tuple(lim)),
                       lambda: _mac_table(ctx, used, rows, lim))
    return ntt_cuda.ks_mac(dig_ntt, ksk.b, ksk.a, table)


def multevk_plain(dig_ntt: torch.Tensor, ksk: KeySwitchKey, used: Sequence[int],
                  lim: Sequence[int], ctx: RnsContext) -> torch.Tensor:
    """`multevk` in plain PyTorch: the key's rows gathered, `mont_mul`, then
    `_sum_digits`, per key component."""
    key_idx, used_idx = ctx.index(ksk.rows(lim)), ctx.index(used)
    sub_plan = ctx.plan.take(lim)
    q, rinv = sub_plan.qb(1), sub_plan.rinvb(1)
    return torch.stack([
        _sum_digits(mont_mul(dig_ntt, k.index_select(0, used_idx).index_select(1, key_idx),
                             q, rinv), q)
        for k in (ksk.b, ksk.a)])


def _mac_table(ctx: RnsContext, used: Sequence[int], rows: Sequence[int],
               lim: Sequence[int]) -> torch.Tensor:
    """`ntt_cuda.ks_mac`'s table on the device: the key row of each limb of
    `lim`, its q, -q⁻¹ mod 2^32, then the key digit of each digit."""
    moduli = [ctx.moduli[l] for l in lim]
    words = (list(rows) + moduli + [montgomery_constants(q)[1] for q in moduli]
             + list(used))
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32)).to(ctx.device)


def _sum_digits(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Sum over the digit axis (axis 0) mod q.  The reference tree-sums with
    add_mod; a modular sum is exact in any order, and ≤ 2^32 terms < 2^31
    fit int64, so one sum and one `%` give the same residues."""
    return t.sum(dim=0) % q
