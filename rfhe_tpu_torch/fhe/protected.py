"""Protected CKKS and BGV evaluators: ABFT detectors on the keyswitch the
plain evaluators run.

Counterpart of `rfhe_tpu/fhe/protected.py`.  Every linear span of the
keyswitch is verified by modular dots against probes built once through the
span's transpose (`protect/ntt_guard.py`), so a check costs O(n) reductions
beside the transforms it covers:

  permute    <φ, c0∘σ> == <φ∘σ⁻¹, c0>: the probe is permuted at build time
  intt       <φ, d> == <(M⁻ᵀφ)∘σ⁻¹, c1>: the c1 permutation and the inverse
             NTT in two dots
  baseconv   the digits' appended checksum, predicted from exact sums of the
             inputs (`keys.compute_digits(with_ecc=True)`, the plain path's
             digit code)
  ks_core    one projection through digits → NTT → ⊙key → Σ_digits: with
             k_c = k_b + ρ∘k_a (random ρ per limb folds both accumulators
             into one check), <φ, acc_0 + ρ∘acc_1> == Σ_j <V_j, dig_j>, V_j
             the transposed probe of φ∘k_cj, built once per (key, level)
  md_intt / md_lift / md_proj / md_range
             the mod-down by each special prime: the guard on the special
             limb's inverse NTT, the centered lift's exact checksum
             (Σ δ_i == S − q_src·n_over mod q_i; in BGV also minus
             q_src·(S_r − t·n_r_over) for the t-correction r), the
             composite projection <φ, out> == q_src⁻¹·(<φ, acc> − <Mᵀφ, δ>)
             and out ∈ [0, q)
  dyadic     the tensor product's fold check and range window
             (`protect/checks.mont_mul_checked`)

rotate (rotate_rows in BGV) / multiply_relin return the plain evaluator's
arrays bit for bit and a dict of per-phase bool flags, keyed as the
reference's (`md` for the last special prime's mod-down, `md1`, `md2`, …
for the others).  A `Fault` flips one bit of a named intermediate; the flip
campaign (`faults/evaluator_campaign.py`) sweeps them.  As in the
reference, each (op, level, fault stage) is one cached program (`_jit`, keys
("pgalois", g, level, stage) and ("pmulrelin", level, stage); a CUDA graph
on a card, `utils/jitcache.py`) whose fault location (limb, index, bit)
arrives as 0-d int64 tensors, so one program serves every trial of a stage.
The flags stay tensors until the caller reads them.  The probes are built
before the program runs and read where they lie.

MULTEVK is the plain keyswitch's `keys.multevk` in every program: on the
card one launch of `rfhe_ks_mac_kernel`, which reads the key's rows in
place and reduces by 32-bit REDC, on the CPU `multevk_plain`.  A fault
flips one of a word's 32 bits, as in the reference's uint32 words, so a
flipped digit word stays below 2^32, inside the kernel's domain.  The
`prod0` stage flips a word of digit 0's b product, which the kernel never
stores: `_prod0_flip` adds the flip's change to that word's digit sum.

Faulted words may lie at or above q.  Every consumer of a faulted word here
reduces it exactly mod q (the NTT kernels on entry, the dots' products, the
exact sums, the Shoup rescale), as the reference's do, so outputs and flags
match the reference's under every fault stage (tests/test_torch_protected.py,
tests/test_torch_protected_bgv.py).

Traced (`trace/spans.py`), a protected op opens the plain evaluator's spans
around the same work (PERMUTE and INTT; KEYSWITCH with BASECONV, NTT,
MULTEVK (the MAC kernel) and MODDOWN; each mod-down's MD_INTT, MD_LIFT,
MD_NTT and MD_SCALE), and each detector
family's check as a phase of its own right after the step it guards
(`spans.CHECK_PHASES`: CHK_PERMUTE, CHK_INTT, CHK_BASECONV, CHK_KS_CORE,
CHK_MD_INTT, CHK_MD_LIFT, CHK_MD_PROJ, CHK_MD_RANGE).  `dyadic` is computed
inside `mont_mul_checked` with the products it checks and has no phase.
Every public op counts the flags it returns (`spans.COUNTS.detector_flags`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..numth import shoup_precompute
from ..ops.modarith import add_mod, mont_mul, mul_mod_shoup, sub_mod
from ..ops.modring import sum_mod
from ..protect.checks import mont_mul_checked
from ..protect.ntt_guard import NttGuard
from ..trace import spans
from ..utils.jitcache import HoistedJit, by_reference, hoisted_jit
from . import keys
from .ckks import Ciphertext, CkksContext
from .keys import KeySwitchKey, _digit_groups, compute_digits
from .rns import RnsContext, RnsPoly, bgv_lift_residue, bgv_lift_shift, lift_to_limbs, limb_plan


@dataclass(frozen=True)
class Fault:
    """Single-bit flip into a named keyswitch intermediate: stage is one of
    c1_perm, intt_out, digits, digits_ntt, prod0, acc0, ks_out; limb, idx and
    bit are ints or 0-d tensors, bit one of a 32-bit word's."""
    stage: str
    limb: object = 0
    idx: object = 0
    bit: object = 0

    def __post_init__(self):
        if not isinstance(self.bit, torch.Tensor) and not 0 <= self.bit < 32:
            raise ValueError(f"bit {self.bit} of a 32-bit word")


def _flip2(x: torch.Tensor, limb, idx, bit) -> torch.Tensor:
    """XOR bit into element [limb, idx] of an (L, N) tensor, as a one-hot
    mask (the reference's form, `protected.py:87-100`)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None] == limb
    cols = torch.arange(x.shape[1], device=x.device)[None, :] == idx
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x ^ torch.where(rows & cols, one << bit, torch.zeros_like(one))


def _prod0_flip(acc0: torch.Tensor, dig_ntt: torch.Tensor, ksk: KeySwitchKey, used, lim,
                ctx: RnsContext, fault: Fault) -> torch.Tensor:
    """The `prod0` fault on MULTEVK's b accumulator acc0 (len(lim), N): a
    flip of word [limb, idx] of digit 0's product with the key's b row,
    which the digit sum then adds.  That product is one word's `mont_mul`
    (p), so the sum with the flipped word is acc0 + (p ^ 2^bit) - p mod q
    at that word: bit for bit the sum of the flipped products."""
    n = acc0.shape[-1]
    limb, idx, bit = (torch.as_tensor(v, device=acc0.device).reshape(1)
                      for v in (fault.limb, fault.idx, fault.bit))
    sub_plan = ctx.plan.take(lim)
    q, rinv = (v.reshape(-1).index_select(0, limb) for v in (sub_plan.qb(1), sub_plan.rinvb(1)))
    at = limb * n + idx
    row = ctx.index(ksk.rows(lim)).index_select(0, limb)
    p = mont_mul(dig_ntt[0].reshape(-1).index_select(0, at),
                 ksk.b[used[0]].reshape(-1).index_select(0, row * n + idx), q, rinv)
    word = acc0.reshape(-1).index_select(0, at) + (p ^ (torch.ones_like(p) << bit)) - p
    return acc0.reshape(-1).index_copy(0, at, word % q).reshape(acc0.shape)


def _check_set(checks, universe):
    if checks is None:
        return universe
    cs = frozenset(checks)
    bad = cs - universe
    if bad:
        raise ValueError(f"unknown detector families {sorted(bad)}; valid: {sorted(universe)}")
    return cs


def _counted(result: tuple) -> tuple:
    """A protected op's (output, flags), its flags counted in `spans.COUNTS`."""
    spans.COUNTS.detector_flags += len(result[1])
    return result


def all_ok(flags: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every flag of every phase true, as a 0-d bool tensor."""
    return torch.stack([torch.all(v) for v in flags.values()]).all()


@by_reference
@dataclass(frozen=True)
class KsProbe:
    """The keyswitch-core projection of one (key, level): the transposed
    probes V_j = Mᵀ(φ∘k_cj∘R⁻¹) per digit and active limb, and the per-limb
    scalars ρ that combine the two accumulators (with Shoup companions).  V
    is held in the normal domain (the reference's Montgomery V times R⁻¹),
    so the check's dot is one product and one reduction."""
    V: torch.Tensor           # (n_used, n_lim, n)
    rho: torch.Tensor         # (n_lim,)
    rho_shoup: torch.Tensor   # (n_lim,)


class ProtectedCkks:
    """Detector-instrumented evaluator over an existing CkksContext."""

    #: detector families; a subset via `checks=` for ablation
    ALL_CHECKS = frozenset({"permute", "intt", "baseconv", "ks_core", "md_intt", "md_lift",
                            "md_proj", "md_range", "dyadic"})
    #: t of the t-aware mod-down (BGV); None in CKKS
    _ks_t: Optional[int] = None

    def __init__(self, ckks: CkksContext, checks=None):
        self.ckks = ckks
        self.guard = NttGuard.make(ckks.ctx.plan)
        self._probes: Dict = {}
        self._jits: Dict = {}
        self.checks = _check_set(checks, self.ALL_CHECKS)

    def _on(self, name: str) -> bool:
        return name in self.checks

    def _jit(self, name, fn) -> HoistedJit:
        """One cached program per (op, level, stage), in the graph pool of
        the evaluator's context."""
        if name not in self._jits:
            self._jits[name] = hoisted_jit(fn, self.ckks._graphs, name)
        return self._jits[name]

    def _location(self, fault: Fault) -> tuple:
        """The fault's (limb, idx, bit) as 0-d int64 tensors on the device:
        arguments of the stage's program, never baked into it."""
        dev = self.ckks.ctx.device
        return tuple(v if isinstance(v, torch.Tensor) else
                     torch.tensor(int(v), dtype=torch.int64, device=dev)
                     for v in (fault.limb, fault.idx, fault.bit))

    # -- probes (once per key and level, cached) ---------------------------
    def _active_basis(self, level: int):
        ckks, ctx = self.ckks, self.ckks.ctx
        L = ckks.L
        sp_idx = list(range(L, len(ctx.moduli)))
        active = level + 1
        groups = _digit_groups(L, ckks.dnum if ckks.dnum is not None else L)
        used = [gi for gi, grp in enumerate(groups) if any(l < active for l in grp)]
        return used, list(range(active)) + sp_idx, sp_idx

    def _ks_probe(self, ksk, level: int, salt: int) -> KsProbe:
        """Build (or fetch) the keyswitch-core probe of this key and level.  ρ
        comes from a numpy seed of (salt, level), the reference's."""
        key = (id(ksk.b), level)
        hit = self._probes.get(key)
        if hit is not None:
            return hit
        ctx = self.ckks.ctx
        used, lim, _ = self._active_basis(level)
        sub_plan = ctx.plan.take(lim)
        g_sub = self.guard.take(lim)
        qb, rinvb = sub_plan.qb(1), sub_plan.rinvb(1)
        lim_idx, used_idx = ctx.index(lim), ctx.index(used)
        kb = ksk.b.index_select(0, used_idx).index_select(1, lim_idx)
        ka = ksk.a.index_select(0, used_idx).index_select(1, lim_idx)
        qs = [int(ctx.moduli[i]) for i in lim]
        rng = np.random.default_rng((0xA5F0_0D00 + salt) * 2654435761 % (1 << 63) + level)
        rho = [int(rng.integers(1, q)) for q in qs]
        rho_s = [shoup_precompute(r, q) for r, q in zip(rho, qs)]
        as_col = lambda v: torch.tensor(v, dtype=torch.int64, device=ctx.device)
        rho_t, rho_s_t = as_col(rho), as_col(rho_s)
        kc = add_mod(kb, mul_mod_shoup(ka, rho_t[:, None], rho_s_t[:, None], qb), qb)
        w = mont_mul(g_sub.phi_mont, kc, qb, rinvb)                 # φ∘k_c, stored
        del kb, ka, kc
        V = g_sub.transpose_probe(sub_plan, w) * rinvb % qb
        probe = KsProbe(V=V, rho=rho_t, rho_shoup=rho_s_t)
        self._probes[key] = probe
        return probe

    def _perm_probe(self, g: int, active: int):
        """(σ, φ∘σ⁻¹, (M⁻ᵀφ)∘σ⁻¹) for automorphism g at `active` limbs, in
        the normal domain."""
        key = ("perm", g, active)
        hit = self._probes.get(key)
        if hit is not None:
            return hit
        ctx = self.ckks.ctx
        perm = ctx.galois_perm_t(g)
        perm_inv = torch.empty_like(perm)
        perm_inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        entry = (perm, self.guard.phi[:active].index_select(-1, perm_inv),
                 self.guard.vi[:active].index_select(-1, perm_inv))
        self._probes[key] = entry
        return entry

    # -- the protected keyswitch -------------------------------------------
    def _keyswitch_protected(self, d: torch.Tensor, level: int, ksk: KeySwitchKey,
                             probe: KsProbe, flags: Dict,
                             fault: Optional[Fault]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The hybrid keyswitch of `keys.keyswitch` with its detectors: the
        digits with their appended checksum, the KS-core projection over
        digits → NTT → ⊙key → Σ, and the guarded mod-down by each special
        prime, last to first.  MULTEVK is `keys.multevk` (one launch of
        `rfhe_ks_mac_kernel` on the card, reading the key's rows in place);
        a `prod0` fault is added to its b sum (`_prod0_flip`).  Traced, it
        opens the plain keyswitch's span and phases around the same work,
        and each check as the phase after the step it guards
        (`spans.CHECK_PHASES`)."""
        ctx, L = self.ckks.ctx, self.ckks.L
        sp_idx = list(range(L, len(ctx.moduli)))
        active = level + 1
        on_ecc = self._on("baseconv")
        with spans.phases(spans.KEYSWITCH) as phase:
            phase("BASECONV")
            if on_ecc:
                dig, used, lim, refs = compute_digits(d, level, ctx, L, self.ckks.dnum,
                                                      with_ecc=True)
            else:
                dig, used, lim = compute_digits(d, level, ctx, L, self.ckks.dnum)
            if fault is not None and fault.stage == "digits":
                dig = torch.cat((_flip2(dig[0], fault.limb, fault.idx, fault.bit)[None],
                                 dig[1:]))
            sub_plan = ctx.plan.take(lim)
            q1 = sub_plan.q_arr
            if on_ecc:
                phase("CHK_BASECONV")
                flags["baseconv"] = sum_mod(dig, q1, axis=-1) == refs
            phase("NTT")
            g_sub = self.guard.take(lim)
            dig_ntt = sub_plan.fwd(dig)
            if fault is not None and fault.stage == "digits_ntt":
                dig_ntt = torch.cat((_flip2(dig_ntt[0], fault.limb, fault.idx, fault.bit)[None],
                                     dig_ntt[1:]))
            phase("MULTEVK")
            acc = keys.multevk(dig_ntt, ksk, used, lim, ctx)
            if fault is not None and fault.stage == "prod0":
                acc = torch.stack((_prod0_flip(acc[0], dig_ntt, ksk, used, lim, ctx, fault),
                                   acc[1]))
            if fault is not None and fault.stage == "acc0":
                acc = torch.stack((_flip2(acc[0], fault.limb, fault.idx, fault.bit), acc[1]))
            # KS CORE: the accumulators (as stored, faulted or not) against
            # the digits through the transposed probe
            if self._on("ks_core"):
                phase("CHK_KS_CORE")
                la = g_sub.dot(g_sub.phi, acc[0])
                lb = g_sub.dot(g_sub.phi, acc[1])
                lhs = add_mod(la, mul_mod_shoup(lb, probe.rho, probe.rho_shoup, q1), q1)
                rhs = sum_mod(g_sub.dot(probe.V, dig), q1, axis=0)
                flags["ks_core"] = lhs == rhs
            phase("MODDOWN")
            with spans.phases() as md:
                for k_i in range(len(sp_idx) - 1, -1, -1):
                    keep = list(range(active)) + sp_idx[:k_i]
                    acc = self._drop_limb_protected(acc, sp_idx[k_i], keep, flags,
                                                    f"md{k_i}" if k_i else "md", self._ks_t, md)
        if fault is not None and fault.stage == "ks_out":
            acc = torch.stack((_flip2(acc[0], fault.limb, fault.idx, fault.bit), acc[1]))
        return acc[0], acc[1]

    def _drop_limb_protected(self, data: torch.Tensor, src_k: int, keep, flags: Dict,
                             tag: str, t: Optional[int] = None,
                             phase: Callable[[str], None] = spans.OFF) -> torch.Tensor:
        """`rns.drop_limb` with the guard on the special limb's inverse NTT,
        the centered lift's checksum and the composite rescale projection;
        data (..., nk+1, N).  t given (BGV): δ also takes the t-correction
        q_src·[r]_c, and the checksum tracks both exact sums
        (`protected.py:338-385`).  The lift checksum is vectorized over the
        kept limbs (the reference loops over them, which jit fuses).
        `phase` (a `spans.phases` of the caller's) is called with each of
        `spans.MODDOWN_PHASES` as its step begins, and with each check's
        phase (CHK_MD_INTT, CHK_MD_LIFT, CHK_MD_PROJ, CHK_MD_RANGE) after
        the step it guards."""
        ctx = self.ckks.ctx
        nk = len(keep)
        phase("MD_INTT")
        src_in = data[..., nk:nk + 1, :].contiguous()
        src_row = limb_plan(ctx, src_k).inv(src_in)
        if self._on("md_intt"):
            phase("CHK_MD_INTT")
            flags[f"{tag}_intt"] = self.guard.take([src_k]).check_inv(src_in, src_row)
        phase("MD_LIFT")
        ck = src_row[..., 0, :]
        q_src = ctx.moduli[src_k]
        delta = lift_to_limbs(ck, src_k, keep, ctx, centered=True)
        keep_plan = ctx.plan.take(keep)
        q_keep = keep_plan.q_arr
        qk_mod, inv_k, inv_k_s = ctx.cached(
            ("drop", src_k, tuple(keep)),
            lambda: tuple(tab[src_k].index_select(0, ctx.index(keep))
                          for tab in (ctx.qk_mod, ctx.qk_inv, ctx.qk_inv_shoup)))
        q_lo = q_keep[:, None]
        if t is not None:
            r = bgv_lift_residue(ck, q_src, t)
            delta = sub_mod(delta, bgv_lift_shift(r, src_k, keep, t, ctx), q_lo)
        if self._on("md_lift"):
            phase("CHK_MD_LIFT")
            # Σ δ_i == (S − q_src·n_over) mod q_i, S the exact sum of ck
            s = ck.sum(dim=-1, keepdim=True)
            n_over = (ck > q_src // 2).sum(dim=-1, keepdim=True)
            corr = qk_mod * (n_over % q_keep) % q_keep
            want = sub_mod(s % q_keep, corr, q_keep)
            if t is not None:
                # − q_src·(S_r − t·n_r_over), S_r the exact sum of r
                s_r = r.sum(dim=-1, keepdim=True) % q_keep
                n_r = (r > t // 2).sum(dim=-1, keepdim=True) % q_keep
                s_rc = sub_mod(s_r, t % q_keep * n_r % q_keep, q_keep)
                want = sub_mod(want, qk_mod * s_rc % q_keep, q_keep)
            flags[f"{tag}_lift"] = sum_mod(delta, q_keep, axis=-1) == want
        phase("MD_NTT")
        delta_ntt = keep_plan.fwd(delta)
        phase("MD_SCALE")
        num = sub_mod(data[..., :nk, :], delta_ntt, q_lo)
        out = mul_mod_shoup(num, inv_k[:, None], inv_k_s[:, None], q_lo)
        if self._on("md_proj"):
            phase("CHK_MD_PROJ")
            g_keep = self.guard.take(keep)
            pa = g_keep.dot(g_keep.phi, data[..., :nk, :])
            pd = g_keep.dot(g_keep.vf, delta)
            po = g_keep.dot(g_keep.phi, out)
            want = mul_mod_shoup(sub_mod(pa, pd, q_keep), inv_k, inv_k_s, q_keep)
            flags[f"{tag}_proj"] = po == want
        if self._on("md_range"):
            phase("CHK_MD_RANGE")
            flags[f"{tag}_range"] = torch.all(out < q_lo)
        return out

    # -- public protected ops ----------------------------------------------
    def _galois_impl(self, ct: Ciphertext, ksk, g: int, level: int, fault: Optional[Fault],
                     probe: Optional[KsProbe] = None, perm_probe=None):
        ctx = self.ckks.ctx
        flags: Dict[str, torch.Tensor] = {}
        active = level + 1
        perm, phi_pi, vi_pi = perm_probe or self._perm_probe(g, active)
        if probe is None:
            probe = self._probes[(id(ksk.b), level)]
        plan = ctx.plan.slice(active)
        g_act = self.guard.slice(active)
        c0, c1 = ct.c[0].data, ct.c[1].data
        with spans.phases() as phase:                   # traced: trace/spans.py
            phase("PERMUTE")
            c0g = c0.index_select(-1, perm)
            c1g = c1.index_select(-1, perm)
            if self._on("permute"):
                phase("CHK_PERMUTE")
                flags["permute"] = g_act.dot(g_act.phi, c0g) == g_act.dot(phi_pi, c0)
            if fault is not None and fault.stage == "c1_perm":
                c1g = _flip2(c1g, fault.limb, fault.idx, fault.bit)
            phase("INTT")
            d = plan.inv(c1g)
            if fault is not None and fault.stage == "intt_out":
                d = _flip2(d, fault.limb, fault.idx, fault.bit)
            if self._on("intt"):
                phase("CHK_INTT")
                flags["intt"] = g_act.dot(g_act.phi, d) == g_act.dot(vi_pi, c1)
        k0, k1 = self._keyswitch_protected(d, level, ksk, probe, flags, fault)
        c0_out = add_mod(c0g, k0, plan.qb(1))
        return Ciphertext([RnsPoly(c0_out, True), RnsPoly(k1, True)], ct.scale,
                          ct.correction), flags

    def apply_galois(self, ct: Ciphertext, g: int,
                     fault: Optional[Fault] = None) -> Tuple[Ciphertext, Dict]:
        assert ct.size == 2
        ksk = self.ckks.galois_key(g)
        lvl = ct.level
        probe = self._ks_probe(ksk, lvl, salt=g)         # built before the program
        pp = self._perm_probe(g, lvl + 1)
        key = ("pgalois", g, lvl, fault.stage if fault else None)
        if fault is None:
            return _counted(self._jit(key, lambda c, k, pr: self._galois_impl(
                c, k, g, lvl, None, pr, pp))(ct, ksk, probe))
        stage = fault.stage
        return _counted(self._jit(key, lambda c, k, pr, li, ix, bi: self._galois_impl(
            c, k, g, lvl, Fault(stage, li, ix, bi), pr, pp))(ct, ksk, probe,
                                                              *self._location(fault)))

    def rotate(self, ct: Ciphertext, r: int,
               fault: Optional[Fault] = None) -> Tuple[Ciphertext, Dict]:
        return self.apply_galois(ct, self.ckks.rotation_galois_element(r), fault)

    def _mul_relin_impl(self, ac, bc, rlk: KeySwitchKey, probe: KsProbe, level: int, scale,
                        fault: Optional[Fault], correction: int = 1):
        """Tensor product (checked dyadic products) + protected relin.
        ac/bc: [c0, c1] data tensors; rlk: the relin key."""
        plan = self.ckks.ctx.plan.slice(level + 1)
        qb, rinvb = plan.qb(1), plan.rinvb(1)
        flags: Dict[str, torch.Tensor] = {}
        prods, oks = [], []
        for x, y in ((ac[0], bc[0]), (ac[0], bc[1]), (ac[1], bc[0]), (ac[1], bc[1])):
            if self._on("dyadic"):
                p, ok = mont_mul_checked(x, y, qb, rinvb)
                oks.append(torch.all(ok))
            else:
                p = mont_mul(x, y, qb, rinvb)
            prods.append(p)
        if oks:
            flags["dyadic"] = torch.stack(oks)
        d0, d1, d2 = prods[0], add_mod(prods[1], prods[2], qb), prods[3]
        with spans.phases() as phase:
            phase("INTT")
            d2c = plan.inv(d2)
            if fault is not None and fault.stage == "intt_out":
                d2c = _flip2(d2c, fault.limb, fault.idx, fault.bit)
            if self._on("intt"):
                phase("CHK_INTT")
                flags["intt"] = self.guard.slice(level + 1).check_inv(d2, d2c)
        k0, k1 = self._keyswitch_protected(d2c, level, rlk, probe, flags, fault)
        c0, c1 = add_mod(d0, k0, qb), add_mod(d1, k1, qb)
        return Ciphertext([RnsPoly(c0, True), RnsPoly(c1, True)], scale, correction), flags

    def multiply_relin(self, a: Ciphertext, b: Ciphertext,
                       fault: Optional[Fault] = None) -> Tuple[Ciphertext, Dict]:
        assert a.size == 2 and b.size == 2 and a.level == b.level
        rlk = self.ckks.rlk
        lvl = a.level
        probe = self._ks_probe(rlk, lvl, salt=-1)
        key = ("pmulrelin", lvl, fault.stage if fault else None)

        def run(a, b, k, pr, fault):
            corr = a.correction * b.correction % self._ks_t if self._ks_t else 1
            return self._mul_relin_impl([c.data for c in a.c], [c.data for c in b.c], k, pr,
                                        lvl, a.scale * b.scale, fault, corr)

        if fault is None:
            return _counted(self._jit(key, lambda a, b, k, pr: run(a, b, k, pr, None))(
                a, b, rlk, probe))
        stage = fault.stage
        return _counted(self._jit(key, lambda a, b, k, pr, li, ix, bi: run(
            a, b, k, pr, Fault(stage, li, ix, bi)))(a, b, rlk, probe, *self._location(fault)))


class ProtectedBgv(ProtectedCkks):
    """The protected evaluator over a BgvContext (`protected.py:551-571`):
    the same protected keyswitch with the t-aware mod-down, and the
    decryption correction carried as `fhe/bgv.py` carries it.  rotate_rows
    and multiply_relin give BgvContext's arrays bit for bit."""

    def __init__(self, bgv, checks=None):
        super().__init__(bgv, checks)
        self._ks_t = bgv.t

    def rotate_rows(self, ct: Ciphertext, r: int,
                    fault: Optional[Fault] = None) -> Tuple[Ciphertext, Dict]:
        return self.apply_galois(ct, self.ckks.rotation_galois_element(r), fault)
