"""The phase-decomposed profiled rotation.

Counterpart of `rfhe_tpu/trace/profiled.py`.  The reference obtains
per-kernel cost breakdowns by patching SEAL to print [NTT] / [MODREDUCTION]
/ [MULTEVK] timings inside each frontend op (build/sample.txt).  The
profiled rotation runs the same math as `CkksContext.rotate` (its arrays are
equal bit for bit), split into phases, each timed on the host clock after
the device has finished it and written in the reference's kernel-line
format:

  PERMUTE   Galois slot permutation of c0 and c1
  INTT      c1 back to the coefficient domain
  BASECONV  digit decomposition and extension to the (Q, P) basis
  NTT       forward NTTs of all digits
  MULTEVK   dyadic MAC against the key and the digit sum
  MODDOWN   divide-and-round by the special primes, and c0 + the c0 delta

These are `spans.PHASES`, the names of the spans of the main path
(`fhe/ckks.py`, `fhe/keys.py`), whose MODDOWN is the mod-down alone.

Each phase is also a `torch.profiler.record_function` range, and so are the
mod-down's constituents, once per special prime (`MD_INTT` the special
limb's inverse NTT, `MD_BASECONV` its centred lift to the kept limbs,
`MD_NTT` the delta's forward NTT, `MD_MODMUL` the subtract and the scale by
q_src⁻¹): bench/phase_profile.py reads each phase's device time from one
profile as the sum of the kernels launched inside its range.  The Galois key
is drawn before the first range opens, so key generation lands in no phase.

As the reference runs one jit program per phase (`rfhe_tpu/trace/profiled.py`),
each phase here, and each constituent of the mod-down, is one cached
program (`_jit`; a CUDA graph on a card, `utils/jitcache.py`), replayed
inside its range: the replay's kernels are launched by one graph launch
within that range, and its input copies and output clones with them.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from ..fhe.ckks import Ciphertext, CkksContext
from ..fhe.keys import _sum_digits, compute_digits, digit_basis
from ..fhe.rns import RnsPoly, lift_to_limbs, limb_plan
from ..ops.modarith import add_mod, mont_mul, mul_mod_shoup, sub_mod
from ..ops.ntt_pease import negacyclic_intt, negacyclic_ntt
from ..utils.jitcache import HoistedJit, hoisted_jit
from .markers import TraceCollector, synchronizer
from .spans import PHASES, named_range

MODDOWN_PARTS = ("MD_INTT", "MD_BASECONV", "MD_NTT", "MD_MODMUL")


@contextlib.contextmanager
def _part(tag: str, sync):
    """A mod-down constituent: a record_function range that ends after the
    device has finished its launches."""
    with named_range(tag):
        yield
        if sync is not None:
            sync()


class ProfiledRotation:
    def __init__(self, ckks: CkksContext):
        self.ckks = ckks
        self.last_collector: Optional[TraceCollector] = None
        self._jits: Dict = {}

    def _jit(self, name, fn) -> HoistedJit:
        """One cached program per phase (and level), in the graph pool of
        the context."""
        if name not in self._jits:
            self._jits[name] = hoisted_jit(fn, self.ckks._graphs, name)
        return self._jits[name]

    def _drop_limb(self, data: torch.Tensor, src_k: int, keep: List[int], level: int,
                   sync) -> torch.Tensor:
        """`fhe.rns.drop_limb` (CKKS) in its four constituents."""
        ctx = self.ckks.ctx
        nk = len(keep)
        key = (level, src_k)
        with _part("MD_INTT", sync):
            src_row = self._jit(("md_intt",) + key, lambda x: negacyclic_intt(
                x[..., nk:nk + 1, :].contiguous(), limb_plan(ctx, src_k)))(data)
        with _part("MD_BASECONV", sync):
            delta = self._jit(("md_baseconv",) + key, lambda r: lift_to_limbs(
                r[..., 0, :], src_k, keep, ctx, centered=True))(src_row)
        with _part("MD_NTT", sync):
            delta_ntt = self._jit(("md_ntt",) + key, lambda x: negacyclic_ntt(
                x, ctx.plan.take(keep)))(delta)
        with _part("MD_MODMUL", sync):
            def modmul(x, dn):
                keep_idx = ctx.index(keep)
                q_lo = ctx.plan.tables.q[keep_idx][:, None]
                num = sub_mod(x[..., :nk, :], dn, q_lo)
                return mul_mod_shoup(num, ctx.qk_inv[src_k, keep_idx][:, None],
                                     ctx.qk_inv_shoup[src_k, keep_idx][:, None], q_lo)
            return self._jit(("md_modmul",) + key, modmul)(data, delta_ntt)

    def rotate(self, ct: Ciphertext, r: int,
               collector: Optional[TraceCollector] = None) -> Ciphertext:
        ckks = self.ckks
        ctx = ckks.ctx
        col = collector if collector is not None else TraceCollector()
        dev = ctx.device
        sync = synchronizer(dev)
        g = ckks.rotation_galois_element(r)
        ksk = ckks.galois_key(g)
        level = ct.level
        active = level + 1
        sp_idx = list(range(ckks.L, len(ctx.moduli)))
        _, used, lim = digit_basis(level, ctx, ckks.L, ckks.dnum)
        sub_plan = ctx.plan.take(lim)
        with col.scope("ROTATE"):
            with col.kernel("PERMUTE", sync=dev):
                perm = ctx.galois_perm_t(g)
                c0g, c1g = self._jit(("perm", g), lambda c0, c1: (
                    c0.index_select(-1, perm), c1.index_select(-1, perm)))(
                        ct.c[0].data, ct.c[1].data)
            with col.kernel("INTT", sync=dev):
                d = self._jit(("intt", level), lambda x: negacyclic_intt(
                    x, ctx.plan_at(level)))(c1g)
            with col.kernel("BASECONV", sync=dev):
                dig = self._jit(("ext", level), lambda x: compute_digits(
                    x, level, ctx, ckks.L, ckks.dnum)[0])(d)
            with col.kernel("NTT", sync=dev):
                dig_ntt = self._jit(("ntt", level), lambda x: negacyclic_ntt(x, sub_plan))(dig)
            with col.kernel("MULTEVK", sync=dev):
                def mac(dn, k):
                    lim_idx, used_idx = ctx.index(lim), ctx.index(used)
                    q, rinv = sub_plan.qb(1), sub_plan.rinvb(1)
                    return torch.stack([
                        _sum_digits(mont_mul(dn, kk.index_select(0, used_idx)
                                             .index_select(1, lim_idx), q, rinv), q)
                        for kk in (k.b, k.a)])
                acc = self._jit(("mac", level), mac)(dig_ntt, ksk)
            with col.kernel("MODDOWN", sync=dev):
                for k_i in range(len(sp_idx) - 1, -1, -1):
                    acc = self._drop_limb(acc, sp_idx[k_i], list(range(active)) + sp_idx[:k_i],
                                          level, sync)
                c0 = self._jit(("moddown", level), lambda x, a: add_mod(
                    x, a, ctx.plan_at(level).qb(1)))(c0g, acc[0])
        self.last_collector = col
        return Ciphertext([RnsPoly(c0, True), RnsPoly(acc[1], True)], ct.scale)

    def breakdown(self) -> Dict[str, float]:
        """Phase shares of the last rotation's host times, mapped onto the
        reference's rotation categories (draw_rotation.py: NTT / ModMul /
        BaseConv / Others), as `rfhe_tpu.trace.ProfiledRotation.breakdown`."""
        tot = self.last_collector.totals()
        ntt = tot.get("NTT", 0) + tot.get("INTT", 0)
        modmul = tot.get("MULTEVK", 0)
        baseconv = tot.get("BASECONV", 0)
        others = tot.get("PERMUTE", 0) + tot.get("MODDOWN", 0)
        s = ntt + modmul + baseconv + others
        return {"NTT": ntt / s, "ModMul": modmul / s, "BaseConv": baseconv / s,
                "Others": others / s, "total_us": tot.get("ROTATE", s)}
