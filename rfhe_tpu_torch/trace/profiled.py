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

Each phase is also a `torch.profiler.record_function` range, and so are the
mod-down's constituents, once per special prime (`MD_INTT` the special
limb's inverse NTT, `MD_BASECONV` its centred lift to the kept limbs,
`MD_NTT` the delta's forward NTT, `MD_MODMUL` the subtract and the scale by
q_src⁻¹): bench/phase_profile.py reads each phase's device time from one
profile as the sum of the kernels launched inside its range.  The Galois key
is drawn before the first range opens, so key generation lands in no phase.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from ..fhe.ckks import Ciphertext, CkksContext
from ..fhe.keys import _sum_digits, compute_digits
from ..fhe.rns import RnsPoly, lift_to_limbs, limb_plan
from ..ops.modarith import add_mod, mont_mul, mul_mod_shoup, sub_mod
from ..ops.ntt_pease import negacyclic_intt, negacyclic_ntt
from .markers import TraceCollector, synchronizer

PHASES = ("PERMUTE", "INTT", "BASECONV", "NTT", "MULTEVK", "MODDOWN")
MODDOWN_PARTS = ("MD_INTT", "MD_BASECONV", "MD_NTT", "MD_MODMUL")


@contextlib.contextmanager
def _part(tag: str, sync):
    """A mod-down constituent: a record_function range that ends after the
    device has finished its launches."""
    with torch.profiler.record_function(tag):
        yield
        if sync is not None:
            sync()


class ProfiledRotation:
    def __init__(self, ckks: CkksContext):
        self.ckks = ckks
        self.last_collector: Optional[TraceCollector] = None

    def _drop_limb(self, data: torch.Tensor, src_k: int, keep: List[int], sync) -> torch.Tensor:
        """`fhe.rns.drop_limb` (CKKS) in its four constituents."""
        ctx = self.ckks.ctx
        nk = len(keep)
        with _part("MD_INTT", sync):
            src_row = negacyclic_intt(data[..., nk:nk + 1, :].contiguous(), limb_plan(ctx, src_k))
        with _part("MD_BASECONV", sync):
            delta = lift_to_limbs(src_row[..., 0, :], src_k, keep, ctx, centered=True)
        with _part("MD_NTT", sync):
            delta_ntt = negacyclic_ntt(delta, ctx.plan.take(keep))
        with _part("MD_MODMUL", sync):
            keep_idx = ctx.index(keep)
            q_lo = ctx.plan.tables.q[keep_idx][:, None]
            num = sub_mod(data[..., :nk, :], delta_ntt, q_lo)
            return mul_mod_shoup(num, ctx.qk_inv[src_k, keep_idx][:, None],
                                 ctx.qk_inv_shoup[src_k, keep_idx][:, None], q_lo)

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
        with col.scope("ROTATE"):
            with col.kernel("PERMUTE", sync=dev):
                perm = ctx.galois_perm_t(g)
                c0g = ct.c[0].data.index_select(-1, perm)
                c1g = ct.c[1].data.index_select(-1, perm)
            with col.kernel("INTT", sync=dev):
                d = negacyclic_intt(c1g, ctx.plan_at(level))
            with col.kernel("BASECONV", sync=dev):
                dig, used, lim = compute_digits(d, level, ctx, ckks.L, ckks.dnum)
            with col.kernel("NTT", sync=dev):
                sub_plan = ctx.plan.take(lim)
                dig_ntt = negacyclic_ntt(dig, sub_plan)
            with col.kernel("MULTEVK", sync=dev):
                lim_idx, used_idx = ctx.index(lim), ctx.index(used)
                q, rinv = sub_plan.qb(1), sub_plan.rinvb(1)
                acc = torch.stack([
                    _sum_digits(mont_mul(dig_ntt, k.index_select(0, used_idx).index_select(1, lim_idx),
                                         q, rinv), q)
                    for k in (ksk.b, ksk.a)])
            with col.kernel("MODDOWN", sync=dev):
                for k_i in range(len(sp_idx) - 1, -1, -1):
                    acc = self._drop_limb(acc, sp_idx[k_i], list(range(active)) + sp_idx[:k_i], sync)
                c0 = add_mod(c0g, acc[0], ctx.plan_at(level).qb(1))
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
