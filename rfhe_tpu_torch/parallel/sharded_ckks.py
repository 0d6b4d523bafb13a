"""The CKKS evaluator on a limb-sharded ciphertext.

In the reference a ciphertext placed over the mesh's "limb" axis
(`rfhe_tpu/parallel/mesh.py:shard_ciphertext`) runs every `CkksContext` op
under jit, and XLA inserts the collectives.  Here they are written out.
Most of an op is limb-local: slot permutations, dyadic products, and the
NTTs of a rank's own limbs (the hand kernels K1 and K2 on the card).  Two
steps cross limbs:

  keyswitch   every digit reads every limb of the coefficient-domain input.
              One all_gather of those coefficients, (level+1, N) words; then
              each rank extends the digits to its own limbs and the special
              ones only (`fhe.keys.keyswitch(targets=...)`), and the MAC
              against its rows of the key, the digit sum and the mod-down by
              the special limbs stay local.  The special limbs are computed
              on every rank.  This holds for per-limb and grouped digits.
  rescale     every limb needs the dropped top limb's coefficients: its owner
              takes the inverse NTT of that row and broadcasts it.

Every rank builds its `CkksContext` from the same parameters and seed, so it
draws the reference's keys; the evaluator then keeps only the rank's rows of
each keyswitch key and the special rows (the context's copy is cut too).
Outputs stay sharded and equal, limb for limb, the unsharded context's
(tests/test_torch_sharded_evaluator.py).
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..fhe.ckks import CkksContext
from ..fhe.keys import KeySwitchKey, keyswitch
from ..fhe.rns import drop_limb_lifted, limb_plan
from ..ops.modarith import add_mod, mont_mul
from .mesh import ShardedCiphertext, axis_rank, axis_size, gather_ciphertext, gather_limbs, \
    shard_ciphertext, slab_bounds

__all__ = ["ShardedCkks"]


class ShardedCkks:
    """rotate, apply_galois, conjugate, multiply, relinearize,
    multiply_relin and rescale of a `CkksContext` on this rank's slab of a
    limb-sharded ciphertext.  Every rank of the mesh calls each op on its own
    slab, in the same order."""

    def __init__(self, ckks: CkksContext, mesh: DeviceMesh, limb_axis: str = "limb"):
        self.ckks = ckks
        self.ctx = ckks.ctx
        self.mesh = mesh
        self.axis = limb_axis
        self.group = mesh.get_group(limb_axis)
        self.coord = axis_rank(mesh, limb_axis)
        lo, hi = slab_bounds(ckks.L, axis_size(mesh, limb_axis))[self.coord]
        self.key_limbs = tuple(range(lo, hi)) + tuple(range(ckks.L, self.ctx.L))

    # -- placement ------------------------------------------------------------
    def shard(self, ct) -> ShardedCiphertext:
        """This rank's slab of a whole ciphertext, split over the chain."""
        return shard_ciphertext(ct, self.mesh, self.axis, n_limbs=self.ckks.L)

    def gather(self, sct: ShardedCiphertext):
        return gather_ciphertext(sct, self.mesh, self.axis)

    # -- keys -----------------------------------------------------------------
    def _cut(self, key: KeySwitchKey) -> KeySwitchKey:
        return key if key.limbs == self.key_limbs else key.cut(self.key_limbs)

    def galois_key(self, g: int) -> KeySwitchKey:
        """The rank's rows of the Galois key for X -> X^g, drawn by the
        context on first use (the reference's order of draws)."""
        key = self._cut(self.ckks.galois_key(g))
        self.ckks._galois[g] = key
        return key

    @property
    def rlk(self) -> KeySwitchKey:
        key = self._cut(self.ckks.rlk)
        self.ckks._rlk = key
        return key

    # -- helpers --------------------------------------------------------------
    def _q(self, limbs: List[int]):
        plan = self.ctx.plan.take(limbs)
        return plan, plan.qb(1), plan.rinvb(1)

    def _keyswitch(self, sct: ShardedCiphertext, d_local: torch.Tensor, ksk: KeySwitchKey):
        """(k0, k1) on the rank's limbs for the NTT-domain rows d_local: the
        rank's inverse NTT, the one all_gather, the local keyswitch."""
        limbs = sct.limbs
        coeff = self.ctx.plan.take(limbs).inv(d_local) if limbs else d_local
        whole = gather_limbs(coeff, sct, self.group)
        if not limbs:
            return d_local, d_local
        return keyswitch(whole, ksk, sct.level, self.ctx, self.ckks.L, dnum=self.ckks.dnum,
                         targets=limbs)

    def _like(self, sct: ShardedCiphertext, c, scale=None, level=None) -> ShardedCiphertext:
        return ShardedCiphertext(list(c), sct.scale if scale is None else scale,
                                 sct.level if level is None else level, sct.bounds, sct.coord)

    # -- evaluator ------------------------------------------------------------
    def apply_galois(self, sct: ShardedCiphertext, g: int) -> ShardedCiphertext:
        """σ_g then keyswitch σ_g(s) -> s (`CkksContext.apply_galois`)."""
        assert sct.size == 2 and sct.is_ntt
        ksk = self.galois_key(g)
        perm = self.ctx.galois_perm_t(g)
        c0g, c1g = (c.index_select(-1, perm) for c in sct.c)
        k0, k1 = self._keyswitch(sct, c1g, ksk)
        if not sct.limbs:
            return self._like(sct, (c0g, c1g))
        _, q, _ = self._q(sct.limbs)
        return self._like(sct, (add_mod(c0g, k0, q), k1))

    def rotate(self, sct: ShardedCiphertext, r: int) -> ShardedCiphertext:
        return self.apply_galois(sct, self.ckks.rotation_galois_element(r))

    def conjugate(self, sct: ShardedCiphertext) -> ShardedCiphertext:
        return self.apply_galois(sct, 2 * self.ckks.params.n - 1)

    def multiply(self, a: ShardedCiphertext, b: ShardedCiphertext) -> ShardedCiphertext:
        """Tensor product (d0, d1, d2), limb-local."""
        assert a.size == 2 and b.size == 2 and a.level == b.level and a.bounds == b.bounds
        if not a.limbs:
            return self._like(a, (a.c[0], a.c[0], a.c[0]), scale=a.scale * b.scale)
        _, q, rinv = self._q(a.limbs)
        mul = lambda x, y: mont_mul(x, y, q, rinv)
        d1 = add_mod(mul(a.c[0], b.c[1]), mul(a.c[1], b.c[0]), q)
        return self._like(a, (mul(a.c[0], b.c[0]), d1, mul(a.c[1], b.c[1])),
                          scale=a.scale * b.scale)

    def relinearize(self, sct: ShardedCiphertext) -> ShardedCiphertext:
        assert sct.size == 3
        k0, k1 = self._keyswitch(sct, sct.c[2], self.rlk)
        if not sct.limbs:
            return self._like(sct, sct.c[:2])
        _, q, _ = self._q(sct.limbs)
        return self._like(sct, (add_mod(sct.c[0], k0, q), add_mod(sct.c[1], k1, q)))

    def multiply_relin(self, a: ShardedCiphertext, b: ShardedCiphertext) -> ShardedCiphertext:
        return self.relinearize(self.multiply(a, b))

    def rescale(self, sct: ShardedCiphertext) -> ShardedCiphertext:
        """Drop the top limb (alpha of them for a composite scale): its owner
        takes the inverse NTT of its rows and broadcasts the coefficients;
        each rank divides its own limbs by it."""
        for _ in range(self.ckks.params.alpha):
            k = sct.level
            owner = sct.owner(k)
            N = self.ckks.params.n
            if sct.coord == owner:
                top = torch.stack([c[-1:] for c in sct.c])           # (comps, 1, N)
                ck = limb_plan(self.ctx, k).inv(top.contiguous())[:, 0, :].contiguous()
            else:
                ck = torch.empty((sct.size, N), dtype=torch.int64, device=self.ckks.device)
            dist.broadcast(ck, src=dist.get_global_rank(self.group, owner), group=self.group)
            lowered = self._like(sct, sct.c, scale=sct.scale / self.ckks.params.moduli[k],
                                 level=k - 1)
            keep = lowered.limbs
            kept = [c[:len(keep)] for c in sct.c]
            if keep:
                out = drop_limb_lifted(torch.stack(kept), ck, k, keep, self.ctx)
                kept = list(out)
            lowered.c = kept
            sct = lowered
        return sct
