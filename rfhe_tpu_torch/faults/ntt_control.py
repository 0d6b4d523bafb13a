"""The standard-NTT control campaign: a radix-2 NTT protected only by the
bucketed lazy-reduction checker and a global ABFT projection, every trial at
once.

Counterpart of `rfhe_tpu/faults/ntt_control.py`, which writes one trial for a
single (n,) vector and runs the campaign as `jax.jit(jax.vmap(trial))`.  Here
the trial axis goes through the stages (as in `faults/campaign.py`): x is
(T, n), the keys (T, 2), and a fault's op index or storage stage is a
per-trial `torch.where` mask.  The draws are the reference's (`prng`, made for
every trial whatever it picks; the (T, n) input and projection vectors on the
device, `prng.randint_on`), so the result dicts equal the reference's.

  LazyChecker  √n buckets (a power of two) accumulate, per stage, the
               butterfly products actually written and the ones recomputed
               true, keyed by op index mod B; a fault at a multiply
               desynchronises its bucket, a storage fault between stages does
               not (the true side recomputes from the corrupted state)
  Global ABFT  <w, y> == <bitrev(NTT(bitrev(w))), x>, which catches any
               corruption but with probability 1/q

Scenarios (the reference's table): SBF, DBF, MLF and the two-fault combos at
distinct ops; DELTA (add δ mod q) builds bucket cancellations in tests.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import prng
from ..ops.modarith import add_mod, mul_mod_shoup, sub_mod
from ..ops.modring import ModArith
from ..ops.ntt_stacked import Radix2NttPlan, bit_reverse_indices, ntt
from .inject import (CODE_DBF, CODE_DELTA, CODE_MLF, CODE_NONE, CODE_SBF, inject_kind,
                     inject_value, sample_distinct_indices)

KIND_NONE, KIND_SBF, KIND_DBF, KIND_MLF, KIND_DELTA = (
    CODE_NONE, CODE_SBF, CODE_DBF, CODE_MLF, CODE_DELTA)

KIND_CODES = {"SBF": KIND_SBF, "DBF": KIND_DBF, "MLF": KIND_MLF, "DELTA": KIND_DELTA}

#: the reference's scenario table (non_four_step_ntt_sim.cpp:265-269)
SCENARIOS: Dict[str, Tuple[str, ...]] = {
    "SBF": ("SBF",), "DBF": ("DBF",), "MLF": ("MLF",),
    "SBF+SBF": ("SBF", "SBF"), "SBF+DBF": ("SBF", "DBF"),
    "MLF+SBF": ("MLF", "SBF"), "MLF+DBF": ("MLF", "DBF"),
    "MLF+MLF": ("MLF", "MLF"),
}


def lazy_num_buckets(n: int) -> int:
    """The largest power of two <= √n, at most n/2 (every bucket sees an op
    of every stage)."""
    b = 1 << ((n.bit_length() - 1) // 2)
    return max(1, min(b, n // 2))


def _fold_buckets(v_flat: torch.Tensor, B: int, q: int) -> torch.Tensor:
    """Σ over the ops with the same index mod B, (T, ops) -> (T, B) mod q.
    The words are residues, so the exact sum mod q is the reference's tree of
    add_mods."""
    return v_flat.reshape(v_flat.shape[0], -1, B).sum(dim=1) % q


def ntt_standard_lazy(x: torch.Tensor, plan: Radix2NttPlan, keys: np.ndarray,
                      mult_ops=None, mult_kinds=None, mult_deltas=None,
                      storage_stages=None, storage_kind: str = "SBF"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The standard DIF NTT of each trial's (n,) vector, x (T, n), with the
    bucketed lazy checker threaded through every butterfly multiply.

    mult_ops (T, F): fault f corrupts the product of global butterfly op
    mult_ops[:, f] (block-major within a stage, stages concatenated; -1
    disables) with kind code mult_kinds[f] and, for DELTA, mult_deltas[f].  storage_stages (T, G): a `storage_kind` fault is written
    into the working array at stage g's index (-1 the input, s after stage
    s).  keys (T, 2) host keys.  Returns (y (T, n), lazy_ok (T,)), the
    computed bucket verification."""
    n, q = plan.n, plan.q
    T = x.shape[0]
    log_n = n.bit_length() - 1
    hops = n // 2
    bits = q.bit_length()
    B = lazy_num_buckets(n)
    if tuple(x.shape) != (T, n) or np.shape(keys) != (T, 2):
        raise ValueError(f"expected x (T, {n}) and keys (T, 2), got {tuple(x.shape)}, "
                         f"{np.shape(keys)}")
    dev = x.device
    F = 0 if mult_ops is None else int(np.shape(mult_ops)[1])
    G = 0 if storage_stages is None else int(np.shape(storage_stages)[1])
    ks = prng.split(keys, max(1, F + G))
    ops = torch.as_tensor(np.asarray(mult_ops, dtype=np.int64), device=dev) if F else None
    stages = torch.as_tensor(np.asarray(storage_stages, dtype=np.int64), device=dev) if G else None

    def store(x, s):
        for g in range(G):
            hit = (stages[:, g] == s)[:, None]
            x = torch.where(hit, inject_kind(storage_kind, ks[:, F + g], x, q, bits), x)
        return x

    bucket_out = torch.zeros((T, B), dtype=torch.int64, device=dev)
    bucket_ref = torch.zeros_like(bucket_out)
    x = store(x, -1)
    lanes = torch.arange(hops, device=dev)
    for s in range(log_n):
        m = n >> s
        xr = x.reshape(T, n // m, m)
        a, b = xr[..., :m // 2], xr[..., m // 2:]
        w, ws = plan.stage_w(s)
        v_true = mul_mod_shoup(sub_mod(a, b, q), w, ws, q).reshape(T, hops)
        v = v_true
        for f in range(F):
            local = ops[:, f] - s * hops
            in_stage = (local >= 0) & (local < hops)
            lc = local.clamp(0, hops - 1)
            delta = 0 if mult_deltas is None else int(mult_deltas[f])
            newv = inject_value(torch.gather(v, 1, lc[:, None])[:, 0], int(mult_kinds[f]),
                                ks[:, f], q, bits, delta=delta)
            v = torch.where(in_stage[:, None] & (lanes == lc[:, None]), newv[:, None], v)
        bucket_out = add_mod(bucket_out, _fold_buckets(v, B, q), q)
        bucket_ref = add_mod(bucket_ref, _fold_buckets(v_true, B, q), q)
        x = store(torch.cat([add_mod(a, b, q), v.reshape(T, n // m, m // 2)], dim=-1).reshape(T, n), s)
    return x, (bucket_out == bucket_ref).all(dim=-1)


def abft_global_check(x: torch.Tensor, y: torch.Tensor, plan: Radix2NttPlan, arith: ModArith,
                      keys: np.ndarray) -> torch.Tensor:
    """<w, y> == <(W·P)w, x> per trial, with P the bit reversal of the DIF
    output: (W·P)w = bitrev(NTT(bitrev(w))), W being symmetric."""
    rev = torch.from_numpy(bit_reverse_indices(plan.n)).to(x.device)
    w = prng.randint_on(keys, (plan.n,), 0, plan.q, x.device)
    w_hat = ntt(w[:, rev], plan)[:, rev]
    return arith.dot(w_hat, x) == arith.dot(w, y)


def standard_ntt_campaign(scenario: str, target: str, trials: int, n: int, q: int,
                          seed: int = 42, device: str = "cuda") -> Dict:
    """The Monte-Carlo control campaign (`rfhe_tpu.faults.ntt_control.
    standard_ntt_campaign`): target 'mult' puts the scenario's faults at
    distinct butterfly multiplies, 'storage' writes them into the array at
    random stages; detection is the computed bucket state and the ABFT
    projection."""
    kinds = SCENARIOS[scenario]
    dev = torch.device(device)
    plan = Radix2NttPlan.make(n, q, dev)
    arith = ModArith.make(q)
    log_n = n.bit_length() - 1
    keys = prng.split(prng.PRNGKey(seed), trials)
    ks = prng.split(keys, 4)
    x = prng.randint_on(ks[:, 0], (n,), 0, q, dev)
    y_clean = ntt(x, plan)
    if target == "mult":
        ops = sample_distinct_indices(ks[:, 1], len(kinds), (n // 2) * log_n)
        y, lazy_ok = ntt_standard_lazy(x, plan, ks[:, 2], mult_ops=ops,
                                       mult_kinds=[KIND_CODES[k] for k in kinds])
    else:
        stages = prng.randint(ks[:, 1], (len(kinds),), -1, log_n)
        y, lazy_ok = ntt_standard_lazy(x, plan, ks[:, 2], storage_stages=stages,
                                       storage_kind=kinds[0])
    abft_ok = abft_global_check(x, y, plan, arith, ks[:, 3])
    harmful = (y != y_clean).any(dim=-1).cpu().numpy()
    lazy = (~lazy_ok).cpu().numpy()
    abft = (~abft_ok).cpu().numpy()
    det = lazy | abft
    return {
        "scenario": scenario,
        "target": target,
        "miss_rate": float((harmful & ~det).sum() / max(1, harmful.sum())),
        "det_rate": float((harmful & det).sum() / max(1, harmful.sum())),
        "harmful": int(harmful.sum()),
        "lazy_catch": int((harmful & lazy).sum()),
        "abft_catch": int((harmful & abft & ~lazy).sum()),
        "abft_only_miss": float((harmful & ~abft).sum() / max(1, harmful.sum())),
    }
