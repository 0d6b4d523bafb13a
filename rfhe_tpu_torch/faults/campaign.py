"""Monte-Carlo fault-injection campaigns, every trial at once.

Counterpart of `rfhe_tpu/faults/campaign.py`, which runs a campaign as
`jax.jit(jax.vmap(trial))` over `split(PRNGKey(seed), trials)`.  Here the
trial body is written over an explicit leading trial axis: no Python loop
over trials, and the number of device operations of a campaign does not
depend on the number of trials.  The keys are the reference's (`prng`), the
injectors draw for every trial whichever stage the trial picks (as under
vmap, so the key streams agree), and a trial's choice of stage is a
per-trial `torch.where`.  The result dicts equal the reference's.

  three_stage_campaign   matmul -> elementwise fold -> matmul pipeline with
                         the SCF/MCF fault taxonomy and per-stage collision
                         probabilities
  four_step_ntt_campaign the protected four-step NTT with its four layered
                         detectors and op-count-weighted stage selection
  four_step_scenario_table  every (scenario, stage) row of the reference's
                         flagship table
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .. import prng
from ..ops.matmul_mod import DigitPlan, matmul_mod
from ..ops.modarith import mod_u64, mul_mod_shoup
from ..ops.modring import ModArith
from ..protect.checks import (elementwise_fold_check, matmul_check, stage1_projection_check,
                              stage2_projection_check, twiddle_collision_model,
                              twiddle_inter_check)
from ..protect.fold import fold_u32, fold_u64, mul32_parts
from ..transform.four_step import FourStepPlan
from .inject import (SCENARIO_KINDS, inject_cle_matrix, inject_cle_vector, inject_elements,
                     inject_kind)

# ---------------------------------------------------------------------------
# 3-stage pipeline campaign (SCF / MCF taxonomy)
# ---------------------------------------------------------------------------

FAULT_TYPES = ("SCF-BF", "SCF-MBU", "MCF-PPE", "MCF-CTE", "MCF-CLE")


def _rand_mat(keys, shape, hi: int, device) -> torch.Tensor:
    return torch.from_numpy(prng.randint(keys, shape, 0, hi, np.uint32).astype(np.int64)).to(device)


def _per_trial(cond: np.ndarray, ndim: int, device) -> torch.Tensor:
    """A (T,) host bool as a tensor that broadcasts over `ndim` element axes."""
    return torch.from_numpy(np.asarray(cond)).to(device).reshape((-1,) + (1,) * ndim)


def _three_stage_trials(keys: np.ndarray, ftype: str, S: int, P: int, W: int,
                        arith: ModArith, digit: DigitPlan, device) -> Tuple[np.ndarray, np.ndarray]:
    """(stage, detected) of each trial, keys (T, 2)."""
    M = (1 << W) - 1
    bitwidth_p = P.bit_length()
    ks = prng.split(keys, 12)
    A1 = _rand_mat(ks[:, 0], (S, S), P, device)
    B1 = _rand_mat(ks[:, 1], (S, S), P, device)
    C1 = matmul_mod(A1, B1, digit)
    T = len(keys)
    X = fold_u32(C1.reshape(T, -1), W)                      # vec(C1) mod M
    Tw = _rand_mat(ks[:, 2], (S * S,), M, device)
    Y = fold_u64(*mul32_parts(X, Tw), W)                     # (X*T) mod M
    B2 = mod_u64(0, Y, P).reshape(T, S, S)
    A2 = _rand_mat(ks[:, 3], (S, S), P, device)
    C3 = matmul_mod(A2, B2, digit)

    stage = prng.randint(ks[:, 4], (), 1, 4)

    if ftype == "MCF-CLE":
        C1f = inject_cle_matrix(ks[:, 5], A1, B1, C1, arith)
        Yf = inject_cle_vector(ks[:, 6], X, Tw, Y, M)
        C3f = inject_cle_matrix(ks[:, 7], A2, B2, C3, arith)
    else:
        C1f = inject_kind(ftype, ks[:, 5], C1, P, bitwidth_p)
        Yf = inject_kind(ftype, ks[:, 6], Y, M, W)
        C3f = inject_kind(ftype, ks[:, 7], C3, P, bitwidth_p)

    C1s = torch.where(_per_trial(stage == 1, 2, device), C1f, C1)
    Ys = torch.where(_per_trial(stage == 2, 1, device), Yf, Y)
    C3s = torch.where(_per_trial(stage == 3, 2, device), C3f, C3)

    det = torch.stack([~matmul_check(A1, B1, C1s, arith),
                       ~elementwise_fold_check(X, Tw, Ys, W),
                       ~matmul_check(A2, B2, C3s, arith)], dim=-1).cpu().numpy()
    return stage, det[np.arange(T), stage - 1]


def three_stage_campaign(ftype: str, trials: int, S: int, P: int, W: int, seed: int = 42,
                         device: str = "cuda") -> Dict[str, np.ndarray]:
    """Per-stage injected counts, undetected counts and collision
    probabilities (`rfhe_tpu.faults.campaign.three_stage_campaign`)."""
    arith = ModArith.make(P)
    digit = DigitPlan(P)
    keys = prng.split(prng.PRNGKey(seed), trials)
    stages, detected = _three_stage_trials(keys, ftype, S, P, W, arith, digit,
                                           torch.device(device))
    inj = np.array([(stages == s).sum() for s in (1, 2, 3)])
    und = np.array([((stages == s) & ~detected).sum() for s in (1, 2, 3)])
    with np.errstate(invalid="ignore"):
        p = np.where(inj > 0, und / np.maximum(inj, 1), 0.0)
    return {"injected": inj, "undetected": und, "collision_prob": p}


# ---------------------------------------------------------------------------
# Protected four-step NTT campaign (SBF / DBF / MOF1 and the multi-fault rows)
# ---------------------------------------------------------------------------

def _op_counts(n1: int, n2: int) -> Tuple[int, int, int]:
    """Butterfly-multiply op counts per stage (one op per butterfly or
    twiddle multiply), which weight the sampled stage."""
    s1 = n1 * (n2 // 2) * int(math.log2(n2))
    tw = n1 * n2
    s2 = n2 * (n1 // 2) * int(math.log2(n1))
    return s1, tw, s2


def _four_step_trials(keys: np.ndarray, kind: str, plan: FourStepPlan, fold_width: int,
                      target_stage=None):
    """(stage, detected, dets) of each trial, keys (T, 2): the scenario's
    faults land in one stage, at distinct elements.  target_stage 0/1/2 pins
    the stage; None samples it weighted by `_op_counts`."""
    kind_codes = SCENARIO_KINDS[kind]
    q = plan.q
    bw = q.bit_length()
    dev = plan.W2.device
    ks = prng.split(keys, 8)
    A = _rand_mat(ks[:, 0], (plan.n,), q, dev).reshape(len(keys), plan.n2, plan.n1)

    if target_stage is None:
        s1, tw, s2 = _op_counts(plan.n1, plan.n2)
        op = prng.randint(ks[:, 1], (), 0, s1 + tw + s2)
        stage = np.where(op < s1, 0, np.where(op < s1 + tw, 1, 2))
    else:
        stage = np.full(len(keys), target_stage)

    B1 = matmul_mod(plan.W2, A, plan.digit)
    B1c = torch.where(_per_trial(stage == 0, 2, dev),
                      inject_elements(kind_codes, ks[:, 2], B1, q, bw), B1)
    B2_true = mul_mod_shoup(B1c, plan.T, plan.T_shoup, q)
    B2c = torch.where(_per_trial(stage == 1, 2, dev),
                      inject_elements(kind_codes, ks[:, 3], B2_true, q, bw), B2_true)
    Y = matmul_mod(B2c, plan.W1T, plan.digit)
    Yc = torch.where(_per_trial(stage == 2, 2, dev),
                     inject_elements(kind_codes, ks[:, 4], Y, q, bw), Y)

    ok_b1 = stage1_projection_check(A, B1c, plan.W2, plan.digit, plan.arith, ks[:, 5])
    intra = twiddle_collision_model(B2_true, B2c, fold_width)
    inter_ok = twiddle_inter_check(B1c, B2c, plan.T, plan.arith, ks[:, 6])
    ok_b2 = stage2_projection_check(B2c, Yc, plan.W1T, plan.digit, plan.arith, ks[:, 7])

    dets = torch.stack([~ok_b1, intra, ~inter_ok, ~ok_b2], dim=-1).cpu().numpy()
    return stage, dets.any(axis=-1), dets


#: the flagship simulator's scenario table
FOUR_STEP_SCENARIOS = ("SBF", "DBF", "MLF", "SBF+SBF", "SBF+DBF",
                       "MLF+SBF", "MLF+DBF", "MLF+MLF")


def four_step_ntt_campaign(kind: str, trials: int, n: int, q: int, fold_width: int = 24,
                           seed: int = 42, plan: FourStepPlan | None = None,
                           target_stage: int | None = None,
                           device: str = "cuda") -> Dict[str, object]:
    """Detection and miss rates of the protected four-step NTT, with the
    per-detector counters (`rfhe_tpu.faults.campaign.four_step_ntt_campaign`).
    A given plan fixes the device."""
    if plan is None:
        plan = FourStepPlan.make(n, q, device=device)
    keys = prng.split(prng.PRNGKey(seed), trials)
    stages, detected, dets = _four_step_trials(keys, kind, plan, fold_width, target_stage)
    det_rate = detected.mean()
    stats = {
        # each detector that fired among detected trials
        "batch1_catch": int((detected & dets[:, 0]).sum()),
        "intra_catch": int((detected & dets[:, 1]).sum()),
        "inter_catch": int((detected & dets[:, 2]).sum()),
        "batch2_catch": int((detected & dets[:, 3]).sum()),
        # legacy priority attribution (intra > inter > batch)
        "batch_catch": int((detected & ~dets[:, 1] & ~dets[:, 2]).sum()),
    }
    per_stage_miss = np.array([(~detected)[stages == s].mean() if (stages == s).any() else 0.0
                               for s in (0, 1, 2)])
    return {"det_rate": float(det_rate), "miss_rate": float(1.0 - det_rate),
            "stats": stats, "per_stage_miss": per_stage_miss}


def four_step_scenario_table(trials: int, n: int, q: int, fold_width: int = 24,
                             seed: int = 42, device: str = "cuda") -> list:
    """One row per (scenario, target stage): the reference's full table."""
    plan = FourStepPlan.make(n, q, device=device)
    rows = []
    for sc in FOUR_STEP_SCENARIOS:
        for stage in (0, 1, 2):
            res = four_step_ntt_campaign(sc, trials, n, q, fold_width, seed, plan,
                                         target_stage=stage)
            rows.append({"scenario": sc, "stage": stage, "det_rate": res["det_rate"],
                         "miss_rate": res["miss_rate"], **res["stats"]})
    return rows
