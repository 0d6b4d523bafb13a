#!/usr/bin/env python3
"""Drive the rfhe_tpu_torch port once on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each a plain function; any failure raises and the exit code is not 0:
  1. toolchain: card, power limit, torch/CUDA versions, nvcc; needs sm_90
  2. build: compile csrc/ntt.cu with nvcc and load it
  3. kernels vs plain: every NTT kernel form against its plain PyTorch version
     on the card, bit for bit: the one-block kernels at the N=4096 path's
     shapes and at every ring they take, n=256 ... 8192; the two-pass and
     cluster kernels at n=16384, 32768 and 65536 at the large paths' shapes
     (per-limb and grouped digits, special limbs, mod-down deltas, the
     protection guard's tables, non-contiguous takes, 30- and 31-bit primes);
     batches that the polynomial groups do not divide and a batch of 70000, in
     every form; the large-ring kernels at n=256 ... 4096 beside the
     one-block kernels; and the fault campaigns' shapes, (1, 8, 4096) of the
     flip-impact sweep and (8, 8, 4096) of the monitor.  Four vectors each: random, all q-1, a spike, and
     random residues with one bit flipped per vector (words up to 2^32, some
     at or above q, as a fault stage hands them to the kernels), which go
     through both directions
  4. N=4096 path: CKKS with 21 ciphertext primes and one special prime (the
     reference's bench.py configuration): encode, encrypt, rotate by 1,
     decrypt; multiply_relin, rescale, decrypt; the keyswitch digits of c1
     through the forward NTT and back; the same seed on the CPU
     (plain versions) gives identical keys, ciphertexts and decrypted words
  5. N=65536 path, per-limb digits (21 + 1 limbs): the same ops; a second
     run of the same seed on the card with the plain NTTs gives identical
     arrays, and a shallower chain of the same ring agrees with a CPU run
  6. N=65536 path, grouped digits (dnum=3, 21 + 7 limbs): rotate,
     multiply_relin and rescale twice, a rotation at the lowered level; the
     same seed on the CPU gives identical arrays
  7. one rotation each at N=8192, N=16384 and N=32768, 21+1 limbs
  7b. BGV at the reference's campaign configuration (bench/northstar.py:61-86:
     N=16384, 10 x 30-bit limbs + a 31-bit special prime, t of 20 bits,
     seed 11, messages from default_rng(1)): keygen, encrypt and
     dot_product_bgv (multiply_relin, mod_switch_to_next, 13 rotate_rows,
     rotate_columns) decrypting to sum(x*y) mod t in every slot; the same
     seed on the CPU gives identical keys and arrays for encrypt,
     multiply_relin, mod_switch_to_next and one rotate_rows
  7c. BFV at N=16384, 10 + 1 limbs, seed 13 (t of 17 bits: no 16-bit prime is
     1 mod 2n there): encrypt, multiply_relin (the BEHZ multiply),
     rotate_rows(1), rotate_columns decrypting to the plaintext results, and
     identical to a CPU run of the same seed
  7d. ProtectedBgv on the dot product's context: clean rotate_rows(1) and
     multiply_relin equal to the plain evaluator with every flag true, one
     fault per stage firing its detector, ks_out none
  8. the protected evaluator (fhe/protected.py) on the N=4096, N=65536 and
     N=65536 dnum=3 contexts: clean rotate(1) and multiply_relin identical to
     the plain evaluator with every flag true; one fault per stage of
     tests/test_protected.py fires its detector, a ks_out fault none; at
     N=4096 the same keys and ciphertext on the CPU give identical arrays and
     flags for the clean ops and two fault stages
  9. the flip campaign (faults/evaluator_campaign.py) with its honesty
     asserts: n=1024, 3 levels, seed 0, both ops, 256 trials per stage, and
     N=4096 21+1 at 32; every row printed
 10. launch counts per rotation at each ring and for dnum=3
 11. protection overheads (bench/protected_overhead.py): protected/plain
     device time, wall and device operations per op at the reference's
     default (n=4096, 9 levels) and at the paths' widths
 12. times: a trivial launch by the device timer (`device.device_ms`: CUDA
     events around launches queued behind a blocker on the stream, which reads
     a kernel's own time also under the host's time per launch), host-paced
     and by torch.profiler; then each kernel form (device timer, and
     host-paced events beside it) against its plain version at every shape a
     rotation launches, (21, 22, n), (2, 21, n), (1, 21, n), (2, 1, n) and
     (3, 28, 65536), at n=4096 in all three forms, at (5, 22, n) and
     (10, 22, n), between which a launch changes from the cluster kernels to
     the two passes, and warm rotations
 13. BGV and BFV times: the warm dot product, BFV multiply_relin and
     rotate_rows (wall, device busy, launches, device time by kernel group,
     NTT launches by shape), the BEHZ stages alone by torch.profiler, and
     every kernel form at the shapes the two schemes launch; then the
     one-block kernels at the fault campaigns' shapes, (1, 8, 4096) and
     (8, 8, 4096)

The fault-injection campaigns (faults/, bench/sweeps.py), after phase 9:
  A. pbits: three_stage_campaign for the 5 fault types x pbits 2, 6, ..., 22
     at T=2000, W=24, S=8, seed 42 on the card; the 90 rows equal
     results/pbits_W24_N64_T2000.csv as formatted there (two rows the
     reference itself now gives otherwise are held against its current
     values, PBITS_REFERENCE_NOW); wall and device operations per campaign,
     the same count at T=64 and T=2000
  B. the protected four-step NTT: the relia_ntt sweep (N=64, q of 10..30
     bits step 2, SBF/DBF/MOF1, T=1000, seed 42) equal to a CPU run row for
     row, and four_step_scenario_table at n=64, q=769, T=1000, likewise
     equal to a CPU run
  C. NTT flip impact through the hand kernels: NttPlan over 8 30-bit primes
     at n=4096, batch 1, flips 1..15 x symbols 1..7, seed 42; the 105 rows
     equal results/flipimpact_logN12.csv; kernel launches by shape
  D. the BGV dot-product campaign at the dot-product phase's configuration
     (N=16384, seed 11, a fresh context): the sweep_dotprod grid (bits 1..8
     with 1 symbol, symbols 2..4 with 1 bit), seed 42, decoded through the
     exact CRT; every clean check true; the (1 bit, 1 symbol) dict equal to
     a CPU run of the same seeds; a fresh product's largest coefficient
     against the reference decode's 2^62 window, and one campaign decoded
     the reference's way
  E. the clean-vs-clean monitor (bench/real_monitor.py): log N = 12, batch
     8, 100 runs, a dot product every 50, into a temporary file; any nonzero
     Hamming distance is printed as a capture
  F. the atom overheads (bench/overheads.py) at n=4096, batch 8, each row
     printed beside the card's name and power limit

The profiling layer (ops/ntt_pease.py, trace/, models/bsgs.py, the bench
modules), last, after phase 13:
  G. Pease: PeaseNttPlan forward and inverse on the card equal to a CPU run
     at (2, 21, 4096) and (1, 6, 65536); ntt_pease.negacyclic_ntt / _intt on
     an NttPlan launch K1 / K2 once each and equal the plain butterflies
  H. north star (bench/northstar.py): CKKS multiply + rescale at N=65536,
     levels 16, 2^56 composite scale (34 + 1 limbs), seed 7, equal to a CPU
     run, max_err < 1e-6; the BGV dot product at N=16384 exact; warm ms
  I. ProfiledRotation equal to ctx.rotate on the N=4096, N=65536 and
     N=65536 dnum=3 contexts; the rotation phase profile at N = 2048 ...
     65536 with 21 limbs, the dnum rows at N=4096 (dnum 1, 2, 3, 4, 6, 8, 12,
     24) and the composition rows, each row's phases summing to its
     total_us, printed beside ctx.rotate's kernel total profiled alone
  J. ops_devtime (n=4096, levels=20, each row's mode) and perf_suite (n=4096,
     levels=3)
  K. BSGS: matvec_bsgs and matvec_naive at N=4096, 21 + 1 limbs, d=64, equal
     to a CPU run, decrypting to M·x within BSGS_LIMIT and to each other
  L. the roofline (bench/roofline.py) at (4096, 21, 8), (16384, 6, 8) and
     (65536, 6, 8), with the byte and integer-operation bounds
Their rows also go to build/h100_profiling/*.csv.

The reduction and control campaigns, the native engine, the grid audit and
the motivation demos, after phase L:
  M. the shape-grid audit (bench/fused_validate.py): n = 512 ... 65536 x
     prime mixes 31+30, 30x3, 28x2, batch 5, every form of each ring
     (one-block up to 8192, two passes and cluster kernels everywhere, n=65536
     at 31+30 included), K1, K2 and the round trip bit-exact against the plain
     butterflies; each row printed, written to build/h100_profiling/
  N. StackedNttPlan ntt / intt / poly_mul_negacyclic at (2, 3, 4096) equal to
     a CPU run; standard_ntt_campaign for every scenario x {mult, storage} at
     n=64 (q = 3457) and one scenario per target at n=4096, T=1000, seed 42,
     each dict equal to a CPU run
  O. the reduction sweeps: montgomery (21 rows) and barrett_final (112) at
     T=300, vec 1024, seed 42; barrett_fold MOF at T=1000 (36 rows) and at
     T=10000 for fold widths 2 and 24; outer_check at fold_k 4 and 8 (T=2000,
     vec 256): every row equal to the reference's current output, pinned in
     rfhe_tpu_torch/bench/reference_now.json; the committed rows the reference
     itself no longer gives printed; wall per campaign, host draws, device
     draws and the rest, and peak device memory
  P. the native engine (native.py) built into build/native/, its four
     functions at the reference tests' settings within their bounds, each run
     twice with identical counts
  Q. the motivation demos' six dicts equal to the reference's, and
     plaintext_perturb (BGV n=256 through the one-block kernels) equal to a
     CPU run

The multi-device layer (parallel/, transform/distributed.py,
transform/mxu_sharded.py, bench/scaling*.py), last, after phase Q:
  R. one NCCL world of torch.cuda.device_count() ranks, here this process
     alone (world of 1: NCCL refuses two ranks on one card), through a
     file:// store with a 120 s timeout: the limb-sharded CKKS evaluator on
     the N=4096 (21 + 1 limbs) and N=65536 per-limb contexts, rotate(1),
     multiply_relin and rescale, every array equal to the unsharded
     context's and decrypting within LIMITS, its K1/K2 launches counted;
     the sharded four-step NTT and its protected form at n=1024 with 8 limbs,
     the sharded production NTT forward and inverse at n=4096 (L=12) and
     n=65536 (L=21) equal to NttPlan.fwd / inv (K1 / K2), the guard's flags
     true on clean data and false on one flipped output word; both scaling
     harnesses' rows; the wall per sharded op beside the unsharded one and
     NCCL's all_gather, broadcast and all_to_all at these shapes

The repository's two entry files, last, after phase R:
  S. bench/headline.py (bench.py's counterpart) three times through its
     main: each prints its JSON line, the warm N=4096 21+1 rotation's
     microseconds against SEAL's 14,377, and must launch the one-block K1 and
     K2, which are then held against their plain versions at every shape the
     headline launched; entry.py's flagship step (the protected four-step NTT
     of (8, 4096) with its three detectors) on the card equal to a CPU run,
     error 0, flags included; entry.dryrun_multichip over
     torch.cuda.device_count() NCCL ranks (one here), whose ranks' K1/K2
     launches are counted with the headline's; each headline run first
     prints the same rotation under jitcache.eager()
  T. the per-op CUDA graphs (utils/jitcache.py; every public op on the card
     is one graph replay): the N=4096 path (encrypt, rotate, multiply_relin,
     rescale, decrypt, decrypt_words), the N=65536 per-limb and dnum=3
     rotations, the BGV dot product at N=16384, BFV multiply_relin at
     N=16384 and ProtectedCkks rotate at N=4096, clean and with one fault per
     stage (the location A or B as tensors: one graph per stage), each
     graphed A, B, A, B against the eager op in the same process: bit for bit,
     earlier results unchanged, one capture per signature, the K1/K2 counts
     of a replay equal to the eager op's; per op the graphed and eager wall
     (30 queued, one synchronise, alternated), device operations and host
     launches, capture time, and each context's pool bytes; then K1 and K2
     launched from a replay equal to the eager launch and to the plain
     versions at every shape of the N=4096 and N=65536 rotations

Phase 3 also holds the kernels at those shapes: the t plans (1, 1, 16384)
at 20 and 17 bits and (1, 1, 4096) at 16, the BEHZ basis (4, 13, 16384) and
(3, 13, 16384), the chain (4, 10) and (3, 10), and the BGV keyswitch's
(10, 11), (1, 10), (2, 1), (2, 10), (2, 9), (9, 10) and (1, 9).

Launch counts are set to 0 just before each path (the protected ones
included) and read just after; the kernel records carry their sum and the
shares of the protected paths, the schemes, the campaigns, the profiling
layer, the grid audit, the motivation demos and the sharded CKKS paths.
The third-to-last line is the per-kernel JSON record, the second-to-last
names the card and its power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from rfhe_tpu_torch import entry, native
from rfhe_tpu_torch.bench import (fused_validate, headline, northstar, ops_devtime, overheads,
                                  perf_suite, phase_profile, protected_overhead, real_monitor,
                                  roofline, scaling, scaling_mxu, sweeps)
from rfhe_tpu_torch.device import (DEVICE_TIMER, MODES, card, cuda_ms, device_ms, op_counts,
                                   profile_kernels, profiled_us, to_numpy_u32, wall_us)
from rfhe_tpu_torch.faults import evaluator_campaign, ntt_control, reduction_campaigns
from rfhe_tpu_torch.faults.campaign import (FAULT_TYPES, four_step_ntt_campaign,
                                            four_step_scenario_table, three_stage_campaign)
from rfhe_tpu_torch.faults.hardware import dotprod_fault_campaign
from rfhe_tpu_torch.fhe import (BehzPlan, BfvContext, BfvParams, BgvContext, BgvParams,
                                Ciphertext, CkksContext, CkksParams)
from rfhe_tpu_torch.fhe.bgv import special_primes
from rfhe_tpu_torch.fhe.ckks import rns_to_signed
from rfhe_tpu_torch.fhe.keys import compute_digits
from rfhe_tpu_torch.fhe.protected import Fault, ProtectedBgv, ProtectedCkks, all_ok
from rfhe_tpu_torch.fhe.params import make_prime_chain
from rfhe_tpu_torch.fhe.rns import poly_intt
from rfhe_tpu_torch.models import bsgs, motivation
from rfhe_tpu_torch.models.dotprod import dot_product_bgv
from rfhe_tpu_torch.numth import find_ntt_prime, find_ntt_primes
from rfhe_tpu_torch.ops import ntt_cuda, ntt_pease, ntt_stacked
from rfhe_tpu_torch.ops.ntt import NttPlan, ntt_fwd_reference, ntt_inv_reference
from rfhe_tpu_torch.parallel import worlds
from rfhe_tpu_torch.parallel.mesh import all_gather_cat, all_to_all_tiled, make_mesh
from rfhe_tpu_torch.parallel.sharded_ckks import ShardedCkks
from rfhe_tpu_torch.transform import mxu_sharded
from rfhe_tpu_torch.utils import jitcache
from rfhe_tpu_torch.transform.four_step import FourStepPlan, four_step_ntt
from rfhe_tpu_torch.profile_rotation import profile_op
from rfhe_tpu_torch.trace import ProfiledRotation
from rfhe_tpu_torch.trace.profiled import MODDOWN_PARTS, PHASES

SEAL_ROTATION_US = 14_377.0      # reference: SEAL 4.1 CPU, N=4096, 21 limbs
SOURCE = "rfhe_tpu_torch/csrc/ntt.cu"
REPLACES = {"fwd": "rfhe_tpu/ops/ntt_fused.py:250 (_fwd_kernel)",
            "inv": "rfhe_tpu/ops/ntt_fused.py:270 (_inv_kernel)"}
CHAIN = dict(levels=20, q0_bits=30, scale_bits=28)      # 21 ciphertext primes
BENCH = dict(n=4096, **CHAIN)
LARGE = dict(n=65536, **CHAIN)
SHALLOW = dict(n=65536, levels=2, q0_bits=30, scale_bits=28)
LARGE_RINGS = (16384, 32768, 65536)
ONE_BLOCK_RINGS = (256, 512, 1024, 2048, 4096, 8192)
DNUM = 3
SEED = 7
# The reference's real-GPU campaign configuration (bench/northstar.py:61-86):
# 10 x 30-bit limbs and a 31-bit special prime, t of 20 bits, seed 11,
# messages from default_rng(1).
BGV_DOT = dict(n=16384, levels=9, q_bits=30, t_bits=20)
BGV_SEED = 11
# BFV at the same ring with seed 13 (bench/ops_devtime.py:108's shape).  Its
# t_bits=16 has no prime ≡ 1 (mod 2n) at n = 16384 (the reference's
# BfvParams.make raises there); 17 bits gives t = 65537.
BFV_RING = dict(n=16384, levels=9, q_bits=30, t_bits=17)
BFV_SEED = 13
# Limits on the decrypted slots, (rotation, square) by ring.  The chain's
# 28-bit scale is the rotation profile's, not a precision setting: the
# reference's keyswitch takes non-centred digits, whose noise is
# low-frequency and grows in a slot about 3.5x per doubling of N (5.6e-4 at
# N=4096, 6.3e-2 at N=65536 on per-limb digits).  A wrong decryption is off
# by far more than 1; bit-exactness is held by the array comparisons.
LIMITS = {4096: (1e-3, 1e-2), 8192: (5e-3, 2e-2), 16384: (2e-2, 2e-2), 32768: (6e-2, 5e-2),
          65536: (2e-1, 1e-1)}
FOURTH_POWER_LIMIT = 2e-1

# The least time the card could take: bytes over the memory rate (H100 SXM
# data sheet) against operations over the peak rate for their type.  The
# butterflies are 32-bit integer operations: 64 per clock per SM, 132 SMs, at
# the SM clock read while a kernel runs (bench/roofline.py, which also counts
# the operations: 9 per lazy butterfly and 5 per exit product, from
# csrc/ntt.cu).
HBM_BYTES_PER_S = 3.35e12
_CLOCK = {}


def sm_clock() -> float:
    """The SM clock (MHz) nvidia-smi reads while one-block kernels run back to
    back, read once."""
    if "mhz" not in _CLOCK:
        plan = NttPlan.make(4096, find_ntt_primes(4096, 30, 21), "cuda")
        x = torch.zeros((8, 21, 4096), dtype=torch.int64, device="cuda")
        _CLOCK["mhz"] = roofline.sm_clock_mhz(lambda: plan.fwd(x))
        print(f"[clock] SM clock under a one-block NTT loop: {_CLOCK['mhz']} MHz (median)")
    return _CLOCK["mhz"]


def phase_toolchain() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs one GPU")
    c = card()
    cap = torch.cuda.get_device_capability(0)
    print(f"[toolchain] card: {c}")
    print(f"[toolchain] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"count {torch.cuda.device_count()}")
    print(f"[toolchain] nvcc {ntt_cuda.find_nvcc()}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a, this card is {cap}")
    return c


def phase_build() -> None:
    t0 = time.perf_counter()
    report = ntt_cuda.build()
    ntt_cuda.KERNELS.lib()
    print(f"[build] {ntt_cuda.library_path().name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")


def basis(n: int, n_special: int) -> tuple:
    """The 21 ciphertext primes of CHAIN at ring n followed by `n_special`
    special primes, chosen as CkksContext chooses them."""
    params = CkksParams.make(n=n, **CHAIN)
    bits = 30 if n >= 65536 else 31
    specials = [p for p in make_prime_chain(n, [bits] * (n_special + 2))
                if p not in params.moduli][:n_special]
    return tuple(params.moduli) + tuple(specials)


def test_vectors(plan: NttPlan, batch: int, seed: int) -> list:
    """Random residues, all q-1, and a lone q-1 spike (with a 1 at n/2): the
    three vectors of the reference's kernel self-check; and random residues
    with one bit in 0..31 flipped per vector, words up to 2^32 that may lie at
    or above q, as the protected path's fault stages hand them to the
    kernels."""
    q = np.array(plan.primes, dtype=np.int64)[:, None]
    rng = np.random.default_rng(seed)
    shape = (batch, plan.L, plan.n)
    rand = (rng.integers(0, 1 << 62, shape, dtype=np.int64) % q)
    full = np.broadcast_to(q - 1, shape).copy()
    spike = np.zeros(shape, dtype=np.int64)
    spike[..., 0] = (q - 1)[:, 0]
    spike[..., plan.n // 2] = 1
    flipped = rand.copy()
    rows = flipped.reshape(-1, plan.n)
    rows[np.arange(len(rows)), rng.integers(0, plan.n, len(rows))] ^= \
        np.int64(1) << rng.integers(0, 32, len(rows))
    return [("random", rand), ("all q-1", full), ("spike", spike), ("flipped", flipped)]


def forms_of(n: int) -> list:
    """The selector of every form that ring n can take: the one-block
    kernels (0) up to n = 8192, and both large-ring kernels at the ring's own
    split."""
    own = ntt_cuda.large_split(n)
    large = [(ntt_cuda.TWO_PASS, own), (ntt_cuda.CLUSTER, own)]
    return large if n > ntt_cuda.MAX_ONE_BLOCK_N else [0] + large


def kind_of(plan: NttPlan, batch: int, split) -> str:
    """'one_block', 'two_pass' or 'cluster': the kernels a launch takes."""
    return ntt_cuda.resolve_split(plan.n, split, batch * plan.L)[0]


def form_of(kind: str) -> str:
    """'' for the one-block kernels, '_large' for the large-ring form."""
    return "" if kind == "one_block" else "_large"


def kernel_cases() -> list:
    """(name, plan, batch, splits): `splits` lists the forms to hold against
    the plain versions, None being the one the launch takes by itself."""
    two_pass, cluster = ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER
    chain = basis(4096, 1)
    full = NttPlan.make(4096, chain, "cuda")
    special = len(chain) - 1
    small = NttPlan.make(256, make_prime_chain(256, [30] * 3), "cuda")
    flip = NttPlan.make(4096, find_ntt_primes(4096, 30, 8), "cuda")
    mixed = lambda n: NttPlan.make(n, make_prime_chain(n, [30, 31, 30, 31]), "cuda").take([3, 0, 1])
    cases = [
        ("n=4096 (21, 22) keyswitch digits", full, 21, [None, (two_pass, 6), (cluster, 6)]),
        ("n=4096 (2, 1) special limb", full.take([special]), 2, [None, (two_pass, 8), (cluster, 4)]),
        ("n=4096 (2, 21) mod-down delta", full.slice(special), 2, [None]),
        ("n=4096 (1, 22) guard tables", full, 1, [None]),
        ("n=4096 (1, 21) c1", full.slice(special), 1, [None]),
        ("n=4096 (3, 3) non-contiguous take", full.take([special, 0, 7]), 3, [None, (two_pass, 5), (cluster, 5)]),
        ("n=4096 31-bit (3, 3)", NttPlan.make(4096, make_prime_chain(4096, [31] * 3), "cuda"), 3, [None]),
        # 23 polynomials over 11 groups, 5 over 5 of 6 resident: loops of uneven length
        ("n=4096 (23, 22) uneven groups", full, 23, [None]),
        ("n=4096 (5, 3) uneven groups", full.take([special, 0, 7]), 5, [None]),
        ("n=2048 31-bit (3, 3)", NttPlan.make(2048, make_prime_chain(2048, [31] * 3), "cuda"), 3,
         [None, (two_pass, 4), (cluster, 7)]),
        ("n=256 30-bit (3, 3)", small, 3, [None, (two_pass, 4), (cluster, 4), (two_pass, 7), (cluster, 7)]),
        ("n=256 (70000, 1) beyond grid.y", small.take([1]), 70000, [None, (two_pass, 4), (cluster, 5)]),
        # the fault campaigns: the flip-impact sweep and the monitor
        ("n=4096 (1, 8) flip impact", flip, 1, [None]),
        ("n=4096 (8, 8) monitor", flip, 8, [None]),
    ]
    for n in (512, 1024, 8192):
        own = ntt_cuda.large_split(n)
        cases.append((f"n={n} 30- and 31-bit (3, 3) take", mixed(n), 3, [None, (two_pass, own), (cluster, own)]))
    ring = NttPlan.make(8192, basis(8192, 1), "cuda")
    cases += [("n=8192 (21, 22) keyswitch digits", ring, 21, [None]),
              ("n=8192 (2, 1) special limb", ring.take([21]), 2, [None]),
              ("n=8192 (23, 6) uneven groups", ring.take([21, 3, 0, 20, 7, 11]), 23, [None])]
    for n in LARGE_RINGS:
        splits = [None] + forms_of(n)
        grouped = NttPlan.make(n, basis(n, 7), "cuda")       # 21 + 7 limbs
        mixed = grouped.take([27, 3, 21, 0, 24, 20])
        cases += [
            (f"n={n} (21, 22) per-limb digits", grouped.slice(22), 21, splits),
            (f"n={n} (2, 1) special limb", grouped.take([21]), 2, splits),
            (f"n={n} (2, 21) mod-down delta", grouped.slice(21), 2, splits),
            (f"n={n} (1, 21) c1", grouped.slice(21), 1, splits),
            (f"n={n} (1, 28) guard tables", grouped, 1, splits),
            (f"n={n} (3, 6) take with specials", mixed, 3, splits),
            (f"n={n} (3, 28) grouped digits", grouped, 3, splits),
            # batches that the polynomial groups do not divide (loops of uneven length)
            (f"n={n} (23, 6) uneven groups", mixed, 23, forms_of(n)[-2:]),
            (f"n={n} (5, 6) uneven groups", mixed, 5, forms_of(n)[-2:]),
            (f"n={n} 31-bit (3, 3)", NttPlan.make(n, make_prime_chain(n, [31] * 3), "cuda"), 3, splits),
        ]
    return cases + scheme_kernel_cases()


def scheme_kernel_cases() -> list:
    """The shapes the BGV dot product and BFV at N = 16384 launch: the
    plaintext-modulus plans (1, 1, n), the BEHZ basis Bsk (4 and 3
    polynomials of 13 limbs) and the chain Q (4 and 3 of 10), the BGV
    keyswitch at level 9 and, after the modulus switch, at level 8."""
    n = BGV_DOT["n"]
    splits = [None] + forms_of(n)
    bgv, bfv = BgvParams.make(**BGV_DOT), BfvParams.make(**BFV_RING)
    chain = NttPlan.make(n, tuple(bgv.moduli) + special_primes(bgv), "cuda")      # 10 + 1
    sp = len(bgv.moduli)
    bsk = BehzPlan.make(n, bfv.moduli, bfv.t, bfv.moduli + special_primes(bfv), "cuda").bsk_plan
    t16 = NttPlan.make(4096, find_ntt_primes(4096, 16, 1), "cuda")
    return [
        (f"n={n} (1, 1) BGV t plan, 20-bit", NttPlan.make(n, [bgv.t], "cuda"), 1, splits),
        (f"n={n} (1, 1) BFV t plan, 17-bit", NttPlan.make(n, [bfv.t], "cuda"), 1, splits),
        ("n=4096 (1, 1) t plan, 16-bit", t16, 1, forms_of(4096)),
        (f"n={n} (4, 13) BEHZ Bsk inputs", bsk, 4, splits),
        (f"n={n} (3, 13) BEHZ Bsk tensor", bsk, 3, splits),
        (f"n={n} (4, 10) BEHZ Q inputs", chain.slice(sp), 4, splits),
        (f"n={n} (3, 10) BEHZ Q tensor", chain.slice(sp), 3, splits),
        (f"n={n} (10, 11) BGV keyswitch digits", chain, 10, splits),
        (f"n={n} (1, 10) BGV c1", chain.slice(sp), 1, splits),
        (f"n={n} (1, 9) BGV c1, level 8", chain.slice(sp - 1), 1, splits),
        (f"n={n} (2, 1) BGV special limb", chain.take([sp]), 2, splits),
        (f"n={n} (2, 10) BGV mod-down delta", chain.slice(sp), 2, splits),
        (f"n={n} (2, 9) BGV mod-switch delta", chain.slice(sp - 1), 2, splits),
        (f"n={n} (9, 10) BGV digits, level 8", chain.take(list(range(sp - 1)) + [sp]), 9, splits),
    ]


def phase_kernels() -> dict:
    err = dict.fromkeys(ntt_cuda.FORMS, 0)
    checked = dict.fromkeys(ntt_cuda.FORMS, 0)
    flipped_checked = {False: 0, True: 0}
    kinds = set()
    for i, (name, plan, batch, splits) in enumerate(kernel_cases()):
        vectors = test_vectors(plan, batch, seed=i)
        for vname, xv in vectors if batch <= 64 else vectors[:1]:
            x = torch.from_numpy(xv).cuda()
            y_ref = ntt_fwd_reference(x, plan)
            # the flipped words go into the inverse too; the others' inverse
            # takes the forward output and must give x back
            flipped = vname == "flipped"
            inv_in = x if flipped else y_ref
            back_ref = ntt_inv_reference(inv_in, plan)
            for split in splits:
                kind = kind_of(plan, batch, split)
                large = form_of(kind)
                kinds.add((kind, plan.n))
                y = ntt_cuda.fwd(x, plan, split)
                back = ntt_cuda.inv(inv_in, plan, split)
                torch.cuda.synchronize()
                e_f = int((y - y_ref).abs().max())
                e_i = int((back - back_ref).abs().max())
                err["fwd" + large] = max(err["fwd" + large], e_f)
                err["inv" + large] = max(err["inv" + large], e_i)
                checked["fwd" + large] += 1
                checked["inv" + large] += 1
                flipped_checked[flipped] += 2
                form = kind if split is None or not large else f"{kind} 2^{split[1]}"
                round_trip = flipped or torch.equal(back, x)
                print(f"[kernels] {name:36s} {vname:8s} {form:22s} fwd err {e_f} inv err {e_i} "
                      f"inv(fwd(x)) == x: {'n/a' if flipped else round_trip}")
                if not (e_f == 0 and e_i == 0 and round_trip):
                    raise RuntimeError(f"kernel disagrees with its plain version: {name}, {vname}, {form}")
    print(f"[kernels] comparisons per kernel form: {checked}, of which {flipped_checked[True]} on "
          f"words with a flipped bit; max abs err {err} (tolerance 0)")
    if min(checked.values()) == 0:
        raise RuntimeError(f"a kernel form was never compared: {checked}")
    missing = [(k, n) for n in LARGE_RINGS for k in (ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER)
               if (k, n) not in kinds]
    missing += [("one_block", n) for n in ONE_BLOCK_RINGS if ("one_block", n) not in kinds]
    if missing:
        raise RuntimeError(f"kernels never compared: {missing}")
    return err


@contextlib.contextmanager
def plain_ntt_on_card():
    """For a comparison run only: the plan's CUDA dispatch goes to the plain
    versions, so a whole path can be held against them on the card."""
    saved = ntt_cuda.fwd, ntt_cuda.inv
    ntt_cuda.fwd, ntt_cuda.inv = ntt_fwd_reference, ntt_inv_reference
    try:
        yield
    finally:
        ntt_cuda.fwd, ntt_cuda.inv = saved


def run_path(device: str, params: dict, dnum=None, twice: bool = False) -> tuple:
    """One path on one device: keygen, encrypt, rotate(1), decrypt;
    multiply_relin, rescale, decrypt; with `twice`, a second multiply_relin
    and rescale and a rotation at the lowered level.  Returns (ctx, arrays,
    checks): arrays maps a name to the numpy arrays the step produced,
    checks is a list of (what, max abs error, limit)."""
    ctx = CkksContext(CkksParams.make(**params), seed=SEED, dnum=dnum, device=device)
    n = params["n"]
    z = np.random.default_rng(0).uniform(-1, 1, n // 2) + 0j
    ct = ctx.encrypt(*ctx.encode(z))
    rot = ctx.rotate(ct, 1)
    sq = ctx.rescale(ctx.multiply_relin(ct, ct))
    checks = [("rotate(1) decrypts to roll(z, -1)",
               np.abs(ctx.decrypt_decode(rot) - np.roll(z, -1)).max(), LIMITS[n][0]),
              ("rescale(x*x) decrypts to z^2",
               np.abs(ctx.decrypt_decode(sq) - z * z).max(), LIMITS[n][1])]
    # the keyswitch digits of c1 and their NTT, as `keyswitch` computes them
    # and back: the only inverse transform of a whole digit tensor, which the
    # evaluator itself never needs (its inverse launches are c1 and the special
    # limbs, 1 to 28 vectors)
    dig, _, lim = compute_digits(poly_intt(ct.c[1], ctx.ctx).data, ct.level, ctx.ctx, ctx.L, dnum)
    dig_plan = ctx.ctx.plan.take(lim)
    dig_ntt = dig_plan.fwd(dig)
    if not torch.equal(dig_plan.inv(dig_ntt), dig):
        raise RuntimeError("inv(fwd(digits)) != digits")
    arrays = {"encrypt": ct.to_numpy(), "rotate": rot.to_numpy(), "mul_relin_rescale": sq.to_numpy(),
              "digits_ntt": [to_numpy_u32(dig_ntt)],
              "rotate_words": [w.cpu().numpy() for w in ctx.decrypt_words(rot)],
              "square_words": [w.cpu().numpy() for w in ctx.decrypt_words(sq)]}
    del dig, dig_ntt
    if twice:
        sq2 = ctx.rescale(ctx.multiply_relin(sq, sq))
        low = ctx.rotate(sq2, 1)
        checks.append(("rotate(rescale((x*x)^2), 1) decrypts to roll(z^4, -1)",
                       np.abs(ctx.decrypt_decode(low) - np.roll(z ** 4, -1)).max(),
                       FOURTH_POWER_LIMIT))
        arrays["square_twice"] = sq2.to_numpy()
        arrays["rotate_low"] = low.to_numpy()
        arrays["rotate_low_words"] = [w.cpu().numpy() for w in ctx.decrypt_words(low)]
    if device == "cuda":
        torch.cuda.synchronize()
    arrays.update({k: [v] for k, v in ctx.export_keys().items()})
    return ctx, arrays, checks


def same_arrays(a: dict, b: dict, what: str) -> int:
    if a.keys() != b.keys():
        raise RuntimeError(f"{what}: the two runs made different arrays")
    for name in a:
        for x, y in zip(a[name], b[name]):
            if x.shape != y.shape or not np.array_equal(x, y):
                raise RuntimeError(f"{what}: the two runs differ in {name}")
    return sum(len(v) for v in a.values())


def drive_counted(tag: str, what: str, params: dict, dnum=None, twice: bool = False) -> tuple:
    """Drive one path on the card with the launch counts set to 0 just
    before and read just after; check its decryptions against their limits."""
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    ctx, arrays, checks = run_path("cuda", params, dnum, twice)
    secs = time.perf_counter() - t0
    k = ntt_cuda.KERNELS
    launches, passes, by_kernels = dict(k.launches), dict(k.passes), dict(k.by_kernels)
    print(f"[{tag}] {what}, seed {SEED} on cuda: keygen, encrypt, rotate(1), multiply_relin, "
          f"rescale{' (twice), rotate' if twice else ''}, decrypts in {secs:.2f} s "
          f"(first call, keys included)")
    for name, e, limit in checks:
        print(f"[{tag}] {name}: max abs err {e:.3e} (limit {limit:g})")
        if not e <= limit:
            raise RuntimeError(f"{what}: {name} fails its limit")
    print(f"[{tag}] kernel launches on this path: {launches}; by the kernels that ran: "
          f"{by_kernels}; __global__ launches: {passes}")
    large = "_large" if ntt_cuda.default_split(params["n"]) else ""
    if launches["fwd" + large] == 0 or launches["inv" + large] == 0:
        raise RuntimeError(f"{what} did not launch both kernels: {launches}")
    return ctx, arrays, launches, by_kernels


def phase_main_path() -> tuple:
    ctx, arrays, launches, by_kernels = drive_counted("main", "CKKS N=4096, 21+1 limbs", BENCH)
    t0 = time.perf_counter()
    _, cpu_arrays, _ = run_path("cpu", BENCH)
    count = same_arrays(arrays, cpu_arrays, "N=4096 cuda vs cpu")
    print(f"[parity] {count} arrays ({', '.join(arrays)}) identical on cuda and cpu "
          f"(cpu run {time.perf_counter() - t0:.1f} s)")
    return ctx, launches, by_kernels


def phase_large_per_limb() -> tuple:
    """N=65536, 21 + 1 limbs, per-limb digits.  A CPU run of the plain
    butterflies over (21, 22, 65536) takes minutes, so the full path is held
    against the plain versions on the card, array by array, and the CPU
    comparison runs at a shallower chain of the same ring."""
    ctx, arrays, launches, by_kernels = drive_counted(
        "large", "CKKS N=65536, 21+1 limbs, per-limb digits", LARGE)
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    with plain_ntt_on_card():
        _, plain_arrays, _ = run_path("cuda", LARGE)
    if ntt_cuda.KERNELS.fwd_launches or ntt_cuda.KERNELS.inv_launches:
        raise RuntimeError("the plain comparison run launched a kernel")
    count = same_arrays(arrays, plain_arrays, "N=65536 kernels vs plain NTTs on the card")
    print(f"[large] {count} arrays ({', '.join(arrays)}) identical between the kernel run and a "
          f"second run of the same seed with the plain NTTs on the card ({time.perf_counter() - t0:.1f} s)")
    del arrays, plain_arrays
    t0 = time.perf_counter()
    _, shallow_cuda, _ = run_path("cuda", SHALLOW)
    _, shallow_cpu, _ = run_path("cpu", SHALLOW)
    count = same_arrays(shallow_cuda, shallow_cpu, "N=65536 shallow chain, cuda vs cpu")
    print(f"[large] CPU comparison at a shallower chain of the same ring (N=65536, 3+1 limbs): "
          f"{count} arrays identical on cuda and cpu ({time.perf_counter() - t0:.1f} s)")
    return ctx, launches, by_kernels


def phase_large_grouped() -> tuple:
    ctx, arrays, launches, by_kernels = drive_counted(
        "grouped", f"CKKS N=65536, 21+7 limbs, dnum={DNUM}", LARGE, DNUM, twice=True)
    shape = tuple(ctx.rlk.b.shape)
    if shape != (DNUM, 28, 65536):
        raise RuntimeError(f"grouped key shape {shape}")
    t0 = time.perf_counter()
    _, cpu_arrays, _ = run_path("cpu", LARGE, DNUM, twice=True)
    count = same_arrays(arrays, cpu_arrays, "N=65536 dnum=3 cuda vs cpu")
    print(f"[grouped] keys of shape {shape}; {count} arrays ({', '.join(arrays)}) identical on "
          f"cuda and cpu (cpu run {time.perf_counter() - t0:.1f} s)")
    return ctx, launches, by_kernels


def phase_mid_rings() -> dict:
    """One rotation at N=8192 (the one-block kernels' 13-stage schedule),
    N=16384 and N=32768, 21 + 1 limbs, so every ring the TPU kernels serve is
    launched on a real path."""
    out = {}
    for n in (8192, 16384, 32768):
        ntt_cuda.KERNELS.reset_counts()
        t0 = time.perf_counter()
        ctx = CkksContext(CkksParams.make(n=n, **CHAIN), seed=SEED, device="cuda")
        z = np.random.default_rng(0).uniform(-1, 1, n // 2) + 0j
        ct = ctx.encrypt(*ctx.encode(z))
        e = np.abs(ctx.decrypt_decode(ctx.rotate(ct, 1)) - np.roll(z, -1)).max()
        launches = dict(ntt_cuda.KERNELS.launches)
        print(f"[rings] CKKS N={n}, 21+1 limbs: rotate(1) decrypts to roll(z, -1): max abs err "
              f"{e:.3e} (limit {LIMITS[n][0]:g}), launches {launches} ({time.perf_counter() - t0:.1f} s)")
        if not e <= LIMITS[n][0]:
            raise RuntimeError(f"N={n}: rotation does not decrypt to the rotated slots")
        large = "_large" if ntt_cuda.default_split(n) else ""
        if launches["fwd" + large] == 0 or launches["inv" + large] == 0:
            raise RuntimeError(f"N={n}: the rotation did not launch both kernels: {launches}")
        out[n] = (ctx, ct, launches)
    return out


def bgv_messages(ctx) -> tuple:
    rng = np.random.default_rng(1)
    return tuple(rng.integers(0, ctx.t, (2, ctx.params.n // 2), dtype=np.uint32) for _ in range(2))


def scheme_arrays(ctx, cts: dict) -> dict:
    """name -> numpy arrays of the ciphertexts `cts` and of the context's
    public, relinearization and Galois keys."""
    arrays = {name: ct.to_numpy() + [np.array([ct.correction])] for name, ct in cts.items()}
    arrays["pk"] = [to_numpy_u32(ctx.pk.b), to_numpy_u32(ctx.pk.a)]
    arrays["rlk"] = [to_numpy_u32(ctx.rlk.b), to_numpy_u32(ctx.rlk.a)]
    for g, k in ctx._galois.items():
        arrays[f"galois {g}"] = [to_numpy_u32(k.b), to_numpy_u32(k.a)]
    return arrays


def bgv_steps(ctx, ct_x, ct_y) -> dict:
    """The steps of the dot product held against a CPU run: multiply_relin,
    mod_switch_to_next and the first rotate_rows(1) of the fold."""
    prod = ctx.multiply_relin(ct_x, ct_y)
    ms = ctx.mod_switch_to_next(prod)
    return {"encrypt x": ct_x, "encrypt y": ct_y, "multiply_relin": prod,
            "mod_switch_to_next": ms, "rotate_rows(1)": ctx.rotate_rows(ms, 1)}


def counted(tag: str, what: str, run) -> tuple:
    """Run `run()` with the launch counts set to 0 just before and read just
    after; fail unless both directions launched.  Returns (its result,
    launches, by_kernels, seconds)."""
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k = ntt_cuda.KERNELS
    launches, by_kernels = dict(k.launches), dict(k.by_kernels)
    print(f"[{tag}] {what}: kernel launches {launches}; by the kernels that ran "
          f"{ {n: c for n, c in by_kernels.items() if c} } ({secs:.2f} s, first call)")
    if k.fwd_launches == 0 or k.inv_launches == 0:
        raise RuntimeError(f"{what} did not launch both kernels: {launches}")
    return out, launches, by_kernels, secs


def phase_bgv() -> tuple:
    """The BGV dot product at the reference's campaign configuration:
    keygen, encrypt, dot_product_bgv (multiply_relin, mod_switch_to_next,
    13 rotate_rows and rotate_columns), decrypt equal to Σ x_i·y_i mod t in
    every slot; then the same seed on the CPU gives identical keys and
    arrays for encrypt, multiply_relin, mod_switch_to_next and one
    rotate_rows."""
    params = BgvParams.make(**BGV_DOT)

    def run():
        ctx = BgvContext(params, seed=BGV_SEED, device="cuda")
        m1, m2 = bgv_messages(ctx)
        ct_x, ct_y = ctx.encrypt(ctx.encode(m1)), ctx.encrypt(ctx.encode(m2))
        return ctx, ct_x, ct_y, ctx.decrypt_decode(dot_product_bgv(ctx, ct_x, ct_y)), m1, m2

    (ctx, ct_x, ct_y, got, m1, m2), launches, by_kernels, _ = counted(
        "bgv", f"BGV N={params.n}, {params.L}+1 limbs, t={params.t}: keygen, encrypt, "
        f"dot_product_bgv, decrypt", run)
    want = int((m1.astype(object) * m2.astype(object)).sum()) % ctx.t
    exact = bool((got == want).all())
    print(f"[bgv] decryption equals sum(x*y) mod t = {want} in all {got.size} slots: {exact}")
    if not exact:
        raise RuntimeError("the BGV dot product does not decrypt to sum(x*y) mod t")
    arrays = scheme_arrays(ctx, bgv_steps(ctx, ct_x, ct_y))
    t0 = time.perf_counter()
    cpu = BgvContext(params, seed=BGV_SEED, device="cpu")
    c1, c2 = bgv_messages(cpu)
    cpu_arrays = scheme_arrays(cpu, bgv_steps(cpu, cpu.encrypt(cpu.encode(c1)),
                                              cpu.encrypt(cpu.encode(c2))))
    arrays = {k: v for k, v in arrays.items() if k in cpu_arrays}      # the CPU drew one Galois key
    count = same_arrays(arrays, cpu_arrays, f"BGV N={params.n} cuda vs cpu")
    print(f"[bgv] {count} arrays ({', '.join(arrays)}) identical on cuda and cpu "
          f"(cpu run {time.perf_counter() - t0:.1f} s)")
    return (ctx, ct_x, ct_y), launches, by_kernels


def bfv_steps(ctx, m1, m2) -> dict:
    ct1, ct2 = ctx.encrypt(ctx.encode(m1)), ctx.encrypt(ctx.encode(m2))
    return {"encrypt 1": ct1, "encrypt 2": ct2, "multiply_relin": ctx.multiply_relin(ct1, ct2),
            "rotate_rows(1)": ctx.rotate_rows(ct1, 1), "rotate_columns": ctx.rotate_columns(ct1)}


def phase_bfv() -> tuple:
    """BFV at N = 16384, 10 + 1 limbs: encrypt, multiply_relin (the full
    BEHZ multiply), rotate_rows(1), rotate_columns, each decrypting to the
    plaintext result; the same seed on the CPU gives identical keys and
    arrays."""
    params = BfvParams.make(**BFV_RING)

    def run():
        ctx = BfvContext(params, seed=BFV_SEED, device="cuda")
        m1, m2 = bgv_messages(ctx)
        return ctx, m1, m2, bfv_steps(ctx, m1, m2)

    (ctx, m1, m2, cts), launches, by_kernels, _ = counted(
        "bfv", f"BFV N={params.n}, {params.L}+1 limbs, t={params.t}: keygen, encrypt, "
        f"multiply_relin, rotate_rows(1), rotate_columns", run)
    m1, m2 = m1.astype(np.int64), m2.astype(np.int64)
    want = {"encrypt 1": m1, "multiply_relin": m1 * m2 % ctx.t,
            "rotate_rows(1)": np.roll(m1, -1, axis=1), "rotate_columns": m1[::-1]}
    for name, m in want.items():
        ok = np.array_equal(ctx.decrypt_decode(cts[name]), m)
        print(f"[bfv] {name} decrypts to the plaintext result: {ok}")
        if not ok:
            raise RuntimeError(f"BFV {name} decrypts wrong")
    arrays = scheme_arrays(ctx, cts)
    t0 = time.perf_counter()
    cpu = BfvContext(params, seed=BFV_SEED, device="cpu")
    cpu_arrays = scheme_arrays(cpu, bfv_steps(cpu, *bgv_messages(cpu)))
    count = same_arrays(arrays, cpu_arrays, f"BFV N={params.n} cuda vs cpu")
    print(f"[bfv] {count} arrays ({', '.join(arrays)}) identical on cuda and cpu "
          f"(cpu run {time.perf_counter() - t0:.1f} s)")
    return (ctx, cts["encrypt 1"], cts["encrypt 2"]), launches, by_kernels


def phase_protected_bgv(bgv: tuple) -> tuple:
    """ProtectedBgv on the dot product's context and its x ciphertext."""
    ctx, ct_x, _ = bgv
    _, _, launches, by_kernels = drive_protected(
        "protected", f"BGV N={ctx.params.n} dot-product context", ctx, ct_x)
    return launches, by_kernels


def phase_counts(ctxs: dict) -> dict:
    """Launches of both kernels in one warm rotation, per context."""
    cts = {}
    for name, ctx in ctxs.items():
        ct = ctx.encrypt(*ctx.encode(np.zeros(ctx.params.n // 2) + 0j))
        ctx.rotate(ct, 1)
        ntt_cuda.KERNELS.reset_counts()
        ctx.rotate(ct, 1)
        torch.cuda.synchronize()
        k = ntt_cuda.KERNELS
        ran = {name: count for name, count in k.by_kernels.items() if count}
        print(f"[counts] per rotation, {name}: fwd {k.fwd_launches}, inv {k.inv_launches} "
              f"(by form {k.launches}; by the kernels that ran {ran}; "
              f"__global__ launches {k.passes})")
        cts[name] = ct
    return cts


# The fault stages of tests/test_protected.py:88-95 and :139-141 with the
# detector each must fire; a ks_out flip lands after the last check.
ROTATE_FAULTS = (("c1_perm", "intt"), ("intt_out", "intt"), ("digits", "baseconv"),
                 ("digits_ntt", "ks_core"), ("prod0", "ks_core"), ("acc0", "ks_core"))
MULTIPLY_FAULTS = (("digits_ntt", "ks_core"), ("acc0", "ks_core"), ("intt_out", "intt"))
CPU_FAULTS = ("rotate acc0", "multiply_relin intt_out")     # also run on the CPU at N=4096


def protected_runs(prot: ProtectedCkks, ct, names=None) -> dict:
    """name -> (output, flags) of the protected ops: clean rotate(1) and
    multiply_relin, each rotate and multiply_relin fault stage, ks_out."""
    runs = {}
    todo = [("rotate", None), ("multiply_relin", None)]
    todo += [(f"rotate {s}", Fault(s, 1, 17, 9)) for s, _ in ROTATE_FAULTS]
    todo += [("rotate ks_out", Fault("ks_out", 0, 3, 4))]
    todo += [(f"multiply_relin {s}", Fault(s, 0, 11, 7)) for s, _ in MULTIPLY_FAULTS]
    for name, fault in todo:
        if names is None or name in names:
            op = name.split()[0]
            runs[name] = (prot.rotate(ct, 1, fault) if op == "rotate"
                          else prot.multiply_relin(ct, ct, fault))
    return runs


def as_numpy(runs: dict) -> dict:
    return {name: ([to_numpy_u32(p.data) for p in out.c],
                   {k: v.cpu().numpy() for k, v in flags.items()})
            for name, (out, flags) in runs.items()}


def drive_protected(tag: str, what: str, ctx, ct=None) -> tuple:
    """The protected evaluator on one path of the card (ProtectedCkks, or
    ProtectedBgv over a BgvContext, whose rotate is rotate_rows): clean ops
    identical to the plain evaluator's with every flag true, each fault stage
    firing its detector, ks_out firing none.  The launch counts are set to 0
    just before the protected ops and read just after.  Returns (ct, runs as
    numpy, launches, by_kernels)."""
    n = ctx.params.n
    bgv = isinstance(ctx, BgvContext)
    if ct is None:
        ct = ctx.encrypt(*ctx.encode(np.random.default_rng(1).uniform(-1, 1, n // 2) + 0j))
    rotate = ctx.rotate_rows if bgv else ctx.rotate
    plain = {"rotate": rotate(ct, 1), "multiply_relin": ctx.multiply_relin(ct, ct)}
    torch.cuda.synchronize()
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    prot = ProtectedBgv(ctx) if bgv else ProtectedCkks(ctx)
    runs = protected_runs(prot, ct)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k = ntt_cuda.KERNELS
    launches, by_kernels = dict(k.launches), dict(k.by_kernels)
    if k.fwd_launches == 0 or k.inv_launches == 0:
        raise RuntimeError(f"{what}: the protected path did not launch both kernels: {launches}")
    for op, ref in plain.items():
        out, flags = runs[op]
        same = all(torch.equal(a.data, b.data) for a, b in zip(out.c, ref.c))
        print(f"[{tag}] protected {op}: arrays identical to the plain evaluator's: {same}; every "
              f"flag true: {bool(all_ok(flags))} ({len(flags)} flags: {', '.join(flags)})")
        if not (same and bool(all_ok(flags))):
            raise RuntimeError(f"{what}: protected {op} differs from the plain one or raises a flag")
    clean = {op: runs[op][0] for op in plain}
    for name, (out, flags) in runs.items():
        if name in plain:
            continue
        op, stage = name.split()
        want = dict(ROTATE_FAULTS if op == "rotate" else MULTIPLY_FAULTS).get(stage)
        fired = sorted(f for f, v in flags.items() if not bool(torch.all(v)))
        changed = any(not torch.equal(a.data, b.data) for a, b in zip(out.c, clean[op].c))
        print(f"[{tag}] fault {name}: output changed {changed}, detectors fired {fired or 'none'}")
        if not changed or (want not in fired if want else fired):
            raise RuntimeError(f"{what}: fault {name} fired {fired}, expected {want or 'none'}")
    print(f"[{tag}] {what}: {len(runs)} protected ops in {secs:.2f} s (first calls, probes "
          f"included); kernel launches {launches}; by the kernels that ran {by_kernels}")
    result = as_numpy(runs)
    del prot, runs, plain, clean
    return ct, result, launches, by_kernels


def phase_protected(ctxs: dict) -> tuple:
    """The protected evaluator at N=4096 (held against a CPU run of the same
    keys and ciphertext), N=65536 per-limb and N=65536 dnum=3."""
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    by_kernels = dict.fromkeys(ntt_cuda.KERNEL_SETS, 0)
    for name in ("N=4096", "N=65536", f"N=65536 dnum={DNUM}"):
        ctx = ctxs[name]
        ct, runs, path_launches, path_kernels = drive_protected("protected", f"CKKS {name}", ctx)
        for form, count in path_launches.items():
            launches[form] += count
        for kernels, count in path_kernels.items():
            by_kernels[kernels] += count
        if name != "N=4096":
            continue
        t0 = time.perf_counter()
        cpu = CkksContext(CkksParams.make(**BENCH), seed=SEED, device="cpu")
        cpu.load_keys(ctx.export_keys())
        ct_cpu = Ciphertext.from_numpy(ct.to_numpy(), ct.scale, True, "cpu")
        names = ("rotate", "multiply_relin") + CPU_FAULTS
        cpu_runs = as_numpy(protected_runs(ProtectedCkks(cpu), ct_cpu, names))
        for op in names:
            (a, fa), (b, fb) = runs[op], cpu_runs[op]
            same = (all(np.array_equal(x, y) for x, y in zip(a, b)) and list(fa) == list(fb)
                    and all(np.array_equal(fa[f], fb[f]) for f in fa))
            if not same:
                raise RuntimeError(f"protected {op} at N=4096: cuda and cpu differ")
        print(f"[protected] N=4096: {', '.join(names)}: arrays and flags identical on cuda and cpu "
              f"(cpu run {time.perf_counter() - t0:.1f} s)")
    return launches, by_kernels


def phase_campaign() -> tuple:
    """The flip campaign with its honesty asserts: the reference's defaults
    (n=1024, 3 levels, seed 0, both ops) at 256 trials per stage, and the
    N=4096 21+1 path at 32."""
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    for label, kwargs, trials in (("n=1024, 3 levels", dict(n=1024, levels=3), 256),
                                  ("N=4096, 21+1 limbs", dict(n=4096, levels=20, q0_bits=30), 32)):
        ntt_cuda.KERNELS.reset_counts()
        t0 = time.perf_counter()
        rows = evaluator_campaign.run(trials=trials, seed=0, device="cuda", log=None, **kwargs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for form, count in ntt_cuda.KERNELS.launches.items():
            launches[form] += count
        for row in rows:
            print(f"[campaign] {label}: {json.dumps(row)}")
        print(f"[campaign] {label}: {len(rows)} stages x {trials} trials, check_row on, in "
              f"{secs:.2f} s ({secs / (len(rows) * trials) * 1e3:.3f} ms per trial, context, "
              f"probes and clean runs included)")
    return launches


RESULTS = Path(__file__).resolve().parent / "results"
PBITS_CSV = "pbits_W24_N64_T2000.csv"
FLIP_CSV = "flipimpact_logN12.csv"
# Two rows of results/pbits_W24_N64_T2000.csv that rfhe_tpu itself no longer
# gives (JAX on the CPU, three_stage_campaign("SCF-MBU", 2000, S=8, P=3,
# W=24, seed=42): undetected 202 and 232, not 198 and 226).  At P = 3 an MBU
# mask reaches 15 > 2q, so the wrapped word stays at or above q; the port
# gives the reference's current values.  tests/test_torch_campaign.py
# (test_pbits_reference_now) runs both at these settings and holds these
# rows against them.
PBITS_REFERENCE_NOW = {("SCF-MBU", "2", "1"): ["SCF-MBU", "2", "1", "656", "202", "0.307927"],
                       ("SCF-MBU", "2", "3"): ["SCF-MBU", "2", "3", "677", "232", "0.342688"]}


def committed_rows(name: str) -> list:
    with open(RESULTS / name, newline="") as f:
        return list(csv.reader(f))[1:]


def phase_pbits() -> None:
    """A. The three-stage campaign's sweep at the committed file's settings."""
    committed = committed_rows(PBITS_CSV)
    want = [PBITS_REFERENCE_NOW.get(tuple(r[:3]), r) for r in committed]
    rows, t0 = [], time.perf_counter()
    for row in sweeps.pbits_rows(2000, 64, 24, 42, range(2, 23, 4), "cuda"):
        rows.append([str(v) for v in row])
    secs = time.perf_counter() - t0
    stale = [r for r, w in zip(committed, want) if r != w]
    print(f"[pbits] {len(rows)} rows in {secs:.2f} s ({secs / (len(rows) // 3) * 1e3:.1f} ms per "
          f"campaign of 2000 trials, {secs / (len(rows) // 3) / 2000 * 1e3:.4f} ms per trial)")
    if rows != want:
        bad = [(r, w) for r, w in zip(rows, want) if r != w]
        raise RuntimeError(f"pbits rows differ from {PBITS_CSV}: {bad[:4]} ({len(bad)} rows)")
    print(f"[pbits] all {len(rows)} rows equal {PBITS_CSV} ({len(stale)} rows against the "
          f"reference's current values: {[w for r, w in zip(committed, want) if r != w]})")
    for ftype in FAULT_TYPES:
        ops = {}
        for trials in (64, 2000):
            run = lambda: three_stage_campaign(ftype, trials, S=8, P=53, W=24, seed=42,
                                               device="cuda")
            us, ops[trials] = profile_kernels(run, reps=1)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            print(f"[pbits] {ftype} P=53 T={trials}: wall {wall:.2f} ms, device {us:.1f} us, "
                  f"{ops[trials]:.0f} device operations per campaign")
        if ops[64] != ops[2000]:
            raise RuntimeError(f"{ftype}: device operations depend on the trial count: {ops}")


def phase_four_step() -> None:
    """B. The relia_ntt sweep on the card against a CPU run, and the
    scenario table at n=64, q=769."""
    grid = dict(trials=1000, N=64, fold=24, seed=42, qbits_range=range(10, 31, 2))
    t0 = time.perf_counter()
    rows = [[str(v) for v in r] for r in sweeps.relia_ntt_rows(device="cuda", **grid)]
    secs = time.perf_counter() - t0
    cpu = [[str(v) for v in r] for r in sweeps.relia_ntt_rows(device="cpu", **grid)]
    for r in rows:
        print(f"[relia_ntt] {','.join(r)}")
    if rows != cpu:
        raise RuntimeError("the relia_ntt rows on the card differ from the CPU run")
    print(f"[relia_ntt] {len(rows)} campaigns of 1000 trials in {secs:.2f} s on the card "
          f"({secs / len(rows) * 1e3:.1f} ms per campaign), equal to a CPU run row for row")
    us, ops = profile_kernels(lambda: four_step_ntt_campaign("SBF", 1000, 64, 769, seed=42,
                                                             device="cuda"), reps=1)
    print(f"[relia_ntt] one campaign (SBF, n=64, T=1000): device {us:.1f} us, {ops:.0f} device "
          f"operations")
    t0 = time.perf_counter()
    table = four_step_scenario_table(1000, 64, 769, seed=42, device="cuda")
    secs = time.perf_counter() - t0
    cpu_table = four_step_scenario_table(1000, 64, 769, seed=42, device="cpu")
    for row in table:
        print(f"[scenarios] {json.dumps(row)}")
    print(f"[scenarios] {len(table)} rows (n=64, q=769, T=1000) in {secs:.2f} s")
    if len(table) != 24 or table != cpu_table:
        raise RuntimeError("the scenario table on the card differs from the CPU run")
    print("[scenarios] equal to a CPU run row for row")


def phase_flip_impact() -> dict:
    """C. The NTT flip-impact sweep through the hand kernels."""
    primes = find_ntt_primes(4096, 30, 8)
    plan = NttPlan.make(4096, primes, "cuda")
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    rows = [[str(v) for v in r] for r in sweeps.ntt_err_rows(plan, 15, 7, 42)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k = ntt_cuda.KERNELS
    launches, by_shape = dict(k.launches), dict(k.by_shape)
    committed = committed_rows(FLIP_CSV)
    print(f"[flip] {len(rows)} campaigns (n=4096, 8 x 30-bit primes, batch 1) in {secs:.2f} s; "
          f"kernel launches {launches}, by shape {by_shape} "
          f"({sum(launches.values()) / len(rows):.0f} per campaign)")
    if rows != committed:
        bad = [(r, w) for r, w in zip(rows, committed) if r != w]
        raise RuntimeError(f"flip-impact rows differ from {FLIP_CSV}: {bad[:4]}")
    print(f"[flip] all {len(rows)} rows equal {FLIP_CSV}")
    if launches["fwd"] != 2 * len(rows):
        raise RuntimeError(f"expected two forward launches per campaign: {launches}")
    return launches


def product_window(ctx) -> None:
    """Why the reference's decode fails on a fresh product at this ring: the
    largest centered coefficient of [c(s)]_Q of multiply_relin(x, y) against
    decrypt_decode's CRT window (exact below 2^62); the exact CRT must give
    x*y mod t."""
    m1, m2 = (np.random.default_rng(s).integers(0, ctx.t, (2, ctx.params.n // 2)) for s in (3, 4))
    prod = ctx.multiply_relin(ctx.encrypt(ctx.encode(m1)), ctx.encrypt(ctx.encode(m2)))
    signed = rns_to_signed(to_numpy_u32(ctx._decrypt_coeffs(prod)),
                           ctx.params.moduli[:prod.level + 1])
    bits = max(abs(int(v)) for v in signed).bit_length()
    want = m1 * m2 % ctx.t
    window_ok = np.array_equal(ctx.decrypt_decode(prod), want)
    exact_ok = np.array_equal(ctx.decode(ctx.decrypt_coeffs_t(prod, exact=True)), want)
    print(f"[dotprod] a fresh product at N={ctx.params.n}, t={ctx.t}: largest centered coefficient "
          f"2^{bits}; decrypt_decode (CRT window 2^62) right: {window_ok}; exact CRT right: "
          f"{exact_ok}")
    if not exact_ok or not (window_ok or bits > 62):
        raise RuntimeError("the product decrypts wrong, or the CRT window fails below 2^62")


def phase_dotprod_campaign() -> dict:
    """D. The BGV dot-product campaign at N=16384 (the dot-product phase's
    parameters and seed, a fresh context so that a CPU run draws the same
    keys in the same order).  The grid decodes through the exact CRT: a
    fresh product's noise passes the reference's 2^62 window at this ring
    (`product_window`), and one campaign is run the reference's way to show
    what that gives."""
    params = BgvParams.make(**BGV_DOT)
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    ctx = BgvContext(params, seed=BGV_SEED, device="cuda")
    keys_s = time.perf_counter() - t0
    results = []
    for bits, syms in sweeps.dotprod_grid(8, 4):
        res = dotprod_fault_campaign(ctx, bits, syms, seed=42, exact_decrypt=True)
        results.append(res)
        print(f"[dotprod] bits {bits}, symbols {syms}: {json.dumps(res)}")
        if not (res["clean_product_ok"] and res["clean_dot_ok"]):
            raise RuntimeError(f"the clean dot product fails at bits {bits}, symbols {syms}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ntt_cuda.KERNELS.launches)
    print(f"[dotprod] N={params.n}: {len(results)} campaigns in {secs:.2f} s (keygen {keys_s:.2f} "
          f"s; {(secs - keys_s) / len(results):.3f} s per campaign: 2 multiply_relin, 2 dot "
          f"products, 4 decryptions); kernel launches {launches}")
    t0 = time.perf_counter()
    cpu = dotprod_fault_campaign(BgvContext(params, seed=BGV_SEED, device="cpu"), 1, 1, seed=42,
                                 exact_decrypt=True)
    print(f"[dotprod] (1 bit, 1 symbol) on the CPU: {json.dumps(cpu)} "
          f"({time.perf_counter() - t0:.1f} s)")
    if cpu != results[0]:
        raise RuntimeError("the (1 bit, 1 symbol) dot-product campaign differs from a CPU run")
    product_window(ctx)
    ref_way = dotprod_fault_campaign(ctx, 1, 1, seed=42)
    print(f"[dotprod] (1 bit, 1 symbol) decoded as the reference decodes (decrypt_decode): "
          f"{json.dumps(ref_way)}")
    if not ref_way["clean_dot_ok"]:
        raise RuntimeError("the clean dot product decodes wrong through decrypt_decode")
    return launches


def phase_monitor() -> dict:
    """E. The clean-vs-clean monitor, into a temporary file."""
    ntt_cuda.KERNELS.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        res = real_monitor.run(runs=100, log_dim=12, batch=8, dot_every=50,
                               out=str(Path(tmp) / "monitor.txt"), device="cuda", log=None)
        head = (Path(tmp) / "monitor.txt").read_text().splitlines()[0]
    torch.cuda.synchronize()
    launches = dict(ntt_cuda.KERNELS.launches)
    print(f"[monitor] {head}")
    print(f"[monitor] {res['runs']} runs (n=4096, batch 8, a dot product every 50) in "
          f"{res['seconds']:.2f} s ({res['seconds'] / res['runs'] * 1e3:.1f} ms per run); "
          f"silent faults {res['faults']}; kernel launches {launches}")
    for line in res["captures"]:
        print(f"[monitor] CAPTURE: {line}")
    if launches["fwd"] < 2 * res["runs"]:
        raise RuntimeError(f"the monitor did not run the kernels: {launches}")
    return launches


def phase_atom_overheads(c: str) -> None:
    """F. The atom overheads at n=4096, batch 8."""
    res = overheads.measure(n=4096, batch=8)
    for row in res["rows"]:
        line = (f"[atoms] {c}: {row['atom']}: plain {row['plain_us']:.2f} us, protected "
                f"{row['prot_us']:.2f} us, x{row['overhead']:.4f} by {row['timer']}; wall "
                f"{row['plain_wall_us']:.1f} -> {row['prot_wall_us']:.1f} us "
                f"(x{row['wall_overhead']:.4f})")
        if row["plain_launches"] is not None:
            line += f"; device ops {row['plain_launches']:.0f} -> {row['prot_launches']:.0f}"
        print(line)


def phase_overheads(c: str) -> list:
    """protected/plain by the device timer (NTT, ModMul) and by torch.profiler
    and the host's wall clock (rotation, multiply+relin) with the device
    operations per op, at the reference's default and at the paths' widths."""
    rows = []
    for kwargs in (dict(n=4096, levels=9, batch=8),
                   dict(n=4096, levels=20, q0_bits=30, batch=8),
                   dict(n=65536, levels=20, q0_bits=30, batch=1),
                   dict(n=65536, levels=20, q0_bits=30, dnum=DNUM,
                        atoms=("Rotation(e2e)", "HMul+Relin(e2e)"))):
        for row in protected_overhead.measure(**kwargs):
            rows.append(row)
            line = (f"[overhead] {c}: {row['config']} {row['atom']}: plain {row['plain_us']:.1f} us, "
                    f"protected {row['prot_us']:.1f} us, x{row['overhead']:.2f} by {row['timer']}")
            if "plain_wall_us" in row:
                line += (f"; wall {row['plain_wall_us']:.1f} -> {row['prot_wall_us']:.1f} us "
                         f"(x{row['wall_overhead']:.2f}); device ops per op "
                         f"{row['plain_launches']:.0f} -> {row['prot_launches']:.0f}")
            print(line)
    return rows


def bound_ms(batch: int, L: int, n: int) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card could take for
    one transform of (batch, L, n) int64 residues.
    Bytes: the input read and the output written once, plus the direction's
    twiddle and Shoup rows of the L limbs (no kernel reads a slot table).
    Operations: n/2·log2(n) butterflies and n exit products per vector, as
    32-bit integer operations over the integer peak at `sm_clock()`."""
    moved = 2 * 8 * batch * L * n + L * 2 * n * 4
    ops = batch * L * roofline.int_ops(n)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / roofline.int_peak(sm_clock()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


L2_BYTES = 50e6                  # the card's L2 cache


def phase_timer(c: str) -> float:
    """The device timer on a launch that does next to nothing, (1, 1, 256):
    it must read well under 10 us, where host-paced events read the host's
    time per launch.  Returns the device reading in ms: the least any launch
    costs, and the practical floor under the small launches' byte bounds."""
    plan = NttPlan.make(256, make_prime_chain(256, [30]), "cuda")
    x = torch.zeros((1, 1, 256), dtype=torch.int64, device="cuda")
    launch = lambda: ntt_cuda.fwd(x, plan, 0)
    dev = [device_ms(launch) for _ in range(2)]
    paced = cuda_ms(launch)
    prof_us = profiled_us(launch)
    print(f"[timer] {c}: device timer = {DEVICE_TIMER}")
    print(f"[timer] {c}: trivial launch (1, 1, 256) one_block fwd: device timer {dev[0] * 1e3:.2f} / "
          f"{dev[1] * 1e3:.2f} us, torch.profiler kernel duration {prof_us:.2f} us, "
          f"host-paced events {paced * 1e3:.2f} us")
    if not max(dev) < 0.010:
        raise RuntimeError(f"the device timer reads {max(dev) * 1e3:.1f} us on a trivial launch")
    return min(dev)


def time_forms(c: str, plan: NttPlan, batch: int, splits: list) -> dict:
    """Kernel (each form of `splits`) and plain times of both directions at
    (batch, L, n), in the order plain, kernel, kernel, plain.  The kernels are
    read twice by the device timer (`device_ms`) and once by host-paced events
    (`cuda_ms`, what a caller pays who launches them one by one); the plain
    versions, hundreds of launches each, by host-paced events.  One input is
    repeated, so a shape whose working set (input, output and the two passes'
    uint32 intermediate) is under the L2's 50 MB is served from the cache and
    the HBM bound is not what binds it: each line says so."""
    q = plan.q_arr[:, None]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 1 << 62, (batch, plan.L, plan.n), device="cuda", generator=g) % q
    y = plan.fwd(x)
    plain_reps = 20 if plan.n <= 8192 else 4
    b_ms, b_by = bound_ms(batch, plan.L, plan.n)
    out = {}
    for d, data, kern, plain in (("fwd", x, ntt_cuda.fwd, ntt_fwd_reference),
                                 ("inv", y, ntt_cuda.inv, ntt_inv_reference)):
        p1 = cuda_ms(lambda: plain(data, plan), plain_reps)
        ks = {s: [device_ms(lambda: kern(data, plan, s)) for _ in range(2)] for s in splits}
        paced = {s: cuda_ms(lambda: kern(data, plan, s)) for s in splits}
        p2 = cuda_ms(lambda: plain(data, plan), plain_reps)
        for s, (k1, k2) in ks.items():
            kind = kind_of(plan, batch, s)
            working = x.numel() * (20 if kind == ntt_cuda.TWO_PASS else 16)
            in_l2 = working < L2_BYTES
            taken = " (default)" if kind == kind_of(plan, batch, None) else ""
            print(f"[times] {c}: {d} NTT ({batch}, {plan.L}, {plan.n}) {kind}{taken}: kernel {k1:.4f} / "
                  f"{k2:.4f} ms by the device timer, {paced[s]:.4f} ms host-paced, plain {p1:.4f} / "
                  f"{p2:.4f} ms host-paced (plain, kernel, kernel, plain), "
                  f"bound {b_ms:.4f} ms by {b_by}, share of bound {200 * b_ms / (k1 + k2):.0f}%, "
                  f"working set {working / 1e6:.1f} MB {'under' if in_l2 else 'over'} the L2")
            out[d, kind] = {"shape": [batch, plan.L, plan.n], "form": kind, "ms": (k1 + k2) / 2,
                            "paced_ms": paced[s], "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms,
                            "bound_by": b_by, "default": bool(taken), "working_set_in_l2": in_l2}
    return out


def warm_rotate_us(ctx: CkksContext, ct, iters: int) -> float:
    ctx.rotate(ct, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        ctx.rotate(ct, 1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def phase_times(ctxs: dict, cts: dict, c: str) -> dict:
    us = warm_rotate_us(ctxs["N=4096"], cts["N=4096"], 30)
    print(f"[times] {c}: warm rotate N=4096 21+1 limbs: {us:.1f} us per rotation "
          f"(30 iterations), SEAL CPU {SEAL_ROTATION_US:.0f} us -> x{SEAL_ROTATION_US / us:.2f}")
    for name in ("N=65536", f"N=65536 dnum={DNUM}"):
        us = warm_rotate_us(ctxs[name], cts[name], 10)
        print(f"[times] {c}: warm rotate {name}, 21 ciphertext limbs: {us:.1f} us per rotation "
              f"(10 iterations)")
    floor = phase_timer(c)
    print(f"[times] {c}: kernel times below are read by the device timer ({DEVICE_TIMER}); a "
          f"trivial launch reads {floor * 1e3:.2f} us there, the floor under every byte bound")
    times = {}
    for n in (4096, 8192):
        # the shapes one rotation launches, the 31-bit special prime last; at
        # n = 4096 the large-ring forms beside the one-block form
        forms = forms_of(n) if n == 4096 else [0]
        ring = NttPlan.make(n, basis(n, 1), "cuda")
        times[f"{n}"] = time_forms(c, ring, 21, forms)
        times[f"{n} mod-down delta"] = time_forms(c, ring.slice(21), 2, forms)
        times[f"{n} c1"] = time_forms(c, ring.slice(21), 1, forms)
        times[f"{n} special limb"] = time_forms(c, ring.take([21]), 2, forms)
    for n in LARGE_RINGS:
        forms = forms_of(n)
        grouped = NttPlan.make(n, basis(n, 7), "cuda")
        # the shapes one rotation launches: digits, mod-down delta, c1, special limb
        times[f"{n}"] = time_forms(c, grouped.slice(22), 21, forms)
        times[f"{n} mod-down delta"] = time_forms(c, grouped.slice(21), 2, forms)
        times[f"{n} c1"] = time_forms(c, grouped.slice(21), 1, forms)
        times[f"{n} special limb"] = time_forms(c, grouped.take([21]), 2, forms)
        # between the grouped digits' 84 vectors and the per-limb digits' 462:
        # where `ntt_cuda.large_form` changes kernels
        times[f"{n} five polynomials"] = time_forms(c, grouped.slice(22), 5, forms)
        times[f"{n} ten polynomials"] = time_forms(c, grouped.slice(22), 10, forms)
        if n == 65536:
            times["65536 grouped digits"] = time_forms(c, grouped, DNUM, forms)
    return times


def phase_fault_times(c: str) -> dict:
    """The kernels at the shapes the fault campaigns launch: the flip-impact
    sweep's (1, 8, 4096) and the monitor's (8, 8, 4096), 30-bit primes."""
    plan = NttPlan.make(4096, find_ntt_primes(4096, 30, 8), "cuda")
    return {"4096 flip impact": time_forms(c, plan, 1, [0]),
            "4096 monitor": time_forms(c, plan, 8, [0])}


def ntt_shapes(fn) -> dict:
    """NTT launches of one warm call of `fn`, by (form, batch, L, n)."""
    fn()
    torch.cuda.synchronize()
    ntt_cuda.KERNELS.reset_counts()
    fn()
    torch.cuda.synchronize()
    return dict(ntt_cuda.KERNELS.by_shape)


def report_op(c: str, what: str, fn, reps: int) -> dict:
    """Wall (each call waited for), device busy, launches, the device time by
    kernel group and the NTT launches by shape of one warm op."""
    wall = wall_us(fn, reps)
    totals, rows = profile_op(fn, reps)
    shapes = ntt_shapes(fn)
    print(f"[scheme] {c}: {what}: wall {wall:.1f} us, device busy {totals['device_us']:.1f} us "
          f"({100 * totals['device_us'] / wall:.1f}% of wall), {totals['launches']:.1f} device "
          f"launches, host enqueue {totals['enqueue_us']:.1f} us, SM clock {totals['sm_mhz']} MHz")
    for name, (us, count) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        print(f"[scheme]   {what}: {name:58s} {us:9.1f} us {100 * us / totals['device_us']:5.1f}% "
              f"{count:6.1f} launches")
    print(f"[scheme]   {what}: NTT launches by (form, batch, L, n): "
          + ", ".join(f"{k}: {v}" for k, v in sorted(shapes.items())))
    return {"wall_us": wall, **totals, "rows": rows, "ntt_shapes": shapes}


def phase_scheme_times(c: str, bgv: tuple, bfv: tuple) -> dict:
    """The warm BGV dot product, BFV multiply_relin and rotate_rows (wall,
    device, launches, where the device time goes), the BEHZ stages alone by
    torch.profiler, and each NTT kernel form at every shape the two
    schemes launch.  Returns the kernel times for the records."""
    ctx, ct_x, ct_y = bgv
    report_op(c, "BGV dot product N=16384", lambda: dot_product_bgv(ctx, ct_x, ct_y), 3)
    bctx, ct1, ct2 = bfv
    mul = report_op(c, "BFV multiply_relin N=16384", lambda: bctx.multiply_relin(ct1, ct2), 5)
    report_op(c, "BFV rotate_rows(1) N=16384", lambda: bctx.rotate_rows(ct1, 1), 5)
    # the BEHZ stages of one multiply, each alone: kernel time by the profiler
    bp, plan = bctx.behz(ct1.level), bctx.ctx.plan_at(ct1.level)
    a0, a1, b0, b1 = ct1.c[0].data, ct1.c[1].data, ct2.c[0].data, ct2.c[1].data
    coeff = plan.inv(torch.stack([a0, a1, b0, b1]))
    ext = bp.extend_to_bsk(coeff)
    d_q = plan.fwd(coeff[:3].contiguous())
    td_b = bp.bsk_plan.inv(bp.bsk_plan.fwd(ext)[:3].contiguous())
    w = bp.rns_floor(plan.inv(d_q), td_b)
    stages = {
        "multiply (whole BEHZ)": lambda: bctx._multiply_impl(a0, a1, b0, b1, bp),
        "inverse NTT Q (4, 10)": lambda: plan.inv(torch.stack([a0, a1, b0, b1])),
        "extend_to_bsk (4, 10 -> 13)": lambda: bp.extend_to_bsk(coeff),
        "forward NTT Bsk (4, 13)": lambda: bp.bsk_plan.fwd(ext),
        "inverse NTT Bsk (3, 13)": lambda: bp.bsk_plan.inv(td_b),
        "rns_floor (3, 10 -> 13)": lambda: bp.rns_floor(d_q, td_b),
        "conv_sk (3, 13 -> 10)": lambda: bp.conv_sk(w),
        "multiply + relinearize": lambda: bctx.relinearize(bctx.multiply(ct1, ct2)),
    }
    whole = None
    for name, fn in stages.items():
        us, count = profile_kernels(fn, 5)
        whole = whole or us
        print(f"[behz] {c}: {name}: {us:.1f} us of kernel time (torch.profiler), {count:.0f} "
              f"device launches ({100 * us / whole:.1f}% of the whole multiply)")
    print(f"[behz] {c}: multiply_relin device busy {mul['device_us']:.1f} us (profiler)")
    times = {}
    n = BGV_DOT["n"]
    for name, plan, batch, _ in scheme_kernel_cases():
        forms = forms_of(plan.n)
        times[name] = time_forms(c, plan, batch, forms if plan.n == n else [0])
    return times


# ---------------------------------------------------------------------------
# The profiling layer (phases G-L)

PEASE_SHAPES = ((2, 21, 4096), (1, 6, 65536))          # (batch, L, n)
ROTATION_RINGS = (2048, 4096, 8192, 16384, 32768, 65536)
PROFILE_LIMBS = 21
DNUMS = (1, 2, 3, 4, 6, 8, 12, 24)                     # the rows of results/dnum_N4096.csv
ROOFLINE_SHAPES = ((4096, 21, 8), (16384, 6, 8), (65536, 6, 8))   # (n, limbs, batch)
BSGS_D = 64                                            # B = G = 8
# Decryption limit of the matrix-vector products (max abs error of a decoded
# slot against M·x; M and x uniform in [-1, 1] from default_rng(5), d = 64,
# at the 21-limb chain's 28-bit scale).  A CPU run of this phase's inputs
# read 2.2e-3 for the BSGS product (14 rotations and 64 plaintext products of
# noise, four times one rotation's 5.6e-4), 3.5e-3 for the naive one (63
# rotations), the two 3.2e-3 apart.  The limit is four times the largest; a
# wrong product is off by more than 1.
BSGS_LIMIT = 1.5e-2
OUT = Path("build") / "h100_profiling"


def count_into(total: dict) -> None:
    """Add the launch counts read now to `total` and set them to 0."""
    torch.cuda.synchronize()
    for form, count in ntt_cuda.KERNELS.launches.items():
        total[form] += count
    ntt_cuda.KERNELS.reset_counts()


def write_rows(name: str, cols: list, rows: list) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / name, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)


def phase_pease() -> dict:
    """G. The Pease pipeline on the card against a CPU run, forward and
    inverse, at (2, 21, 4096) and (1, 6, 65536); then ntt_pease's dispatch
    on an NttPlan, which must launch K1 (and K2) and equal the plan's
    transforms, the Pease output being the same evaluations in slot order nu."""
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    for batch, L, n in PEASE_SHAPES:
        primes = find_ntt_primes(n, 30, L)
        x = torch.from_numpy(np.random.default_rng(n).integers(0, min(primes), (batch, L, n)))
        runs = {}
        for dev in ("cuda", "cpu"):
            pease = ntt_pease.PeaseNttPlan.make(n, primes, dev)
            t0 = time.perf_counter()
            y = ntt_pease.negacyclic_ntt(x.to(dev), pease)
            back = ntt_pease.negacyclic_intt(y, pease)
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] = (y.cpu(), back.cpu(), time.perf_counter() - t0)
        if not (torch.equal(runs["cuda"][0], runs["cpu"][0])
                and torch.equal(runs["cuda"][1], runs["cpu"][1]) and torch.equal(runs["cpu"][1], x)):
            raise RuntimeError(f"Pease ({batch}, {L}, {n}): the card and the CPU differ")
        plan = NttPlan.make(n, primes, "cuda")
        xc = x.to("cuda")
        ntt_cuda.KERNELS.reset_counts()
        y = ntt_pease.negacyclic_ntt(xc, plan)
        back = ntt_pease.negacyclic_intt(y, plan)
        torch.cuda.synchronize()
        got = dict(ntt_cuda.KERNELS.launches)
        count_into(launches)
        large = form_of(kind_of(plan, batch, None))
        if got["fwd" + large] != 1 or got["inv" + large] != 1:
            raise RuntimeError(f"ntt_pease on an NttPlan ({batch}, {L}, {n}) launched {got}")
        if not (torch.equal(y, ntt_fwd_reference(xc, plan)) and torch.equal(back, xc)):
            raise RuntimeError(f"ntt_pease on an NttPlan ({batch}, {L}, {n}) is not the plan's NTT")
        nu_p, nu_k = runs["cpu"][0].numpy()[..., pease.nu_inv], y.cpu().numpy()[..., plan.nu_inv]
        if not np.array_equal(nu_p, nu_k):
            raise RuntimeError(f"Pease and NttPlan ({batch}, {L}, {n}) hold other evaluations")
        print(f"[pease] ({batch}, {L}, {n}): forward and inverse on the card equal the CPU "
              f"(first call {runs['cuda'][2]:.2f} s, CPU {runs['cpu'][2]:.2f} s); "
              f"negacyclic_ntt/intt on an NttPlan launched {got}, equal to the plain butterflies, "
              f"and hold the Pease output's evaluations in slot order nu")
    return launches


def phase_northstar() -> dict:
    """H. Both north-star rows at full size: the CKKS multiply + rescale at
    N = 65536 (34 + 1 limbs, 2^56 scale) equal to a CPU run of the port with
    max_err < 1e-6, and the BGV dot product at N = 16384, exact."""
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    ntt_cuda.KERNELS.reset_counts()
    row, m = northstar.ckks_row("cuda")
    count_into(launches)
    t0 = time.perf_counter()
    *_, m_cpu = northstar.ckks_case("cpu")
    count = same_arrays({"rescale(multiply)": m.to_numpy()}, {"rescale(multiply)": m_cpu.to_numpy()},
                        "north-star CKKS cuda vs cpu")
    print(f"[northstar] ckks_mult_rescale N={row['n']}, {row['limbs']} + 1 limbs: warm "
          f"{row['warm_ms']:.3f} ms, max_err {row['max_err']}, setup {row['setup_s']:.1f} s; "
          f"{count} arrays identical to a CPU run ({time.perf_counter() - t0:.1f} s)")
    if not row["exact"]:
        raise RuntimeError(f"north-star CKKS: max_err {row['max_err']} is not below 1e-6")
    brow, _ = northstar.bgv_row("cuda")
    count_into(launches)
    print(f"[northstar] bgv_dotprod N={brow['n']}, {brow['limbs']} limbs: warm "
          f"{brow['warm_ms']:.3f} ms, exact {brow['exact']}, setup {brow['setup_s']:.1f} s")
    if not brow["exact"]:
        raise RuntimeError("north-star BGV dot product is not exact")
    write_rows("h100_northstar.csv", northstar.COLUMNS, [row, brow])
    print(f"[northstar] kernel launches: {launches}")
    return launches


def print_profile_row(tag: str, row: dict) -> None:
    phases = ", ".join(f"{p} {row[p + '_us']:.1f}" for p in PHASES + MODDOWN_PARTS)
    print(f"[{tag}] n={row['n']} limbs={row['limbs']} dnum={row['dnum'] or '-'}: {phases} us; "
          f"total_us {row['total_us']:.1f} (the phases' sum), ctx.rotate profiled alone "
          f"{row['rotate_us']:.1f} us; shares NTT {row['NTT']:.4f} ModMul {row['ModMul']:.4f} "
          f"BaseConv {row['BaseConv']:.4f} Others {row['Others']:.4f} ({row['mode']}, "
          f"{row['lost_records']} device records lost)")


def phase_profiled(ctxs: dict, cts: dict) -> dict:
    """I. ProfiledRotation equal to ctx.rotate on the card at N=4096,
    N=65536 per-limb and N=65536 dnum=3; the rotation rows at N = 2048 ...
    65536 with 21 limbs, the dnum rows at N = 4096, the composition rows;
    every row's phases sum to its total_us (phase_profile raises if not)."""
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    for name in ("N=4096", "N=65536", f"N=65536 dnum={DNUM}"):
        ctx, ct = ctxs[name], cts[name]
        ntt_cuda.KERNELS.reset_counts()
        out = ProfiledRotation(ctx).rotate(ct, 1)
        count_into(launches)
        plain = ctx.rotate(ct, 1)
        if not all(torch.equal(a.data, b.data) for a, b in zip(out.c, plain.c)):
            raise RuntimeError(f"ProfiledRotation differs from ctx.rotate at {name}")
        print(f"[profiled] {name}: ProfiledRotation equals ctx.rotate (c0, c1)")
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    rows = list(phase_profile.rotation_rows(ROTATION_RINGS, PROFILE_LIMBS, "cuda"))
    dn_rows = list(phase_profile.dnum_rows(4096, PROFILE_LIMBS, DNUMS, "cuda"))
    comp = sweeps.composition_rows(4096, 2, 42, "cuda")
    count_into(launches)
    for tag, group in (("rotation", rows), ("dnum", dn_rows)):
        for row in group:
            print_profile_row(tag, row)
            phase_sum = sum(row[p + "_us"] for p in PHASES)
            if abs(phase_sum - row["total_us"]) > 1e-9 * row["total_us"]:
                raise RuntimeError(f"{tag} row n={row['n']}: phases {phase_sum} != total "
                                   f"{row['total_us']}")
    for group, part, share in comp:
        print(f"[composition] {group} {part}: {share}")
    write_rows("h100_rotation_profile.csv", phase_profile.COLUMNS, rows)
    write_rows("h100_dnum_N4096.csv", phase_profile.COLUMNS, dn_rows)
    write_rows("h100_op_composition.csv", ["group", "part", "share"],
               [dict(zip(["group", "part", "share"], r)) for r in comp])
    print(f"[profiled] rows in {time.perf_counter() - t0:.1f} s; kernel launches {launches}")
    return launches


def phase_ops_devtime() -> dict:
    """J. ops_devtime at its default (n = 4096, levels = 20) with each row's
    mode, and perf_suite at its defaults."""
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    ntt_cuda.KERNELS.reset_counts()
    rows = ops_devtime.measure(4096, 20, "cuda")
    for row in rows:
        print(f"[ops_devtime] {row['op']}: {row['us']} us ({row['mode']}, "
              f"{row['launches'] or '-'} launches)")
        if row["mode"] not in MODES or (row["us"] in ("", 0.0) and row["mode"] != "device-unresolved"):
            raise RuntimeError(f"ops_devtime row {row} has no reading")
    write_rows("h100_ops_devtime.csv", ops_devtime.COLUMNS, rows)
    for line in perf_suite.lines("all", 4096, 3, 10, "cuda"):
        print(f"[perf_suite] {line}")
    count_into(launches)
    print(f"[ops_devtime] kernel launches {launches}")
    return launches


def bsgs_run(device: str) -> tuple:
    ctx = CkksContext(CkksParams.make(**BENCH), seed=SEED, device=device)
    rng = np.random.default_rng(5)
    M = rng.uniform(-1, 1, (BSGS_D, BSGS_D))
    x = rng.uniform(-1, 1, BSGS_D)
    slots = BENCH["n"] // 2
    ct = ctx.encrypt(*ctx.encode(np.tile(x, slots // BSGS_D) + 0j))
    t0 = time.perf_counter()
    yb = bsgs.matvec_bsgs(ctx, M, ct)
    t1 = time.perf_counter()
    yn = bsgs.matvec_naive(ctx, M, ct)
    t2 = time.perf_counter()
    return ctx, M, x, ct, yb, yn, (t1 - t0, t2 - t1)


def phase_bsgs() -> dict:
    """K. matvec_bsgs and matvec_naive at N = 4096, 21 + 1 limbs, d = 64
    (B = G = 8: 7 baby and 7 giant rotations; the naive product 63), equal
    to a CPU run of the port, decrypting to M·x within BSGS_LIMIT, and to
    each other within it."""
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    ntt_cuda.KERNELS.reset_counts()
    ctx, M, x, ct, yb, yn, secs = bsgs_run("cuda")
    count_into(launches)
    warm = {name: wall_us(lambda: fn(ctx, M, ct), 3) / 1e3
            for name, fn in (("bsgs", bsgs.matvec_bsgs), ("naive", bsgs.matvec_naive))}
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    *_, yb_cpu, yn_cpu, _ = bsgs_run("cpu")
    count = same_arrays({"bsgs": yb.to_numpy(), "naive": yn.to_numpy()},
                        {"bsgs": yb_cpu.to_numpy(), "naive": yn_cpu.to_numpy()},
                        "BSGS N=4096 cuda vs cpu")
    want = np.tile(M @ x, BENCH["n"] // 2 // BSGS_D)
    got_b, got_n = ctx.decrypt_decode(yb), ctx.decrypt_decode(yn)
    errs = {"bsgs vs M.x": float(np.max(np.abs(got_b - want))),
            "naive vs M.x": float(np.max(np.abs(got_n - want))),
            "bsgs vs naive": float(np.max(np.abs(got_b - got_n)))}
    print(f"[bsgs] N=4096 21+1 limbs, d={BSGS_D}: first calls bsgs {secs[0]:.2f} s, naive "
          f"{secs[1]:.2f} s (keys included); warm bsgs {warm['bsgs']:.2f} ms, naive "
          f"{warm['naive']:.2f} ms; {count} arrays identical to a CPU run "
          f"({time.perf_counter() - t0:.1f} s); "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (limit {BSGS_LIMIT:g})")
    if not max(errs.values()) <= BSGS_LIMIT:
        raise RuntimeError(f"BSGS decryption off: {errs}")
    print(f"[bsgs] kernel launches {launches}")
    return launches


def phase_roofline() -> tuple:
    """L. The roofline at (4096, 21, 8), (16384, 6, 8) and (65536, 6, 8):
    the hand kernels in each form the shape takes, the plain butterflies and
    the Pease pipeline, against the byte and integer-operation bounds.
    Returns (launches, the SM clock read at the first shape)."""
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    clock = None
    all_rows = []
    ntt_cuda.KERNELS.reset_counts()
    for n, limbs, batch in ROOFLINE_SHAPES:
        rows = roofline.measure(n, limbs, batch, device="cuda")
        for row in rows:
            if row["us_per_call"] is None:
                raise RuntimeError(f"roofline {row['impl']} at ({n}, {limbs}, {batch}) is unresolved")
            print(f"[roofline] ({n}, {limbs}, {batch}) {row['impl']}: {row['us_per_call']:.3f} us "
                  f"({row['mode']}), {row['butterflies_per_s']} butterflies/s, hbm floor "
                  f"{row['hbm_floor_pct']:.2f}%, int ops {row['int_ops_peak_pct']:.2f}% of the peak "
                  f"at {row['sm_mhz']} MHz; bounds: bytes {row['bytes_bound_us']:.3f} us, "
                  f"operations {row['ops_bound_us']:.3f} us -> {row['bound_by']}")
        clock = clock or rows[0]["sm_mhz"]
        all_rows += rows
    count_into(launches)
    write_rows("h100_roofline.csv", roofline.COLUMNS, all_rows)
    print(f"[roofline] ops per butterfly {roofline.OPS_PER_BUTTERFLY} (lazy, from csrc/ntt.cu), "
          f"{roofline.OPS_PER_EXIT} per exit product; integer peak "
          f"{roofline.INT_OPS_PER_CLOCK_PER_SM} x {roofline.SMS} x SM clock; kernel launches {launches}")
    return launches, clock


# ---------------------------------------------------------------------------
# The reduction and control campaigns, the native engine, the grid audit and
# the motivation demos (phases M-Q)

CONTROL_N, CONTROL_T, CONTROL_LARGE_N = 64, 1000, 4096
STACKED_SHAPE = (2, 3, 4096)                           # (batch, L, n)
# outer_check_campaign at fold_k 4 and 8, T=2000, vec 256 (seed 4, its default)
OUTER = dict(ks=(4, 8), trials=2000, vec=256)
BARRETT_FOLD_CSV = "barrett_fold_MOF_T10000.csv"
MONTGOMERY_CSV = "montgomery_T300.csv"
BARRETT_FINAL_CSV = "barrett_final_T300.csv"


def reference_now() -> dict:
    """The reference's current outputs at the sweeps' settings, computed with
    rfhe_tpu on the CPU and pinned in the port (bench/reference_now.json)."""
    with open(Path(sweeps.__file__).with_name("reference_now.json")) as f:
        return json.load(f)


def _fmt_fold(key: str, d: dict) -> list:
    return key.split(",") + [f"{d['detection_rate']:.4f}", str(d["TP"]), str(d["FP"]),
                             str(d["TN"]), str(d["FN"])]


def _fmt_mont(key: str, d: dict) -> list:
    return key.split(",") + [f"{d['detection_rate']:.4f}"]


def _fmt_final(key: str, d: dict) -> list:
    return key.split(",") + [f"{d['miss_rate']:.6f}", str(d["det_intra_only"]),
                             str(d["det_sum_only"]), str(d["det_both"]), str(d["undetected"])]


def phase_grid(c: str) -> tuple:
    """M. The shape-grid audit (bench/fused_validate.py): the 24 (n, prime mix)
    points of the reference's grid, batch 5, every form of each ring (one-block
    up to n = 8192, two passes and cluster kernels at every n), K1, K2 of its
    output and the round trip bit for bit against the plain butterflies;
    its rows go to build/h100_profiling/.  Then every form's time beside its
    byte bound at the grid's (5, 3, 4096) and (5, 3, 65536), 30x3 primes."""
    path = OUT / "h100_fused_validate_grid.csv"
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    rc = fused_validate.run(path, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, by_kernels = dict(ntt_cuda.KERNELS.launches), dict(ntt_cuda.KERNELS.by_kernels)
    ntt_cuda.KERNELS.reset_counts()
    with open(path, newline="") as f:
        rows = [{k: int(v) if k not in ("bits", "form") else v for k, v in r.items()}
                for r in csv.DictReader(f)]
    bad = [r for r in rows if not (r["fwd_ok"] and r["inv_ok"] and r["roundtrip_ok"])]
    points = {(r["n"], r["bits"]) for r in rows}
    per_point = {p: sorted(r["form"] for r in rows if (r["n"], r["bits"]) == p) for p in points}
    want = lambda n: sorted(fused_validate.forms(n))
    if rc or bad or len(points) != 24 or any(f != want(n) for (n, _), f in per_point.items()):
        raise RuntimeError(f"grid audit: {len(bad)} mismatching rows {bad[:3]}, {len(points)} points")
    print(f"[grid] {len(rows)} rows at {len(points)} points, every form bit-exact (n=65536 at "
          f"31+30 in both large-ring forms) in {secs:.2f} s; launches {launches}, by kernels "
          f"{by_kernels}")
    for n in (4096, 65536):
        plan = NttPlan.make(n, fused_validate.grid_primes(n, fused_validate.BIT_SETS["30x3"]), "cuda")
        time_forms(c, plan, 5, list(fused_validate.forms(n).values()))
    ntt_cuda.KERNELS.reset_counts()
    return launches


def phase_control() -> None:
    """N. The radix-2 plans (ops/ntt_stacked.py) on the card against a CPU
    run, and the standard-NTT control campaign: every scenario x {mult,
    storage} at n=64 and one scenario per target at n=4096, T=1000, seed 42,
    each dict equal to a CPU run."""
    batch, L, n = STACKED_SHAPE
    primes = find_ntt_primes(n, 30, L)
    rng = np.random.default_rng(9)
    x, y = (torch.from_numpy(rng.integers(0, min(primes), STACKED_SHAPE)) for _ in range(2))
    outs = {}
    for dev in ("cuda", "cpu"):
        plan = ntt_stacked.StackedNttPlan.make(n, primes, dev)
        xd, yd = x.to(dev), y.to(dev)
        fwd = ntt_stacked.ntt(xd, plan)
        outs[dev] = [t.cpu() for t in (fwd, ntt_stacked.intt(fwd, plan),
                                       ntt_stacked.poly_mul_negacyclic(xd, yd, plan))]
    if not all(torch.equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"])):
        raise RuntimeError(f"StackedNttPlan {STACKED_SHAPE}: the card and the CPU differ")
    print(f"[stacked] StackedNttPlan ntt, intt and poly_mul_negacyclic at {STACKED_SHAPE} on the "
          f"card equal a CPU run")
    cases = [(CONTROL_N, sc, target) for sc in ntt_control.SCENARIOS for target in ("mult", "storage")]
    cases += [(CONTROL_LARGE_N, "SBF", "mult"), (CONTROL_LARGE_N, "MLF", "storage")]
    for n, sc, target in cases:
        q = find_ntt_prime(n, 12 if n == CONTROL_N else 30, negacyclic=False)
        t0 = time.perf_counter()
        card_res = ntt_control.standard_ntt_campaign(sc, target, CONTROL_T, n, q, 42, "cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cpu_res = ntt_control.standard_ntt_campaign(sc, target, CONTROL_T, n, q, 42, "cpu")
        print(f"[control] n={n} q={q} {json.dumps(card_res)} ({secs * 1e3:.1f} ms on the card)")
        if card_res != cpu_res:
            raise RuntimeError(f"control campaign {sc} {target} n={n}: card {card_res}, CPU {cpu_res}")
    print(f"[control] {len(cases)} campaigns of {CONTROL_T} trials equal to a CPU run, dict for dict")


def _campaign_walls(tag: str, timings: list, peak: int) -> None:
    wall = sum(t["wall_s"] for t in timings)
    host = sum(t["host_draw_s"] for t in timings)
    dev = sum(t["device_draw_s"] for t in timings)
    print(f"[{tag}] {len(timings)} campaigns in {wall:.2f} s: per campaign {wall / len(timings) * 1e3:.1f}"
          f" ms, of which host draws {host / len(timings) * 1e3:.1f} ms, device draws "
          f"{dev / len(timings) * 1e3:.1f} ms (the device waited for), the rest (device ops and "
          f"their launches) {(wall - host - dev) / len(timings) * 1e3:.1f} ms; peak device memory "
          f"{peak / 2**20:.0f} MiB")


def _sweep(tag: str, rows_fn, want: list) -> list:
    """Run one sweep's rows on the card against `want`, printing its walls."""
    timings = []
    torch.cuda.reset_peak_memory_stats()
    rows = [[str(v) for v in r] for r in rows_fn(timings)]
    torch.cuda.synchronize()
    for r, t in zip(rows, timings):          # one campaign a row
        print(f"[{tag}] {','.join(r)}  ({t['wall_s'] * 1e3:.1f} ms: host draws "
              f"{t['host_draw_s'] * 1e3:.1f}, device draws {t['device_draw_s'] * 1e3:.1f})")
    _campaign_walls(tag, timings, torch.cuda.max_memory_allocated())
    if rows != want:
        bad = [(r, w) for r, w in zip(rows, want) if r != w]
        raise RuntimeError(f"{tag}: {len(bad)} rows differ from the reference's: {bad[:3]}")
    return rows


def phase_reduction() -> None:
    """O. The reduction sweeps on the card: montgomery (21 rows) and
    barrett_final (112) at the CLI's defaults (T=300, vec 1024, seed 42),
    barrett_fold MOF at T=1000 (36 rows) and at T=10000 for fold widths 2 and
    24 (the rows of results/barrett_fold_MOF_T10000.csv), outer_check at
    fold_k 4 and 8 (T=2000, vec 256): every row equal to the reference's
    current output (bench/reference_now.json); the committed rows that the
    reference itself no longer gives are printed."""
    pins = reference_now()
    mont = {tuple(k.split(",")): _fmt_mont(k, d) for k, d in pins["montgomery_T300"].items()}
    _sweep("montgomery", lambda t: sweeps.montgomery_rows(300, 1024, 42, "cuda", t), list(mont.values()))
    final = {tuple(k.split(",")): _fmt_final(k, d) for k, d in pins["barrett_final_T300"].items()}
    _sweep("barrett_final", lambda t: sweeps.barrett_final_rows(300, 1024, 42, "cuda", t),
           list(final.values()))
    fold = [_fmt_fold(k, d) for k, d in pins["barrett_fold_MOF_T1000"].items()]
    _sweep("barrett_fold T=1000", lambda t: sweeps.barrett_fold_rows(
        1000, 1024, 1, 42, "MOF", range(2, 25, 2), "cuda", t), fold)
    fold10k = {tuple(k.split(",")): _fmt_fold(k, d) for k, d in pins["barrett_fold_MOF_T10000"].items()}
    _sweep("barrett_fold T=10000", lambda t: sweeps.barrett_fold_rows(
        10000, 1024, 1, 42, "MOF", (2, 24), "cuda", t), list(fold10k.values()))
    committed = [r for r in committed_rows(BARRETT_FOLD_CSV) if r[0] in ("2", "24")]
    print(f"[stale] {BARRETT_FOLD_CSV}: rows at fold widths 2 and 24 "
          f"{'equal' if committed == list(fold10k.values()) else 'differ from'} the card's "
          f"{[(r, w) for r, w in zip(committed, fold10k.values()) if r != w]}")
    for name, want in ((MONTGOMERY_CSV, mont), (BARRETT_FINAL_CSV, final)):
        rows = committed_rows(name)
        stale = [(r, want[tuple(r[:3])]) for r in rows if r != want[tuple(r[:3])]]
        print(f"[stale] {name}: {len(stale)} of {len(rows)} committed rows differ from the "
              f"reference's current output (committed, now): {stale}")
    timings = []
    torch.cuda.reset_peak_memory_stats()
    for k in OUTER["ks"]:
        for mode in reduction_campaigns.OUTER_MODES:
            timing = {}
            got = reduction_campaigns.outer_check_campaign(k, mode, OUTER["trials"],
                                                           vec_len=OUTER["vec"], device="cuda",
                                                           timing=timing)
            timings.append(timing)
            print(f"[outer] fold_k={k} {mode}: {json.dumps(got)} ({timing['wall_s'] * 1e3:.1f} ms)")
            if got != pins["outer_check_T2000"][f"{k},{mode}"]:
                raise RuntimeError(f"outer_check {k} {mode}: {got}, the reference "
                                   f"{pins['outer_check_T2000'][f'{k},{mode}']}")
    _campaign_walls("outer", timings, torch.cuda.max_memory_allocated())


# the settings and bounds of tests/test_native.py, and for the two reduction
# engines those of the device campaigns' tests (tests/test_reduction_campaigns.py:
# test_montgomery_full_scheme, test_barrett_final_intra_s4)
NATIVE_RUNS = (
    ("four_step_mc", ("SBF", 200_000, 64, 769, 24), dict(seed=42),
     lambda r: 0.0003 < r["miss_rate"] < 0.003 and r["stats"]["intra_catch"] > 0
     and r["stats"]["batch_catch"] > 0),
    ("three_stage_mc", ("MCF-CLE", 20_000, 8, 3, 4), dict(seed=1),
     lambda r: 0.45 < r["collision_prob"][0] < 0.65 and 0.45 < r["collision_prob"][2] < 0.65),
    ("three_stage_mc", ("SCF-BF", 20_000, 8, 12289, 24), dict(seed=2),
     lambda r: max(r["collision_prob"]) < 0.01),
    ("four_step_mc", ("MOF1", 50_000, 64, 769, 24), dict(seed=3), lambda r: r["miss_rate"] < 0.02),
    ("four_step_mc", ("SBF+SBF", 20_000, 64, 769, 24), dict(seed=42, target_stage=1),
     lambda r: r["miss_rate"] == 0.0 and r["stats"]["intra_catch"] == 20_000),
    ("four_step_mc", ("SBF+SBF", 20_000, 64, 769, 24), dict(seed=42, target_stage=0),
     lambda r: 0.001 < r["miss_rate"] < 0.01),
    ("four_step_mc", ("MLF+MLF", 20_000, 64, 769, 24), dict(seed=42, target_stage=2),
     lambda r: r["miss_rate"] < 0.01 and r["stats"]["batch2_catch"] > 19_000),
    ("montgomery_mc", (24, (True, True, True), 200), dict(pbits=37, vec_len=256, flip_count=2, seed=4),
     lambda r: r["detection_rate"] > 0.97),
    ("barrett_final_mc", (4, 1, 600), dict(pbits=37, vec_len=128, use_intra=True, use_range=False,
                                          use_sum=False, seed=6),
     lambda r: 0.01 < r["miss_rate"] < 0.15),
)


def phase_native() -> None:
    """P. The native engine's binding (native.py): built from
    native/rfhe_mc.cpp into build/native/, each of its four functions at the
    reference tests' settings, within their bounds, two calls at one
    OMP_NUM_THREADS giving identical counts."""
    t0 = time.perf_counter()
    lib = native.build()
    print(f"[native] {lib.relative_to(native.ROOT)} built in {time.perf_counter() - t0:.2f} s "
          f"(OMP_NUM_THREADS={os.environ.get('OMP_NUM_THREADS', 'unset')}, {os.cpu_count()} cores)")
    for name, args, kwargs, within in NATIVE_RUNS:
        fn = getattr(native, name)
        t0 = time.perf_counter()
        first = fn(*args, **kwargs)
        secs = time.perf_counter() - t0
        again = fn(*args, **kwargs)
        print(f"[native] {name}{args} {kwargs}: {json.dumps(first)} in {secs:.2f} s")
        if first != again or not within(first):
            raise RuntimeError(f"native {name}{args}: {first}, again {again}, within bounds "
                               f"{within(first)}")
    print(f"[native] {len(NATIVE_RUNS)} runs within the reference tests' bounds, each repeated "
          f"with identical counts")


def phase_motivation() -> dict:
    """Q. The motivation demos (models/motivation.py): main()'s six dicts
    equal to the reference's (bench/reference_now.json); plaintext_perturb
    (BGV at n=256, the one-block kernels) on the card equal to a CPU run."""
    pins = reference_now()["motivation"]
    ntt_cuda.KERNELS.reset_counts()
    got = motivation.demos("cuda")
    torch.cuda.synchronize()
    launches = dict(ntt_cuda.KERNELS.launches)
    ntt_cuda.KERNELS.reset_counts()
    cpu = motivation.plaintext_perturb(device="cpu")
    for name, res in got.items():
        print(f"[motivation] {name}: {res}")
    if got != pins or got["plaintext_perturb"] != cpu:
        raise RuntimeError(f"motivation: {got}, the reference {pins}, plaintext_perturb on the CPU {cpu}")
    print(f"[motivation] six dicts equal the reference's; plaintext_perturb on the card equals a "
          f"CPU run; kernel launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# The multi-device layer (phase R)
# ---------------------------------------------------------------------------

SHARDED_CKKS = ("N=4096", "N=65536")
FOUR_STEP_SHARDED = (1024, 8)                  # n, limbs (bench/scaling.py's default)
MXU_SHARDED = ((4096, 12), (65536, 21))        # n, limbs (bench/scaling_mxu.py's default; the path's)


@contextlib.contextmanager
def nccl_world():
    """This process as the only rank of an NCCL world (file:// store,
    120 s timeout); destroyed on the way out."""
    with tempfile.TemporaryDirectory(prefix="rfhe_nccl_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=timedelta(seconds=120), device_id=torch.device("cuda", 0))
        try:
            yield
        finally:
            dist.destroy_process_group()


def sharded_ckks_path(c: str, name: str, ctx: CkksContext, mesh) -> dict:
    """rotate(1), multiply_relin and rescale on the limb-sharded ciphertext,
    counted, each gathered array equal to the unsharded context's; then the
    warm wall of each op beside the unsharded one and NCCL's collectives at
    the op's shapes."""
    n = ctx.params.n
    z = np.random.default_rng(0).uniform(-1, 1, n // 2) + 0j
    ct = ctx.encrypt(*ctx.encode(z))
    plain = {"rotate": ctx.rotate(ct, 1), "multiply_relin": ctx.multiply_relin(ct, ct)}
    plain["rescale"] = ctx.rescale(plain["multiply_relin"])
    sh = ShardedCkks(ctx, mesh)
    torch.cuda.synchronize()
    ntt_cuda.KERNELS.reset_counts()
    t0 = time.perf_counter()
    sct = sh.shard(ct)
    got = {"rotate": sh.rotate(sct, 1), "multiply_relin": sh.multiply_relin(sct, sct)}
    got["rescale"] = sh.rescale(got["multiply_relin"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ntt_cuda.KERNELS.launches)
    ntt_cuda.KERNELS.reset_counts()
    for op, want in plain.items():
        if not same_arrays({op: sh.gather(got[op]).to_numpy()}, {op: want.to_numpy()},
                           f"sharded {op} at {name}"):
            raise RuntimeError(f"sharded {op} at {name}: no arrays compared")
    errs = (np.abs(ctx.decrypt_decode(sh.gather(got["rotate"])) - np.roll(z, -1)).max(),
            np.abs(ctx.decrypt_decode(sh.gather(got["rescale"])) - z * z).max())
    if not (errs[0] <= LIMITS[n][0] and errs[1] <= LIMITS[n][1]):
        raise RuntimeError(f"sharded CKKS at {name}: decryption errors {errs}, limits {LIMITS[n]}")
    large = "_large" if ntt_cuda.default_split(n) else ""
    if launches["fwd" + large] == 0 or launches["inv" + large] == 0:
        raise RuntimeError(f"sharded CKKS at {name} did not launch both kernels: {launches}")
    print(f"[sharded] {name}: rotate(1), multiply_relin, rescale on the limb-sharded ciphertext "
          f"(world of 1) equal the unsharded context's, array for array; decryption errors "
          f"{errs[0]:.3e}, {errs[1]:.3e} (limits {LIMITS[n]}); {secs:.3f} s first call; K1/K2 "
          f"launches {launches}")
    ops = {"rotate": (lambda: ctx.rotate(ct, 1), lambda: sh.rotate(sct, 1)),
           "multiply_relin": (lambda: ctx.multiply_relin(ct, ct),
                              lambda: sh.multiply_relin(sct, sct)),
           "rescale": (lambda: ctx.rescale(plain["multiply_relin"]),
                       lambda: sh.rescale(got["multiply_relin"]))}
    for op, (unsharded, sharded) in ops.items():
        # alternated, five readings of 10 calls each: the host-bound walls
        # spread by tens of percent from one reading to the next
        a, b = [], []
        for _ in range(5):
            a.append(wall_us(unsharded, 10))
            b.append(wall_us(sharded, 10))
        a, b = np.median(a), np.median(b)
        print(f"[sharded] {name} {op}: wall {b:.1f} us sharded (D=1), {a:.1f} us unsharded "
              f"(medians of 5 alternated readings of 10 calls), {b - a:+.1f} us; {c}")
    group = mesh.get_group("limb")
    rows = torch.zeros((ct.level + 1, n), dtype=torch.int64, device="cuda")
    top = torch.zeros((2, n), dtype=torch.int64, device="cuda")
    ag = wall_us(lambda: all_gather_cat(rows, group), 20)
    bc = wall_us(lambda: dist.broadcast(top, src=0, group=group), 20)
    print(f"[sharded] {name} NCCL (world of 1): all_gather of ({ct.level + 1}, {n}) words "
          f"{ag:.1f} us, broadcast of (2, {n}) {bc:.1f} us; {c}")
    return launches


def phase_sharded(c: str, ctxs: dict) -> dict:
    """R. The multi-device layer through an NCCL world of
    torch.cuda.device_count() ranks, which on this one-card machine is this
    process alone.  Returns the sharded CKKS paths' launches."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f"[sharded] {count} card: worlds of 2 or more ranks ran only as the CPU tests' gloo "
              f"worlds (tests/test_torch_distributed.py, _mxu_sharded.py, "
              f"_sharded_evaluator.py, _scaling.py); no scaling across cards is measured here")
    t0 = time.perf_counter()
    total = dict.fromkeys(ntt_cuda.FORMS, 0)
    rng = np.random.default_rng(3)
    with nccl_world():
        mesh = make_mesh(1, axis="limb", device="cuda")
        for name in SHARDED_CKKS:
            for form, k in sharded_ckks_path(c, name, ctxs[name], mesh).items():
                total[form] += k
        # the sharded four-step NTT and its protected form
        n, limbs = FOUR_STEP_SHARDED
        q = find_ntt_prime(n, 28)
        x1 = rng.integers(0, q, n, dtype=np.uint32)
        xb = rng.integers(0, q, (limbs, n), dtype=np.uint32)
        out = worlds.four_step_cases(n, q, x1, xb, 0, (3, 5, 7), (1,), "cuda")
        plan = FourStepPlan.make(n, q, "cuda")
        y = four_step_ntt(torch.from_numpy(xb.astype(np.int64)).cuda(), plan)
        prot, flipped = out[1, "protected"], out[1, "flipped"]
        if not (np.array_equal(out[1, "fwd", "batched"], to_numpy_u32(y))
                and np.array_equal(out[1, "inv", "batched"], xb)
                and np.array_equal(out[1, "fwd", "single"], to_numpy_u32(four_step_ntt(
                    torch.from_numpy(x1.astype(np.int64)).cuda(), plan)))
                and prot[1:] == (True, True, True) and not flipped[0]):
            raise RuntimeError(f"sharded four-step NTT at n={n}: flags {prot[1:]}, flipped {flipped}")
        print(f"[sharded] four_step_ntt_sharded / intt at n={n}, {limbs} limbs equal the unsharded "
              f"four-step NTT and the input; protected flags {prot[1:]} clean, {flipped} with one "
              f"flipped B1 word")
        # the sharded production NTT against K1 / K2
        for n, limbs in MXU_SHARDED:
            primes = find_ntt_primes(n, 30, limbs)
            x = rng.integers(0, min(primes), (limbs, n), dtype=np.uint32)
            flip = (limbs // 2, n // 3, 9)
            out = worlds.mxu_cases(n, primes, x, x[None], flip, (1,), "cuda")
            plan = NttPlan.make(n, primes, "cuda")
            xt = torch.from_numpy(x.astype(np.int64)).cuda()
            y = plan.fwd(xt)
            ok, bad_ok = out[1, "protected"][1], out[1, "flipped"][1]
            want_bad = np.ones(limbs, dtype=bool)
            want_bad[flip[0]] = False
            if not (np.array_equal(out[1, "fwd"], to_numpy_u32(y))
                    and np.array_equal(out[1, "inv"], to_numpy_u32(plan.inv(y)))
                    and np.array_equal(out[1, "roundtrip"], x)
                    and ok.all() and np.array_equal(bad_ok, want_bad)):
                raise RuntimeError(f"sharded production NTT at n={n}, L={limbs}: guard {ok}, "
                                   f"flipped {bad_ok}")
            fft = make_mesh(1, axis="fft", device="cuda")
            g = fft.get_group("fft")
            B = torch.zeros((limbs, plan.n2, plan.n1), dtype=torch.int64, device="cuda")
            a2a = wall_us(lambda: all_to_all_tiled(B, g, -2, -1), 20)
            ag = wall_us(lambda: all_gather_cat(B, g, -2), 20)
            xs = mxu_sharded.shard_coeffs(xt, plan, fft)
            walls = (wall_us(lambda: mxu_sharded.mxu_ntt_sharded(xs, plan, fft), 5),
                     wall_us(lambda: plan.fwd(xt), 20))
            print(f"[sharded] mxu_ntt_sharded / mxu_intt_sharded at n={n}, L={limbs} equal K1 / K2 "
                  f"(NttPlan.fwd / inv) and the round trip; guard flags all true clean, false only "
                  f"on limb {flip[0]} with one flipped output word; NCCL (world of 1) all_to_all "
                  f"{a2a:.1f} us, all_gather {ag:.1f} us of ({limbs}, {plan.n2}, {plan.n1}) words; "
                  f"wall of mxu_ntt_sharded {walls[0]:.1f} us, of NttPlan.fwd (K1) {walls[1]:.1f} "
                  f"us; {c}")
        for rows, what in ((scaling.measure(*FOUR_STEP_SHARDED, 20, "cuda"), "scaling"),
                           (scaling_mxu.measure(*MXU_SHARDED[0], 30, "cuda"), "scaling_mxu")):
            for row in rows:
                print(f"[sharded] {what}: {row}; {c}")
    print(f"[sharded] phase R in {time.perf_counter() - t0:.2f} s")
    return total


HEADLINE_RUNS = 3


def hold_at_shapes(shapes: dict, ring: NttPlan) -> dict:
    """K1 and K2 against their plain versions at each (form, batch, L, n) of
    `shapes` (ring n, the limbs a prefix of `ring`, or all of it): random
    residues forward, the forward's output back, error 0 and the round
    trip.  Returns the max abs error per form; the counts are reset after."""
    err = dict.fromkeys(ntt_cuda.FORMS, 0)
    g = torch.Generator(device="cuda").manual_seed(11)
    for form, batch, L, n in sorted(shapes):
        plan = ring if L == ring.L else ring.slice(L)
        x = torch.randint(0, 1 << 62, (batch, L, n), device="cuda", generator=g) % plan.q_arr[:, None]
        y = ntt_cuda.fwd(x, plan)
        back = ntt_cuda.inv(y, plan)
        large = "" if form in ("fwd", "inv") else "_large"
        err["fwd" + large] = max(err["fwd" + large], int((y - ntt_fwd_reference(x, plan)).abs().max()))
        err["inv" + large] = max(err["inv" + large],
                                 int((back - ntt_inv_reference(y, plan)).abs().max()))
        if not torch.equal(back, x):
            raise RuntimeError(f"K2(K1(x)) != x at ({batch}, {L}, {n})")
    torch.cuda.synchronize()
    ntt_cuda.KERNELS.reset_counts()
    if max(err.values()):
        raise RuntimeError(f"a kernel disagrees with its plain version at the headline's shapes: {err}")
    return err


def phase_entries(c: str) -> tuple:
    """S. The headline (bench/headline.py) and the entry points (entry.py)
    through the calls a user makes.  Returns (the K1/K2 launches of the
    headline and the dry run's ranks, the kernels' errors at the headline's
    shapes)."""
    t0 = time.perf_counter()
    ntt_cuda.KERNELS.reset_counts()
    readings = []
    for _ in range(HEADLINE_RUNS):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            headline.main(["--device", "cuda"])
        lines = buf.getvalue().strip().splitlines()
        print("\n".join(lines))
        if len(lines) != 2 or not lines[0].startswith("eager (no graphs)"):
            raise RuntimeError(f"the headline printed {lines}")
        line = lines[-1]
        rec = json.loads(line)
        if rec["metric"] != "h100_ckks_rotation_n4096_L21_latency" or rec["unit"] != "us":
            raise RuntimeError(f"headline line {line}")
        readings.append(rec["value"])
    torch.cuda.synchronize()
    k = ntt_cuda.KERNELS
    launches, shapes = dict(k.launches), dict(k.by_shape)
    if launches["fwd"] == 0 or launches["inv"] == 0:
        raise RuntimeError(f"the headline did not launch the one-block K1 and K2: {launches}")
    err = hold_at_shapes(shapes, NttPlan.make(4096, basis(4096, 1), "cuda"))
    print(f"[entry] {c}: headline {HEADLINE_RUNS} runs of 30 warm N=4096 21+1 rotations: "
          f"{', '.join(f'{v:.1f}' for v in readings)} us; K1/K2 launches {launches}; held at "
          f"{len(shapes)} shapes against the plain versions, max abs err {err} (tolerance 0)")
    fn, args = entry.entry("cuda")
    y, ok = fn(*args)
    cpu_fn, cpu_args = entry.entry("cpu")
    y_cpu, ok_cpu = cpu_fn(*cpu_args)
    e = int((y.cpu() - y_cpu).abs().max())
    if e or not torch.equal(ok.cpu(), ok_cpu) or not bool(ok.all()):
        raise RuntimeError(f"entry() on the card: max abs err {e} against the CPU, flags "
                           f"{ok.tolist()} / {ok_cpu.tolist()}")
    print(f"[entry] entry(): protected four-step NTT of {tuple(y.shape)} on cuda equal to the CPU "
          f"run, max abs err {e}, flags {ok.tolist()}")
    ntt_cuda.KERNELS.reset_counts()
    ranks = entry.dryrun_multichip(torch.cuda.device_count(), "cuda")
    for r in ranks:
        print(f"[entry] dryrun_multichip rank {r['rank']}: {r}")
        for form, count in r["launches"].items():
            launches[form] += count
    for form, count in ntt_cuda.KERNELS.launches.items():
        launches[form] += count
    print(f"[entry] phase S K1/K2 launches (headline and the dry run's ranks): {launches}; "
          f"phase S in {time.perf_counter() - t0:.2f} s")
    return launches, err


# ---------------------------------------------------------------------------
# T. the per-op CUDA graphs (utils/jitcache.py) against the eager ops
# ---------------------------------------------------------------------------
GRAPH_REPS = 30            # calls queued before one synchronise, per wall reading
GRAPH_ROUNDS = 3           # alternated graphed / eager readings, the median kept
FAULT_LOCATIONS = ((1, 17, 3), (7, 2049, 29))      # (limb, idx, bit) A and B of a stage


def host_arrays(tree) -> list:
    """The tensors of an op's result, copied to the host."""
    return [t.cpu().numpy() for t in jitcache.flatten(tree)[0]]


def kernel_counts(run) -> dict:
    """K1/K2 counts of one `run()`: transforms by form, `__global__` launches,
    transforms by the kernels that ran."""
    ntt_cuda.KERNELS.reset_counts()
    run()
    torch.cuda.synchronize()
    k = ntt_cuda.KERNELS
    return {"launches": dict(k.launches), "passes": dict(k.passes),
            "by_kernels": dict(k.by_kernels)}


def paired_walls(run) -> tuple:
    """(graphed, eager) microseconds per call: GRAPH_REPS calls queued and
    one synchronise, graphed and eager alternated GRAPH_ROUNDS times, the
    median of each."""
    walls = {False: [], True: []}
    for _ in range(GRAPH_ROUNDS):
        for is_eager in (False, True):
            with (jitcache.eager() if is_eager else contextlib.nullcontext()):
                run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(GRAPH_REPS):
                    run()
                torch.cuda.synchronize()
            walls[is_eager].append((time.perf_counter() - t0) / GRAPH_REPS * 1e6)
    return tuple(float(np.median(walls[e])) for e in (False, True))


def graph_case(tag: str, name: str, op, a, b, jits) -> dict:
    """One op through its graphs and under `eager()`: op(a), op(b) eagerly,
    then graphed A, B, A, B (a new signature's first call captures, every
    other call replays), each result bit for bit the eager one of its input
    and every earlier result unchanged after the last call; the K1/K2
    counts of a replay equal the eager op's; at most one capture per jit and
    signature, three replays or more.  `jits()` lists the HoistedJits the
    op runs.  Returns the readings."""
    with jitcache.eager():
        want = {"A": host_arrays(op(a)), "B": host_arrays(op(b))}
    op(a)                       # the first call of a new signature captures
    before = {id(j): (len(j.graphs), sum(g.replays for g in j.graphs)) for j in jits()}
    outs = []
    for label, x in (("A", a), ("B", b), ("A", a), ("B", b)):
        out = op(x)
        outs.append((label, out, host_arrays(out)))
    torch.cuda.synchronize()
    for i, (label, out, seen) in enumerate(outs):
        if not all(np.array_equal(s, w) for s, w in zip(seen, want[label])) \
                or len(seen) != len(want[label]):
            raise RuntimeError(f"{name}: graphed call {i} ({label}) differs from the eager op")
        if not all(np.array_equal(s, t) for s, t in zip(seen, host_arrays(out))):
            raise RuntimeError(f"{name}: result of call {i} ({label}) changed by a later replay")
    if all(np.array_equal(x, y) for x, y in zip(want["A"], want["B"])):
        raise RuntimeError(f"{name}: inputs A and B give the same result; the case shows nothing")
    used = []
    for j in jits():
        n0, r0 = before.get(id(j), (0, 0))
        made, replays = len(j.graphs) - n0, sum(g.replays for g in j.graphs) - r0
        if made or replays:
            used.append(j)
        if made != 0 or 0 < replays < 4:
            raise RuntimeError(f"{name}: {j.name} captured {made} graphs and replayed "
                               f"{replays} times over A, B, A, B; one signature and four "
                               f"replays expected")
    if not used:
        raise RuntimeError(f"{name}: no graph replayed")
    graphs = sum(len(j.graphs) for j in used)
    replay, eager_run = kernel_counts(lambda: op(b)), None
    with jitcache.eager():
        eager_run = kernel_counts(lambda: op(b))
    if replay != eager_run:
        raise RuntimeError(f"{name}: K1/K2 counts of a replay {replay} != eager {eager_run}")
    graphed_us, eager_us = paired_walls(lambda: op(a))
    g_kernels, g_launches, g_lost = op_counts(lambda: op(a), 3)
    with jitcache.eager():
        e_kernels, e_launches, e_lost = op_counts(lambda: op(a), 3)
    capture_s = sum(g.capture_s for j in used for g in j.graphs)
    row = {"op": name, "graphed_us": graphed_us, "eager_us": eager_us,
           "kernels_graphed": g_kernels, "kernels_eager": e_kernels,
           "host_launches_graphed": g_launches, "host_launches_eager": e_launches,
           "lost_records": g_lost + e_lost, "graphs": graphs, "capture_s": capture_s,
           "ntt_per_call": replay["launches"]}
    print(f"[{tag}] {name}: graphed {graphed_us:.1f} us, eager {eager_us:.1f} us per call "
          f"({GRAPH_REPS} queued, one synchronise, median of {GRAPH_ROUNDS} alternated rounds); "
          f"device operations {g_kernels:.0f} graphed / {e_kernels:.0f} eager, host launches "
          f"{g_launches:.0f} / {e_launches:.0f} per call ({g_lost + e_lost} records lost); "
          f"NTT transforms per call {replay['launches']} = eager; {graphs} graph(s), capture "
          f"{capture_s * 1e3:.1f} ms; A, B, A, B bit-exact, earlier results unchanged")
    return row


def jits_of(*owners):
    """The HoistedJits of `owners` (contexts and evaluators), at call time."""
    return lambda: [j for o in owners for j in o._jits.values()]


def ckks_cases(tag: str, label: str, ctx: CkksContext, rotate_only: bool) -> list:
    n = ctx.params.n
    zs = np.random.default_rng(21).uniform(-1, 1, (2, n // 2)) + 0j
    pts = [ctx.encode(z) for z in zs]
    rng = ctx.rng

    def encrypt(x):
        ctx.rng = np.random.default_rng(x[1])
        return ctx.encrypt(*x[0])

    cta, ctb = encrypt((pts[0], 100)), encrypt((pts[1], 101))
    rows = [graph_case(tag, f"{label} rotate", lambda ct: ctx.rotate(ct, 1), cta, ctb,
                       jits_of(ctx))]
    if not rotate_only:
        prods = [ctx.multiply_relin(ct, ct) for ct in (cta, ctb)]
        rows += [graph_case(tag, f"{label} encrypt", encrypt, (pts[0], 100), (pts[1], 101),
                            jits_of(ctx)),
                 graph_case(tag, f"{label} multiply_relin", lambda ct: ctx.multiply_relin(ct, ct),
                            cta, ctb, jits_of(ctx)),
                 graph_case(tag, f"{label} rescale", ctx.rescale, *prods, jits_of(ctx)),
                 graph_case(tag, f"{label} decrypt", ctx.decrypt, cta, ctb, jits_of(ctx)),
                 graph_case(tag, f"{label} decrypt_words", ctx.decrypt_words, cta, ctb,
                            jits_of(ctx))]
        err = np.abs(ctx.decrypt_decode(ctx.rotate(cta, 1)) - np.roll(zs[0], -1)).max()
        if not err <= LIMITS[n][0]:
            raise RuntimeError(f"{label}: the graphed rotation decrypts with error {err}")
    ctx.rng = rng
    return rows


def protected_cases(tag: str, label: str, ctx: CkksContext) -> list:
    """ProtectedCkks rotate, clean and with one fault per stage: A and B are
    two fault locations of the stage, 0-d tensors on the card, so one
    graph per stage serves both."""
    prot = ProtectedCkks(ctx)
    zs = np.random.default_rng(22).uniform(-1, 1, (2, ctx.params.n // 2)) + 0j
    cta, ctb = (ctx.encrypt(*ctx.encode(z)) for z in zs)
    rows = [graph_case(tag, f"{label} protected rotate", lambda ct: prot.rotate(ct, 1),
                       cta, ctb, jits_of(prot))]
    for stage in evaluator_campaign.STAGES + ("c1_perm",):
        a, b = (Fault(stage, *(torch.tensor(v, device="cuda") for v in loc))
                for loc in FAULT_LOCATIONS)
        rows.append(graph_case(tag, f"{label} protected rotate, {stage} fault",
                               lambda f: prot.rotate(cta, 1, f), a, b, jits_of(prot)))
        _, flags = prot.rotate(cta, 1, a)
        if stage != "ks_out" and bool(all_ok(flags)):
            raise RuntimeError(f"{label}: the graphed {stage} fault fired no detector")
    return rows


def phase_graphs(c: str, ctxs: dict, bgv: tuple, bfv: tuple) -> tuple:
    """T. Every listed path through its graphs and under `eager()` in one
    process: the N=4096 path (encrypt, rotate, multiply_relin, rescale,
    decrypt), the N=65536 per-limb and dnum=3 rotations, the BGV dot
    product at N=16384, BFV multiply_relin at N=16384, ProtectedCkks rotate
    clean and with one fault per stage at N=4096 (`graph_case`); then K1
    and K2 launched from a replay equal to the same kernels launched eagerly
    and to their plain versions at every shape the graphed N=4096 and
    N=65536 ops launch.  Returns (the K1/K2 launches of the phase, rows)."""
    t0 = time.perf_counter()
    launches = dict.fromkeys(ntt_cuda.FORMS, 0)
    shapes = {}
    rows = (ckks_cases("graphs", "N=4096", ctxs["N=4096"], rotate_only=False)
            + ckks_cases("graphs", "N=65536", ctxs["N=65536"], rotate_only=True)
            + ckks_cases("graphs", f"N=65536 dnum={DNUM}", ctxs[f"N=65536 dnum={DNUM}"],
                         rotate_only=True))
    bctx, ct_x, ct_y = bgv
    rows.append(graph_case("graphs", f"BGV N={bctx.params.n} dot product",
                           lambda p: dot_product_bgv(bctx, *p), (ct_x, ct_y), (ct_x, ct_x),
                           jits_of(bctx)))
    got = bctx.decrypt_decode(dot_product_bgv(bctx, ct_x, ct_y))
    m1, m2 = bgv_messages(bctx)
    if not (got == int((m1.astype(object) * m2.astype(object)).sum()) % bctx.t).all():
        raise RuntimeError("the graphed BGV dot product does not decrypt to sum(x*y) mod t")
    fctx, ct1, ct2 = bfv
    rows.append(graph_case("graphs", f"BFV N={fctx.params.n} multiply_relin",
                           lambda p: fctx.multiply_relin(*p), (ct1, ct2), (ct1, ct1),
                           jits_of(fctx)))
    rows += protected_cases("graphs", "N=4096", ctxs["N=4096"])
    # K1/K2 from a replay against the eager launch and the plain version
    for name in ("N=4096", "N=65536"):
        ctx = ctxs[name]
        ct = ctx.encrypt(*ctx.encode(np.zeros(ctx.params.n // 2) + 0j))
        ntt_cuda.KERNELS.reset_counts()
        ctx.rotate(ct, 1)
        torch.cuda.synchronize()
        shapes[name] = dict(ntt_cuda.KERNELS.by_shape)
    err = dict.fromkeys(ntt_cuda.FORMS, 0)
    g = torch.Generator(device="cuda").manual_seed(13)
    for name, by_shape in shapes.items():
        ring = ctxs[name].ctx.plan
        for form, batch, L, n in sorted(by_shape):
            plan = ring.slice(L) if L < ring.L else ring
            inverse = form.startswith("inv")
            kernel = ntt_cuda.inv if inverse else ntt_cuda.fwd
            plain = ntt_inv_reference if inverse else ntt_fwd_reference
            replayed = jitcache.hoisted_jit(lambda x: kernel(x, plan), name=f"{form} {batch}x{L}x{n}")
            for _ in range(3):          # capture, then two replays on new inputs
                x = torch.randint(0, 1 << 62, (batch, L, n), device="cuda",
                                  generator=g) % plan.q_arr[:, None]
                y = replayed(x)
                e = kernel(x, plan)
                if not torch.equal(y, e):
                    raise RuntimeError(f"{form} ({batch}, {L}, {n}): a replay differs from the "
                                       f"eager launch")
                err[form] = max(err[form], int((y - plain(x, plan)).abs().max()))
    if max(err.values()):
        raise RuntimeError(f"a replayed kernel disagrees with its plain version: {err}")
    print(f"[graphs] K1/K2 replayed at {sum(len(s) for s in shapes.values())} shapes of the "
          f"N=4096 and N=65536 rotations: equal to the eager launches bit for bit, max abs err "
          f"against the plain versions {err} (tolerance 0)")
    ntt_cuda.KERNELS.reset_counts()
    for owner in (ctxs["N=4096"], ctxs["N=65536"], ctxs[f"N=65536 dnum={DNUM}"], bctx, fctx):
        pool = owner._graphs
        print(f"[graphs] {c}: pool of {type(owner).__name__} N={owner.params.n} "
              f"(dnum={owner.dnum}): {pool.graphs} graphs, {pool.bytes} bytes reserved by "
              f"their captures, {pool.capture_s:.2f} s capturing")
    for row in rows:
        for form, count in row["ntt_per_call"].items():
            launches[form] += count
    write_rows("h100_graphs.csv", list(rows[0]), rows)
    print(f"[graphs] phase T in {time.perf_counter() - t0:.2f} s, {len(rows)} ops")
    return launches, err, rows


def kernel_records(err: dict, launches: dict, times: dict, protected: dict,
                   scheme: dict, faults: dict, profiling: dict, validate: dict,
                   demos: dict, sharded: dict, entries: dict, graphs: dict) -> list:
    """One record per kernel form at its path's keyswitch shape, in the form
    that shape takes by itself, with every other shape and form timed in this
    run under `other_shapes`.  `ms` is the device timer's reading, `paced_ms`
    the host-paced one.  `launches` counts every counted path;
    `launches_protected`, `launches_bgv_bfv`, `launches_faults` and
    `launches_profiling`, `launches_validate` and `launches_motivation` are
    the shares of the protected paths and campaigns, of the BGV, BFV and
    ProtectedBgv paths, of the fault campaigns and the monitor, of the
    profiling layer (phases G-L), of the grid audit (phase M), of the
    motivation demos (phase Q); `launches_sharded` is the limb-sharded CKKS
    paths' (phase R), `launches_entry` the headline's and the dry run's
    (phase S), `launches_graphs` the graphed and eager ops of phase T (each
    NTT of a replay counted as one launch of its kernel)."""
    records = []
    for d in ("fwd", "inv"):
        for large, key in (("", "4096"), ("_large", "65536")):
            head = next(v for (dd, _), v in times[key].items() if dd == d and v["default"])
            others = [dict(v, of=name) for name, group in times.items()
                      for (dd, kind), v in group.items()
                      if dd == d and form_of(kind) == large and v is not head]
            records.append({"name": f"ntt_{d}{large}", "route": "cuda", "source": SOURCE,
                            "replaces": REPLACES[d], "launches": launches[d + large],
                            "launches_protected": protected[d + large],
                            "launches_bgv_bfv": scheme[d + large],
                            "launches_faults": faults[d + large],
                            "launches_profiling": profiling[d + large],
                            "launches_validate": validate[d + large],
                            "launches_motivation": demos[d + large],
                            "launches_sharded": sharded[d + large],
                            "launches_entry": entries[d + large],
                            "launches_graphs": graphs[d + large],
                            "max_abs_err": err[d + large], "ms": head["ms"],
                            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                            "bound_by": head["bound_by"], "library_ms": None,
                            "timer": DEVICE_TIMER, "paced_ms": head["paced_ms"],
                            "shape": head["shape"], "form": head["form"],
                            "other_shapes": others})
    return records


def main() -> None:
    c = phase_toolchain()
    phase_build()
    err = phase_kernels()
    ctxs, launches = {}, dict.fromkeys(ntt_cuda.FORMS, 0)
    by_kernels = dict.fromkeys(ntt_cuda.KERNEL_SETS, 0)
    paths = {"N=4096": phase_main_path, "N=65536": phase_large_per_limb,
             f"N=65536 dnum={DNUM}": phase_large_grouped}
    for name, phase in paths.items():
        ctxs[name], path_launches, path_kernels = phase()
        for form, count in path_launches.items():
            launches[form] += count
        for kernels, count in path_kernels.items():
            by_kernels[kernels] += count
    for n, (ctx, _, ring_launches) in phase_mid_rings().items():
        ctxs[f"N={n}"] = ctx
        for form, count in ring_launches.items():
            launches[form] += count
    # BGV, BFV and ProtectedBgv at N = 16384
    scheme = dict.fromkeys(ntt_cuda.FORMS, 0)
    bgv, bgv_launches, _ = phase_bgv()
    bfv, bfv_launches, _ = phase_bfv()
    pbgv_launches, _ = phase_protected_bgv(bgv)
    for path in (bgv_launches, bfv_launches, pbgv_launches):
        for form, count in path.items():
            scheme[form] += count
    protected, prot_kernels = phase_protected(ctxs)
    for form, count in phase_campaign().items():
        protected[form] += count
    # the fault-injection campaigns (phases A-E)
    phase_pbits()
    phase_four_step()
    faults = dict.fromkeys(ntt_cuda.FORMS, 0)
    for path in (phase_flip_impact(), phase_dotprod_campaign(), phase_monitor()):
        for form, count in path.items():
            faults[form] += count
    cts = phase_counts(ctxs)
    phase_overheads(c)
    phase_atom_overheads(c)
    times = phase_times(ctxs, cts, c)
    times.update(phase_scheme_times(c, bgv, bfv))
    times.update(phase_fault_times(c))
    # the profiling layer (phases G-L), last: a long process's torch.profiler
    # sessions lose device records (device.padded_profile), more the more
    # sessions came before, so the earlier phases run before this layer's
    profiling = dict.fromkeys(ntt_cuda.FORMS, 0)
    for run in (phase_pease, phase_northstar, lambda: phase_profiled(ctxs, cts),
                phase_ops_devtime, phase_bsgs, lambda: phase_roofline()[0]):
        for form, count in run().items():
            profiling[form] += count
    # the grid audit, the control and reduction campaigns, the native engine
    # and the motivation demos (phases M-Q)
    validate = phase_grid(c)
    phase_control()
    phase_reduction()
    phase_native()
    demos = phase_motivation()
    # the multi-device layer (phase R), last
    sharded = phase_sharded(c, ctxs)
    # the repository's entry files (phase S)
    entries, entry_err = phase_entries(c)
    # the per-op graphs against the eager ops (phase T), last
    graphs, graph_err, _ = phase_graphs(c, ctxs, bgv, bfv)
    for form in launches:
        launches[form] += (protected[form] + scheme[form] + faults[form] + profiling[form]
                           + validate[form] + demos[form] + sharded[form] + entries[form]
                           + graphs[form])
        err[form] = max(err[form], entry_err[form], graph_err[form])
    print(f"[main] kernel launches over all counted paths: {launches}, of which on the protected "
          f"CKKS paths and the campaigns {protected}, on the BGV, BFV and ProtectedBgv paths "
          f"{scheme}, in the fault campaigns and the monitor {faults}, in the profiling layer "
          f"{profiling}, in the grid audit {validate}, in the motivation demos {demos}, on the "
          f"limb-sharded CKKS paths {sharded}, in the headline and the dry run {entries}, in "
          f"the graphs phase {graphs}")
    print(f"[main] on the N=4096 and the two N=65536 paths, by the kernels that ran: {by_kernels}; "
          f"protected: {prot_kernels}")
    if min(launches.values()) == 0 or min(by_kernels.values()) == 0:
        raise RuntimeError(f"kernels that no path launched: {launches}, {by_kernels}")
    print(json.dumps({"kernels": kernel_records(err, launches, times, protected, scheme, faults,
                                                profiling, validate, demos, sharded,
                                                entries, graphs)}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
