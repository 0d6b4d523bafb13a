#!/usr/bin/env python3
"""Drive the rfhe_tpu_torch port once on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each a plain function; any failure raises and the exit code is not 0:
  1. toolchain: card, power limit, torch/CUDA versions, nvcc; needs sm_90
  2. build: compile csrc/ntt.cu with nvcc and load it
  3. kernels vs plain: every NTT kernel form against its plain PyTorch version
     on the card, bit for bit: the one-block kernels at the N=4096 path's
     shapes; the one-block, two-pass and cluster kernels at n=16384 and 32768
     and both large-ring kernels at n=65536 at the large paths' shapes
     (per-limb and grouped digits, special limbs, mod-down deltas,
     non-contiguous takes, 30- and 31-bit primes); batches that the polynomial
     groups do not divide and a batch of 70000; and the large-ring kernels at
     n=256 and 4096 against the one-block kernels
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
  7. one rotation each at N=16384 and N=32768, 21 + 1 limbs
  8. launch counts per rotation at each ring and for dnum=3
  9. times with CUDA events: each kernel form against its plain version at
     every shape a rotation launches, (21, 22, n), (2, 21, n), (1, 21, n),
     (2, 1, n) and (3, 28, 65536), at (5, 22, n) and (10, 22, n), between which
     a launch changes from the cluster kernels to the two passes, and warm
     rotations

The third-to-last line is the per-kernel JSON record, the second-to-last
names the card and its power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import torch

from rfhe_tpu_torch.device import card, cuda_ms, to_numpy_u32
from rfhe_tpu_torch.fhe import CkksContext, CkksParams
from rfhe_tpu_torch.fhe.keys import compute_digits
from rfhe_tpu_torch.fhe.params import make_prime_chain
from rfhe_tpu_torch.fhe.rns import poly_intt
from rfhe_tpu_torch.ops import ntt_cuda
from rfhe_tpu_torch.ops.ntt import NttPlan, ntt_fwd_reference, ntt_inv_reference

SEAL_ROTATION_US = 14_377.0      # reference: SEAL 4.1 CPU, N=4096, 21 limbs
SOURCE = "rfhe_tpu_torch/csrc/ntt.cu"
REPLACES = {"fwd": "rfhe_tpu/ops/ntt_fused.py:250 (_fwd_kernel)",
            "inv": "rfhe_tpu/ops/ntt_fused.py:270 (_inv_kernel)"}
CHAIN = dict(levels=20, q0_bits=30, scale_bits=28)      # 21 ciphertext primes
BENCH = dict(n=4096, **CHAIN)
LARGE = dict(n=65536, **CHAIN)
SHALLOW = dict(n=65536, levels=2, q0_bits=30, scale_bits=28)
LARGE_RINGS = (16384, 32768, 65536)
DNUM = 3
SEED = 7
# Limits on the decrypted slots, (rotation, square) by ring.  The chain's
# 28-bit scale is the rotation profile's, not a precision setting: the
# reference's keyswitch takes non-centred digits, whose noise is
# low-frequency and grows in a slot about 3.5x per doubling of N (5.6e-4 at
# N=4096, 6.3e-2 at N=65536 on per-limb digits).  A wrong decryption is off
# by far more than 1; bit-exactness is held by the array comparisons.
LIMITS = {4096: (1e-3, 1e-2), 16384: (2e-2, 2e-2), 32768: (6e-2, 5e-2), 65536: (2e-1, 1e-1)}
FOURTH_POWER_LIMIT = 2e-1

# The least time the card could take (H100 SXM data sheet): bytes over the
# memory rate against operations over the peak rate.  The butterflies are
# 32-bit integer operations, for which the sheet has no row; they are counted
# against its float32 rate outside the tensor cores, which the integer units
# do not exceed, so the bound stays a lower bound.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_BUTTERFLY = 12           # Shoup product 6, modular add 3, modular sub 3
OPS_PER_SCALE = 6                # the exit factor: one Shoup product


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
    three vectors of the reference's kernel self-check."""
    q = np.array(plan.primes, dtype=np.int64)[:, None]
    rng = np.random.default_rng(seed)
    shape = (batch, plan.L, plan.n)
    rand = (rng.integers(0, 1 << 62, shape, dtype=np.int64) % q)
    full = np.broadcast_to(q - 1, shape).copy()
    spike = np.zeros(shape, dtype=np.int64)
    spike[..., 0] = (q - 1)[:, 0]
    spike[..., plan.n // 2] = 1
    return [("random", rand), ("all q-1", full), ("spike", spike)]


def forms_of(n: int) -> list:
    """The selector of every form that ring n can take: the one-block
    kernels (0) where the ring fits one block, and both large-ring kernels
    at the ring's own split."""
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
    cases = [
        ("n=4096 (21, 22) keyswitch digits", full, 21, [None, (two_pass, 6), (cluster, 6)]),
        ("n=4096 (2, 1) special limb", full.take([special]), 2, [None, (two_pass, 8), (cluster, 4)]),
        ("n=4096 (2, 21) mod-down delta", full.slice(special), 2, [None]),
        ("n=4096 (3, 3) non-contiguous take", full.take([special, 0, 7]), 3, [None, (two_pass, 5), (cluster, 5)]),
        ("n=2048 31-bit (3, 3)", NttPlan.make(2048, make_prime_chain(2048, [31] * 3), "cuda"), 3,
         [None, (two_pass, 4), (cluster, 7)]),
        ("n=256 30-bit (3, 3)", small, 3, [None, (two_pass, 4), (cluster, 4), (two_pass, 7), (cluster, 7)]),
        ("n=256 (70000, 1) beyond grid.y", small.take([1]), 70000, [(two_pass, 4), (cluster, 5)]),
    ]
    for n in LARGE_RINGS:
        splits = [None] + forms_of(n)
        grouped = NttPlan.make(n, basis(n, 7), "cuda")       # 21 + 7 limbs
        mixed = grouped.take([27, 3, 21, 0, 24, 20])
        cases += [
            (f"n={n} (21, 22) per-limb digits", grouped.slice(22), 21, splits),
            (f"n={n} (2, 1) special limb", grouped.take([21]), 2, splits),
            (f"n={n} (2, 21) mod-down delta", grouped.slice(21), 2, splits),
            (f"n={n} (1, 21) c1", grouped.slice(21), 1, splits),
            (f"n={n} (3, 6) take with specials", mixed, 3, splits),
            (f"n={n} (3, 28) grouped digits", grouped, 3, splits),
            # batches that the polynomial groups do not divide (loops of uneven length)
            (f"n={n} (23, 6) uneven groups", mixed, 23, forms_of(n)[-2:]),
            (f"n={n} (5, 6) uneven groups", mixed, 5, forms_of(n)[-2:]),
            (f"n={n} 31-bit (3, 3)", NttPlan.make(n, make_prime_chain(n, [31] * 3), "cuda"), 3, splits),
        ]
    return cases


def phase_kernels() -> dict:
    err = dict.fromkeys(ntt_cuda.FORMS, 0)
    checked = dict.fromkeys(ntt_cuda.FORMS, 0)
    kinds = set()
    for i, (name, plan, batch, splits) in enumerate(kernel_cases()):
        vectors = test_vectors(plan, batch, seed=i)
        for vname, xv in vectors if batch <= 64 else vectors[:1]:
            x = torch.from_numpy(xv).cuda()
            y_ref = ntt_fwd_reference(x, plan)
            back_ref = ntt_inv_reference(y_ref, plan)
            for split in splits:
                kind = kind_of(plan, batch, split)
                large = form_of(kind)
                kinds.add((kind, plan.n))
                y = ntt_cuda.fwd(x, plan, split)
                back = ntt_cuda.inv(y_ref, plan, split)
                torch.cuda.synchronize()
                e_f = int((y - y_ref).abs().max())
                e_i = int((back - back_ref).abs().max())
                err["fwd" + large] = max(err["fwd" + large], e_f)
                err["inv" + large] = max(err["inv" + large], e_i)
                checked["fwd" + large] += 1
                checked["inv" + large] += 1
                form = kind if split is None or not large else f"{kind} 2^{split[1]}"
                print(f"[kernels] {name:36s} {vname:8s} {form:22s} fwd err {e_f} inv err {e_i} "
                      f"inv(fwd(x)) == x: {torch.equal(back, x)}")
                if not (e_f == 0 and e_i == 0 and torch.equal(back, x)):
                    raise RuntimeError(f"kernel disagrees with its plain version: {name}, {vname}, {form}")
    print(f"[kernels] comparisons per kernel form: {checked}, max abs err {err} (tolerance 0)")
    if min(checked.values()) == 0:
        raise RuntimeError(f"a kernel form was never compared: {checked}")
    missing = [(k, n) for n in LARGE_RINGS for k in (ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER)
               if (k, n) not in kinds]
    if missing:
        raise RuntimeError(f"large-ring kernels never compared: {missing}")
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
    """One rotation at N=16384 and N=32768, 21 + 1 limbs, so every ring the
    TPU kernels serve is launched on a real path."""
    out = {}
    for n in (16384, 32768):
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


def bound_ms(batch: int, L: int, n: int, kind: str) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card could take for
    one transform of (batch, L, n) int64 residues by the kernels `kind`.
    Bytes: the input read and the output written once, plus the direction's
    twiddle and Shoup rows of the L limbs and, in the one-block kernels only,
    the slot table (the large-ring kernels compute the slot and read none).
    Operations: n/2·log2(n) butterflies and n exit products per vector."""
    log_n = n.bit_length() - 1
    moved = 2 * 8 * batch * L * n + L * 2 * n * 4 + (n * 4 if kind == "one_block" else 0)
    ops = batch * L * (n // 2 * log_n * OPS_PER_BUTTERFLY + n * OPS_PER_SCALE)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


L2_BYTES = 50e6                  # the card's L2 cache


def time_forms(c: str, plan: NttPlan, batch: int, splits: list) -> dict:
    """Kernel (each form of `splits`) and plain times of both directions at
    (batch, L, n), in the order plain, kernel, kernel, plain.  `cuda_ms`
    repeats one input, so a shape whose working set (input, output and the
    two passes' uint32 intermediate) is under the L2's 50 MB is served from
    the cache and the HBM bound is not what binds it: each line says so."""
    q = plan.q_arr[:, None]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 1 << 62, (batch, plan.L, plan.n), device="cuda", generator=g) % q
    y = plan.fwd(x)
    plain_reps = 20 if plan.n <= 4096 else 4
    out = {}
    for d, data, kern, plain in (("fwd", x, ntt_cuda.fwd, ntt_fwd_reference),
                                 ("inv", y, ntt_cuda.inv, ntt_inv_reference)):
        p1 = cuda_ms(lambda: plain(data, plan), plain_reps)
        ks = {s: [cuda_ms(lambda: kern(data, plan, s)) for _ in range(2)] for s in splits}
        p2 = cuda_ms(lambda: plain(data, plan), plain_reps)
        for s, (k1, k2) in ks.items():
            kind = kind_of(plan, batch, s)
            b_ms, b_by = bound_ms(batch, plan.L, plan.n, kind)
            working = x.numel() * (20 if kind == ntt_cuda.TWO_PASS else 16)
            in_l2 = working < L2_BYTES
            taken = " (default)" if kind == kind_of(plan, batch, None) else ""
            print(f"[times] {c}: {d} NTT ({batch}, {plan.L}, {plan.n}) {kind}{taken}: kernel {k1:.4f} / "
                  f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms (plain, kernel, kernel, plain), "
                  f"bound {b_ms:.4f} ms by {b_by}, share of bound {200 * b_ms / (k1 + k2):.0f}%, "
                  f"working set {working / 1e6:.1f} MB {'under' if in_l2 else 'over'} the L2")
            out[d, kind] = {"shape": [batch, plan.L, plan.n], "form": kind, "ms": (k1 + k2) / 2,
                            "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms, "bound_by": b_by,
                            "default": bool(taken), "working_set_in_l2": in_l2}
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
    bench = NttPlan.make(4096, basis(4096, 1), "cuda")
    times = {"4096": time_forms(c, bench, 21, [0]),
             "4096 mod-down delta": time_forms(c, bench.slice(21), 2, [0]),
             "4096 c1": time_forms(c, bench.slice(21), 1, [0]),
             "4096 special limb": time_forms(c, bench.take([21]), 2, [0])}
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


def kernel_records(err: dict, launches: dict, times: dict) -> list:
    """One record per kernel form at its path's keyswitch shape, in the form
    that shape takes by itself, with every other shape and form timed in this
    run under `other_shapes`."""
    records = []
    for d in ("fwd", "inv"):
        for large, key in (("", "4096"), ("_large", "65536")):
            head = next(v for (dd, _), v in times[key].items() if dd == d and v["default"])
            others = [dict(v, of=name) for name, group in times.items()
                      for (dd, kind), v in group.items()
                      if dd == d and form_of(kind) == large and v is not head]
            records.append({"name": f"ntt_{d}{large}", "route": "cuda", "source": SOURCE,
                            "replaces": REPLACES[d], "launches": launches[d + large],
                            "max_abs_err": err[d + large], "ms": head["ms"],
                            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                            "bound_by": head["bound_by"], "library_ms": None,
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
    print(f"[main] kernel launches over all counted paths: {launches}")
    print(f"[main] on the N=4096 and the two N=65536 paths, by the kernels that ran: {by_kernels}")
    if min(launches.values()) == 0 or min(by_kernels.values()) == 0:
        raise RuntimeError(f"kernels that no path launched: {launches}, {by_kernels}")
    cts = phase_counts(ctxs)
    times = phase_times(ctxs, cts, c)
    print(json.dumps({"kernels": kernel_records(err, launches, times)}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
