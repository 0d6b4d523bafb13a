"""Time the large-ring NTT kernels form by form, beside a plain copy.

For each shape (batch, L, n) it prints the forward and inverse time of the
two-pass and the cluster kernels (CUDA events, 20 launches after 3 warm-ups,
one input repeated) and the time of `y.copy_(x)` on the same tensor, which
moves the same 16 bytes per element and is the rate the card's memory gives
a kernel in practice.  Every forward result is held against the plain
version first (not with --skip-butterflies, whose transform is not the NTT).
Diagnostics, for finding what a kernel's time is made of:

  --skip-butterflies  builds the kernels with -DRFHE_NTT_SKIP_BUTTERFLIES:
                      loads, exchanges, barriers and stores without the
                      arithmetic
  --cp-async          builds the forward cluster kernel with
                      -DRFHE_NTT_CLUSTER_CP_ASYNC: the next polynomial's tile
                      staged in shared memory by 16-byte cp.async requests
                      instead of the register prefetch of the low words
  --groups G          fixes the number of polynomial groups (grid.y)
                      instead of `ntt_cuda.poly_groups`

Run on a machine with one NVIDIA GPU and nvcc, from the root of a checkout:

    python3 -m rfhe_tpu_torch.time_ntt --shapes 21,22,65536 3,28,65536
"""
from __future__ import annotations

import argparse

import torch

from .device import card, cuda_ms
from .numth import find_ntt_primes
from .ops import ntt_cuda
from .ops.ntt import NttPlan, ntt_fwd_reference

SHAPES = ("21,22,65536", "3,28,65536", "2,21,65536", "21,22,32768", "21,22,16384")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=SHAPES, help="batch,L,n")
    ap.add_argument("--skip-butterflies", action="store_true")
    ap.add_argument("--cp-async", action="store_true")
    ap.add_argument("--groups", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_ntt needs a CUDA device")
    if args.skip_butterflies:
        ntt_cuda.NVCC_FLAGS += ("-DRFHE_NTT_SKIP_BUTTERFLIES",)
    if args.cp_async:
        ntt_cuda.NVCC_FLAGS += ("-DRFHE_NTT_CLUSTER_CP_ASYNC",)
    if args.groups:
        ntt_cuda.poly_groups = lambda batch, ctas, slots: min(batch, args.groups)
    what = ("data movement only" if args.skip_butterflies else "kernels") + \
        (", forward cluster loads by cp.async" if args.cp_async else "") + \
        (f", {args.groups} polynomial groups" if args.groups else "")
    name = card()
    for shape in args.shapes:
        batch, L, n = (int(v) for v in shape.split(","))
        plan = NttPlan.make(n, find_ntt_primes(n, 30, L), "cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randint(0, 1 << 62, (batch, L, n), device="cuda", generator=g) % plan.q_arr[:, None]
        y = torch.empty_like(x)
        copy = cuda_ms(lambda: y.copy_(x))
        line = [f"copy {copy:.4f} ms ({2 * 8 * x.numel() / copy / 1e9:.2f} TB/s)"]
        for kind in (ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER):
            split = (kind, ntt_cuda.large_split(n))
            if not args.skip_butterflies and \
                    not torch.equal(ntt_cuda.fwd(x, plan, split), ntt_fwd_reference(x, plan)):
                raise RuntimeError(f"{kind} forward kernel disagrees with its plain version at {shape}")
            fwd = cuda_ms(lambda: ntt_cuda.fwd(x, plan, split))
            inv = cuda_ms(lambda: ntt_cuda.inv(x, plan, split))
            line.append(f"{kind} fwd {fwd:.4f} inv {inv:.4f} ms")
        print(f"[time_ntt] {name}: ({batch}, {L}, {n}) {what}: " + ", ".join(line), flush=True)


if __name__ == "__main__":
    main()
