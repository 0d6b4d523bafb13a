"""Time the NTT kernels form by form, beside a plain copy.

For each shape (batch, L, n) it prints the forward and inverse time of each
form that takes the ring (one-block up to n = 8192, two passes, cluster), one
input repeated, by two timers: `device` (`device.device_ms`: the launches
queued behind a blocker on the stream, so the reading is the kernels' own
time also where that is under the host's time to enqueue a launch) and
`paced` (`device.cuda_ms`: events around launches the host issues one by one,
what a caller pays today).  Beside them the time of `y.copy_(x)` on the same
tensor, which moves the same 16 bytes per element and is the rate the card's
memory gives a kernel in practice, and first of all the time of a trivial
launch, (1, 1, 256) in the one-block form: the least any launch costs.  Every
forward result is held against the plain version first (not with
--skip-butterflies, whose transform is not the NTT).  Diagnostics, for
finding what a kernel's time is made of:

  --forms F ...       the forms to time: one_block, two_pass, cluster
  --skip-butterflies  builds the kernels with -DRFHE_NTT_SKIP_BUTTERFLIES:
                      loads, exchanges, barriers and stores without the
                      arithmetic
  --groups G ...      fixes the number of polynomial groups (grid.y) instead
                      of `ntt_cuda.poly_groups`; several values are timed in
                      turn
  --primes-bits B     the limbs' primes (30: lazy butterflies, 31: strict)
  --cold              also reads each kernel's own duration from
                      torch.profiler: launched again and again (warm); on an
                      idle card (a synchronize before every launch); with the
                      L2 evicted before every launch (input and twiddles come
                      from device memory); and after other kernels (a dozen
                      small elementwise torch kernels and the L2 eviction
                      before every launch, as in the middle of a rotation:
                      the instruction caches hold other code)

Run on a machine with one NVIDIA GPU and nvcc, from the root of a checkout:

    python3 -m rfhe_tpu_torch.time_ntt --shapes 21,22,4096 2,21,4096 --groups 1 6 11 21
"""
from __future__ import annotations

import argparse

import torch

from .device import DEVICE_TIMER, card, cuda_ms, device_ms, profiled_us
from .numth import find_ntt_primes
from .ops import ntt_cuda
from .ops.ntt import NttPlan, ntt_fwd_reference

SHAPES = ("21,22,4096", "2,21,4096", "1,21,4096", "2,1,4096",
          "21,22,65536", "3,28,65536", "2,21,65536", "21,22,32768", "21,22,16384")
FORMS = ("one_block", ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER)


def split_of(form: str, n: int):
    """The selector of `form` at ring n, or None where the form does not take it."""
    if form == "one_block":
        return 0 if ntt_cuda.default_split(n) == 0 else None
    return (form, ntt_cuda.large_split(n))


def trivial_launch_ms() -> tuple:
    """(device, paced) ms of a (1, 1, 256) one-block forward launch."""
    plan = NttPlan.make(256, find_ntt_primes(256, 30, 1), "cuda")
    x = torch.zeros((1, 1, 256), dtype=torch.int64, device="cuda")
    return device_ms(lambda: ntt_cuda.fwd(x, plan, 0)), cuda_ms(lambda: ntt_cuda.fwd(x, plan, 0))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=SHAPES, help="batch,L,n")
    ap.add_argument("--forms", nargs="+", default=FORMS, choices=FORMS)
    ap.add_argument("--skip-butterflies", action="store_true")
    ap.add_argument("--groups", type=int, nargs="+", default=[None])
    ap.add_argument("--primes-bits", type=int, default=30)
    ap.add_argument("--cold", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_ntt needs a CUDA device")
    if args.skip_butterflies:
        ntt_cuda.NVCC_FLAGS += ("-DRFHE_NTT_SKIP_BUTTERFLIES",)
    own_groups = ntt_cuda.poly_groups
    big = torch.zeros(1 << 26, dtype=torch.int32, device="cuda")
    evict = lambda: big.add_(1)       # 256 MB read and written through the 50 MB L2
    small = torch.arange(4096, dtype=torch.int64, device="cuda")

    def others() -> None:
        """Kernels of other code before a launch, then the L2 eviction."""
        v = small
        for op in (torch.add, torch.sub, torch.mul, torch.remainder, torch.bitwise_and,
                   torch.bitwise_or, torch.maximum, torch.minimum):
            v = op(v, small + 1)
        torch.where(v > 5, v, small).sum().sqrt().exp()
        small.to(torch.float32).cumsum(0).sort()
        evict()

    conditions = (("warm", None), ("idle card", torch.cuda.synchronize), ("cold L2", evict),
                  ("after other kernels", others))
    name = card()
    print(f"[time_ntt] {name}: device = {DEVICE_TIMER}; paced = events around launches "
          f"the host issues one by one")
    dev, paced = trivial_launch_ms()
    print(f"[time_ntt] {name}: trivial launch (1, 1, 256) one_block fwd: device {dev:.4f} ms, "
          f"paced {paced:.4f} ms", flush=True)
    for groups in args.groups:
        if groups:
            ntt_cuda.poly_groups = lambda batch, ctas, slots: min(batch, groups)
            if hasattr(ntt_cuda, "launch_plan"):
                ntt_cuda.launch_plan.cache_clear()
        what = ("data movement only" if args.skip_butterflies else "kernels") + \
            (f", {groups} polynomial groups" if groups else "") + f", {args.primes_bits}-bit primes"
        for shape in args.shapes:
            batch, L, n = (int(v) for v in shape.split(","))
            plan = NttPlan.make(n, find_ntt_primes(n, args.primes_bits, L), "cuda")
            g = torch.Generator(device="cuda").manual_seed(0)
            x = torch.randint(0, 1 << 62, (batch, L, n), device="cuda", generator=g) % plan.q_arr[:, None]
            y = torch.empty_like(x)
            copy = device_ms(lambda: y.copy_(x))
            line = [f"copy {copy:.4f} ms ({2 * 8 * x.numel() / copy / 1e9:.2f} TB/s)"]
            for form in args.forms:
                split = split_of(form, n)
                if split is None:
                    continue
                if not args.skip_butterflies and \
                        not torch.equal(ntt_cuda.fwd(x, plan, split), ntt_fwd_reference(x, plan)):
                    raise RuntimeError(f"{form} forward kernel disagrees with its plain version at {shape}")
                fwd, inv = (lambda: ntt_cuda.fwd(x, plan, split)), (lambda: ntt_cuda.inv(x, plan, split))
                if groups is None:
                    G = "own" if form != "one_block" else own_groups(
                        batch, L, ntt_cuda.resident_ctas(ntt_cuda.sm_count(0), n // 16))
                    form = f"{form} (G={G})"
                line.append(f"{form} device fwd {device_ms(fwd):.4f} inv {device_ms(inv):.4f} ms, "
                            f"paced fwd {cuda_ms(fwd):.4f} inv {cuda_ms(inv):.4f} ms")
                if args.cold:
                    line[-1] += ", by the profiler: " + ", ".join(
                        f"{name} fwd {profiled_us(fwd, match='ntt_', between=between) / 1e3:.4f} "
                        f"inv {profiled_us(inv, match='ntt_', between=between) / 1e3:.4f} ms"
                        for name, between in conditions)
            print(f"[time_ntt] {name}: ({batch}, {L}, {n}) {what}: " + "; ".join(line), flush=True)


if __name__ == "__main__":
    main()
