"""Entry points: the single-card flagship step and the multi-device dry run.

Counterpart of the repository's `__graft_entry__.py`:

  entry(device)                 (fn, (x0, key)): the protected four-step NTT
                                forward over a batch of 8 limbs at n=4096 with
                                its three detectors, the flagship compute step
  dryrun_multichip(n, device)   one world of n ranks (`parallel.spawn_world`:
                                gloo processes on the CPU, NCCL on the cards)
                                running the reference's dry run on real
                                shardings, then `init_multihost`

NCCL takes one rank a card and refuses two ranks on one GPU, so on the card
`n` is at most `torch.cuda.device_count()`: one H100 runs the dry run as a
world of one rank, which exercises every sharded path and its collectives
but measures no scaling across cards.  Worlds of 2 or more ranks run as gloo
processes on the CPU.

Usage: python -m rfhe_tpu_torch.entry [n_devices] [--device cuda|cpu]
       (n_devices: the card count on the card, 8 with --device cpu)
"""
from __future__ import annotations

import argparse
import socket

import numpy as np
import torch
import torch.distributed as dist

from . import numth, prng
from .device import require, to_torch
from .fhe import CkksContext, CkksParams
from .ops import ntt_cuda
from .ops.ntt import NttPlan
from .parallel.mesh import all_gather_cat, block, init_multihost, make_mesh, make_mesh_2d, \
    spawn_world
from .parallel.sharded_ckks import ShardedCkks
from .protect.checks import stage1_projection_check, stage2_projection_check, twiddle_inter_check
from .protect.ntt_guard import NttGuard
from .transform import distributed as fs
from .transform import mxu_sharded as mx
from .transform.four_step import FourStepPlan, four_step_intt, four_step_ntt, four_step_ntt_stages


def entry(device="cuda"):
    """(fn, (x0, key)): fn(x, key) -> (y, ok) is the forward four-step NTT of
    each limb of x with the stage-1 projection, twiddle inter-check and
    stage-2 projection drawn from the three keys `prng.split(key, 3)`; y is
    in natural order, ok one flag per limb.  x0 is the reference's
    (8, 4096) draw from default_rng(0) below find_ntt_prime(4096, 30), an
    int64 tensor on `device`; key is PRNGKey(0)."""
    dev = require(device)
    n = 4096
    q = numth.find_ntt_prime(n, 30)
    plan = FourStepPlan.make(n, q, dev)

    def fn(x, key):
        k1, k2, k3 = prng.split(key, 3)
        A, B1, B2, Y = four_step_ntt_stages(x, plan)
        ok1 = stage1_projection_check(A, B1, plan.W2, plan.digit, plan.arith, k1)
        ok2 = twiddle_inter_check(B1, B2, plan.T, plan.arith, k2)
        ok3 = stage2_projection_check(B2, Y, plan.W1T, plan.digit, plan.arith, k3)
        y = Y.transpose(-1, -2).reshape(x.shape)
        return y, ok1 & ok2 & ok3

    rng = np.random.default_rng(0)
    x0 = rng.integers(0, q, size=(8, n), dtype=np.uint32)
    return fn, (to_torch(x0, dev), prng.PRNGKey(0))


def _mesh_shape(n_devices: int) -> tuple:
    """(limb, fft): the fft axis doubles up to 4 while the count stays even
    (`__graft_entry__.py:131-137`); fft must divide n1 = 16 at n = 256."""
    fft, d = 1, n_devices
    while d % 2 == 0 and fft < 4:
        fft *= 2
        d //= 2
    return n_devices // fft, fft


def _square(y: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """The Montgomery square mont_mul(y, to_mont(y)) = y² mod q."""
    return plan.arith.mont_mul(y, plan.arith.mul(y, (1 << 32) % plan.q))


def _dryrun_rank(device: str) -> dict:
    """One rank of the dry run; every check raises.  Returns what this rank
    saw, with the NTT kernels' launches it made."""
    ntt_cuda.KERNELS.reset_counts()
    D = dist.get_world_size()
    limb, fft = _mesh_shape(D)
    mesh = make_mesh_2d(limb, fft, device=device)
    lc, _ = mesh.get_coordinate()

    # forward -> Montgomery square -> inverse: limbs over "limb", t1 over "fft"
    n = 256
    q = numth.find_ntt_prime(n, 28)
    plan = FourStepPlan.make(n, q, device)
    x = to_torch(np.random.default_rng(1).integers(0, q, size=(2 * limb, n), dtype=np.uint32),
                 device)
    xs = fs.shard_coeffs(block(x, 0, limb, lc), plan, mesh, "fft")
    y = fs.four_step_ntt_sharded(xs, plan, mesh, axis="fft", batch_axis="limb")
    a = fs.four_step_intt_sharded(_square(y, plan), plan, mesh, axis="fft", batch_axis="limb")
    out = all_gather_cat(fs.gather_coeffs(a, plan, mesh, "fft"), mesh.get_group("limb"))
    y0 = four_step_ntt(x, plan)
    if not torch.equal(out, four_step_intt(_square(y0, plan), plan)):
        raise RuntimeError("multichip result mismatch")

    # the limb-sharded CKKS evaluator: rotate -> multiply_relin -> rescale
    ckks = CkksContext(CkksParams.make(n=256, levels=3, q0_bits=30, scale_bits=26), seed=3,
                       device=device)
    z = np.random.default_rng(2).uniform(-1, 1, 128) + 0j
    ct = ckks.encrypt(*ckks.encode(z))
    sh = ShardedCkks(ckks, mesh, "limb")
    sct = sh.shard(ct)
    r = sh.rescale(sh.multiply_relin(sh.rotate(sct, 1), sct))
    err = float(np.abs(ckks.decrypt_decode(sh.gather(r)) - np.roll(z, -1) * z).max())
    if not err < 5e-2:
        raise RuntimeError(f"sharded evaluator error {err}")

    # the protected sharded NTT: the three detectors ride the collectives
    res = fs.four_step_ntt_sharded_protected(fs.shard_coeffs(x[0], plan, mesh, "fft"), plan,
                                             mesh, prng.PRNGKey(7), axis="fft")
    flags = (bool(res.batch1_ok), bool(res.inter_ok), bool(res.batch2_ok))
    if not all(flags):
        raise RuntimeError(f"protected sharded NTT: detector fired on a clean pass {flags}")
    if not torch.equal(fs.gather_slots(res.y, plan, mesh, "fft"), y0[0]):
        raise RuntimeError("protected sharded NTT result mismatch")

    # the production sharded NTT at n=4096, two 30-bit primes, against
    # NttPlan (K1 on the card), and its NttGuard
    fft_mesh = make_mesh(D, axis="fft", device=device)
    primes = numth.find_ntt_primes(4096, 30, 2)
    nplan = NttPlan.make(4096, primes, device)
    xp = to_torch(np.random.default_rng(5).integers(0, min(primes), (2, 4096), dtype=np.uint32),
                  device)
    xps = mx.shard_coeffs(xp, nplan, fft_mesh)
    yp = mx.mxu_ntt_sharded(xps, nplan, fft_mesh)
    if not torch.equal(mx.gather_coeffs(mx.mxu_intt_sharded(yp, nplan, fft_mesh), nplan,
                                        fft_mesh), xp):
        raise RuntimeError("sharded production NTT roundtrip mismatch")
    if not torch.equal(mx.gather_slots(yp, nplan, fft_mesh), nplan.fwd(xp)):
        raise RuntimeError("sharded production NTT != single-chip plan")
    guard = mx.mxu_ntt_sharded_protected(xps, nplan, NttGuard.make(nplan), fft_mesh)
    if not bool(guard.ok.all()):
        raise RuntimeError("sharded NttGuard fired on a clean pass")
    return {"rank": dist.get_rank(), "mesh": {"limb": limb, "fft": fft},
            "coord": tuple(mesh.get_coordinate()), "x": tuple(x.shape), "q": q,
            "ckks_err": err, "protected": flags, "guard": guard.ok.tolist(),
            "launches": dict(ntt_cuda.KERNELS.launches)}


def _multihost(backend: str, device: torch.device) -> str:
    """init_multihost with a one-process coordinator on localhost, one
    all_reduce through it, and the group closed again."""
    if dist.is_initialized():
        return "init_multihost=skipped(a process group is open)"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_multihost(f"localhost:{port}", num_processes=1, process_id=0, backend=backend,
                   timeout_s=120)
    try:
        t = torch.ones(1, device=device)
        dist.all_reduce(t)
        if float(t) != 1.0:
            raise RuntimeError(f"all_reduce over one process gave {float(t)}")
    finally:
        dist.destroy_process_group()
    return "init_multihost=ok"


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """The reference's dry run (`__graft_entry__.py:40-163`) in one world of
    `n_devices` ranks: a (limb, fft) mesh, the sharded forward, Montgomery
    square and inverse equal to the single-device result; the limb-sharded
    CKKS (n=256, levels 3, q0 30, scale 26, seed 3) rotate, multiply_relin,
    rescale within 5e-2; the protected sharded NTT's flags true and its y
    equal to the unsharded one; the production sharded NTT at n=4096 round
    tripping and equal to NttPlan.fwd, its NttGuard ok; then init_multihost.
    On the card the world is NCCL and may have at most device_count() ranks
    (one a card).  Every check raises; returns each rank's dict, in rank
    order."""
    dev = require(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need {n_devices} cards (NCCL takes one rank a "
                         f"card), this machine has {torch.cuda.device_count()}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    seen = spawn_world(_dryrun_rank, n_devices, backend, args=(dev.type,), timeout_s=120,
                       deadline_s=600)
    mh = _multihost(backend, dev)
    print(f"dryrun_multichip OK: {backend} world of {n_devices}, mesh={seen[0]['mesh']}, "
          f"x={seen[0]['x']}, q={seen[0]['q']}, protected=ok, {mh}")
    return seen


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the multi-device dry run")
    ap.add_argument("n_devices", type=int, nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = require(args.device)
    n = args.n_devices or (torch.cuda.device_count() if dev.type == "cuda" else 8)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    # the ranks unpickle their body by module path, so run the module's own
    # copy, not this __main__ one
    from rfhe_tpu_torch.entry import main as _main
    _main()
