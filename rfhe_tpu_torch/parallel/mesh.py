"""Device meshes over torch.distributed, the launcher of process worlds, the
collectives of the sharded paths, and the limb-sharded ciphertext.

Counterpart of `rfhe_tpu/parallel/mesh.py`, with the axis conventions of
the reference:

  "limb"  RNS residue channels (the ciphertext's limb axis)
  "fft"   the four-step t1 axis (the all_to_all transposes ride it)

XLA's SPMD partitioner placed the reference's collectives; here every rank
runs the same program on its own block and issues them itself.  A function
of the sharded layer takes and returns the rank's local block, the block a
`shard_map` body sees in the reference, and the helpers below cut a whole
array into blocks and gather it back.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the first
`n_devices` ranks of the world (the reference's `make_mesh(n)` takes
`devs[:n]`).  Building one is collective over the whole world; a rank
outside it gets `mesh.get_coordinate() is None` and takes no part in its
collectives.
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "make_mesh_2d", "init_multihost", "spawn_world", "ShardedCiphertext",
           "shard_ciphertext", "gather_ciphertext", "slab_bounds", "axis_size", "axis_rank",
           "all_gather_stack", "all_gather_cat", "all_to_all_tiled", "allsum_mod", "block"]

# Modules a rank of a world may not load: the port runs without the JAX
# package, and a spawned rank is where that is checked.
FORBIDDEN = ("jax", "jaxlib", "rfhe_tpu")


def _device_type(device) -> str:
    return torch.device(device).type


def make_mesh(n_devices: Optional[int] = None, axis: str = "fft", device="cuda") -> DeviceMesh:
    """1-D mesh over ranks 0 .. n_devices-1 (all ranks by default)."""
    n = n_devices or dist.get_world_size()
    return DeviceMesh(_device_type(device), torch.arange(n), mesh_dim_names=(axis,))


def make_mesh_2d(limb: int, fft: int, axes=("limb", "fft"), device="cuda") -> DeviceMesh:
    """2-D mesh over ranks 0 .. limb·fft-1, row-major as the reference's."""
    if limb * fft > dist.get_world_size():
        raise ValueError(f"need {limb * fft} ranks, the world has {dist.get_world_size()}")
    return DeviceMesh(_device_type(device), torch.arange(limb * fft).reshape(limb, fft),
                      mesh_dim_names=tuple(axes))


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, backend: str = "nccl",
                   timeout_s: float = 600) -> None:
    """Join a process group.  With no arguments the address, world size and
    rank come from the environment (`env://`, as torchrun sets them);
    otherwise `coordinator_address` is host:port of rank 0's TCP store."""
    timeout = timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)


# ---------------------------------------------------------------------------
# process worlds
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, tmp: str,
               timeout_s: float, args: tuple) -> None:
    torch.set_num_threads(1)
    device_id = None
    if backend == "nccl":
        device_id = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), device_id=device_id)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        raise RuntimeError(f"rank {rank} loaded {loaded}")
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def spawn_world(fn: Callable, world_size: int, backend: str = "nccl", args: tuple = (),
                timeout_s: float = 60, deadline_s: float = 600) -> List:
    """Run fn(*args) in each rank of a new process world and return the
    ranks' results, in rank order.

    The ranks are spawned processes (`torch.multiprocessing`): `fn` must be
    importable from the port, and a rank imports neither jax nor the JAX
    package (it raises if it did).  They meet through a `file://` store in
    a temporary directory, so worlds started side by side never share a
    port; every collective waits at most `timeout_s`, and a world that has
    not ended `deadline_s` after its start is killed and raises
    TimeoutError.  A rank that raises ends the world, and its traceback is
    in the exception raised here.  Each rank runs one torch thread; with
    `backend="nccl"` rank r takes card r mod device_count()."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="rfhe_world_") as tmp:
        ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False, start_method="spawn",
                                 args=(fn, world_size, backend, tmp, timeout_s, args))
        end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > end:
                    raise TimeoutError(f"a world of {world_size} ranks running {fn.__name__} "
                                       f"did not end within {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# mesh axes and collectives
# ---------------------------------------------------------------------------

def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def block(x: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Block `index` of `parts` equal blocks of x along `dim`, contiguous."""
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"axis of {size} does not split into {parts} blocks")
    return x.narrow(dim, index * (size // parts), size // parts).contiguous()


# torch 2.13 renamed all_gather_into_tensor; both take a flat output here,
# the one layout gloo accepts as well as NCCL
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(D, *x.shape): the ranks' equal blocks x in rank order, one collective
    into one buffer."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.numel(),))
    _all_gather_flat(out, x.view(-1), group=group)
    return out.view((-1,) + tuple(x.shape))


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks x joined along `dim` in rank order (equal shapes)."""
    parts = all_gather_stack(x, group)
    d = dim % x.ndim
    merged = list(x.shape)
    merged[d] *= parts.shape[0]
    return parts.movedim(0, d).reshape(merged)


def all_to_all_tiled(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """`jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True)`: block j
    of x along split_axis goes to rank j, and the blocks a rank receives are
    joined along concat_axis in the order of their source ranks.

    `all_to_all_single` exchanges along dim 0 only, so the D blocks are first
    moved to a leading axis of their own (a contiguous copy), exchanged, and
    that axis is then merged into concat_axis in front of its own index."""
    D = dist.get_world_size(group)
    s, c = split_axis % x.ndim, concat_axis % x.ndim
    shape = list(x.shape)
    if shape[s] % D:
        raise ValueError(f"split axis of {shape[s]} does not divide over {D} ranks")
    shape[s:s + 1] = [D, shape[s] // D]
    send = x.reshape(shape).movedim(s, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = recv.movedim(0, c)                          # (..., D, concat_size, ...)
    merged = list(out.shape)
    merged[c:c + 2] = [merged[c] * merged[c + 1]]
    return out.reshape(merged)


def allsum_mod(x: torch.Tensor, q, group) -> torch.Tensor:
    """Σ over the ranks of x, mod q: the reference's all_gather and tree-sum
    (`rfhe_tpu/transform/distributed.py:_allsum_mod`).  An int64 all_reduce
    is exact here: the partial sums are words below 2^32 and a world holds
    far fewer than 2^31 ranks, so the sum stays below 2^63, and the one `%`
    after it gives the residue the reference's modular tree-sum gives.  A
    world of one rank returns its word unreduced, as the reference's sum
    over an axis of length 1 does."""
    s = x.contiguous().clone()
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return s if dist.get_world_size(group) == 1 else s % q


# ---------------------------------------------------------------------------
# the limb-sharded ciphertext
# ---------------------------------------------------------------------------

def slab_bounds(n_limbs: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """(lo, hi) of each part of `np.array_split(range(n_limbs), parts)`:
    contiguous slabs, the larger first, some empty where parts > n_limbs."""
    sizes = [len(s) for s in np.array_split(np.arange(n_limbs), parts)]
    starts = np.cumsum([0] + sizes)
    return tuple((int(starts[i]), int(starts[i + 1])) for i in range(parts))


@dataclass
class ShardedCiphertext:
    """One rank's limbs of a ciphertext.  `bounds` is the chain's split into
    the mesh's slabs, fixed when the ciphertext is sharded; the rank at
    coordinate `coord` holds limbs lo .. min(hi, level+1)-1 of its slab of
    every component (NTT domain), so a rescale takes the top limb from its
    owner only and may leave a slab empty."""

    c: List[torch.Tensor]          # (len(limbs), N) per component
    scale: float
    level: int
    bounds: Tuple[Tuple[int, int], ...]
    coord: int
    is_ntt: bool = True

    @property
    def size(self) -> int:
        return len(self.c)

    def slab(self, coord: int) -> Tuple[int, int]:
        lo, hi = self.bounds[coord]
        top = self.level + 1
        return min(lo, top), min(hi, top)

    @property
    def limbs(self) -> List[int]:
        lo, hi = self.slab(self.coord)
        return list(range(lo, hi))

    def owner(self, limb: int) -> int:
        """The mesh coordinate holding `limb`."""
        return next(r for r in range(len(self.bounds)) if self.slab(r)[0] <= limb < self.slab(r)[1])


def shard_ciphertext(ct, mesh: DeviceMesh, limb_axis: str = "limb",
                     n_limbs: Optional[int] = None) -> ShardedCiphertext:
    """This rank's slab of `ct` (a `fhe.ckks.Ciphertext` every rank holds
    whole): rank r keeps limbs `np.array_split(range(n_limbs), D)[r]` of
    each component.  `n_limbs` is the chain the split is made over, the
    ciphertext's own limbs by default; the sharded evaluator passes its
    context's, so that a rank's key rows cover every level."""
    D = axis_size(mesh, limb_axis)
    bounds = slab_bounds(n_limbs or ct.level + 1, D)
    coord = axis_rank(mesh, limb_axis)
    out = ShardedCiphertext([], ct.scale, ct.level, bounds, coord, ct.c[0].is_ntt)
    lo, hi = out.slab(coord)
    out.c = [p.data[lo:hi].contiguous() for p in ct.c]
    return out


def gather_limbs(rows: torch.Tensor, sct: ShardedCiphertext, group) -> torch.Tensor:
    """(..., level+1, N): the ranks' limb rows (..., len(limbs), N) joined in
    limb order.  Slabs may differ in size, so each is padded to the largest
    for the one all_gather."""
    sizes = [hi - lo for lo, hi in (sct.slab(r) for r in range(len(sct.bounds)))]
    width = max(sizes)
    pad = width - rows.shape[-2]
    if pad:
        rows = torch.cat([rows, rows.new_zeros(rows.shape[:-2] + (pad, rows.shape[-1]))], dim=-2)
    if min(sizes) == width:
        return all_gather_cat(rows, group, dim=-2)
    parts = all_gather_stack(rows, group)                  # (D, ..., width, N)
    return torch.cat([parts[r, ..., :size, :] for r, size in enumerate(sizes) if size], dim=-2)


def gather_ciphertext(sct: ShardedCiphertext, mesh: DeviceMesh, limb_axis: str = "limb"):
    """The whole ciphertext on every rank of the mesh (for decryption)."""
    from ..fhe.ckks import Ciphertext
    from ..fhe.rns import RnsPoly
    data = gather_limbs(torch.stack(sct.c), sct, mesh.get_group(limb_axis))
    return Ciphertext([RnsPoly(d, sct.is_ntt) for d in data], sct.scale)


def members(mesh: DeviceMesh) -> bool:
    """Whether this rank is in `mesh`."""
    return mesh.get_coordinate() is not None

