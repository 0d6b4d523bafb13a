"""Build, bind and launch the CUDA NTT kernels of `csrc/ntt.cu`.

The forward kernels replace `rfhe_tpu/ops/ntt_fused.py:_fwd_kernel` and the
inverse kernels `_inv_kernel`.  Each direction has two forms:

  one-block   `rfhe_ntt_fwd` / `rfhe_ntt_inv`: one CTA of n/16 threads holds
              the vector of a (poly, limb), 256 <= n <= 8192;
  large-ring  n = na·nb with 16 <= na <= 256, 2 <= nb <= 256, n >= 256, as
              one trip through device memory, `rfhe_ntt_fwd_cluster` /
              `rfhe_ntt_inv_cluster` (a thread-block cluster of nb/16 CTAs
              holds the vector across its shared memories), or as two passes
              through a uint32 intermediate, `rfhe_ntt_fwd_col` +
              `rfhe_ntt_fwd_row` (inverse: `_inv_row` + `_inv_col`).

All of them keep 16 elements of a thread in registers for four butterfly
stages at a time, loop over the polynomials of a limb (and tile) so that
twiddles are fetched once and the next polynomial's loads are in flight while
the current one computes, compute the slot of a network position in closed
form and take the lazy butterflies for q < 2^30.  The one-block kernels run
both phases of the split n = na·nb in one CTA (`one_block_split`); the
large-ring form is bounded by bytes (16 per element at the least), and its
cluster kernels drop the intermediate's 8 bytes per element and one launch.
The host side of that design is here: `one_block_split`, `large_geometry` and
`cluster_geometry` (splits, tiles and chunks), `poly_groups` (how the batch
is split over grid.y), `default_split` and `large_form` (which form a ring
and a launch take), `launch_plan` (the launches of a transform, kept per
shape).

`split` selects the form: 0 the one-block form, an int log2(na) the
large-ring form at that split with the kernels `large_form` picks for the
launch's size, `("cluster", log2 na)` and `("two_pass", log2 na)` one of them
by name, None what `default_split(n)` says.  The source is compiled with nvcc for
sm_90a into `build/rfhe_tpu_torch/` of the checkout at first use, into a
library named by the hash of the source and flags, and loaded with ctypes.
Importing this module needs no nvcc and no GPU.

`fwd`/`inv` take int64 tensors (..., L, n) on a CUDA device, allocate the
output (and the intermediate), launch on the current stream and count one
launch of the form's kernel in `KERNELS.launches` (and, by the kernels that
ran, in `KERNELS.by_kernels`; by shape in `KERNELS.by_shape`) and each
`__global__` launch in `KERNELS.passes`.  Anything the kernels do not take raises; there
is no fallback.  A launch inside a CUDA graph capture runs nothing: the capture
takes its counts back and every replay adds them (`KERNELS.snapshot`,
`since`, `add`; utils/jitcache.py), so the counters count transforms that
ran.  This module also stands where the reference's `utils/compilecache.py`
does: the kernel library is built once per checkout and source, into
`build/rfhe_tpu_torch/`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from ..device import check_residues

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ntt.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rfhe_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_N = 65536             # the largest ring the reference package runs
MAX_ONE_BLOCK_N = 8192    # 512 threads of 16 elements: the one-block form's largest ring
MIN_N = 256               # a row-phase chunk is a multiple of 256 words, in every form
LOG_COLS = 5              # a column tile is at most 32 columns wide,
LOG_COLS_CLUSTER = 4      # 16 in the cluster kernels (two CTAs of 256 threads per SM)
LOG_CHUNK = 12            # a row pass works on chunks of at most 4096 words
CLUSTER_MAX_WORDS = 3 * 28 * 65536  # batch·L·n up to which the cluster kernels are the default
FORMS = ("fwd", "inv", "fwd_large", "inv_large")
CLUSTER, TWO_PASS = "cluster", "two_pass"
KERNEL_SETS = tuple(f"{d}_{kind}" for d in ("fwd", "inv") for kind in ("one_block", TWO_PASS, CLUSTER))
Split = Union[None, int, Tuple[str, int]]


def large_split(n: int) -> int:
    """log2(na) of the large-ring form's own split, nb = 2^floor(log2(n)/2).
    From n = 16384 up that is n1, the plan's slot-order split, so every row
    of the network is one contiguous row of slots."""
    log_n = n.bit_length() - 1
    return log_n - (log_n // 2)


def default_split(n: int) -> int:
    """log2(na) of the form that ring n takes by itself; 0 is the one-block
    form, which takes n = 256 ... 8192 and is the form of all of them; the
    large-ring form takes every n from 256 up (chip_smoke.py times both at
    n = 4096)."""
    return 0 if n <= MAX_ONE_BLOCK_N else large_split(n)


def one_block_split(log_n: int) -> int:
    """log2(na) of the split n = na·nb inside the one-block kernels: na = 16
    up to n = 4096 and 32 at n = 8192.  The column phase's first round then
    runs the four highest stages, and the row phase (nb <= 256) at most eight:
    rounds of 4 + 4 stages at n = 256, 4 + k + 4 at n = 256·2^k up to 4096
    (three full rounds), 4 + 1 + 4 + 4 at n = 8192; only the k-stage round is
    short, and an empty round is skipped with its exchange."""
    if not MIN_N.bit_length() - 1 <= log_n <= MAX_ONE_BLOCK_N.bit_length() - 1:
        raise ValueError(f"the one-block form takes {MIN_N} <= n <= {MAX_ONE_BLOCK_N}, "
                         f"got n=2^{log_n}")
    return max(4, log_n - 8)


def large_form(vectors: int, n: int) -> str:
    """Which large-ring kernels a launch of `vectors` = batch·L vectors of
    ring n takes by itself.  The cluster kernels move 16 bytes per element in
    one launch but keep the CTAs of a cluster in step, polynomial by
    polynomial; the two passes move 24 in two launches of independent CTAs.
    On an H100 the crossing follows the launch's size in words.  From
    (5, 22, 65536), (10, 22, 32768) and (21, 22, 16384) on the two passes win
    in both directions, by a sixth at (21, 22, 65536).  Up to a grouped
    keyswitch's (3, 28, 65536), which is (5, 22, 32768) and (10, 22, 16384)
    at the smaller rings, a transform takes under 75 µs and the forms draw
    (either leads by up to a fifth from one run to the next, where two
    launches cost two enqueues of the host); at half that size and below the
    cluster kernels lead in most readings, by a tenth to a third
    (chip_smoke.py times both forms at all of these)."""
    return CLUSTER if vectors * n <= CLUSTER_MAX_WORDS else TWO_PASS


def resolve_split(n: int, split: Split, vectors: int) -> Tuple[str, int]:
    """(kind, log2 na) of a selector for a launch of `vectors` vectors: kind is
    "one_block", CLUSTER or TWO_PASS."""
    if split is None:
        split = default_split(n)
    if isinstance(split, tuple):
        kind, log_na = split
        if kind not in (CLUSTER, TWO_PASS):
            raise ValueError(f"unknown large-ring form {kind!r}")
        return kind, int(log_na)
    return ("one_block", 0) if split == 0 else (large_form(vectors, n), int(split))


def large_geometry(log_n: int, log_na: int) -> tuple:
    """(log_c, log_chunk) of the large-ring kernels for n = 2^log_n split as
    na = 2^log_na rows by nb columns.  A column tile is C = 2^log_c columns
    wide and na rows high, na·C/16 threads; a row pass works on chunks of
    2^log_chunk consecutive words, chunk/16 threads.  A thread holds 16
    elements for at most four stages and a phase is two such rounds, so na
    lies in [16, 256] and nb in [2, 256]."""
    log_nb = log_n - log_na
    if not (log_n >= MIN_N.bit_length() - 1 and 4 <= log_na <= 8 and 1 <= log_nb <= 8):
        raise ValueError(f"split 2^{log_na} x 2^{log_nb} of n=2^{log_n}: the large-ring "
                         f"form takes n >= {MIN_N}, 16 <= na <= 256, 2 <= nb <= 256")
    return min(log_nb, LOG_COLS), min(log_n, LOG_CHUNK)


def cluster_geometry(log_n: int, log_na: int) -> tuple:
    """(log_c, CTAs per cluster) of the cluster kernels: the cluster's CTAs
    hold nb/C column tiles of C = 2^log_c columns each."""
    log_c = min(large_geometry(log_n, log_na)[0], LOG_COLS_CLUSTER)
    return log_c, 1 << (log_n - log_na - log_c)


def resident_ctas(sms: int, threads: int) -> int:
    """CTAs of `threads` threads that the card holds at once: the kernels
    take up to 128 registers a thread, so an SM holds 512 threads of them (at
    most 8 CTAs)."""
    return sms * min(8, max(1, 512 // threads))


def poly_groups(batch: int, ctas: int, slots: int) -> int:
    """grid.y of a launch: the batch is split into this many groups, and a
    CTA loops over the polynomials g, g + G, ... of its limb (and tile).
    `ctas` is the grid's x and `slots` the CTAs the card holds at once.  The
    launch runs in ceil(ctas·G/slots) waves of ceil(batch/G) loop trips each,
    and a CTA pays about one trip's time to fetch its twiddles, so G is the
    smallest count that minimises waves·(trips + 1): long loops (twiddles
    fetched once, the next polynomial's loads in flight) unless more groups
    fill a ragged last wave."""
    best, best_cost = 1, None
    for g in range(1, min(batch, max(1, 4 * slots // ctas)) + 1):
        cost = -(-ctas * g // slots) * (-(-batch // g) + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = g, cost
    return best


def large_passes(kind: str, inverse: bool, L: int, batch: int, log_n: int, log_na: int,
                 log_n1: int, sms: int) -> list:
    """The `__global__` launches of one large-ring transform, in order:
    (entry point, the ints that follow (L, batch) in its arguments), i.e.
    (G, log_n, log_na, log_c or log_chunk[, log_n1])."""
    log_c, log_chunk = large_geometry(log_n, log_na)
    groups = lambda ctas, elems: poly_groups(batch, L * ctas, resident_ctas(sms, elems // 16))
    d = "inv" if inverse else "fwd"
    if kind == CLUSTER:
        log_c, ctas = cluster_geometry(log_n, log_na)
        return [(f"rfhe_ntt_{d}_cluster",
                 (groups(ctas, 1 << (log_na + log_c)), log_n, log_na, log_c, log_n1))]
    col = (f"rfhe_ntt_{d}_col", (groups(1 << (log_n - log_na - log_c), 1 << (log_na + log_c)),
                                 log_n, log_na, log_c))
    row = (f"rfhe_ntt_{d}_row", (groups(1 << (log_n - log_chunk), 1 << log_chunk),
                                 log_n, log_na, log_chunk, log_n1))
    return [row, col] if inverse else [col, row]


@lru_cache(maxsize=None)
def launch_plan(kind: str, inverse: bool, L: int, batch: int, log_n: int, log_na: int,
                log_n1: int, sms: int) -> tuple:
    """The `__global__` launches of one transform of (batch, L, n) by the
    kernels `kind`, as `large_passes` lists them; the one-block form is one
    launch, (G, log_n, log_na, log_n1).  Kept per shape: a rotation repeats
    the same few."""
    if kind != "one_block":
        return tuple(large_passes(kind, inverse, L, batch, log_n, log_na, log_n1, sms))
    groups = poly_groups(batch, L, resident_ctas(sms, (1 << log_n) // 16))
    return ((f"rfhe_ntt_{'inv' if inverse else 'fwd'}",
             (groups, log_n, one_block_split(log_n), log_n1)),)


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libntt_{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the kernels if the library for this source is missing.
    Returns the compiler's report (ptxas register/shared-memory lines), or
    "" when the library was already built."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stderr


class NttKernels:
    """The loaded library and the launch counters of the kernels."""

    def __init__(self) -> None:
        self.launches = dict.fromkeys(FORMS, 0)   # transforms, by kernel form
        self.passes = dict.fromkeys(FORMS, 0)     # __global__ launches
        self.by_kernels = dict.fromkeys(KERNEL_SETS, 0)   # transforms, by the kernels that ran
        self.by_shape: dict = {}                  # transforms, by (form, batch, L, n)
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(FORMS, 0)
        self.passes = dict.fromkeys(FORMS, 0)
        self.by_kernels = dict.fromkeys(KERNEL_SETS, 0)
        self.by_shape = {}

    # A graph capture runs no kernel but makes the counts of its launches; it
    # takes them back, and every replay adds them (utils/jitcache.py).
    _COUNTERS = ("launches", "passes", "by_kernels", "by_shape")

    def snapshot(self) -> dict:
        return {name: dict(getattr(self, name)) for name in self._COUNTERS}

    def restore(self, snap: dict) -> None:
        for name in self._COUNTERS:
            setattr(self, name, dict(snap[name]))

    def since(self, snap: dict) -> dict:
        """The counts made since `snap`, nonzero ones only."""
        out = {}
        for name in self._COUNTERS:
            now, then = getattr(self, name), snap[name]
            out[name] = {k: v - then.get(k, 0) for k, v in now.items() if v != then.get(k, 0)}
        return out

    def add(self, delta: dict) -> None:
        for name, counts in delta.items():
            mine = getattr(self, name)
            for k, v in counts.items():
                mine[k] = mine.get(k, 0) + v

    @property
    def fwd_launches(self) -> int:
        """Forward transforms launched, in either form."""
        return self.launches["fwd"] + self.launches["fwd_large"]

    @property
    def inv_launches(self) -> int:
        """Inverse transforms launched, in either form."""
        return self.launches["inv"] + self.launches["inv_large"]

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            ptr, num = ctypes.c_void_p, ctypes.c_int
            signatures = {
                "rfhe_ntt_fwd": [ptr] * 5 + [num] * 6 + [ptr],
                "rfhe_ntt_inv": [ptr] * 5 + [num] * 6 + [ptr],
                "rfhe_ntt_fwd_col": [ptr] * 5 + [num] * 6 + [ptr],
                "rfhe_ntt_inv_col": [ptr] * 5 + [num] * 6 + [ptr],
                "rfhe_ntt_fwd_row": [ptr] * 5 + [num] * 7 + [ptr],
                "rfhe_ntt_inv_row": [ptr] * 5 + [num] * 7 + [ptr],
                "rfhe_ntt_fwd_cluster": [ptr] * 5 + [num] * 7 + [ptr],
                "rfhe_ntt_inv_cluster": [ptr] * 5 + [num] * 7 + [ptr],
                "rfhe_span_mark_launch": [ptr, ctypes.c_uint64, ctypes.c_uint64, ptr],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, inverse: bool, x: torch.Tensor, plan,
               split: Split = None) -> torch.Tensor:
        """One transform in the form `split` selects (see the module's note)."""
        check_residues(x, plan.L, plan.n, plan.device)
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA NTT takes CUDA tensors, got {x.device}")
        if not MIN_N <= plan.n <= MAX_N:
            raise ValueError(f"n={plan.n}: the kernels take {MIN_N} <= n <= {MAX_N}")
        B = x.numel() // (plan.L * plan.n)
        kind, log_na = resolve_split(plan.n, split, B * plan.L)
        if kind == "one_block":
            one_block_split(plan.log_n)                   # raises above n = 8192
        else:
            large_geometry(plan.log_n, log_na)            # raises on a split it does not take
        out = torch.empty_like(x)
        if B == 0:
            return out
        t, lib = plan.tables, self.lib()
        form = ("inv" if inverse else "fwd") + ("" if kind == "one_block" else "_large")
        passes = launch_plan(kind, inverse, plan.L, B, plan.log_n, log_na,
                             plan.n1.bit_length() - 1, sm_count(x.device.index))
        # two passes go through a uint32 intermediate
        scratch = [torch.empty(x.numel(), dtype=torch.int32, device=x.device)
                   for _ in passes[1:]]
        ptrs = [x.data_ptr(), *(s.data_ptr() for s in scratch), out.data_ptr()]
        tables = (t.kernel_tw.data_ptr(), t.kernel_consts.data_ptr(), plan.limb_ids32.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            for (name, ints), src, dst in zip(passes, ptrs, ptrs[1:]):
                rc = getattr(lib, name)(src, dst, *tables, plan.L, B, *ints, stream)
                if rc != 0:
                    raise RuntimeError(f"{name} launch failed: cudaError {rc} "
                                       f"(n={plan.n}, L={plan.L}, B={B}, split={split})")
                self.passes[form] += 1
        self.launches[form] += 1
        self.by_kernels[("inv_" if inverse else "fwd_") + kind] += 1
        shape = (form, B, plan.L, plan.n)
        self.by_shape[shape] = self.by_shape.get(shape, 0) + 1
        return out


KERNELS = NttKernels()


def fwd(x: torch.Tensor, plan, split: Split = None) -> torch.Tensor:
    """Forward NTT kernel (replaces ntt_fused.py:_fwd_kernel)."""
    return KERNELS.launch(False, x, plan, split)


def inv(y: torch.Tensor, plan, split: Split = None) -> torch.Tensor:
    """Inverse NTT kernel (replaces ntt_fused.py:_inv_kernel)."""
    return KERNELS.launch(True, y, plan, split)
