"""Build, bind and launch the CUDA NTT kernels of `csrc/ntt.cu`.

The forward kernels replace `rfhe_tpu/ops/ntt_fused.py:_fwd_kernel` and the
inverse kernels `_inv_kernel`.  Each direction has two forms:

  one-block   `rfhe_ntt_fwd` / `rfhe_ntt_inv`: one CTA holds the vector of a
              (poly, limb) in shared memory, n <= 32768 (above 8192 with
              opt-in dynamic shared memory);
  large-ring  `rfhe_ntt_fwd_col` + `rfhe_ntt_fwd_row` (inverse: `_inv_row` +
              `_inv_col`): n = na·nb in two passes through a uint32
              intermediate in global memory, any n >= 4.

`default_split` picks the form from n.  The source is compiled with nvcc for
sm_90a into `build/rfhe_tpu_torch/` of the checkout at first use, into a
library named by the hash of the source and flags, and loaded with ctypes.
Importing this module needs no nvcc and no GPU.

`fwd`/`inv` take int64 tensors (..., L, n) on a CUDA device, allocate the
output (and the intermediate), launch on the current stream and count one
launch of the form's kernel in `KERNELS.launches` and each `__global__`
launch in `KERNELS.passes`.  Anything the kernels do not take raises; there
is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from ..device import check_residues

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ntt.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rfhe_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_N = 65536             # the largest ring the reference package runs
MAX_ONE_BLOCK_N = 32768   # 128 KB of the 227 KB a block may use on sm_90
MAX_ONE_BLOCK_DEFAULT_N = 16384   # the largest ring that takes one block by itself
MAX_BATCH = 65535         # grid.y
MAX_PASS_ELEMS = 8192     # words of shared memory a pass may hold (32 KB)
FORMS = ("fwd", "inv", "fwd_large", "inv_large")


def large_split(n: int) -> int:
    """log2(na) of the large-ring form's own split, nb = 2^floor(log2(n)/2).
    From n = 16384 up that is n1, the plan's slot-order split, so every row
    of the intermediate maps to one contiguous row of slots."""
    log_n = n.bit_length() - 1
    return log_n - (log_n // 2)


def default_split(n: int) -> int:
    """log2(na) of the form that n takes by itself; 0 is the one-block form.
    Both forms take n = 16384 and 32768; on an H100 the one-block form is
    the faster at n = 16384 and the large-ring form at n = 32768, at the
    keyswitch shape (21, 22, n) and at the mod-down's (2, 1, n) alike
    (chip_smoke.py times both)."""
    return 0 if n <= MAX_ONE_BLOCK_DEFAULT_N else large_split(n)


def large_geometry(log_n: int, log_na: int) -> tuple:
    """(log_c, log_chunk) of the large-ring passes for n = 2^log_n split as
    na = 2^log_na rows by nb columns: the column tile is C = 2^log_c columns
    wide (na·C words of shared memory), the row pass works on chunks of
    2^log_chunk consecutive words (whole rows)."""
    log_nb = log_n - log_na
    cap = MAX_PASS_ELEMS.bit_length() - 1
    if not (1 <= log_na <= cap and 1 <= log_nb <= cap):
        raise ValueError(f"split 2^{log_na} x 2^{log_nb} of n=2^{log_n}: both "
                         f"factors must lie in [2, {MAX_PASS_ELEMS}]")
    log_c = min(log_nb, 5, cap - log_na)
    log_chunk = max(log_nb, min(log_n, 11))
    return log_c, log_chunk


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
        self._lib: Optional[ctypes.CDLL] = None

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(FORMS, 0)
        self.passes = dict.fromkeys(FORMS, 0)

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
                "rfhe_ntt_fwd": [ptr] * 6 + [num] * 3 + [ptr],
                "rfhe_ntt_inv": [ptr] * 6 + [num] * 3 + [ptr],
                "rfhe_ntt_fwd_col": [ptr] * 5 + [num] * 5 + [ptr],
                "rfhe_ntt_inv_col": [ptr] * 5 + [num] * 5 + [ptr],
                "rfhe_ntt_fwd_row": [ptr] * 6 + [num] * 5 + [ptr],
                "rfhe_ntt_inv_row": [ptr] * 6 + [num] * 5 + [ptr],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, inverse: bool, x: torch.Tensor, plan,
               split: Optional[int] = None) -> torch.Tensor:
        """One transform.  `split` is log2(na) of the large-ring form, 0 for
        the one-block form, None for `default_split(n)`."""
        check_residues(x, plan.L, plan.n, plan.device)
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA NTT takes CUDA tensors, got {x.device}")
        if plan.n > MAX_N:
            raise ValueError(f"n={plan.n} exceeds the largest supported ring {MAX_N}")
        if split is None:
            split = default_split(plan.n)
        if split == 0 and plan.n > MAX_ONE_BLOCK_N:
            raise ValueError(f"n={plan.n} does not fit one block's shared memory")
        geometry = large_geometry(plan.log_n, split) if split else None
        B = x.numel() // (plan.L * plan.n)
        if B > MAX_BATCH:
            raise ValueError(f"batch {B} exceeds the grid limit {MAX_BATCH}")
        out = torch.empty_like(x)
        if B == 0:
            return out
        t, lib = plan.tables, self.lib()
        form = ("inv" if inverse else "fwd") + ("_large" if split else "")
        shape = (plan.L, B, plan.log_n)
        tw, consts, limbs = (t.kernel_tw.data_ptr(), t.kernel_consts.data_ptr(),
                             plan.limb_ids32.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if not split:
                fn = lib.rfhe_ntt_inv if inverse else lib.rfhe_ntt_fwd
                calls = [(fn, (x.data_ptr(), out.data_ptr(), tw, consts,
                               t.kernel_pos.data_ptr(), limbs, *shape, stream))]
            else:
                log_c, log_chunk = geometry
                tmp = torch.empty(x.numel(), dtype=torch.int32, device=x.device)
                pos_inv = t.kernel_pos_inv.data_ptr()
                col = lambda src, dst: (src, dst, tw, consts, limbs, *shape,
                                        split, log_c, stream)
                row = lambda src, dst: (src, dst, tw, consts, pos_inv, limbs,
                                        *shape, split, log_chunk, stream)
                if inverse:
                    calls = [(lib.rfhe_ntt_inv_row, row(x.data_ptr(), tmp.data_ptr())),
                             (lib.rfhe_ntt_inv_col, col(tmp.data_ptr(), out.data_ptr()))]
                else:
                    calls = [(lib.rfhe_ntt_fwd_col, col(x.data_ptr(), tmp.data_ptr())),
                             (lib.rfhe_ntt_fwd_row, row(tmp.data_ptr(), out.data_ptr()))]
            for fn, args in calls:
                rc = fn(*args)
                if rc != 0:
                    raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc} "
                                       f"(n={plan.n}, L={plan.L}, B={B}, split={split})")
                self.passes[form] += 1
        self.launches[form] += 1
        return out


KERNELS = NttKernels()


def fwd(x: torch.Tensor, plan, split: Optional[int] = None) -> torch.Tensor:
    """Forward NTT kernel (replaces ntt_fused.py:_fwd_kernel)."""
    return KERNELS.launch(False, x, plan, split)


def inv(y: torch.Tensor, plan, split: Optional[int] = None) -> torch.Tensor:
    """Inverse NTT kernel (replaces ntt_fused.py:_inv_kernel)."""
    return KERNELS.launch(True, y, plan, split)
