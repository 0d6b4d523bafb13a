"""The numpy/torch boundary, device checks and the card's name and clock.

Residues live on the device as torch.int64: every q < 2^31, so the product
of two residues is < 2^62 and exact.  uint32 numpy arrays (the JAX package's
storage) are converted only here, at the edges.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch


def to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 (or any integer) numpy array -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(arr).astype(np.int64)).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int64 residue tensor -> uint32 numpy array; raises if a value does
    not fit 32 bits."""
    a = t.detach().cpu().numpy()
    if a.size and (a.min() < 0 or a.max() >= (1 << 32)):
        raise ValueError("tensor holds values outside [0, 2^32)")
    return a.astype(np.uint32)


def check_device(t: torch.Tensor, device: torch.device, what: str = "tensor") -> None:
    """Raise unless `t` lies on `device` (the port never moves work silently)."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")


def check_residues(x: torch.Tensor, L: int, n: int, device: torch.device) -> None:
    """Raise unless x is a contiguous int64 tensor of shape (..., L, n) on
    `device`: the layout the NTT kernels and their plain versions take."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
        raise TypeError(f"expected an int64 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"expected shape (..., {L}, {n}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    check_device(x, device, "input")


def card() -> str:
    """The first card's name and power limit, as nvidia-smi gives them; every
    measured number is written beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of `fn` on the current CUDA stream: CUDA events
    around `reps` calls after 3 warm-ups."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
