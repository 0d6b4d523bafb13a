"""The yardstick, frozen here so that a change to the program cannot move it.

H100 peaks and the work of a transform, copied from
`rfhe_tpu_torch/bench/roofline.py` (module docstring and constants) at
4-byte words: a residue word is read once and written once per
limb-transform, the reference's floor (`floor_bytes`, 2·4·n), whatever word
the program stores.  The rule that names the NTT kernels is `csrc/ntt.cu`'s
`ntt_*_kernel` names, and the host launch calls are the ones
`rfhe_tpu_torch/device.py` (`_LAUNCH_CALLS`, `device_records`) counts.
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT_OPS_PER_CLOCK_PER_SM = 64      # 32-bit integer ops, compute capability 9.0
SMS = 132
SM_MHZ = 1980                      # the H100 SXM's highest boost clock
INT_OPS_PER_S = INT_OPS_PER_CLOCK_PER_SM * SMS * SM_MHZ * 1e6
OPS_PER_BUTTERFLY = 9              # the lazy butterfly (`ct_round` / `gs_round`)
OPS_PER_EXIT = 5                   # the exit factor's Shoup product, once per element
BYTES_PER_WORD = 4

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync")
_NTT = re.compile(r"\bntt_[a-z_]+_kernel\b")
_COPY = ("Memcpy", "Memset")
_COPY_KERNELS = ("FillFunctor", "direct_copy_kernel")


def is_ntt(name: str) -> bool:
    """A kernel of `csrc/ntt.cu` (`ntt_fwd_kernel<4>`, `ntt_inv_cluster_kernel`, ...)."""
    return _NTT.search(name) is not None


def is_copy(name: str) -> bool:
    """A copy or fill: the graphs' input copies and output clones, zeros."""
    return name.startswith(_COPY) or any(k in name for k in _COPY_KERNELS)


def ntt_least_s(n: int) -> tuple:
    """(least seconds of one limb-transform of size n, the bound that sets
    it): words in and out once over HBM, or the butterflies' and exit
    products' integer operations over the integer peak."""
    t_bytes = 2 * BYTES_PER_WORD * n / HBM_BYTES_PER_S
    t_ops = ((n // 2) * (n.bit_length() - 1) * OPS_PER_BUTTERFLY + n * OPS_PER_EXIT) / INT_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
