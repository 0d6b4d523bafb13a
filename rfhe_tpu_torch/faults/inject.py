"""Fault-injection primitives: bit flips and multiplier-fault models on
residue tensors, batched over trials.

Counterpart of `rfhe_tpu/faults/inject.py`, which writes each injector for
one trial and runs it under `jax.vmap` over per-trial keys.  Here each
injector takes the batch of keys, shape (*lead, 2), and tensors whose
leading axes are those trial axes: x has shape (*lead, *element), and the
reference's `x.size` is the size of one trial's element.  Every draw is made
on the host from `prng` (the same draws as `jax.random` under vmap) and moved
to x's device in one copy per injector call, whatever the number of trials.

Taxonomies (SURVEY.md §5):
  SCF-BF / SCF-MBU      storage single-bit / multi-bit-upset flips
  MCF-PPE / MCF-CTE / MCF-CLE  multiplier partial-product / carry-tree /
                        control-logic errors
  SBF / DBF / MOF1      single / double bit flip, randomize

Each injector corrupts one element per trial (MCF-CLE on a matrix corrupts a
row) and wraps the corrupted value by one conditional subtract of q, as the
reference does.  Element writes are one-hot `torch.where`s, the reference's
`_set_flat` (it avoids scatters, which its TPU runtime dropped under vmap).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..ops.modarith import mod_u64
from ..protect.fold import mul32_parts


def _dev(a, like: torch.Tensor) -> torch.Tensor:
    """A host draw as an int64 tensor on like's device."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(like.device)


def _trials(keys, x: torch.Tensor):
    """(leading trial shape, x as (*lead, size)): x's leading axes must be the keys'."""
    lead = np.shape(keys)[:-1]
    if tuple(x.shape[:len(lead)]) != lead:
        raise ValueError(f"tensor of shape {tuple(x.shape)} does not lead with the keys' {lead}")
    return lead, x.reshape(lead + (-1,))


def _wrap(v: torch.Tensor, q: int) -> torch.Tensor:
    # corrupted values are below 2^bitwidth <= 2q: one conditional subtract
    return torch.where(v >= q, v - q, v)


def _set_flat(flat: torch.Tensor, idx: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """flat[..., idx] = value per trial, as a one-hot where."""
    onehot = torch.arange(flat.shape[-1], device=flat.device) == idx[..., None]
    return torch.where(onehot, value[..., None], flat)


def _get_flat(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(flat, -1, idx[..., None])[..., 0]


def _scatter_xor_flat(x: torch.Tensor, keys, idx, mask, q: int) -> torch.Tensor:
    """XOR `mask` into flat element `idx` of each trial, wrapping by q."""
    _, flat = _trials(keys, x)
    idx, mask = _dev(idx, x), _dev(mask, x)
    v = _wrap(_get_flat(flat, idx) ^ mask, q)
    return _set_flat(flat, idx, v).reshape(x.shape)


def _size(keys, x: torch.Tensor) -> int:
    return int(np.prod(x.shape[len(np.shape(keys)) - 1:], dtype=np.int64))


def inject_sbf(keys, x: torch.Tensor, q: int, bitwidth: int) -> torch.Tensor:
    """Flip one random bit (< bitwidth) of one random element."""
    k = prng.split(keys)
    idx = prng.randint(k[..., 0, :], (), 0, _size(keys, x))
    b = prng.randint(k[..., 1, :], (), 0, bitwidth, np.uint32).astype(np.int64)
    return _scatter_xor_flat(x, keys, idx, 1 << b, q)


def inject_dbf(keys, x: torch.Tensor, q: int, bitwidth: int) -> torch.Tensor:
    """Flip two independently chosen random bits of one element (they may
    coincide, which is a single flip)."""
    k = prng.split(keys, 3)
    idx = prng.randint(k[..., 0, :], (), 0, _size(keys, x))
    b1 = prng.randint(k[..., 1, :], (), 0, bitwidth, np.uint32).astype(np.int64)
    b2 = prng.randint(k[..., 2, :], (), 0, bitwidth, np.uint32).astype(np.int64)
    return _scatter_xor_flat(x, keys, idx, (1 << b1) | (1 << b2), q)


def inject_mbu(keys, x: torch.Tensor, q: int, bitwidth: int,
               k_choices=(2, 3, 4)) -> torch.Tensor:
    """SCF-MBU: flip K contiguous bits at a random start."""
    k = prng.split(keys, 3)
    idx = prng.randint(k[..., 0, :], (), 0, _size(keys, x))
    K = np.asarray(k_choices, np.int64)[prng.randint(k[..., 1, :], (), 0, len(k_choices))]
    start = prng.randint(k[..., 2, :], (), 0, max(1, bitwidth - int(max(k_choices)) + 1),
                         np.uint32).astype(np.int64)
    return _scatter_xor_flat(x, keys, idx, (((1 << K) - 1) << start) & 0xFFFFFFFF, q)


def inject_mof1(keys, x: torch.Tensor, q: int) -> torch.Tensor:
    """Randomize one element uniformly in [0, q)."""
    k = prng.split(keys)
    _, flat = _trials(keys, x)
    idx = _dev(prng.randint(k[..., 0, :], (), 0, flat.shape[-1]), x)
    v = _dev(prng.randint(k[..., 1, :], (), 0, q, np.uint32), x)
    return _set_flat(flat, idx, v).reshape(x.shape)


def inject_cte(keys, x: torch.Tensor, q: int, bitwidth: int) -> torch.Tensor:
    """MCF-CTE: a bit flip biased to the high half of the word."""
    k = prng.split(keys)
    idx = prng.randint(k[..., 0, :], (), 0, _size(keys, x))
    b = prng.randint(k[..., 1, :], (), max(1, bitwidth // 2), bitwidth, np.uint32).astype(np.int64)
    return _scatter_xor_flat(x, keys, idx, 1 << b, q)


def inject_cle_matrix(keys, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                      arith) -> torch.Tensor:
    """MCF-CLE on a matmul result C = A @ B: a whole output row absorbs
    ±{1,2}·A[i, k0]·B[k0, :].  A, B, C: (*lead, rows, k), (*lead, k, cols),
    (*lead, rows, cols)."""
    k = prng.split(keys, 4)
    rows, kdim = C.shape[-2], B.shape[-2]
    lead = np.shape(keys)[:-1]
    i = _dev(prng.randint(k[..., 0, :], (), 0, rows), C).reshape(-1)
    k0 = _dev(prng.randint(k[..., 1, :], (), 0, kdim), C).reshape(-1)
    mfac = _dev(prng.randint(k[..., 2, :], (), 1, 3, np.uint32), C).reshape(-1, 1)
    s = torch.from_numpy(prng.bernoulli(k[..., 3, :])).to(C.device).reshape(-1, 1)
    A_, B_, C_ = (t.reshape((-1,) + tuple(t.shape[-2:])) for t in (A, B, C))
    t = torch.arange(C_.shape[0], device=C.device)
    delta = arith.mul(mfac, arith.mul(A_[t, i, k0][:, None], B_[t, k0, :]))
    row = C_[t, i, :]
    new_row = torch.where(s, arith.add(row, delta), arith.sub(row, delta))
    onehot = (torch.arange(rows, device=C.device) == i[:, None])[..., None]
    return torch.where(onehot, new_row[:, None, :], C_).reshape(lead + tuple(C.shape[-2:]))


def inject_cle_vector(keys, X: torch.Tensor, T: torch.Tensor, Y: torch.Tensor,
                      mod: int) -> torch.Tensor:
    """MCF-CLE on an elementwise product: Y[idx] = k·(X[idx]·T[idx]) mod M,
    k ∈ {-1, 2, -2}, M possibly composite (2^W - 1)."""
    k = prng.split(keys)
    _, flat = _trials(keys, Y)
    idx = _dev(prng.randint(k[..., 0, :], (), 0, flat.shape[-1]), Y)
    kk = np.array([mod - 1, 2, mod - 2], dtype=np.int64)
    kv = _dev(kk[prng.randint(k[..., 1, :], (), 0, 3)], Y)
    xf = _get_flat(_trials(keys, X)[1], idx)
    tf = _get_flat(_trials(keys, T)[1], idx)
    r = mod_u64(*mul32_parts(xf, tf), mod)
    r = mod_u64(*mul32_parts(r, kv), mod)
    return _set_flat(flat, idx, r).reshape(Y.shape)


# integer kind codes of the op-granularity injectors (the reference's
# FaultType enum NONE/SBF/DBF/MLF, and DELTA, which tests use to build
# checksum cancellations)
CODE_NONE, CODE_SBF, CODE_DBF, CODE_MLF, CODE_DELTA = 0, 1, 2, 3, 4
SCENARIO_KINDS = {
    "SBF": (CODE_SBF,), "DBF": (CODE_DBF,), "MLF": (CODE_MLF,),
    "MOF1": (CODE_MLF,),          # element randomization == MLF at this grain
    "SBF+SBF": (CODE_SBF, CODE_SBF), "SBF+DBF": (CODE_SBF, CODE_DBF),
    "MLF+SBF": (CODE_MLF, CODE_SBF), "MLF+DBF": (CODE_MLF, CODE_DBF),
    "MLF+MLF": (CODE_MLF, CODE_MLF),
}


def inject_value(v: torch.Tensor, kind, keys, q: int, bits: int, delta: int = 0) -> torch.Tensor:
    """Corrupt one value per trial by kind code (an int, or a tensor of codes
    per trial): SBF flips one random bit (< bits) and wraps by q, DBF two
    distinct bits, MLF randomizes in [0, q), DELTA adds `delta` mod q.  Every
    kind's draws are made whatever the kind, as in the reference."""
    k = prng.split(keys, 3)
    b1 = prng.randint(k[..., 0, :], (), 0, bits, np.uint32).astype(np.int64)
    b2 = prng.randint(k[..., 1, :], (), 0, bits - 1, np.uint32).astype(np.int64)
    b2 = np.where(b2 >= b1, b2 + 1, b2)
    m1, m2 = _dev(1 << b1, v), _dev(1 << b2, v)
    sbf = _wrap(v ^ m1, q)
    dbf = _wrap(v ^ m1 ^ m2, q)
    mlf = _dev(prng.randint(k[..., 2, :], (), 0, q, np.uint32), v)
    dl = _wrap(v + delta, q)
    kind = torch.as_tensor(kind, device=v.device)
    out = torch.where(kind == CODE_DELTA, dl, v)
    out = torch.where(kind == CODE_MLF, mlf, out)
    out = torch.where(kind == CODE_DBF, dbf, out)
    return torch.where(kind == CODE_SBF, sbf, out)


def sample_distinct_indices(keys, count: int, total: int) -> np.ndarray:
    """count ∈ {1, 2} distinct uniform indices in [0, total) per trial,
    (*lead, count) on the host."""
    if count == 1:
        return prng.randint(keys, (1,), 0, total)
    if count != 2:
        raise ValueError("the reference's scenarios inject at most 2 faults")
    k = prng.split(keys)
    o1 = prng.randint(k[..., 0, :], (), 0, total)
    o2 = prng.randint(k[..., 1, :], (), 0, total - 1)
    return np.stack([o1, np.where(o2 >= o1, o2 + 1, o2)], axis=-1)


def inject_elements(kind_codes, keys, x: torch.Tensor, q: int, bits: int) -> torch.Tensor:
    """Corrupt len(kind_codes) distinct elements of each trial's x (the
    multi-fault scenarios at storage granularity)."""
    _, flat = _trials(keys, x)
    k = prng.split(keys, len(kind_codes) + 1)
    idxs = _dev(sample_distinct_indices(k[..., 0, :], len(kind_codes), flat.shape[-1]), x)
    for j, kc in enumerate(kind_codes):
        v = inject_value(_get_flat(flat, idxs[..., j]), kc, k[..., j + 1, :], q, bits)
        flat = _set_flat(flat, idxs[..., j], v)
    return flat.reshape(x.shape)


def inject_kind(kind: str, keys, x: torch.Tensor, q: int, bitwidth: int) -> torch.Tensor:
    if kind in ("SBF", "SCF-BF", "MCF-PPE"):
        return inject_sbf(keys, x, q, bitwidth)
    if kind == "DBF":
        return inject_dbf(keys, x, q, bitwidth)
    if kind == "SCF-MBU":
        return inject_mbu(keys, x, q, bitwidth)
    if kind == "MCF-CTE":
        return inject_cte(keys, x, q, bitwidth)
    if kind in ("MOF1", "MLF"):
        # MLF (multi-line fault) randomizes the value in [0, q): MOF1 at
        # element granularity
        return inject_mof1(keys, x, q)
    raise ValueError(f"unknown fault kind {kind}")
