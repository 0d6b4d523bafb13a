"""Measured cost of one evaluator op: device operations, kernel time, bytes.

Counterpart of `rfhe_tpu/trace/cost.py`.  The reference reads XLA's static
cost analysis of the compiled op (FLOPs, bytes accessed), its analog of the
reference's callgrind instruction counts.  Eager PyTorch compiles nothing,
so there is no static count to read: `op_cost` MEASURES one call under
torch.profiler (with `record_shapes`):

  device operations  the device kernels, copies and fills the call ran (on
                     the CPU: the outermost aten operations it called)
  kernel us          their summed durations (on the CPU: the host time of
                     those aten operations)
  bytes accessed     the bytes of the tensor arguments of the outermost aten
                     operations, plus input and output of each hand NTT
                     launch (`ops/ntt_cuda.py` counts them by shape; a ctypes
                     launch records no arguments)

FLOPs do not apply: the work is modular integer arithmetic on int64
residues, and the reference's FLOP column has no counterpart.  Whoever calls
`op_cost` builds keys and caches first, or their construction is measured.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..ops import ntt_cuda

_DTYPE_BYTES = {"long": 8, "long int": 8, "int": 4, "unsigned int": 4, "double": 8, "float": 4,
                "c10::complex<double>": 16, "bool": 1, "short": 2, "signed char": 1,
                "unsigned char": 1, "c10::Half": 2, "c10::BFloat16": 2}


def _elements(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _arg_bytes(ev) -> int:
    shapes, dtypes = ev.input_shapes or [], getattr(ev, "input_dtypes", None) or []
    total = 0
    for shape, dtype in zip(shapes, dtypes):
        if isinstance(shape, (list, tuple)) and shape and all(isinstance(d, int) for d in shape):
            total += _elements(shape) * _DTYPE_BYTES.get(dtype, 0)
    return total


def _outermost_aten(events) -> list:
    out = []
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.name.startswith("aten::"):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("aten::"):
            parent = parent.cpu_parent
        if parent is None:
            out.append(ev)
    return out


def op_cost(fn, *args) -> Dict[str, float]:
    """Measure one call of fn(*args) (after one warm call) as above.  Keys:
    'device operations', 'kernel us', 'bytes accessed', 'device'."""
    fn(*args)
    cuda = torch.cuda.is_available() and any(
        isinstance(a, torch.Tensor) and a.is_cuda for a in _tensors(args))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    shapes_before = dict(ntt_cuda.KERNELS.by_shape)
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        fn(*args)
        if cuda:
            torch.cuda.synchronize()
    events = prof.events()
    aten = _outermost_aten(events)
    nbytes = sum(_arg_bytes(ev) for ev in aten)
    for (form, batch, L, n), count in ntt_cuda.KERNELS.by_shape.items():
        nbytes += (count - shapes_before.get((form, batch, L, n), 0)) * 2 * 8 * batch * L * n
    if cuda:
        device = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(ev, "is_user_annotation", False)]
        ops, us = len(device), sum(ev.device_time_total for ev in device)
    else:
        ops, us = len(aten), sum(ev.cpu_time_total for ev in aten)
    return {"device operations": float(ops), "kernel us": float(us),
            "bytes accessed": float(nbytes), "device": "cuda" if cuda else "cpu"}


def _tensors(obj):
    """The tensors inside nested arguments (ciphertexts, key objects, lists)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif dataclasses.is_dataclass(obj):
        for o in vars(obj).values():
            yield from _tensors(o)


def evaluator_cost_report(ckks, ct_a, ct_b) -> Dict[str, Dict[str, float]]:
    """`op_cost` of each evaluator op at the ciphertexts' level
    (`rfhe_tpu.trace.cost.evaluator_cost_report`).  The relinearization and
    Galois keys are drawn first."""
    g = ckks.rotation_galois_element(1)
    ckks.rlk, ckks.galois_key(g)
    report = {}
    report["add"] = op_cost(lambda a, b: ckks.add(a, b).c[0].data, ct_a, ct_b)
    report["multiply"] = op_cost(lambda a, b: ckks.multiply(a, b).c[0].data, ct_a, ct_b)
    report["multiply_relin"] = op_cost(lambda a, b: ckks.multiply_relin(a, b).c[0].data,
                                       ct_a, ct_b)
    report["rescale"] = op_cost(
        lambda a, b: ckks.rescale(ckks.multiply_relin(a, b)).c[0].data, ct_a, ct_b)
    report["rotate"] = op_cost(lambda a: ckks.apply_galois(a, g).c[0].data, ct_a)
    return report


def format_report(report: Dict[str, Dict[str, float]]) -> str:
    lines = [f"{'op':<16}{'device ops':>12}{'kernel us':>12}{'MB moved':>12}"]
    for op, ca in report.items():
        lines.append(f"{op:<16}{ca['device operations']:>12.0f}{ca['kernel us']:>12.1f}"
                     f"{ca['bytes accessed'] / 1e6:>12.2f}")
    return "\n".join(lines)
