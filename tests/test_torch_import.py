"""The port's package boundary: it loads without jax and without the JAX
package, and its kernel wrapper refuses what the kernels do not take."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rfhe_tpu_torch import profile_rotation
from rfhe_tpu_torch.ops import ntt_cuda
from rfhe_tpu_torch.ops.ntt import NttPlan
from rfhe_tpu_torch.numth import find_ntt_primes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "rfhe_tpu_torch"


def test_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import rfhe_tpu_torch, rfhe_tpu_torch.fhe, rfhe_tpu_torch.ops.ntt_cuda\n"
        "import rfhe_tpu_torch.protect.checks, rfhe_tpu_torch.protect.ntt_guard\n"
        "import rfhe_tpu_torch.fhe.protected, rfhe_tpu_torch.faults.evaluator_campaign\n"
        "import rfhe_tpu_torch.bench.protected_overhead\n"
        "import rfhe_tpu_torch.fhe.bgv, rfhe_tpu_torch.fhe.bfv, rfhe_tpu_torch.fhe.serialize\n"
        "import rfhe_tpu_torch.ops.baseconv, rfhe_tpu_torch.models.dotprod\n"
        "from rfhe_tpu_torch.fhe.protected import ProtectedBgv\n"
        "import rfhe_tpu_torch.prng, rfhe_tpu_torch.ops.matmul_mod\n"
        "import rfhe_tpu_torch.transform.four_step\n"
        "import rfhe_tpu_torch.faults.inject, rfhe_tpu_torch.faults.campaign\n"
        "import rfhe_tpu_torch.faults.hardware, rfhe_tpu_torch.bench.real_monitor\n"
        "import rfhe_tpu_torch.bench.sweeps, rfhe_tpu_torch.bench.overheads\n"
        "import rfhe_tpu_torch.ops.ntt_pease, rfhe_tpu_torch.trace, rfhe_tpu_torch.models.bsgs\n"
        "import rfhe_tpu_torch.trace.markers, rfhe_tpu_torch.trace.analyze\n"
        "import rfhe_tpu_torch.trace.profiled, rfhe_tpu_torch.trace.cost\n"
        "import rfhe_tpu_torch.bench.phase_profile, rfhe_tpu_torch.bench.ops_devtime\n"
        "import rfhe_tpu_torch.bench.perf_suite, rfhe_tpu_torch.bench.northstar\n"
        "import rfhe_tpu_torch.bench.roofline\n"
        "import chip_smoke\n"
        "bad = [m for m, mod in sys.modules.items()\n"
        "       if mod is not None and m.split('.')[0] in ('jax', 'rfhe_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', rfhe_tpu_torch.__version__)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*.py")) + ["chip_smoke.py"])
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "rfhe_tpu"), (path, name)


@pytest.fixture(scope="module")
def plan():
    return NttPlan.make(256, find_ntt_primes(256, 30, 2), "cpu")


def test_cuda_wrapper_refuses_cpu_tensors(plan):
    x = torch.zeros((2, 256), dtype=torch.int64)
    before = (ntt_cuda.KERNELS.fwd_launches, ntt_cuda.KERNELS.inv_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ntt_cuda.fwd(x, plan)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ntt_cuda.inv(x, plan)
    plan.fwd(x)                      # the plain version counts nothing
    assert (ntt_cuda.KERNELS.fwd_launches, ntt_cuda.KERNELS.inv_launches) == before


@pytest.mark.parametrize("bad, err", [
    (lambda: torch.zeros((2, 256), dtype=torch.int32), TypeError),
    (lambda: np.zeros((2, 256), dtype=np.int64), TypeError),
    (lambda: torch.zeros((3, 256), dtype=torch.int64), ValueError),
    (lambda: torch.zeros((256,), dtype=torch.int64), ValueError),
    (lambda: torch.zeros((256, 2), dtype=torch.int64).T, ValueError),
])
def test_plan_checks_inputs(plan, bad, err):
    with pytest.raises(err):
        plan.fwd(bad())
    with pytest.raises(err):
        plan.inv(bad())


def test_build_location_is_inside_checkout():
    lib = ntt_cuda.library_path()
    assert lib.parent == ROOT / "build" / "rfhe_tpu_torch"
    assert lib.name.startswith("libntt_") and lib.suffix == ".so"
    assert ntt_cuda.SOURCE == PKG / "csrc" / "ntt.cu"
    assert "arch=compute_90a,code=sm_90a" in ntt_cuda.NVCC_FLAGS


@pytest.mark.parametrize("kernel, row", [
    ("(anonymous namespace)::ntt_fwd_col_kernel(long const*, unsigned int*)", "NTT forward kernels"),
    ("(anonymous namespace)::ntt_inv_kernel(long const*, long*)", "NTT inverse kernels"),
    ("void at::native::elementwise_kernel<remainder_kernel_cuda>", "aten::remainder (int64 %)"),
    ("void at::native::index_select_large_index<long>", "gathers (index_select / index)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<long, MulFunctor>>",
     "aten::mul"),
    ("Memcpy DtoD (Device -> Device)", "other elementwise (add, sub, where, compare, shift, copy)"),
])
def test_profile_rows(kernel, row):
    assert profile_rotation.group_of(kernel) == row


def test_profile_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        profile_rotation.profile_rotation(4096, None, 1)
