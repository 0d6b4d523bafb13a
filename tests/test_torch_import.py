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
        "import rfhe_tpu_torch.ops.bigint, rfhe_tpu_torch.ops.ntt_stacked\n"
        "import rfhe_tpu_torch.faults.ntt_control, rfhe_tpu_torch.faults.reduction_campaigns\n"
        "import rfhe_tpu_torch.native, rfhe_tpu_torch.oracle, rfhe_tpu_torch.models.motivation\n"
        "import rfhe_tpu_torch.bench.fused_validate\n"
        "import rfhe_tpu_torch.parallel, rfhe_tpu_torch.parallel.mesh\n"
        "import rfhe_tpu_torch.parallel.sharded_ckks, rfhe_tpu_torch.parallel.worlds\n"
        "import rfhe_tpu_torch.transform.distributed, rfhe_tpu_torch.transform.mxu_sharded\n"
        "import rfhe_tpu_torch.bench.scaling, rfhe_tpu_torch.bench.scaling_mxu\n"
        "import rfhe_tpu_torch.figures, rfhe_tpu_torch.figures.draw\n"
        "import rfhe_tpu_torch.entry, rfhe_tpu_torch.bench.headline\n"
        "import rfhe_tpu_torch.utils, rfhe_tpu_torch.utils.jitcache\n"
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


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*.py")) + ["chip_smoke.py"])
def test_only_figures_import_matplotlib(path):
    """The chip machine has no matplotlib: only the figures package takes it."""
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    uses = any(name.split(".")[0] == "matplotlib" for name in names)
    assert not uses or path.startswith("rfhe_tpu_torch/figures/"), path


def test_rank_refuses_jax():
    """A rank of a spawned world that loads the JAX package raises, and the
    world's launcher raises with that rank's message."""
    from rfhe_tpu_torch.parallel.mesh import spawn_world
    with pytest.raises(Exception, match="loaded"):
        spawn_world(__import__, 2, "gloo", args=("rfhe_tpu.numth",), timeout_s=60, deadline_s=120)


def test_rank_failure_carries_its_traceback():
    from rfhe_tpu_torch.parallel.mesh import spawn_world
    with pytest.raises(Exception, match="No module named 'no_such_module_here'"):
        spawn_world(__import__, 2, "gloo", args=("no_such_module_here",), timeout_s=60,
                    deadline_s=120)


# rfhe_tpu modules with no file of the same path in the port, and where
# their work went (ROADMAP.md, "Every module of rfhe_tpu and its counterpart")
NO_SAME_PATH = {
    "ops/u32.py": "ops/modarith.py", "ops/const_matmul.py": "ops/ntt.py",
    "ops/ntt_mxu.py": "ops/ntt.py", "ops/ntt_fused.py": "csrc/ntt.cu",
    "bench/devtime.py": "device.py", "oracle/__init__.py": "oracle.py",
    "oracle/ntt.py": "oracle.py", "oracle/baseconv.py": "oracle.py",
    "oracle/reduction.py": None, "utils/compilecache.py": "ops/ntt_cuda.py",
}


def test_every_reference_module_has_a_counterpart():
    ref = {p.relative_to(ROOT / "rfhe_tpu").as_posix() for p in (ROOT / "rfhe_tpu").rglob("*.py")}
    missing = {m for m in ref if not (PKG / m).exists()}
    assert missing == set(NO_SAME_PATH)
    assert all((PKG / where).exists() for where in NO_SAME_PATH.values() if where)


# Public top-level names of a reference module that its counterpart does not
# define: where each one's work went (a path in the port), or None where the
# port needs none, and why.
NAMES_ELSEWHERE = {
    "fhe/rns.py": {"base_extend_digit": ("fhe/keys.py", "inlined in the keyswitch")},
    "numth.py": {"PrimeCtx": ("numth.py", "psi_negacyclic and NttPlan's tables hold its "
                              "constants"),
                 "base_conv_matrix": ("ops/baseconv.py", "beside its only user")},
    "ops/matmul_mod.py": {"np_matmul_mod": (None, "a numpy test oracle; the tests use the "
                                            "reference's")},
    "faults/evaluator_campaign.py": {"MISS_STAGES": ("faults/evaluator_campaign.py",
                                                     "check_row's ks_out branch")},
    "faults/inject.py": {k: ("faults/ntt_control.py", "the port's kind codes")
                         for k in ("KIND_SBF", "KIND_DBF", "KIND_MOF1")},
    "native.py": {"KIND_IDS": ("native.py", "SCENARIOS holds the codes")},
    "bench/phase_profile.py": {k: ("bench/phase_profile.py", "the spans give the phases "
                                   "and their sum")
                               for k in ("rotation_total", "rotation_total_checked")},
    "bench/roofline.py": {k: (None, "TPU v5e constants; the port's are the H100's")
                          for k in ("V5E_HBM_BPS", "V5E_BF16_FLOPS", "V5E_INT8_OPS")},
    "trace/markers.py": {"xla_trace": (None, "a jax.profiler trace; torch.profiler serves "
                                       "device.py and trace/")},
    "transform/distributed.py": {"make_mesh": ("parallel/mesh.py", "the one place meshes are made")},
    "ops/ntt.py": {**{k: ("ops/ntt_stacked.py", "the radix-2 stacked plans")
                      for k in ("StackedNttPlan", "bit_reverse_indices", "ntt", "intt",
                                "pointwise_mul", "poly_mul_negacyclic")},
                   **{k: ("ops/ntt_stacked.py", "and ops/ntt_pease.py for a Pease plan")
                      for k in ("negacyclic_ntt", "negacyclic_intt")}},
}


def _public_names(path: Path) -> set:
    """Functions, classes and assigned names at the top level of a module,
    less those starting with an underscore (imports are not counted)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in getattr(node, "targets", [getattr(node, "target", None)]):
                elts = target.elts if isinstance(target, ast.Tuple) else [target]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_every_reference_name_has_a_counterpart():
    ref = ROOT / "rfhe_tpu"
    missing = {}
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        if (PKG / rel).exists():
            gone = _public_names(path) - _public_names(PKG / rel)
            if gone:
                missing[rel] = gone
    assert missing == {m: set(names) for m, names in NAMES_ELSEWHERE.items()}
    for names in NAMES_ELSEWHERE.values():
        for where, why in names.values():
            assert why and (where is None or (PKG / where).exists()), (where, why)


def test_world_past_its_deadline_is_killed():
    import time
    from rfhe_tpu_torch.parallel.mesh import spawn_world
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not end"):
        spawn_world(time.sleep, 2, "gloo", args=(60,), timeout_s=60, deadline_s=3)
    assert time.monotonic() - t0 < 30


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
