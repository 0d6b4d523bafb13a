"""The CUDA NTT kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips when there is no CUDA device.  This file
imports only torch and the port, so it also runs on a machine without jax:
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from rfhe_tpu_torch.numth import find_ntt_primes
from rfhe_tpu_torch.ops import ntt_cuda
from rfhe_tpu_torch.ops.ntt import NttPlan, ntt_fwd_reference, ntt_inv_reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(plan, batch, seed):
    g = torch.Generator(device=plan.device).manual_seed(seed)
    x = torch.randint(0, 1 << 62, (batch, plan.L, plan.n), device=plan.device, generator=g)
    return x % plan.q_arr[:, None]


def _check(plan, x, split=None):
    """One forward and one inverse launch in the form `split` selects,
    counted once each, equal to the plain versions."""
    before = dict(ntt_cuda.KERNELS.launches)
    y = ntt_cuda.fwd(x, plan, split)
    back = ntt_cuda.inv(y, plan, split)
    torch.cuda.synchronize()
    large = "_large" if (ntt_cuda.default_split(plan.n) if split is None else split) else ""
    after = ntt_cuda.KERNELS.launches
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
        {"fwd" + large: 1, "inv" + large: 1}
    assert torch.equal(y, ntt_fwd_reference(x, plan))
    assert torch.equal(back, ntt_inv_reference(y, plan))
    assert torch.equal(back, x)
    return y


@pytest.mark.parametrize("n, bits", [(256, 30), (2048, 31), (4096, 30), (8192, 31)])
def test_kernels_match_plain(cuda, n, bits):
    plan = NttPlan.make(n, find_ntt_primes(n, bits, 3), cuda).take([2, 0])
    x = _rand(plan, 3, n)
    before = (ntt_cuda.KERNELS.fwd_launches, ntt_cuda.KERNELS.inv_launches)
    y = plan.fwd(x)
    back = plan.inv(y)
    assert (ntt_cuda.KERNELS.fwd_launches, ntt_cuda.KERNELS.inv_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(y, ntt_fwd_reference(x, plan))
    assert torch.equal(back, ntt_inv_reference(y, plan))
    assert torch.equal(back, x)


@pytest.mark.parametrize("n, bits", [(16384, 30), (16384, 31), (32768, 30), (32768, 31),
                                     (65536, 30), (65536, 31)])
def test_large_ring_kernels_match_plain(cuda, n, bits):
    """The form each large ring takes by default, through `NttPlan.fwd/inv`,
    and the large-ring form at its default split."""
    plan = NttPlan.make(n, find_ntt_primes(n, bits, 4), cuda).take([3, 0, 2])
    x = _rand(plan, 3, n)
    y = _check(plan, x)
    log_n = n.bit_length() - 1
    assert torch.equal(ntt_cuda.fwd(x, plan, log_n - log_n // 2), y)
    assert torch.equal(plan.fwd(x), y) and torch.equal(plan.inv(y), x)


@pytest.mark.parametrize("n", [16384, 32768])
def test_one_block_form_with_opt_in_shared_memory(cuda, n):
    """64 KB and 128 KB of dynamic shared memory in the one-block kernels."""
    plan = NttPlan.make(n, find_ntt_primes(n, 31, 2), cuda)
    _check(plan, _rand(plan, 2, n), split=0)


@pytest.mark.parametrize("n, split", [(256, 1), (256, 4), (256, 7), (4096, 6), (4096, 9),
                                      (8192, 1), (8192, 12)])
def test_split_form_matches_one_block_kernels(cuda, n, split):
    """The large-ring form at small n with an explicit split, against the
    one-block kernels and the plain versions."""
    plan = NttPlan.make(n, find_ntt_primes(n, 31, 3), cuda).take([1, 2])
    x = _rand(plan, 2, n + split)
    y = _check(plan, x, split)
    assert torch.equal(y, ntt_cuda.fwd(x, plan, 0))
    assert torch.equal(ntt_cuda.inv(y, plan, 0), x)


def test_kernel_refuses_what_it_does_not_take(cuda):
    plan = NttPlan.make(65536, find_ntt_primes(65536, 30, 1), cuda)
    x = torch.zeros((1, 65536), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x, plan, 0)                 # 256 KB does not fit one block
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x, plan, 16)                # nb = 1
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x.cpu(), plan)              # a CPU tensor never reaches the kernel
