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
    kind, _ = ntt_cuda.resolve_split(plan.n, split, x.shape[0] * plan.L)
    large = "" if kind == "one_block" else "_large"
    after = ntt_cuda.KERNELS.launches
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
        {"fwd" + large: 1, "inv" + large: 1}
    assert torch.equal(y, ntt_fwd_reference(x, plan))
    assert torch.equal(back, ntt_inv_reference(y, plan))
    assert torch.equal(back, x)
    return y


@pytest.mark.parametrize("n, bits", [(256, 30), (256, 31), (512, 30), (512, 31), (1024, 30),
                                     (1024, 31), (2048, 30), (2048, 31), (4096, 30), (4096, 31),
                                     (8192, 30), (8192, 31)])
def test_kernels_match_plain(cuda, n, bits):
    """The one-block kernels at every ring they take, lazy and strict limbs."""
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
    and both large-ring kernels at the ring's own split."""
    plan = NttPlan.make(n, find_ntt_primes(n, bits, 4), cuda).take([3, 0, 2])
    x = _rand(plan, 3, n)
    y = _check(plan, x)
    for kind in (ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER):
        assert torch.equal(_check(plan, x, (kind, ntt_cuda.large_split(n))), y)
    assert torch.equal(plan.fwd(x), y) and torch.equal(plan.inv(y), x)


@pytest.mark.parametrize("batch", [1, 5, 23, 70000])
def test_one_block_polynomial_groups_on_the_card(cuda, batch):
    """The one-block kernels on batches of one, of groups of uneven length
    (23 polynomials of 22 limbs at n = 4096: 11 groups of three trips and
    two) and beyond grid.y's 65535, lazy and strict limbs together; n = 8192
    takes its shared memory as an opt-in."""
    n = 256 if batch > 64 else 4096
    many = 1 if batch > 64 else 7
    plan = NttPlan.make(n, find_ntt_primes(n, 30, 2 * many) + find_ntt_primes(n, 31, many + 1), cuda)
    _check(plan, _rand(plan, batch, batch), split=0)
    if batch <= 64:
        big = NttPlan.make(8192, find_ntt_primes(8192, 30, 2) + find_ntt_primes(8192, 31, 1), cuda)
        _check(big, _rand(big, batch, batch), split=0)


@pytest.mark.parametrize("kind", [ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER])
@pytest.mark.parametrize("n, split", [(256, 4), (256, 7), (2048, 4), (4096, 5), (4096, 6),
                                      (4096, 8), (8192, 5), (8192, 8)])
def test_split_form_matches_one_block_kernels(cuda, n, split, kind):
    """The large-ring kernels at small n with an explicit split, against the
    one-block kernels and the plain versions."""
    plan = NttPlan.make(n, find_ntt_primes(n, 31, 3), cuda).take([1, 2])
    x = _rand(plan, 2, n + split)
    y = _check(plan, x, (kind, split))
    assert torch.equal(y, ntt_cuda.fwd(x, plan, 0))
    assert torch.equal(ntt_cuda.inv(y, plan, 0), x)


@pytest.mark.parametrize("kind", [ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER])
@pytest.mark.parametrize("batch", [1, 5, 23, 70000])
def test_polynomial_groups_on_the_card(cuda, kind, batch):
    """Batches of one, of groups of uneven length (5 over 2, 23 over 5) and
    beyond grid.y's 65535, lazy and strict limbs together."""
    n = 256 if batch > 64 else 16384
    primes = find_ntt_primes(n, 30, 2) + find_ntt_primes(n, 31, 1)
    plan = NttPlan.make(n, primes, cuda)
    _check(plan, _rand(plan, batch, batch), (kind, ntt_cuda.large_split(n) if n > 256 else 4))


def test_launch_size_picks_the_large_ring_kernels(cuda):
    """By itself a launch of few vectors takes the cluster kernels (one
    __global__ launch), a launch of many the two passes (two)."""
    n = 32768
    plan = NttPlan.make(n, find_ntt_primes(n, 30, 8), cuda)
    for batch, passes in ((2, 1), (ntt_cuda.CLUSTER_MAX_WORDS // (8 * n) + 1, 2)):
        before = ntt_cuda.KERNELS.passes["fwd_large"]
        _check(plan, _rand(plan, batch, batch))
        assert ntt_cuda.KERNELS.passes["fwd_large"] - before == passes


def test_kernel_refuses_what_it_does_not_take(cuda):
    plan = NttPlan.make(65536, find_ntt_primes(65536, 30, 1), cuda)
    x = torch.zeros((1, 65536), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x, plan, 0)                 # one block takes n <= 8192
    mid = NttPlan.make(16384, find_ntt_primes(16384, 30, 1), cuda)
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x[:, :16384].contiguous(), mid, 0)
    tiny = NttPlan.make(128, find_ntt_primes(128, 30, 1), cuda)
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x[:, :128].contiguous(), tiny)      # no kernel takes n < 256
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x, plan, 12)                # nb = 16 but na = 4096 rows
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x, plan, ("rows", 8))       # no such form
    with pytest.raises(ValueError):
        ntt_cuda.fwd(x.cpu(), plan)              # a CPU tensor never reaches the kernel


@pytest.mark.parametrize("n, bits, split", [(256, 30, None), (4096, 31, None), (8192, 30, None),
                                            (16384, 30, (ntt_cuda.TWO_PASS, 7)),
                                            (65536, 30, (ntt_cuda.CLUSTER, 8)),
                                            (65536, 31, (ntt_cuda.TWO_PASS, 8))])
def test_kernels_on_flipped_words(cuda, n, bits, split):
    """Words with a flipped bit (up to 2^32, some at or above q) in both
    directions: each kernel reduces a word on entry, so it gives the plain
    versions' output, the transform of the words mod q."""
    plan = NttPlan.make(n, find_ntt_primes(n, bits, 3), cuda).take([2, 0])
    x = _rand(plan, 3, n)
    g = torch.Generator(device=cuda).manual_seed(n)
    rows = x.view(-1, n)
    idx = torch.randint(0, n, (rows.shape[0],), device=cuda, generator=g)
    bit = torch.randint(0, 32, (rows.shape[0],), device=cuda, generator=g)
    rows[torch.arange(rows.shape[0], device=cuda), idx] ^= torch.ones_like(bit) << bit
    assert torch.equal(ntt_cuda.fwd(x, plan, split), ntt_fwd_reference(x, plan))
    assert torch.equal(ntt_cuda.inv(x, plan, split), ntt_inv_reference(x, plan))


def test_protected_ops_match_cpu(cuda):
    """The protected rotate and multiply_relin at n=1024 on the card equal a
    CPU run of the same seed, arrays and flags, clean and under two faults."""
    import numpy as np
    from rfhe_tpu_torch.fhe import CkksContext, CkksParams
    from rfhe_tpu_torch.fhe.protected import Fault, ProtectedCkks, all_ok

    runs = []
    for dev in (cuda, "cpu"):
        ctx = CkksContext(CkksParams.make(n=1024, levels=3), seed=3, dnum=2, device=dev)
        prot = ProtectedCkks(ctx)
        ct = ctx.encrypt(*ctx.encode(np.random.default_rng(7).normal(size=512)))
        ops = [prot.rotate(ct, 1), prot.multiply_relin(ct, ct),
               prot.rotate(ct, 1, Fault("acc0", 1, 17, 9)),
               prot.multiply_relin(ct, ct, Fault("intt_out", 0, 11, 7))]
        assert bool(all_ok(ops[0][1])) and bool(all_ok(ops[1][1]))
        assert not bool(all_ok(ops[2][1])) and not bool(all_ok(ops[3][1]))
        runs.append([([c.data.cpu() for c in out.c], {k: v.cpu() for k, v in flags.items()})
                     for out, flags in ops])
    for (a, fa), (b, fb) in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert list(fa) == list(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("n, t_bits", [(4096, 16), (16384, 17), (16384, 20)])
def test_plaintext_modulus_plan(cuda, n, t_bits):
    """BGV/BFV's t plan, (1, 1, n) with one 16- to 20-bit prime, in the form
    it takes by itself and, at n = 16384, in both large-ring forms."""
    plan = NttPlan.make(n, find_ntt_primes(n, t_bits, 1), cuda)
    x = _rand(plan, 1, n)
    y = _check(plan, x)
    if n > ntt_cuda.MAX_ONE_BLOCK_N:
        for kind in (ntt_cuda.TWO_PASS, ntt_cuda.CLUSTER):
            assert torch.equal(_check(plan, x, (kind, ntt_cuda.large_split(n))), y)


@pytest.mark.parametrize("batch, L", [(4, 13), (3, 13), (3, 10), (10, 11), (1, 10), (2, 1),
                                      (2, 10), (9, 10), (1, 9)])
def test_scheme_shapes(cuda, batch, L):
    """The shapes of the BEHZ basis and of the BGV keyswitch at N = 16384
    (30-bit primes, a non-contiguous take) against the plain versions."""
    plan = NttPlan.make(16384, find_ntt_primes(16384, 30, L + 1), cuda)
    plan = plan.take([L] + list(range(L - 1)))
    _check(plan, _rand(plan, batch, L))


@pytest.mark.parametrize("scheme", ["bgv", "bfv", "protected bgv"])
def test_scheme_ops_match_cpu(cuda, scheme):
    """BGV multiply_relin, mod_switch_to_next and rotate_rows, BFV
    multiply_relin and rotate_rows, and ProtectedBgv's (arrays and flags),
    at n=1024 on the card equal a CPU run of the same seed."""
    import numpy as np
    from rfhe_tpu_torch.fhe import BfvContext, BfvParams, BgvContext, BgvParams
    from rfhe_tpu_torch.fhe.protected import ProtectedBgv

    runs = []
    for dev in (cuda, "cpu"):
        if scheme == "bfv":
            ctx = BfvContext(BfvParams.make(n=1024, levels=3), seed=13, device=dev)
        else:
            ctx = BgvContext(BgvParams.make(n=1024, levels=3), seed=11, dnum=2, device=dev)
        m = np.random.default_rng(1).integers(0, ctx.t, (2, 512))
        ct = ctx.encrypt(ctx.encode(m))
        if scheme == "protected bgv":
            prot = ProtectedBgv(ctx)
            ops = [prot.rotate_rows(ct, 1), prot.multiply_relin(ct, ct)]
            outs = [out for out, _ in ops]
            flags = [{k: v.cpu() for k, v in f.items()} for _, f in ops]
        else:
            prod = ctx.multiply_relin(ct, ct)
            outs = [prod, ctx.rotate_rows(ct, 1)]
            if scheme == "bgv":
                outs.append(ctx.mod_switch_to_next(prod))
            flags = []
        np.testing.assert_array_equal(ctx.decrypt_decode(outs[0]),
                                      np.roll(m, -1, axis=1) if scheme == "protected bgv"
                                      else m * m % ctx.t)
        runs.append(([[c.data.cpu() for c in out.c] for out in outs], flags))
    (a, fa), (b, fb) = runs
    assert all(torch.equal(x, y) for xs, ys in zip(a, b) for x, y in zip(xs, ys))
    assert all(list(f) == list(g) and all(torch.equal(f[k], g[k]) for k in f)
               for f, g in zip(fa, fb))


def test_matmul_mod_exact_on_card(cuda):
    """The float64 split on the card's FP64 units equals the exact product in
    Python integers, at the four-step's n2 = 64 and at a contraction of 8192."""
    import numpy as np
    from rfhe_tpu_torch.ops.matmul_mod import DigitPlan, matmul_mod

    for bits in (20, 30, 31):
        q = find_ntt_primes(64, bits, 1)[0]
        plan = DigitPlan(q)
        for m, k, n in ((64, 64, 64), (8, 8192, 8)):
            g = torch.Generator().manual_seed(k + bits)
            a = torch.randint(0, 1 << 32, (3, m, k), generator=g)
            b = torch.randint(0, 1 << 32, (k, n), generator=g)
            mask = plan.word_mask                          # the bits the reference's digits read
            want = ((a & mask).numpy().astype(object) @ (b & mask).numpy().astype(object)) % q
            got = matmul_mod(a.to(cuda), b.to(cuda), plan).cpu().numpy()
            assert (got == want).all()


@pytest.mark.parametrize("ftype", ["SCF-BF", "SCF-MBU", "MCF-PPE", "MCF-CTE", "MCF-CLE"])
def test_three_stage_campaign_matches_cpu(cuda, ftype):
    from rfhe_tpu_torch.faults.campaign import three_stage_campaign

    got = three_stage_campaign(ftype, 512, S=8, P=53, W=24, seed=42, device="cuda")
    want = three_stage_campaign(ftype, 512, S=8, P=53, W=24, seed=42, device="cpu")
    assert all((got[k] == want[k]).all() for k in want)


@pytest.mark.parametrize("scenario, target", [("SBF", None), ("MLF+DBF", 0), ("SBF+SBF", 2)])
def test_four_step_campaign_matches_cpu(cuda, scenario, target):
    from rfhe_tpu_torch.faults.campaign import four_step_ntt_campaign

    kw = dict(fold_width=24, seed=42, target_stage=target)
    got = four_step_ntt_campaign(scenario, 512, 256, 7681, device="cuda", **kw)
    want = four_step_ntt_campaign(scenario, 512, 256, 7681, device="cpu", **kw)
    assert got["stats"] == want["stats"] and got["det_rate"] == want["det_rate"]
    assert (got["per_stage_miss"] == want["per_stage_miss"]).all()


def test_ntt_flip_campaign_matches_cpu(cuda):
    """Through the hand kernels: the statistics and a launch per transform."""
    from rfhe_tpu_torch.faults.hardware import ntt_flip_campaign, ntt_real_test

    primes = find_ntt_primes(4096, 30, 8)
    plans = {dev: NttPlan.make(4096, primes, dev) for dev in (cuda, "cpu")}
    for flips, syms in ((1, 1), (3, 7), (15, 7)):
        before = ntt_cuda.KERNELS.fwd_launches
        got, info = ntt_flip_campaign(plans[cuda], 1, flips, syms, seed=42)
        assert ntt_cuda.KERNELS.fwd_launches == before + 2
        want, want_info = ntt_flip_campaign(plans["cpu"], 1, flips, syms, seed=42)
        assert vars(got) == vars(want) and info == want_info
    assert ntt_real_test(plans[cuda], batch=8, seed=0).hamming_bits == 0


def test_dotprod_fault_campaign_matches_cpu(cuda):
    from rfhe_tpu_torch.faults.hardware import dotprod_fault_campaign
    from rfhe_tpu_torch.fhe import BgvContext, BgvParams

    res = [dotprod_fault_campaign(BgvContext(BgvParams.make(n=1024, levels=2, q_bits=30,
                                                            t_bits=16), seed=5, device=dev),
                                  2, 3, seed=42) for dev in (cuda, "cpu")]
    assert res[0] == res[1]
    assert res[0]["clean_product_ok"] and res[0]["clean_dot_ok"] and res[0]["symbol_errors"] > 0


def test_overhead_atoms_match_cpu(cuda):
    from rfhe_tpu_torch.bench.overheads import atoms

    on_card, on_cpu = atoms(4096, 8, "cuda"), atoms(4096, 8, "cpu")
    for name in on_card:
        for fn_card, fn_cpu in zip(on_card[name], on_cpu[name]):
            a, b = fn_card(), fn_cpu()
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b)), name


@pytest.mark.parametrize("n, L", [(1024, 3), (4096, 21)])
def test_pease_matches_cpu(cuda, n, L):
    """The Pease pipeline on the card equals a CPU run; on an NttPlan the
    dispatch launches K1 / K2 and equals the plan's transforms."""
    from rfhe_tpu_torch.ops import ntt_pease

    primes = find_ntt_primes(n, 30, L)
    x = torch.randint(0, min(primes), (2, L, n), generator=torch.Generator().manual_seed(n))
    out = []
    for dev in (cuda, "cpu"):
        plan = ntt_pease.PeaseNttPlan.make(n, primes, dev)
        y = ntt_pease.negacyclic_ntt(x.to(dev), plan)
        out.append((y.cpu(), ntt_pease.negacyclic_intt(y, plan).cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][1], x)
    plan = NttPlan.make(n, primes, cuda)
    before = ntt_cuda.KERNELS.fwd_launches
    assert torch.equal(ntt_pease.negacyclic_ntt(x.to(cuda), plan), plan.fwd(x.to(cuda)))
    assert ntt_cuda.KERNELS.fwd_launches == before + 2


@pytest.mark.parametrize("dnum", [None, 2])
def test_profiled_rotation_matches_cpu(cuda, dnum):
    """ProfiledRotation on the card equals ctx.rotate there and a CPU run of
    the same seed."""
    import numpy as np
    from rfhe_tpu_torch.fhe import CkksContext, CkksParams
    from rfhe_tpu_torch.trace import ProfiledRotation

    runs = []
    for dev in (cuda, "cpu"):
        ctx = CkksContext(CkksParams.make(n=1024, levels=3), seed=3, dnum=dnum, device=dev)
        ct = ctx.encrypt(*ctx.encode(np.random.default_rng(7).normal(size=512)))
        out, plain = ProfiledRotation(ctx).rotate(ct, 1), ctx.rotate(ct, 1)
        assert all(torch.equal(a.data, b.data) for a, b in zip(out.c, plain.c))
        runs.append([c.data.cpu() for c in out.c])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("n", [1024, 65536])
def test_grid_audit_rings(cuda, n):
    """The shape-grid audit (bench/fused_validate.py) at two rings: every mix
    in every form bit-exact, one K1 and one K2 launch per row."""
    from rfhe_tpu_torch.bench import fused_validate

    saved = fused_validate.NS
    fused_validate.NS = (n,)
    try:
        before = ntt_cuda.KERNELS.fwd_launches
        rows = list(fused_validate.grid_rows(cuda))
    finally:
        fused_validate.NS = saved
    assert len(rows) == 3 * len(fused_validate.forms(n))
    assert all(r["fwd_ok"] and r["inv_ok"] and r["roundtrip_ok"] for r in rows)
    assert ntt_cuda.KERNELS.fwd_launches == before + len(rows)


@pytest.mark.parametrize("name, args, kw", [
    ("barrett_scheme_campaign", (4, (True, True, True), 300), dict(vec_len=512, fault="MOF")),
    ("barrett_final_campaign", (5, 4, 300), dict(vec_len=512)),
])
def test_reduction_campaign_matches_cpu(cuda, name, args, kw):
    from rfhe_tpu_torch.faults import reduction_campaigns

    fn = getattr(reduction_campaigns, name)
    assert fn(*args, device="cuda", chunk=100, **kw) == fn(*args, device="cpu", **kw)


def test_stacked_plan_and_control_match_cpu(cuda):
    from rfhe_tpu_torch.faults.ntt_control import standard_ntt_campaign
    from rfhe_tpu_torch.numth import find_ntt_prime
    from rfhe_tpu_torch.ops import ntt_stacked

    primes = find_ntt_primes(4096, 30, 3)
    x = torch.randint(0, min(primes), (2, 3, 4096), generator=torch.Generator().manual_seed(3))
    out = [ntt_stacked.poly_mul_negacyclic(x.to(dev), x.to(dev),
                                           ntt_stacked.StackedNttPlan.make(4096, primes, dev)).cpu()
           for dev in (cuda, "cpu")]
    assert torch.equal(out[0], out[1])
    q = find_ntt_prime(64, 12, negacyclic=False)
    for target in ("mult", "storage"):
        assert standard_ntt_campaign("SBF+DBF", target, 500, 64, q, device="cuda") == \
            standard_ntt_campaign("SBF+DBF", target, 500, 64, q, device="cpu")


@pytest.mark.parametrize("what", ["four_step", "mxu", "ckks"])
def test_sharded_paths_in_an_nccl_world(cuda, what):
    """A world of one NCCL rank on the card: the sharded NTTs equal the
    unsharded transforms (the production one: K1/K2), and the limb-sharded
    evaluator equals the unsharded context, launching the kernels."""
    import numpy as np

    from rfhe_tpu_torch.fhe import CkksContext, CkksParams
    from rfhe_tpu_torch.parallel import worlds
    from rfhe_tpu_torch.parallel.mesh import spawn_world
    from rfhe_tpu_torch.transform.four_step import FourStepPlan, four_step_ntt

    rng = np.random.default_rng(1)
    if what == "four_step":
        n, q = 1024, find_ntt_primes(1024, 28, 1)[0]
        x1, xb = rng.integers(0, q, n, dtype=np.uint32), rng.integers(0, q, (8, n), dtype=np.uint32)
        out = spawn_world(worlds.four_step_cases, 1, "nccl",
                          args=(n, q, x1, xb, 0, (1, 2, 3), (1,), "cuda"))[0]
        want = four_step_ntt(torch.from_numpy(xb.astype(np.int64)), FourStepPlan.make(n, q, "cpu"))
        assert np.array_equal(out[1, "fwd", "batched"], want.numpy())
        assert np.array_equal(out[1, "inv", "batched"], xb)
        assert out[1, "protected"][1:] == (True, True, True) and not out[1, "flipped"][0]
    elif what == "mxu":
        n = 4096
        primes = find_ntt_primes(n, 30, 12)
        x = rng.integers(0, min(primes), (12, n), dtype=np.uint32)
        out = spawn_world(worlds.mxu_cases, 1, "nccl",
                          args=(n, primes, x, x[None], (3, 77, 5), (1,), "cuda"))[0]
        plan = NttPlan.make(n, primes, cuda)
        xt = torch.from_numpy(x.astype(np.int64)).to(cuda)
        assert np.array_equal(out[1, "fwd"], plan.fwd(xt).cpu().numpy())
        assert np.array_equal(out[1, "inv"], plan.inv(plan.fwd(xt)).cpu().numpy())
        assert out[1, "protected"][1].all() and not out[1, "flipped"][1][3]
    else:
        params = dict(n=4096, levels=4, q0_bits=30, scale_bits=28)
        z = rng.uniform(-1, 1, 2048) + 0j
        out = spawn_world(worlds.ckks_cases, 1, "nccl", args=(params, 7, z, 1, None, True, "cuda"))[0]
        ckks = CkksContext(CkksParams.make(**params), seed=7, device=cuda)
        ct = ckks.encrypt(*ckks.encode(z))
        rot = ckks.rotate(ct, 1)
        mr = ckks.multiply_relin(ct, ct)
        for name, want in (("rotate", rot), ("multiply_relin", mr), ("rescale", ckks.rescale(mr)),
                           ("conjugate", ckks.conjugate(ct))):
            assert all(np.array_equal(a, b) for a, b in zip(out[name], want.to_numpy())), name


# ---------------------------------------------------------------------------
# the per-op CUDA graphs (utils/jitcache.py)
# ---------------------------------------------------------------------------

def _graph_ctx(cuda, dnum=None):
    import numpy as np
    from rfhe_tpu_torch.fhe import CkksContext, CkksParams
    ctx = CkksContext(CkksParams.make(n=1024, levels=3), seed=3, dnum=dnum, device=cuda)
    zs = np.random.default_rng(7).uniform(-1, 1, (2, 512)) + 0j
    return ctx, [ctx.encrypt(*ctx.encode(z)) for z in zs]


@pytest.mark.parametrize("dnum", [None, 2])
def test_replay_equals_eager(cuda, dnum):
    """Every public CKKS op, graphed (a capture, then replays) and under
    eager(), on the same inputs: equal arrays, equal scale."""
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx, (a, b) = _graph_ctx(cuda, dnum)
    ops = {"rotate": lambda x: ctx.rotate(x, 1), "conjugate": ctx.conjugate,
           "multiply_relin": lambda x: ctx.multiply_relin(x, b), "add": lambda x: ctx.add(x, b),
           "rescale": lambda x: ctx.rescale(ctx.multiply_relin(x, x)),
           "multiply": lambda x: ctx.multiply(x, b)}
    for name, op in ops.items():
        with eager():
            want = op(a)
        for _ in range(3):
            got = op(a)
            assert got.scale == want.scale, name
            assert all(torch.equal(x.data, y.data) for x, y in zip(got.c, want.c)), name
    assert all(len(j.graphs) == 1 for j in ctx._jits.values())
    assert sum(g.replays for j in ctx._jits.values() for g in j.graphs) > 0


def test_interleaved_replays_leave_earlier_results(cuda):
    """A, B, A, B through one graph: each result is the eager one of its
    input, and the earlier results are not overwritten by later replays."""
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx, (a, b) = _graph_ctx(cuda)
    with eager():
        want = {id(a): ctx.rotate(a, 1), id(b): ctx.rotate(b, 1)}
    outs = [(x, ctx.rotate(x, 1)) for x in (a, b, a, b)]
    torch.cuda.synchronize()
    for x, out in outs:
        assert all(torch.equal(p.data, q.data) for p, q in zip(out.c, want[id(x)].c))
    assert not torch.equal(outs[0][1].c[0].data, outs[1][1].c[0].data)
    (jit,) = [j for k, j in ctx._jits.items() if k[0] == "galois"]
    assert len(jit.graphs) == 1 and jit.graphs[0].replays == 3


def test_replay_counts_its_kernels(cuda):
    """A replay adds the NTT counts the eager op makes; a capture adds none."""
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx, (a, _) = _graph_ctx(cuda)
    k = ntt_cuda.KERNELS

    def counts(run):
        k.reset_counts()
        run()
        return k.snapshot()

    ctx.galois_key(ctx.rotation_galois_element(1))          # keygen launches NTTs too
    with eager():
        want = counts(lambda: ctx.rotate(a, 1))
    assert want["launches"]["fwd"] > 0 and want["launches"]["inv"] > 0
    assert counts(lambda: ctx.rotate(a, 1)) == want        # first call: eager warm-up, capture
    assert counts(lambda: ctx.rotate(a, 1)) == want        # replay


def test_capture_failure_raises(cuda):
    """An op that syncs with the host cannot be captured: the call raises
    with the op's name, it does not run eagerly instead; the side stream is
    usable afterwards."""
    from rfhe_tpu_torch.utils.jitcache import CaptureError, hoisted_jit
    x = torch.arange(8, device=cuda)
    bad = hoisted_jit(lambda t: t * int(t.sum().item()), name="syncs")
    with pytest.raises(CaptureError, match="syncs"):
        bad(x)
    assert bad.graphs == []
    good = hoisted_jit(lambda t: t + 1, name="adds")
    for _ in range(3):
        assert torch.equal(good(x), x + 1)
    assert len(good.graphs) == 1 and good.graphs[0].replays == 2


def test_load_keys_drops_the_graphs(cuda):
    """After load_keys the ops run on the new keys: the graphs that read the
    old ones are gone."""
    from rfhe_tpu_torch.fhe import CkksContext, CkksParams
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx, (a, _) = _graph_ctx(cuda)
    other = CkksContext(CkksParams.make(n=1024, levels=3), seed=4, device=cuda)
    other.galois_key(ctx.rotation_galois_element(1))
    ctx.rotate(a, 1), ctx.rotate(a, 1)
    ctx.load_keys(other.export_keys())
    assert ctx._jits == {}
    got = ctx.rotate(a, 1)
    with eager():
        want = other.rotate(a, 1)
    assert all(torch.equal(p.data, q.data) for p, q in zip(got.c, want.c))


def test_capture_while_a_dropped_context_is_collected(cuda):
    """A context dropped with its graphs is freed by the cyclic collector;
    a collection during another op's capture must not destroy a graph
    inside that capture (it would invalidate it)."""
    import gc
    ctx, (a, _) = _graph_ctx(cuda)
    ctx.rotate(a, 1), ctx.rotate(a, 1)
    del ctx, a
    other, (b, _) = _graph_ctx(cuda, dnum=2)
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        first, second = other.rotate(b, 1), other.rotate(b, 1)
    finally:
        gc.set_threshold(*old)
    assert all(torch.equal(p.data, q.data) for p, q in zip(first.c, second.c))


def _kernel_names(run):
    """The device records of `run()` by name in start order, copies and
    fills left out, from a padded profile that lost none of them."""
    from rfhe_tpu_torch.device import device_records, padded_profile
    for _ in range(3):
        with padded_profile() as prof:
            run()
        device, _, lost = device_records(prof.events())
        if lost == 0:
            return [ev.name for ev in sorted(device, key=lambda e: e.time_range.start)
                    if not ev.name.startswith(("Memcpy", "Memset"))]
    raise AssertionError(f"three profiles lost device records ({lost} in the last)")


@pytest.mark.parametrize("dnum", [None, 2])
def test_traced_rotation_equals_untraced(cuda, dnum):
    """With tracing on, a rotation captures a graph of its own, whose result
    is the untraced one bit for bit and whose replays add each phase's time
    on the card, the mod-down's four once per special prime; with tracing
    off again, the first graph serves."""
    from rfhe_tpu_torch.trace import spans
    ctx, (a, _) = _graph_ctx(cuda, dnum)
    want = [ctx.rotate(a, 1) for _ in range(2)][-1]
    spans.enable(cuda)
    try:
        snap = spans.snapshot()
        got = [ctx.rotate(a, 1) for _ in range(3)]      # eager warm-up, capture, 2 replays
        read = spans.since(snap)
    finally:
        spans.disable()
    again = ctx.rotate(a, 1)
    for out in got + [again]:
        assert all(torch.equal(x.data, y.data) for x, y in zip(out.c, want.c))
    (jit,) = [j for k, j in ctx._jits.items() if k[0] == "galois"]
    assert [g.replays for g in jit.graphs] == [2, 2]
    for name in spans.PHASES + (spans.KEYSWITCH,):
        assert read[name]["device_count"] == 3 and read[name]["device_ns"] > 0, name
    specials = len(ctx.ctx.moduli) - ctx.L
    for name in spans.MODDOWN_PHASES:
        assert read[name]["device_count"] == 3 * specials and read[name]["device_ns"] > 0, name
        assert read[name]["parent"] == "MODDOWN"
    assert read["MODDOWN"]["self_device_ns"] >= 0
    assert read["MULTEVK"]["parent"] == spans.KEYSWITCH
    assert read[spans.KEYSWITCH]["self_device_ns"] >= 0
    assert read[spans.DISPATCH]["count"] == 3 and read[spans.DISPATCH]["device_count"] == 0


def test_untraced_replay_holds_no_marks(cuda):
    """Tracing off, a replay launches the eager op's kernels and no mark;
    tracing on, the same kernels and the rotation's 13 marks (8, and the
    mod-down's 5 over its one special prime)."""
    from rfhe_tpu_torch.trace import spans
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx, (a, _) = _graph_ctx(cuda)
    ctx.rotate(a, 1), ctx.rotate(a, 1)
    off = _kernel_names(lambda: ctx.rotate(a, 1))
    with eager():
        plain = _kernel_names(lambda: ctx.rotate(a, 1))
    spans.enable(cuda)
    try:
        ctx.rotate(a, 1)
        on = _kernel_names(lambda: ctx.rotate(a, 1))
    finally:
        spans.disable()
    assert off == plain and not any("rfhe_span_mark" in k for k in off)
    assert sum("rfhe_span_mark" in k for k in on) == 13
    assert [k for k in on if "rfhe_span_mark" not in k] == off


@pytest.mark.parametrize("op", ["rotate_rows", "multiply_relin"])
def test_traced_protected_op_equals_untraced(cuda, op):
    """A protected BGV op traced on the card (an eager run and capture, three
    replays) gives the untraced graph's arrays and flags bit for bit; each
    detector phase adds its time on the card, the mod-down's once per
    special prime; the untraced graph launches the eager op's kernels and no
    mark, and serves again once tracing is off."""
    import numpy as np
    from rfhe_tpu_torch.fhe import BgvContext, BgvParams
    from rfhe_tpu_torch.fhe.protected import ProtectedBgv
    from rfhe_tpu_torch.trace import spans
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx = BgvContext(BgvParams.make(n=1024, levels=3), seed=11, dnum=2, device=cuda)
    pb = ProtectedBgv(ctx)
    ct = ctx.encrypt(ctx.encode(np.random.default_rng(1).integers(0, ctx.t, (2, 512))))
    run = {"rotate_rows": lambda: pb.rotate_rows(ct, 1),
           "multiply_relin": lambda: pb.multiply_relin(ct, ct)}[op]

    def same(a, b):
        (x, fx), (y, fy) = a, b
        return (all(torch.equal(p.data, q.data) for p, q in zip(x.c, y.c))
                and list(fx) == list(fy) and all(torch.equal(fx[k], fy[k]) for k in fx))

    want = [run() for _ in range(3)][-1]
    off = _kernel_names(run)
    with eager():
        plain = _kernel_names(run)
    assert off == plain and not any("rfhe_span_mark" in k for k in off)
    spans.enable(cuda)
    try:
        snap = spans.snapshot()
        got = [run() for _ in range(4)]      # eager run and capture, 3 replays
        read = spans.since(snap)
    finally:
        spans.disable()
    assert all(same(g, want) for g in got) and same(run(), want)
    specials = len(ctx.ctx.moduli) - ctx.L
    checks = [c for c in spans.CHECK_PHASES if op == "rotate_rows" or c != "CHK_PERMUTE"]
    for name in checks + [spans.KEYSWITCH, "MULTEVK", "MODDOWN"]:
        per = specials if name.startswith("CHK_MD_") else 1
        assert read[name]["device_count"] == 4 * per and read[name]["device_ns"] > 0, name
    for name in spans.MODDOWN_PHASES:
        assert read[name]["device_count"] == 4 * specials and read[name]["parent"] == "MODDOWN"
    assert read[spans.KEYSWITCH]["self_device_ns"] >= 0 and read["MODDOWN"]["self_device_ns"] >= 0


def test_copy_counter_equals_the_shapes(cuda):
    """A replay counts the argument tensors it copies in and the outputs it
    clones, with their bytes as their shapes give them; an op under eager()
    on the card is counted as such."""
    from rfhe_tpu_torch.trace import spans
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx, (a, b) = _graph_ctx(cuda)
    ctx.rotate(a, 1), ctx.add(a, b)
    snap = spans.COUNTS.snapshot()
    ctx.rotate(a, 1), ctx.add(a, b)
    with eager():
        ctx.add(a, b)
    poly = a.c[0].data.numel() * 8                     # one component, int64
    assert spans.COUNTS.since(snap) == {
        "replays": 2, "captures": 0, "copies_in": 2 + 4, "copy_in_bytes": (2 + 4) * poly,
        "clones_out": 2 + 2, "clone_out_bytes": (2 + 2) * poly, "eager_on_card": 1,
        "detector_flags": 0}


# ---------------------------------------------------------------------------
# MULTEVK's kernel (csrc/ntt.cu:rfhe_ks_mac_kernel, fhe/keys.py:multevk)
# ---------------------------------------------------------------------------

_CKKS_BITS = [30] + [28] * 20          # bsgs's chain: 21 ciphertext primes
# (ring, prime bit sizes, ciphertext limbs, dnum, level, targets, cut key, worst words)
_MAC_CASES = {
    "bsgs top level": (65536, _CKKS_BITS + [30], 21, None, 20, None, False, False),
    "lower level": (65536, _CKKS_BITS + [30], 21, None, 9, None, False, False),
    "dnum=3": (65536, _CKKS_BITS + [30] * 7, 21, 3, 20, None, False, False),
    "BGV": (16384, [30] * 10 + [31], 10, None, 9, None, False, False),
    "key cut to limbs": (65536, _CKKS_BITS + [30], 21, None, 20, list(range(11, 21)), True, False),
    "worst words": (65536, _CKKS_BITS + [30], 21, None, 20, None, False, True),
}


@pytest.mark.parametrize("case", list(_MAC_CASES))
def test_ks_mac_matches_plain(cuda, case):
    """One launch of the MAC kernel equals the plain version bit for bit:
    bsgs's 21 digits x 22 rows at N=65536, a lower level (the row table
    gathers the special row), dnum=3, BGV's 10 x 11 at N=16384, a key cut to
    some limbs as a rank of the sharded evaluator holds it, and the worst
    words (every key word q - 1, every digit word 2^32 - 1)."""
    from rfhe_tpu_torch.fhe.keys import KeySwitchKey, digit_basis, multevk, multevk_plain
    from rfhe_tpu_torch.fhe.params import make_prime_chain
    from rfhe_tpu_torch.fhe.rns import RnsContext
    n, bits, L, dnum, level, targets, cut, worst = _MAC_CASES[case]
    ctx = RnsContext.make(n, make_prime_chain(n, bits), cuda)
    _, used, lim = digit_basis(level, ctx, L, dnum, targets)
    q = ctx.plan.q_arr[None, :, None]
    shape = (L if dnum is None else dnum, ctx.L, n)
    g = torch.Generator(device=cuda).manual_seed(n + len(lim))
    if worst:
        ksk = KeySwitchKey(b=(q - 1).expand(shape).contiguous(), a=(q - 2).expand(shape).contiguous())
        dig = torch.full((len(used), len(lim), n), (1 << 32) - 1, device=cuda)
    else:
        key = lambda: torch.randint(0, 1 << 62, shape, device=cuda, generator=g) % q
        ksk = KeySwitchKey(b=key(), a=key())
        dig = torch.randint(0, 1 << 32, (len(used), len(lim), n), device=cuda, generator=g)
    if cut:
        ksk = ksk.cut(targets + list(range(L, ctx.L)))
    before = ntt_cuda.KERNELS.snapshot()
    got = multevk(dig, ksk, used, lim, ctx)
    assert ntt_cuda.KERNELS.since(before)["ks_mac"] == {(len(used), len(lim), n): 1}
    assert torch.equal(got, multevk_plain(dig, ksk, used, lim, ctx))


def test_ks_mac_counts_one_launch_per_rotation_replay(cuda):
    """A graphed N=65536 rotation launches the MAC kernel once: the first
    call's eager warm-up counts one, its capture none, and every replay adds
    exactly one, as the eager op does; the MAC is counted in `ks_mac` only,
    never by shape beside the transforms."""
    import numpy as np
    from rfhe_tpu_torch.fhe import CkksContext, CkksParams
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx = CkksContext(CkksParams.make(n=65536, levels=3), seed=5, device=cuda)
    ct = ctx.encrypt(*ctx.encode(np.random.default_rng(5).uniform(-1, 1, 32768) + 0j))
    ctx.galois_key(ctx.rotation_galois_element(1))
    k = ntt_cuda.KERNELS
    before = k.snapshot()
    with eager():
        want = ctx.rotate(ct, 1)
    counts = k.since(before)
    assert sum(counts["ks_mac"].values()) == 1
    assert all(s[0] in ntt_cuda.FORMS for s in counts["by_shape"])
    for _ in range(3):                      # capture, then two replays
        before = k.snapshot()
        got = ctx.rotate(ct, 1)
        assert k.since(before) == counts
        assert all(torch.equal(x.data, y.data) for x, y in zip(got.c, want.c))
    (jit,) = [j for key, j in ctx._jits.items() if key[0] == "galois"]
    assert len(jit.graphs) == 1 and jit.graphs[0].replays == 2


_FAULTS = [None] + [(s, 9) for s in ("c1_perm", "intt_out", "digits", "digits_ntt", "prod0",
                                      "acc0", "ks_out")] + [("digits_ntt", 31), ("prod0", 31)]


@pytest.mark.parametrize("where", _FAULTS, ids=[str(f) for f in _FAULTS])
def test_protected_multevk_matches_cpu(cuda, where):
    """ProtectedBgv's rotate_rows and multiply_relin at n=1024 (dnum=2)
    under each fault stage: the card's arrays and flags equal a CPU run's,
    and MULTEVK is one MAC launch an op.  Bit 31 puts a digit word (or
    digit 0's b product) at or above q: the kernel's words stay exact
    below 2^32."""
    import numpy as np
    from rfhe_tpu_torch.fhe import BgvContext, BgvParams
    from rfhe_tpu_torch.fhe.protected import Fault, ProtectedBgv
    fault = None if where is None else Fault(where[0], 1, 17, where[1])
    runs = []
    for dev in (cuda, "cpu"):
        ctx = BgvContext(BgvParams.make(n=1024, levels=3), seed=11, dnum=2, device=dev)
        prot = ProtectedBgv(ctx)
        ct = ctx.encrypt(ctx.encode(np.random.default_rng(1).integers(0, ctx.t, (2, 512))))
        run = []
        for op in (lambda: prot.rotate_rows(ct, 1, fault),
                   lambda: prot.multiply_relin(ct, ct, fault)):
            before = ntt_cuda.KERNELS.snapshot()
            out, flags = op()
            if dev == cuda:
                assert sum(ntt_cuda.KERNELS.since(before)["ks_mac"].values()) == 1
            run.append(([c.data.cpu() for c in out.c], {k: v.cpu() for k, v in flags.items()}))
        runs.append(run)
    for (a, fa), (b, fb) in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert list(fa) == list(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def test_ks_mac_counts_one_launch_per_protected_rotation_replay(cuda):
    """A graphed protected rotate_rows at N=16384 over 10 + 1 primes
    launches the MAC kernel once: the first call's eager warm-up counts one,
    its capture none, and each of two replays adds exactly one and gives the
    eager op's arrays and flags."""
    import numpy as np
    from rfhe_tpu_torch.fhe import BgvContext, BgvParams
    from rfhe_tpu_torch.fhe.protected import ProtectedBgv
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx = BgvContext(BgvParams.make(n=16384, levels=9, q_bits=30, t_bits=20), seed=11,
                     device=cuda)
    prot = ProtectedBgv(ctx)
    ct = ctx.encrypt(ctx.encode(np.random.default_rng(11).integers(0, ctx.t, (2, 8192))))
    k = ntt_cuda.KERNELS
    with eager():
        want = prot.rotate_rows(ct, 1)
    for _ in range(3):                      # capture, then two replays
        before = k.snapshot()
        got = prot.rotate_rows(ct, 1)
        assert k.since(before)["ks_mac"] == {(10, 11, 16384): 1}
        assert all(torch.equal(x.data, y.data) for x, y in zip(got[0].c, want[0].c))
        assert list(got[1]) == list(want[1])
        assert all(torch.equal(got[1][f], want[1][f]) for f in want[1])
    (jit,) = prot._jits.values()
    assert len(jit.graphs) == 1 and jit.graphs[0].replays == 2


# ---------------------------------------------------------------------------
# MODDOWN's kernels (csrc/ntt.cu:rfhe_md_lift_kernel, rfhe_md_scale_kernel;
# fhe/rns.py:moddown_lift, moddown_scale)
# ---------------------------------------------------------------------------

_BGV_T = 786433
# (ring, prime bit sizes, dropped modulus, kept moduli, batched, t)
_MD_CASES = {
    **{f"dnum=3 nk={21 + k}": (65536, _CKKS_BITS + [30] * 7, 21 + k, list(range(21 + k)), True,
                               None) for k in range(6, -1, -1)},
    "per-limb": (65536, _CKKS_BITS + [30], 21, list(range(21)), True, None),
    "rescale": (65536, _CKKS_BITS + [30], 20, list(range(20)), False, None),
    "BGV keyswitch": (16384, [30] * 10 + [31], 10, list(range(10)), True, _BGV_T),
    "BGV mod_switch_to_next": (16384, [30] * 10 + [31], 9, list(range(9)), True, _BGV_T),
}


def _md_inputs(ctx, src_k, keep, batched, cuda):
    """Canonical NTT-domain rows for `keep` then src_k, the dropped row's
    coefficients ck with the edge words 0, q_src//2, q_src//2 + 1, q_src − 1
    first, and a δ̂ whose first words pair 0 and q_i − 1 with the kept
    rows' 0 and q_i − 1."""
    from rfhe_tpu_torch.fhe import rns
    nk, n = len(keep), ctx.n
    q = ctx.plan.q_arr[keep + [src_k]][:, None]
    g = torch.Generator(device=cuda).manual_seed(n + nk)
    shape = ((2,) if batched else ()) + (nk + 1, n)
    data = torch.randint(0, 1 << 62, shape, device=cuda, generator=g) % q
    zero = torch.zeros_like(q)
    data[..., :4] = torch.cat([zero, zero, q - 1, q - 1], dim=1)
    ck = rns.limb_plan(ctx, src_k).inv(data[..., nk:nk + 1, :].contiguous())[..., 0, :]
    q_src = ctx.moduli[src_k]
    ck[..., :4] = torch.tensor([0, q_src // 2, q_src // 2 + 1, q_src - 1], device=cuda)
    dnt = torch.randint(0, 1 << 62, shape[:-2] + (nk, n), device=cuda, generator=g) % q[:nk]
    dnt[..., :4] = torch.cat([zero, q - 1, zero, q - 1], dim=1)[:nk]
    return data, ck, dnt


def _drop_limb_plain(data, src_k, keep, ctx, t):
    """`drop_limb` composed of the plain versions on the card (its NTTs the
    kernels, which the tests above hold)."""
    from rfhe_tpu_torch.fhe import rns
    from rfhe_tpu_torch.ops.modarith import sub_mod
    nk = len(keep)
    ck = rns.limb_plan(ctx, src_k).inv(data[..., nk:nk + 1, :].contiguous())[..., 0, :]
    delta = rns.lift_to_limbs(ck, src_k, keep, ctx, centered=True)
    if t is not None:
        shift = rns.bgv_lift_shift(rns.bgv_lift_residue(ck, ctx.moduli[src_k], t), src_k, keep,
                                   t, ctx)
        delta = sub_mod(delta, shift, ctx.plan.tables.q[ctx.index(keep)][:, None])
    return rns.moddown_scale_plain(data[..., :nk, :], ctx.plan.take(keep).fwd(delta), src_k,
                                   keep, ctx)


@pytest.mark.parametrize("case", list(_MD_CASES))
def test_moddown_kernels_match_plain(cuda, case):
    """One launch of each MODDOWN kernel equals its plain version bit for
    bit: the seven dnum=3 `drop_limb`s (2, 27 ... 21, 65536), the per-limb
    (2, 21, 65536), the batchless `rescale` (20 kept of 21), BGV's keyswitch
    (31-bit special above 30-bit limbs) and `mod_switch_to_next` at
    N=16384; kept read through the strided view data[..., :nk, :]; the edge
    words of `_md_inputs`, q_src above and below q_i (q0 and the specials
    are 30 bits, the other limbs 28).  The whole `drop_limb`, BGV's t-shift
    between the kernels included, equals the plain composition."""
    from rfhe_tpu_torch.fhe import rns
    from rfhe_tpu_torch.fhe.params import make_prime_chain
    n, bits, src_k, keep, batched, t = _MD_CASES[case]
    ctx = rns.RnsContext.make(n, make_prime_chain(n, bits), cuda)
    nk = len(keep)
    data, ck, dnt = _md_inputs(ctx, src_k, keep, batched, cuda)
    kept = data[..., :nk, :]
    assert kept.stride()[-2:] == (n, 1) and kept.is_contiguous() != batched
    before = ntt_cuda.KERNELS.snapshot()
    delta = rns.moddown_lift(ck, src_k, keep, ctx)
    scaled = rns.moddown_scale(kept, dnt, src_k, keep, ctx)
    counts = ntt_cuda.KERNELS.since(before)
    shape = (2 if batched else 1, nk, n)
    assert counts["md_lift"] == {shape: 1} and counts["md_scale"] == {shape: 1}
    assert torch.equal(delta, rns.lift_to_limbs(ck, src_k, keep, ctx, centered=True))
    assert torch.equal(scaled, rns.moddown_scale_plain(kept, dnt, src_k, keep, ctx))
    assert torch.equal(rns.drop_limb(data, src_k, keep, ctx, t),
                       _drop_limb_plain(data, src_k, keep, ctx, t))


def test_moddown_kernels_read_any_even_strides(cuda):
    """ck rows and kept rows at other batch and limb strides (a slice of a
    wider tensor, every other limb) give the plain words."""
    from rfhe_tpu_torch.fhe import rns
    from rfhe_tpu_torch.fhe.params import make_prime_chain
    n, keep, src_k = 16384, [0, 1, 2, 3], 4
    ctx = rns.RnsContext.make(n, make_prime_chain(n, [28, 30, 28, 30, 30]), cuda)
    data, ck, dnt = _md_inputs(ctx, src_k, keep, True, cuda)
    wide = torch.zeros((2, 3, 2 * len(keep), n), dtype=torch.int64, device=cuda)
    wide[:, 1, ::2] = data[:, :4]
    kept = wide[:, 1, ::2]
    rows = torch.zeros((2, 3, n), dtype=torch.int64, device=cuda)
    rows[:, 2] = ck
    assert kept.stride() == (6 * len(keep) * n, 2 * n, 1) and rows[:, 2].stride() == (3 * n, 1)
    assert torch.equal(rns.moddown_lift(rows[:, 2], src_k, keep, ctx),
                       rns.lift_to_limbs(ck, src_k, keep, ctx, centered=True))
    assert torch.equal(rns.moddown_scale(kept, dnt, src_k, keep, ctx),
                       rns.moddown_scale_plain(data[:, :4], dnt, src_k, keep, ctx))


def test_moddown_wrappers_refuse(cuda):
    """The bindings raise on CPU tensors, the wrong dtype, a pointer off a
    16-byte boundary, a non-contiguous δ̂, a table of the wrong length and
    odd strides, before anything launches."""
    from rfhe_tpu_torch.fhe import rns
    from rfhe_tpu_torch.fhe.params import make_prime_chain
    n, keep, src_k = 16384, [0, 1, 2], 3
    ctx = rns.RnsContext.make(n, make_prime_chain(n, [30] * 4), cuda)
    data, ck, dnt = _md_inputs(ctx, src_k, keep, True, cuda)
    table, kept = rns._md_table(ctx, src_k, keep), data[:, :3]
    before = ntt_cuda.KERNELS.snapshot()
    bad_lift = [(ck.cpu(), table), (ck, table.cpu()), (ck.to(torch.int32), table),
                (ck.reshape(-1)[1:1 + n], table), (ck, table[1:]), (ck[:, :-1], table),
                (ck.as_strided((2, n - 2), (n - 1, 1)), table)]
    for args in bad_lift:
        with pytest.raises(ValueError):
            ntt_cuda.md_lift(*args, len(keep))
    bad_scale = [(kept.cpu(), dnt.cpu(), table.cpu()), (kept, dnt.to(torch.int32), table),
                 (kept, dnt.transpose(0, 1).contiguous().transpose(0, 1), table),
                 (kept, dnt, table[:-1]), (kept, dnt[:, :2], table),
                 (data.reshape(-1)[1:1 + kept.numel()].view(kept.shape), dnt, table)]
    for args in bad_scale:
        with pytest.raises(ValueError):
            ntt_cuda.md_scale(*args)
    after = ntt_cuda.KERNELS.since(before)
    assert not after["md_lift"] and not after["md_scale"]


def test_moddown_kernels_count_seven_per_dnum3_rotation_replay(cuda):
    """A graphed dnum=3 rotation at N=65536 (21 limbs, 7 special primes)
    launches each MODDOWN kernel 7 times, once per `drop_limb` at (2, 27 ...
    21, n): the eager warm-up counts 7, its capture none, every replay 7."""
    import numpy as np
    from rfhe_tpu_torch.fhe import CkksContext, CkksParams
    from rfhe_tpu_torch.utils.jitcache import eager
    ctx = CkksContext(CkksParams.make(n=65536, levels=20, q0_bits=30, scale_bits=28), seed=5,
                      dnum=3, device=cuda)
    ct = ctx.encrypt(*ctx.encode(np.random.default_rng(5).uniform(-1, 1, 32768) + 0j))
    ctx.galois_key(ctx.rotation_galois_element(1))
    k = ntt_cuda.KERNELS
    want_counts = {(2, nk, 65536): 1 for nk in range(21, 28)}
    before = k.snapshot()
    with eager():
        want = ctx.rotate(ct, 1)
    counts = k.since(before)
    assert counts["md_lift"] == want_counts and counts["md_scale"] == want_counts
    for _ in range(3):                      # capture, then two replays
        before = k.snapshot()
        got = ctx.rotate(ct, 1)
        assert k.since(before) == counts
        assert all(torch.equal(x.data, y.data) for x, y in zip(got.c, want.c))
    (jit,) = [j for key, j in ctx._jits.items() if key[0] == "galois"]
    assert len(jit.graphs) == 1 and jit.graphs[0].replays == 2
