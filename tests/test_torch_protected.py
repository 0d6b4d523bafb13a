"""The port's protected CKKS evaluator against rfhe_tpu's, with the parameters
of tests/test_protected.py (n=256, 3 levels, 25-bit scale, seed 3; dnum None
and 2): the digits with their checksum references, clean rotate and
multiply_relin, every fault stage of tests/test_protected.py, and flip
campaign rows.  Output arrays and every flag array are compared with
tolerance 0.  The reference is called eagerly through `_galois_impl` and
`_mul_relin_impl` with its probes built once per module, not through its
per-stage jit programs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu.fhe import keys as ref_keys
from rfhe_tpu.fhe.ckks import CkksContext as RefContext
from rfhe_tpu.fhe.params import CkksParams as RefParams
from rfhe_tpu.fhe.protected import Fault as RefFault, ProtectedCkks as RefProtected
from rfhe_tpu_torch.faults import evaluator_campaign as campaign
from rfhe_tpu_torch.fhe import Ciphertext, CkksContext, CkksParams
from rfhe_tpu_torch.fhe.keys import compute_digits
from rfhe_tpu_torch.fhe.protected import Fault, ProtectedCkks, all_ok

torch.set_num_threads(1)

PARAMS = dict(n=256, levels=3, scale_bits=25)
ROTATE_STAGES = [("c1_perm", ("intt",)), ("intt_out", ("intt",)), ("digits", ("baseconv",)),
                 ("digits_ntt", ("ks_core",)), ("prod0", ("ks_core",)), ("acc0", ("ks_core",)),
                 ("ks_out", ())]
MULTIPLY_STAGES = [("digits_ntt", ("ks_core",)), ("acc0", ("ks_core",)), ("intt_out", ("intt",))]


class Pair:
    """A reference context, its protected evaluator and probes, and the port's
    context with the same keys and ciphertext."""

    def __init__(self, dnum):
        self.dnum = dnum
        self.rc = RefContext(RefParams.make(**PARAMS), seed=3, dnum=dnum)
        self.rp = RefProtected(self.rc)
        z = np.random.default_rng(5).normal(size=128) + 1j * np.random.default_rng(6).normal(size=128)
        self.ref_ct = self.rc.encrypt(*self.rc.encode(z))
        self.lvl = self.ref_ct.level
        self.ksk, self.rlk = {}, self.rc.rlk
        self.probes, self.perm = {}, {}
        for r in (2,):
            g = self.rc.rotation_galois_element(r)
            self.ksk[r] = self.rc.galois_key(g)
            self.probes[r] = self.rp._ks_probe(self.ksk[r], self.lvl, salt=g)
            self.perm[r] = self.rp._perm_probe(g, self.lvl + 1)
        self.rlk_probe = self.rp._ks_probe(self.rlk, self.lvl, salt=-1)
        self.tc = CkksContext(CkksParams.make(**PARAMS), seed=3, dnum=dnum, device="cpu")
        state = {"sk_s_ntt": np.asarray(self.rc.sk.s_ntt), "sk_s_coeff": self.rc.sk.s_coeff,
                 "pk_b": np.asarray(self.rc.pk.b), "pk_a": np.asarray(self.rc.pk.a),
                 "rlk_b": np.asarray(self.rlk.b), "rlk_a": np.asarray(self.rlk.a)}
        for r, k in self.ksk.items():
            g = self.rc.rotation_galois_element(r)
            state[f"galois_{g}_b"], state[f"galois_{g}_a"] = np.asarray(k.b), np.asarray(k.a)
        self.tc.load_keys(state)
        self.tp = ProtectedCkks(self.tc)
        self.ct = Ciphertext.from_numpy([np.asarray(c.data) for c in self.ref_ct.c],
                                        self.ref_ct.scale, True, "cpu")

    def ref_rotate(self, r, fault=None):
        g = self.rc.rotation_galois_element(r)
        return self.rp._galois_impl(self.ref_ct, self.ksk[r], g, self.lvl, fault,
                                    self.probes[r], self.perm[r])

    def ref_multiply(self, fault=None):
        c = [p.data for p in self.ref_ct.c]
        sc = self.ref_ct.scale ** 2
        return self.rp._mul_relin_impl(c, c, self.rlk.b, self.rlk.a, self.rlk_probe, self.lvl,
                                       sc, 1, fault)


_PAIRS = {}


@pytest.fixture(scope="module", params=[None, 2], ids=["dnum-None", "dnum-2"])
def pair(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = Pair(request.param)
    return _PAIRS[request.param]


@pytest.fixture(scope="module")
def per_limb():
    if None not in _PAIRS:
        _PAIRS[None] = Pair(None)
    return _PAIRS[None]


def _same_op(port, ref):
    """Output arrays and every flag array identical, flags in the same order."""
    (out, flags), (r_out, r_flags) = port, ref
    for c, rc in zip(out.c, r_out.c):
        np.testing.assert_array_equal(c.data.numpy(), np.asarray(rc.data).astype(np.int64))
    assert list(flags) == list(r_flags)
    for k in flags:
        np.testing.assert_array_equal(flags[k].numpy(), np.asarray(r_flags[k]), err_msg=k)


def _fired(flags):
    return sorted(k for k, v in flags.items() if not bool(torch.all(v)))


def test_compute_digits_with_ecc(pair):
    """Digits and checksum references at full level and one level down, on a
    clean input and on one with a word flipped above q (a single-limb digit
    passes such a word through where the reference does)."""
    tc, rc = pair.tc, pair.rc
    d = tc.ctx.plan_at(pair.lvl).inv(pair.ct.c[1].data)
    bad = d.clone()
    bad[1, 17] ^= 1 << 29
    for lvl, x in ((pair.lvl, d), (pair.lvl, bad), (pair.lvl - 1, d[:pair.lvl].contiguous())):
        dig, used, lim, refs = compute_digits(x, lvl, tc.ctx, tc.L, tc.dnum, with_ecc=True)
        r_dig, r_used, r_lim, r_refs = ref_keys.compute_digits(
            jnp.asarray(x.numpy().astype(np.uint32)), lvl, rc.ctx, rc.L, rc.dnum, with_ecc=True)
        assert (used, lim) == (r_used, r_lim)
        np.testing.assert_array_equal(dig.numpy(), np.asarray(r_dig).astype(np.int64))
        np.testing.assert_array_equal(refs.numpy(), np.asarray(r_refs).astype(np.int64))
        plain = compute_digits(x, lvl, tc.ctx, tc.L, tc.dnum)
        assert torch.equal(plain[0], dig) and plain[1:] == (used, lim)


def test_rotate_clean(pair):
    out = pair.tp.rotate(pair.ct, 2)
    _same_op(out, pair.ref_rotate(2))
    plain = pair.tc.rotate(pair.ct, 2)
    assert all(torch.equal(a.data, b.data) for a, b in zip(out[0].c, plain.c))
    assert bool(all_ok(out[1]))


def test_multiply_relin_clean(pair):
    out = pair.tp.multiply_relin(pair.ct, pair.ct)
    _same_op(out, pair.ref_multiply())
    plain = pair.tc.multiply_relin(pair.ct, pair.ct)
    assert all(torch.equal(a.data, b.data) for a, b in zip(out[0].c, plain.c))
    assert bool(all_ok(out[1]))


@pytest.mark.parametrize("stage, keys", ROTATE_STAGES, ids=[s for s, _ in ROTATE_STAGES])
def test_rotate_fault(pair, stage, keys):
    """Each fault stage of tests/test_protected.py: the reference's arrays and
    flags, and the detector it expects (none for ks_out)."""
    limb, idx, bit = (0, 3, 4) if stage == "ks_out" else (1, 17, 9)
    out = pair.tp.rotate(pair.ct, 2, Fault(stage, limb, idx, bit))
    _same_op(out, pair.ref_rotate(2, RefFault(stage, limb, idx, bit)))
    fired = _fired(out[1])
    assert fired if keys else not fired, (stage, fired)
    assert set(keys) <= set(fired)


@pytest.mark.parametrize("stage, keys", MULTIPLY_STAGES, ids=[s for s, _ in MULTIPLY_STAGES])
def test_multiply_fault(pair, stage, keys):
    out = pair.tp.multiply_relin(pair.ct, pair.ct, Fault(stage, 0, 11, 7))
    _same_op(out, pair.ref_multiply(RefFault(stage, 0, 11, 7)))
    assert set(keys) <= set(_fired(out[1]))


@pytest.mark.parametrize("stage", ["intt_out", "acc0", "ks_out"])
def test_stage_campaign_rows(per_limb, stage):
    """The port's campaign row over 8 trials against the row the reference's
    `stage_campaign` builds from its calls on the same (limb, idx, bit)
    draws, with per-limb digits."""
    pair = per_limb
    trials, seed = 8, 1
    row = campaign.stage_campaign(pair.tp, pair.ct, 2, stage, trials, seed)
    campaign.check_row(row)
    clean, _ = pair.ref_rotate(2)
    changed, detected, by = [], [], {}
    for l, i, b in zip(*campaign.triples(pair.lvl, PARAMS["n"], trials, seed)):
        out, flags = pair.ref_rotate(2, RefFault(stage, int(l), int(i), int(b)))
        changed.append(any(not np.array_equal(np.asarray(o.data), np.asarray(c.data))
                           for o, c in zip(out.c, clean.c)))
        fired = [k for k, v in flags.items() if not bool(jnp.all(v))]
        detected.append(bool(fired))
        for k in fired:
            by[k] = by.get(k, 0) + 1
    n_changed, n_det = sum(changed), sum(detected)
    n_miss = sum(c and not d for c, d in zip(changed, detected))
    assert row == {"op": "rotate", "stage": stage, "trials": trials, "changed": n_changed,
                   "detected": n_det, "missed": n_miss,
                   "detect_rate": round(n_det / trials, 6),
                   "miss_rate": round(n_miss / max(1, n_changed), 6),
                   "top_detector": max(by, key=by.get) if by else "",
                   "detectors": "+".join(sorted(by))}


def test_checks_ablation(per_limb):
    """`checks=` keeps only the named detector families (their flags equal
    the full evaluator's), leaves the arrays alone, and refuses unknown
    names."""
    pair = per_limb
    full = pair.tp.rotate(pair.ct, 2, Fault("acc0", 1, 17, 9))
    part = ProtectedCkks(pair.tc, checks={"ks_core", "md_range"})
    out, flags = part.rotate(pair.ct, 2, Fault("acc0", 1, 17, 9))
    assert list(flags) == ["ks_core", "md_range"]
    for k in flags:
        assert torch.equal(flags[k], full[1][k])
    assert all(torch.equal(a.data, b.data) for a, b in zip(out.c, full[0].c))
    with pytest.raises(ValueError):
        ProtectedCkks(pair.tc, checks={"ks_core", "parity"})
