"""The port's protected BGV evaluator against rfhe_tpu's with the parameters
of tests/test_protected.py (n=256, 4 primes of 28 bits, t_bits=14, seed 3;
dnum None and 2): clean rotate_rows and multiply_relin, and every fault stage
of tests/test_protected.py.  Output arrays, corrections and every flag array
(the t-aware mod-down's lift checksum among them) are compared with
tolerance 0.  The reference is called eagerly through `_galois_impl` and
`_mul_relin_impl` with its probes built once per module."""
import numpy as np
import pytest
import torch

from rfhe_tpu.fhe.bgv import BgvContext as RefBgv
from rfhe_tpu.fhe.params import BgvParams as RefParams
from rfhe_tpu.fhe.protected import Fault as RefFault, ProtectedBgv as RefProtected
from rfhe_tpu_torch.fhe import BgvContext, BgvParams
from rfhe_tpu_torch.fhe import keys as fhe_keys
from rfhe_tpu_torch.fhe.protected import Fault, ProtectedBgv, all_ok

torch.set_num_threads(1)

PARAMS = dict(n=256, levels=3, q_bits=28, t_bits=14)
ROTATE_STAGES = [("c1_perm", ("intt",)), ("intt_out", ("intt",)), ("digits", ("baseconv",)),
                 ("digits_ntt", ("ks_core",)), ("prod0", ("ks_core",)), ("acc0", ("ks_core",)),
                 ("ks_out", ())]
MULTIPLY_STAGES = [("digits_ntt", ("ks_core",)), ("acc0", ("ks_core",)), ("intt_out", ("intt",))]


class Pair:
    """A reference BGV context, its protected evaluator and probes, and the
    port's context of the same seed with its protected evaluator."""

    def __init__(self, dnum):
        self.rc = RefBgv(RefParams.make(**PARAMS), seed=3, dnum=dnum)
        self.rp = RefProtected(self.rc)
        z = np.random.default_rng(5).integers(0, self.rc.t, (2, PARAMS["n"] // 2), dtype=np.uint32)
        self.z = z
        self.ref_ct = self.rc.encrypt(self.rc.encode(z))
        self.lvl = self.ref_ct.level
        self.g = pow(5, 2, 2 * PARAMS["n"])              # rotate_rows(2)
        self.ksk = self.rc.galois_key(self.g)
        self.probe = self.rp._ks_probe(self.ksk, self.lvl, salt=self.g)
        self.perm = self.rp._perm_probe(self.g, self.lvl + 1)
        self.rlk_probe = self.rp._ks_probe(self.rc.rlk, self.lvl, salt=-1)
        self.tc = BgvContext(BgvParams.make(**PARAMS), seed=3, dnum=dnum, device="cpu")
        self.ct = self.tc.encrypt(self.tc.encode(z))
        self.tp = ProtectedBgv(self.tc)

    def ref_rotate(self, fault=None):
        return self.rp._galois_impl(self.ref_ct, self.ksk, self.g, self.lvl, fault,
                                    self.probe, self.perm)

    def ref_multiply(self, fault=None):
        c = [p.data for p in self.ref_ct.c]
        corr = self.ref_ct.correction ** 2 % self.rc.t
        return self.rp._mul_relin_impl(c, c, self.rc.rlk.b, self.rc.rlk.a, self.rlk_probe,
                                       self.lvl, 1.0, corr, fault)


_PAIRS = {}


@pytest.fixture(scope="module", params=[None, 2], ids=["dnum-None", "dnum-2"])
def pair(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = Pair(request.param)
    return _PAIRS[request.param]


def _same_op(port, ref):
    (out, flags), (r_out, r_flags) = port, ref
    assert out.correction == r_out.correction
    for c, rc in zip(out.c, r_out.c):
        np.testing.assert_array_equal(c.data.numpy(), np.asarray(rc.data).astype(np.int64))
    assert list(flags) == list(r_flags)
    for k in flags:
        np.testing.assert_array_equal(flags[k].numpy(), np.asarray(r_flags[k]), err_msg=k)


def _fired(flags):
    return sorted(k for k, v in flags.items() if not bool(torch.all(v)))


def test_ciphertext_matches_reference(pair):
    for a, b in zip(pair.ct.c, pair.ref_ct.c):
        np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data).astype(np.int64))


def test_rotate_rows_clean(pair):
    """The plain evaluator's arrays, every flag true (the t-aware lift
    checksum among them), and the rotated matrix on decryption."""
    out = pair.tp.rotate_rows(pair.ct, 2)
    _same_op(out, pair.ref_rotate())
    plain = pair.tc.rotate_rows(pair.ct, 2)
    assert all(torch.equal(a.data, b.data) for a, b in zip(out[0].c, plain.c))
    assert bool(all_ok(out[1])) and any(k.endswith("_lift") for k in out[1])
    np.testing.assert_array_equal(pair.tc.decrypt_decode(out[0]), np.roll(pair.z, -2, axis=1))


def test_multiply_relin_clean(pair):
    out = pair.tp.multiply_relin(pair.ct, pair.ct)
    _same_op(out, pair.ref_multiply())
    plain = pair.tc.multiply_relin(pair.ct, pair.ct)
    assert all(torch.equal(a.data, b.data) for a, b in zip(out[0].c, plain.c))
    assert out[0].correction == plain.correction
    assert bool(all_ok(out[1]))
    np.testing.assert_array_equal(pair.tc.decrypt_decode(out[0]),
                                  pair.z.astype(np.int64) ** 2 % pair.tc.t)


@pytest.mark.parametrize("stage, keys", ROTATE_STAGES, ids=[s for s, _ in ROTATE_STAGES])
def test_rotate_fault(pair, stage, keys):
    limb, idx, bit = (0, 3, 4) if stage == "ks_out" else (1, 17, 9)
    out = pair.tp.rotate_rows(pair.ct, 2, Fault(stage, limb, idx, bit))
    _same_op(out, pair.ref_rotate(RefFault(stage, limb, idx, bit)))
    fired = _fired(out[1])
    assert fired if keys else not fired, (stage, fired)
    assert set(keys) <= set(fired)


@pytest.mark.parametrize("stage, keys", MULTIPLY_STAGES, ids=[s for s, _ in MULTIPLY_STAGES])
def test_multiply_fault(pair, stage, keys):
    out = pair.tp.multiply_relin(pair.ct, pair.ct, Fault(stage, 0, 11, 7))
    _same_op(out, pair.ref_multiply(RefFault(stage, 0, 11, 7)))
    assert set(keys) <= set(_fired(out[1]))


@pytest.mark.parametrize("stage", [None] + [s for s, _ in ROTATE_STAGES])
def test_multevk_once_per_op(pair, stage, monkeypatch):
    """Every protected op's MULTEVK is one `keys.multevk` call (the MAC
    kernel on a card) under every fault stage, prod0 included."""
    calls = []
    real = fhe_keys.multevk
    monkeypatch.setattr(fhe_keys, "multevk", lambda *a: calls.append(a) or real(*a))
    fault = None if stage is None else Fault(stage, 1, 17, 9)
    pair.tp.rotate_rows(pair.ct, 2, fault)
    assert len(calls) == 1
    pair.tp.multiply_relin(pair.ct, pair.ct, fault)
    assert len(calls) == 2


def test_fault_bit_is_one_of_32():
    """A fault flips one of a 32-bit word's bits, as the reference's uint32
    words hold; a bit past them is refused where the fault is made."""
    assert Fault("digits_ntt", 0, 0, 31).bit == 31
    with pytest.raises(ValueError):
        Fault("digits_ntt", 0, 0, 32)
