"""The comparison that decides `correct` fails where it must: the control
(the configuration's lower precision) and a timed path broken underneath,
once for each fault a cell can have.  At the tiny ring of `tiny.py`, on the
CPU: the harness's look for a card is skipped, the rest of a run is driven;
`tiny.BFV_CELL` stands for a BFV cell.  The chip runs the control at the
cells' own sizes with `benchmark/control.py`."""
import pytest
import torch

from benchmark.tests import tiny
from rfhe_tpu_torch.fhe.bfv import BehzPlan, BfvContext
from rfhe_tpu_torch.fhe.bgv import BgvContext
from rfhe_tpu_torch.fhe.ckks import Ciphertext, CkksContext
from rfhe_tpu_torch.fhe.rns import RnsPoly
from rfhe_tpu_torch.ops.baseconv import base_conv


def _scheme(name: str) -> str:
    return tiny.parts(name)[1]["deployment"]["scheme"]


CKKS = [c for c in tiny.CELLS if _scheme(c) == "ckks"]
INTEGER = [c for c in tiny.CELLS if _scheme(c) != "ckks"] + [tiny.BFV_CELL]
CONTEXTS = {"ckks": CkksContext, "bgv": BgvContext, "bfv": BfvContext}


@pytest.mark.parametrize("name", CKKS)
def test_ckks_control_reads_far_above_the_program(name):
    seeds = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
    sound = max(tiny.run(name, s)[2]["slot_err"][0] for s in seeds)
    low = min(tiny.run(name, s, control=True)[2]["slot_err"][0] for s in seeds)
    assert low > 3 * sound


@pytest.mark.parametrize("name", INTEGER)
def test_bgv_control_is_not_correct(name):
    correct, failed, checks, _ = tiny.run(name, control=True)
    assert not correct and checks["slot_mismatch"][0] > 0


def _same(ct):
    return ct


def _flip(ct: Ciphertext) -> Ciphertext:
    """One word of the output altered where it is produced."""
    c0 = ct.c[0].data.clone()
    c0[-1, 3] ^= 1 << 5
    return Ciphertext([RnsPoly(c0, True), ct.c[1]], ct.scale, ct.correction)


def _every_other(add):
    """Half of the terms of every sum left out."""
    calls = [0]

    def half(self, a, b):
        calls[0] += 1
        return a if calls[0] % 2 else add(self, a, b)
    return half


FAULTS = {
    "ckks": {
        "state_unchanged": ("rotate", lambda f: lambda self, ct, r: ct),
        "half_left_out": ("add", _every_other),
        "answer_altered": ("rescale", lambda f: lambda self, ct: _flip(f(self, ct))),
    },
    "bgv": {
        "state_unchanged": ("rotate_rows", lambda f: lambda self, ct, r: ct),
        "half_left_out": ("add", _every_other),
        "answer_altered": ("mod_switch_to_next", lambda f: lambda self, ct: _flip(f(self, ct))),
    },
    "bfv": {
        "state_unchanged": ("multiply_relin", lambda f: lambda self, a, b: a),
        "half_left_out": ("multiply_relin", _every_other),
        "answer_altered": ("multiply_relin", lambda f: lambda self, a, b: _flip(f(self, a, b))),
    },
}


@pytest.mark.parametrize("name,fault", [(c, f) for c in [*tiny.CELLS, tiny.BFV_CELL]
                                        for f in FAULTS["ckks"]])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    scheme = _scheme(name)
    cls = CONTEXTS[scheme]
    method, breaker = FAULTS[scheme][fault]
    if name.endswith("chanmix_c64") and fault == "state_unchanged":
        method, breaker = "multiply_plain", lambda f: lambda self, ct, pt, s: ct
    if name.endswith("dotprod_protected") and fault == "state_unchanged":
        # the protected cell rotates through ProtectedBgv: its galois op returns its input
        from rfhe_tpu_torch.fhe.protected import ProtectedBgv
        cls, method = ProtectedBgv, "apply_galois"
        breaker = lambda f: lambda self, ct, g, fault=None: (ct, {"x": torch.tensor(True)})
    monkeypatch.setattr(cls, method, breaker(getattr(cls, method)))
    correct, failed, checks, _ = tiny.run(name)
    assert not correct, checks


def _conv_sk_without_alpha(self, w):
    """`BehzPlan.conv_sk` with its m_sk correction (α·B) left out."""
    conv = base_conv(w[..., :-1, :] * self.bhat_inv % self.bsk_col[:-1], self.conv_b_to_qmsk)
    return conv[..., :-1, :].contiguous()


def test_a_broken_bfv_path_is_not_correct(monkeypatch):
    monkeypatch.setattr(BehzPlan, "conv_sk", _conv_sk_without_alpha)
    correct, failed, checks, _ = tiny.run(tiny.BFV_CELL)
    assert not correct and checks["slot_mismatch"][0] > 0, checks
