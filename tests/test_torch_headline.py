"""bench/headline.py against the repository's bench.py: the same rotation,
bit for bit, at a small ring (n=1024, 3 + 1 ciphertext primes, seed 7, z
from default_rng(0)); bench.py's keys plus the card; the gate that refuses
to report a rotation that does not decrypt, and the refusal to run without
a card.  The reference's rotation goes through its jitted public op (one
compile); its context is built once for the module."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from rfhe_tpu.fhe import CkksContext as RefContext, CkksParams as RefParams
from rfhe_tpu_torch.bench import headline
from rfhe_tpu_torch.fhe import CkksContext

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, LEVELS, ITERS = 1024, 3, 2


def _bench_keys() -> set:
    """The keys of the dict bench.py's rotation_bench returns (read from its
    source: running it takes the full-size rotation)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "rotation_bench")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


@pytest.fixture(scope="module")
def reference():
    rc = RefContext(RefParams.make(n=N, levels=LEVELS, q0_bits=30, scale_bits=28), seed=7)
    z = np.random.default_rng(0).uniform(-1, 1, N // 2) + 0j
    ct = rc.encrypt(*rc.encode(z))
    return [np.asarray(p.data) for p in rc.rotate(ct, 1).c]


def test_rotation_equals_reference(reference, monkeypatch):
    rotated = []
    real = CkksContext.rotate

    def rotate(self, ct, r):
        rotated.append(real(self, ct, r))
        return rotated[-1]

    monkeypatch.setattr(CkksContext, "rotate", rotate)
    out = headline.rotation_bench(n=N, levels=LEVELS, iters=ITERS, device="cpu")
    assert len(rotated) == 1 + ITERS
    for ct in rotated:
        got = ct.to_numpy()
        assert len(got) == len(reference)
        for a, b in zip(got, reference):
            np.testing.assert_array_equal(a, b)
    assert set(out) == _bench_keys() | {"card"}
    assert out["metric"] == f"cpu_ckks_rotation_n{N}_L{LEVELS + 1}_latency"
    assert out["unit"] == "us" and out["card"] == "cpu" and out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(headline.BASELINE_ROTATION_US / out["value"],
                                               abs=0.01)


def test_wrong_rotation_refuses_to_report(monkeypatch, capsys):
    """main at bench.py's size: a rotation by 2 where 1 was asked decrypts
    cleanly to the wrong slots, so the gate raises and nothing is printed."""
    real = CkksContext.rotate
    monkeypatch.setattr(CkksContext, "rotate", lambda self, ct, r: real(self, ct, r + 1))
    with pytest.raises(RuntimeError, match="refusing to report"):
        headline.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_no_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        headline.main(["--device", "cuda"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""
