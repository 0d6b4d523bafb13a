"""entry.py against the repository's __graft_entry__.py: the flagship step
(the protected four-step NTT of the (8, 4096) draw with its three
detectors) equals `jax.jit(fn)(*args)` bit for bit, flags included; the dry
run passes in one world of 4 gloo processes; without a card both refuse to
run on the card."""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from rfhe_tpu_torch import entry
from rfhe_tpu_torch.device import to_numpy_u32

torch.set_num_threads(1)


def test_flagship_step_equals_reference():
    ref_fn, (ref_x, ref_key) = graft.entry()
    y_ref, ok_ref = jax.jit(ref_fn)(ref_x, ref_key)
    fn, (x0, key) = entry.entry("cpu")
    np.testing.assert_array_equal(to_numpy_u32(x0), ref_x)
    np.testing.assert_array_equal(key, np.asarray(ref_key))
    y, ok = fn(x0, key)
    assert y.shape == x0.shape and y.device == x0.device
    np.testing.assert_array_equal(to_numpy_u32(y), np.asarray(y_ref))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert ok.all()


def test_dryrun_in_a_gloo_world_of_4(capsys):
    ranks = entry.dryrun_multichip(4, "cpu")
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert sorted(r["coord"] for r in ranks) == [(0, f) for f in range(4)]
    for r in ranks:
        assert r["mesh"] == {"limb": 1, "fft": 4} and r["x"] == (2, 256)
        assert r["protected"] == (True, True, True) and r["guard"] == [True, True]
        assert r["ckks_err"] < 5e-2
        assert not any(r["launches"].values())       # the CPU runs the plain versions
    assert "init_multihost=ok" in capsys.readouterr().out


@pytest.mark.parametrize("call", [lambda: entry.entry("cuda"),
                                  lambda: entry.dryrun_multichip(1, "cuda"),
                                  lambda: entry.main(["--device", "cuda"])])
def test_no_card_refuses(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        call()
    assert exc.value.code not in (0, None)
