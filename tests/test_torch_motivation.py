"""Port parity: rfhe_tpu_torch.models.motivation and rfhe_tpu_torch.oracle
against rfhe_tpu's, tolerance 0: every demo's dict, and the oracle copies."""
import random

import pytest
import torch

from rfhe_tpu import numth as ref_numth
from rfhe_tpu import oracle as ref_oracle
from rfhe_tpu.models import motivation as ref
from rfhe_tpu_torch import oracle
from rfhe_tpu_torch.models import motivation as port

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["ntt_smear", "fft_smear", "bsgs_block_smear", "baseconv_smear",
                                  "grouped_crt_check"])
def test_host_demos(name):
    assert getattr(port, name)() == getattr(ref, name)()


def test_host_demos_other_arguments():
    assert port.ntt_smear(n=64, qbits=17, noise_idx=0, seed=3) == ref.ntt_smear(64, 17, 0, 3)
    assert port.baseconv_smear(3, 14, 16, seed=2) == ref.baseconv_smear(3, 14, 16, seed=2)


def test_plaintext_perturb():
    """The port's BGV (n=256, t of 16 bits) on the CPU against the reference."""
    got = port.plaintext_perturb(device="cpu")
    assert got == ref.plaintext_perturb()
    assert got["disturbed"] == got["slots"]


def test_oracle_copies():
    n = 32
    q = ref_numth.find_ntt_prime(n, 20)
    psi = ref_numth.psi_negacyclic(n, q)
    w = ref_numth.root_of_unity(n, q)
    r = random.Random(1)
    a = [r.randrange(q) for _ in range(n)]
    assert oracle.ntt(a, w, q) == ref_oracle.ntt(a, w, q)
    assert oracle.intt(a, w, q) == ref_oracle.intt(a, w, q)
    assert oracle.negacyclic_ntt(a, psi, q) == ref_oracle.negacyclic_ntt(a, psi, q)
    assert oracle.negacyclic_intt(a, psi, q) == ref_oracle.negacyclic_intt(a, psi, q)
    moduli = ref_numth.generate_crt_primes(3, 14, random.Random(4))
    out = ref_numth.generate_crt_primes(2, 28, random.Random(5))
    res = [[r.randrange(p) for _ in range(8)] for p in moduli]
    for reduce_out in (True, False):
        assert oracle.base_conv(res, moduli, out, reduce_out) == \
            ref_oracle.base_conv(res, moduli, out, reduce_out)


def test_main_needs_a_card_or_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        port.main([])
    port.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["ntt_smear", "fft_smear", "bsgs_block_smear",
                                                    "baseconv_smear", "grouped_crt_check",
                                                    "plaintext_perturb"]
