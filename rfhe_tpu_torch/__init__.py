"""rfhe_tpu_torch: the PyTorch/CUDA port of rfhe_tpu.

The JAX package `rfhe_tpu` is the reference; every array this package
produces is held bit-exact against it (tests/test_torch_*.py).  Residues are
int64 tensors on an explicit device; the NTT runs through hand-written CUDA
kernels on a GPU (ops/ntt_cuda.py, csrc/ntt.cu) and through their plain
PyTorch versions on the CPU (ops/ntt.py).

Layer map:
  numth      host-side number theory (primes, roots, Shoup/CRT constants)
  device     numpy uint32 <-> int64 tensor boundary, device checks
  ops        modular arithmetic, NTT plan + CUDA kernels, CRT to 64-bit words,
             RNS base conversion
  fhe        CKKS, BGV and BFV: parameters, RNS polynomials, keys, evaluators,
             the protected evaluators, serialization
  models     the encrypted dot product

This package imports torch and numpy, never jax.
"""
__version__ = "0.1.0"
