"""Scheme layer of the port: parameters, RNS polynomials, keys, the CKKS,
BGV and BFV evaluators, the protected evaluators and serialization."""
from .params import BfvParams, BgvParams, CkksParams, make_prime_chain  # noqa: F401
from .rns import RnsContext, RnsPoly, rescale, drop_limb  # noqa: F401
from .keys import KeyGen, SecretKey, PublicKey, KeySwitchKey, keyswitch  # noqa: F401
from .ckks import CkksContext, Ciphertext, encode, decode  # noqa: F401
from .bgv import BgvContext  # noqa: F401
from .bfv import BehzPlan, BfvContext, GammaDecryptPlan  # noqa: F401
