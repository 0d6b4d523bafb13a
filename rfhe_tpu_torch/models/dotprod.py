"""Encrypted dot product by rotate-and-add folding (`rfhe_tpu/models/dotprod.py`):
the reference's end-to-end campaign workload, encode → encrypt →
multiply+relinearize(+mod switch or rescale) → a log-depth rotation tree →
decrypt."""
from __future__ import annotations

from ..fhe.bgv import BgvContext
from ..fhe.ckks import Ciphertext, CkksContext


def dot_product_ckks(ctx: CkksContext, ct_x: Ciphertext, ct_y: Ciphertext,
                     rescale: bool = True) -> Ciphertext:
    """Every slot of the result holds <x, y> over the n/2 complex slots."""
    prod = ctx.multiply_relin(ct_x, ct_y)
    if rescale:
        prod = ctx.rescale(prod)
    step = 1
    while step < ctx.params.n // 2:
        prod = ctx.add(prod, ctx.rotate(prod, step))
        step <<= 1
    return prod


def dot_product_bgv(ctx: BgvContext, ct_x: Ciphertext, ct_y: Ciphertext,
                    mod_switch: bool = True) -> Ciphertext:
    """Every slot holds Σ x_i·y_i mod t over the whole 2×(n/2) matrix:
    log2(n/2) row rotations, then one column rotation."""
    prod = ctx.multiply_relin(ct_x, ct_y)
    if mod_switch:
        prod = ctx.mod_switch_to_next(prod)
    step = 1
    while step < ctx.params.n // 2:
        prod = ctx.add(prod, ctx.rotate_rows(prod, step))
        step <<= 1
    return ctx.add(prod, ctx.rotate_columns(prod))
