"""Monte-Carlo campaigns of protected Barrett and Montgomery reduction with
wide (37-bit) primes in multi-limb words, every trial at once.

Counterpart of `rfhe_tpu/faults/reduction_campaigns.py`, which runs each
campaign as `jax.jit(jax.vmap(trial))` over `split(PRNGKey(seed), trials)`.
Here a trial's body is written over a leading trial axis: the words are
(T, vec, limbs) int64 tensors (`ops/bigint.py`), a trial's fault choice is a
per-trial `torch.where`, and an element write is a scatter at distinct
indices.  Every draw uses the key the reference uses: the large ones (the
operands' words, the fault words, the permutations of `choice`) are made on
the campaign's device by `prng.random_bits_on` / `choice_on`, the small ones
on the host.  Each trial has its own key, so a campaign runs its trials in
chunks of `chunk` (by default about 2^22 working elements, `CHUNK_ELEMENTS`)
with the same counts; the result dicts equal the reference's.

  barrett_scheme_campaign  Barrett with fold ECC on t = x·mu and on s·p, and
                           the final range window; BF flips bits within a
                           value's bit length, MOF randomizes within it
  montgomery_campaign      REDC with fold ECC on m = T·m' and on m·p, and the
                           final (T + m·p) ≡ 0 mod R check
  barrett_final_campaign   Intra (2^s+1 fold of the products), Range
                           (windows inside Barrett) and Sum (Σ reduced ==
                           Σ products mod Q) under four fault models
  outer_check_campaign     intra and inter folds over 2^k + 1 on 64-bit
                           words, eight fault modes

As in the reference, `_uniform_below` reduces 2·bitlen(p) random bits with
one Barrett step that is exact only below p², so the "uniform" operands are
not below p (ROADMAP, caveats in the reference); the port gives the same words.

`timing`, a dict, if given, receives the seconds spent on host draws
('host_draw_s'), on device draws ('device_draw_s', the device waited for)
and in the whole campaign ('wall_s').
"""
from __future__ import annotations

import random as _random
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import prng
from ..numth import barrett_constants, find_prime_with_bitlen, next_prime_ge
from ..ops import bigint
from ..ops.modarith import mulhi32
from ..ops.modring import sum_mod
from ..protect.fold import mul32_parts

CHUNK_ELEMENTS = 1 << 22          # trials x vector elements per chunk, by default


def _limbs(bits: int) -> int:
    return -(-bits // 32)


class _Draws:
    """The campaign's draws on its device, each timed (the device waited
    for), into `timing` when the caller gave one."""

    def __init__(self, device: torch.device, timing: Optional[dict]):
        self.device = device
        self.timing = timing if timing is not None else {}
        for k in ("host_draw_s", "device_draw_s"):
            self.timing.setdefault(k, 0.0)

    def _timed(self, what: str, fn, *args):
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        if what == "host_draw_s":
            out = torch.from_numpy(np.asarray(out).astype(np.int64)).to(self.device)
        sync()
        self.timing[what] += time.perf_counter() - t0
        return out

    def bits(self, keys, shape) -> torch.Tensor:
        return self._timed("device_draw_s", prng.random_bits_on, keys, shape, self.device)

    def choice(self, keys, n: int, shape) -> torch.Tensor:
        return self._timed("device_draw_s", prng.choice_on, keys, n, shape, self.device)

    def host(self, fn, *args) -> torch.Tensor:
        """A small draw (randint, bernoulli) on the host, moved to the device."""
        return self._timed("host_draw_s", fn, *args)


def _uniform_below(dr: _Draws, keys, vec: int, p: int, limbs: int) -> torch.Tensor:
    """(T, vec, limbs): 2·bitlen(p) random bits per value, Barrett-reduced
    once (below p only where the bits are below p²)."""
    raw = dr.bits(keys, (vec, _limbs(2 * p.bit_length())))
    mu, k = barrett_constants(p)
    return bigint.barrett_reduce_big(raw, p, mu, k, limbs)


def _take(vals: torch.Tensor, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(elements idx of each trial's (vec, L) values, the gather index)."""
    gi = idx[..., None].expand(idx.shape + (vals.shape[-1],))
    return torch.gather(vals, 1, gi), gi


class _FlipDraws:
    """The draws of `_flip_bits_in_elements(key, ...)`: they depend on the key
    and the element count only, so the reference's two calls with one key (on
    t and on s·p) share them."""

    def __init__(self, dr: _Draws, keys, n: int, elem_count: int, bits_per_elem: int):
        k = prng.split(keys, 3)
        self.idx = dr.choice(k[:, 0], n, (elem_count,))
        self.r1 = dr.bits(k[:, 1], (elem_count,))
        self.r2 = dr.bits(k[:, 2], (elem_count,)) if bits_per_elem >= 2 else None

    def apply(self, vals: torch.Tensor) -> torch.Tensor:
        """Flip one (two distinct, with r2) bit positions within each chosen
        value's bit length: the positions by the mulhi trick."""
        chosen, gi = _take(vals, self.idx)
        bl = bigint.bit_length(chosen).clamp(min=1)
        b1 = mulhi32(self.r1, bl)
        out = bigint.xor_bit(chosen, b1)
        if self.r2 is not None:
            b2 = mulhi32(self.r2, (bl - 1).clamp(min=1))
            b2 = b2 + (b2 >= b1).long()
            out = torch.where((bl >= 2)[..., None], bigint.xor_bit(out, b2), out)
        return vals.scatter(1, gi, out)


class _MofDraws:
    """The draws of `_randomize_elements(key, ...)`: the chosen elements are
    shared by calls with one key, the words are drawn per value width."""

    def __init__(self, dr: _Draws, keys, n: int, elem_count: int):
        k = prng.split(keys)
        self.dr, self.k2 = dr, k[:, 1]
        self.idx = dr.choice(k[:, 0], n, (elem_count,))

    def apply(self, vals: torch.Tensor) -> torch.Tensor:
        """Replace the chosen values with random words of their bit length."""
        chosen, gi = _take(vals, self.idx)
        bl = bigint.bit_length(chosen).clamp(min=1)
        rnd = bigint.mask_to_bits(self.dr.bits(self.k2, tuple(chosen.shape[1:])), bl)
        return vals.scatter(1, gi, rnd)


def _chunks(trials: int, vec: int, chunk: Optional[int]):
    step = chunk if chunk is not None else max(1, CHUNK_ELEMENTS // vec)
    return [(c, min(trials, c + step)) for c in range(0, trials, step)]


def _run(trials: int, seed: int, nkeys: int, vec: int, chunk: Optional[int], device,
         timing: Optional[dict], body) -> tuple:
    """body(dr, ks) over the trial chunks, ks (Tc, nkeys, 2) the per-trial
    keys split as the reference splits them; its outputs (per-trial bool
    tensors) concatenated on the host."""
    t0 = time.perf_counter()
    dr = _Draws(torch.device(device), timing)
    ks = prng.split(prng.split(prng.PRNGKey(seed), trials), nkeys)
    outs = [tuple(o.cpu().numpy() for o in body(dr, ks[c0:c1]))
            for c0, c1 in _chunks(trials, vec, chunk)]
    dr.timing["wall_s"] = dr.timing.get("wall_s", 0.0) + time.perf_counter() - t0
    return tuple(np.concatenate(parts) for parts in zip(*outs))


def _fold_sum(v: torch.Tensor, w: int) -> torch.Tensor:
    """Σ over the vector of the values' folds mod 2^w − 1."""
    return sum_mod(bigint.fold_mod(v, w), (1 << w) - 1)


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-trial choice between (T, vec, L) values."""
    return torch.where(cond[:, None, None], a, b)


# ---------------------------------------------------------------------------
# Barrett scheme campaign (T-check / SN-check / final range)
# ---------------------------------------------------------------------------

def barrett_scheme_campaign(fold_width: int, scheme: Tuple[bool, bool, bool], trials: int,
                            pbits: int = 37, vec_len: int = 8192, elem_count: int = 1,
                            bits_per_elem: int = 1, seed: int = 42, fault: str = "BF",
                            device: str = "cuda", chunk: Optional[int] = None,
                            timing: Optional[dict] = None) -> Dict:
    """fault 'BF' flips bits_per_elem distinct bits in elem_count elements of
    t (or of s·p); 'MOF' randomizes them within their bit length
    (`rfhe_tpu.faults.reduction_campaigns.barrett_scheme_campaign`)."""
    use_t, use_sn, use_final = scheme
    p = find_prime_with_bitlen(pbits, _random.Random(seed))
    mu, k = barrett_constants(p)
    Lp, Lx, Lmu = _limbs(pbits), _limbs(2 * pbits), _limbs(mu.bit_length())
    Ls = max(_limbs(2 * pbits - 2 * k + Lmu * 32), Lp)
    Lsn = Ls + Lp
    dev = torch.device(device)
    mu_l, p_l = bigint.from_int(mu, Lmu, dev), bigint.from_int(p, Lp, dev)
    p_fit = bigint._fit(p_l, Lsn)
    p2_fit = bigint._fit(bigint.from_int(2 * p, Lx, dev), Lsn)
    one = bigint.from_int(1, Lsn, dev)

    def body(dr, ks):
        a = _uniform_below(dr, ks[:, 0], vec_len, p, Lp)
        b = _uniform_below(dr, ks[:, 1], vec_len, p, Lp)
        x = bigint.mul(a, b)
        t = bigint.mul(x, mu_l)
        sn = bigint.mul(bigint.shift_right(t, 2 * k, Ls), p_l)
        inject_t = dr.host(prng.bernoulli, ks[:, 2]).bool()
        if fault == "MOF":
            draws = _MofDraws(dr, ks[:, 3], vec_len, elem_count)
        else:
            draws = _FlipDraws(dr, ks[:, 3], vec_len, elem_count, bits_per_elem)
        t_used = _where(inject_t, draws.apply(t), t)
        sn_used = _where(inject_t, bigint.mul(bigint.shift_right(t_used, 2 * k, Ls), p_l),
                         draws.apply(sn))
        detected = torch.zeros_like(inject_t)
        if use_t:
            detected |= inject_t & (_fold_sum(t_used, fold_width) != _fold_sum(t, fold_width))
        if use_sn:
            detected |= _fold_sum(sn_used, fold_width) != _fold_sum(sn, fold_width)
        # final stage: c = x − s·p in the window [0, 2p), one conditional subtract
        c, borrow = bigint.sub(bigint._fit(x, Lsn), sn_used)
        if use_final:
            in_window = (borrow == 0) & bigint.cmp_ge(p2_fit, bigint.add(c, one))
            detected |= (~in_window).any(dim=-1)
        c_red = bigint.cond_sub_big(c, p_fit)
        c_ok = bigint.cond_sub_big(bigint.sub(bigint._fit(x, Lsn), bigint._fit(sn, Lsn))[0], p_fit)
        return (c_red != c_ok).any(dim=-1).any(dim=-1), detected

    harmful, detected = _run(trials, seed, 4, vec_len, chunk, device, timing, body)
    TP = int((harmful & detected).sum())
    FN = int((harmful & ~detected).sum())
    FP = int((~harmful & detected).sum())
    TN = int((~harmful & ~detected).sum())
    rate = TP / (TP + FN) if TP + FN else 1.0
    return {"detection_rate": rate, "TP": TP, "FP": FP, "TN": TN, "FN": FN, "p": p}


# ---------------------------------------------------------------------------
# Montgomery campaign
# ---------------------------------------------------------------------------

def montgomery_campaign(fold_width: int, scheme: Tuple[bool, bool, bool], trials: int,
                        pbits: int = 37, vec_len: int = 8192, flip_count: int = 2,
                        seed: int = 42, device: str = "cuda", chunk: Optional[int] = None,
                        timing: Optional[dict] = None) -> Dict:
    """REDC with R = 2^bitlen(p) and fold ECC on m = lowT·m' and on m·p, and
    the final low-word check; flip_count distinct bits flipped in one element
    of m (or of m·p)."""
    use_m, use_mp, use_final = scheme
    p = find_prime_with_bitlen(pbits, _random.Random(seed))
    kbits = p.bit_length()
    Lp = _limbs(kbits)
    Lprod = 2 * Lp
    m_prime = (-pow(p, -1, 1 << kbits)) % (1 << kbits)
    dev = torch.device(device)
    mp_l, p_l = bigint.from_int(m_prime, Lp, dev), bigint.from_int(p, Lp, dev)
    p_fit = bigint._fit(p_l, Lp + 1)
    rem = kbits % 32

    def mask_R(v):
        """v mod 2^kbits in Lp limbs."""
        out = bigint._fit(v, Lp)
        if rem:
            out = torch.cat([out[..., :-1], out[..., -1:] & ((1 << rem) - 1)], dim=-1)
        return out

    def body(dr, ks):
        a = _uniform_below(dr, ks[:, 0], vec_len, p, Lp)
        b = _uniform_below(dr, ks[:, 1], vec_len, p, Lp)
        T = bigint.mul(a, b)
        prod_m = bigint.mul(mask_R(T), mp_l)
        prod_mp = bigint.mul(mask_R(prod_m), p_l)
        inject_m = dr.host(prng.bernoulli, ks[:, 2]).bool()
        draws = _FlipDraws(dr, ks[:, 3], vec_len, 1, flip_count)
        prod_m_used = _where(inject_m, draws.apply(prod_m), prod_m)
        prod_mp_used = _where(inject_m, bigint.mul(mask_R(prod_m_used), p_l), draws.apply(prod_mp))
        detected = torch.zeros_like(inject_m)
        if use_m:
            detected |= inject_m & (_fold_sum(prod_m_used, fold_width)
                                    != _fold_sum(prod_m, fold_width))
        if use_mp:
            detected |= _fold_sum(prod_mp_used, fold_width) != _fold_sum(prod_mp, fold_width)
        Tv = bigint._fit(T, Lprod + 1)
        total = bigint.add(Tv, bigint._fit(prod_mp_used, Lprod + 1))
        if use_final:
            detected |= (mask_R(total) != 0).any(dim=-1).any(dim=-1)
        u = bigint.cond_sub_big(bigint.shift_right(total, kbits, Lp + 1), p_fit)
        tot_ok = bigint.add(Tv, bigint._fit(prod_mp, Lprod + 1))
        u_ok = bigint.cond_sub_big(bigint.shift_right(tot_ok, kbits, Lp + 1), p_fit)
        return (u != u_ok).any(dim=-1).any(dim=-1), detected

    harmful, detected = _run(trials, seed, 4, vec_len, chunk, device, timing, body)
    TP = int((harmful & detected).sum())
    FN = int((harmful & ~detected).sum())
    rate = TP / (TP + FN) if TP + FN else 1.0
    return {"detection_rate": rate, "TP": TP, "FN": FN, "p": p}


# ---------------------------------------------------------------------------
# barrett_final campaign: Intra / Range / Sum under four fault models
# ---------------------------------------------------------------------------

def barrett_final_campaign(s_bits: int, fault_model: int, trials: int, pbits: int = 37,
                           vec_len: int = 8192, use_intra: bool = True, use_range: bool = True,
                           use_sum: bool = True, seed: int = 1, device: str = "cuda",
                           chunk: Optional[int] = None, timing: Optional[dict] = None) -> Dict:
    """Fault models: 1 randomize one product within bit_length + 1 bits, 2
    randomize two, 3 flip two bits of one product, 4 flip one bit of two.
    The products a·b are kept in 3 limbs (mod 2^96), as the reference keeps
    them."""
    Q = next_prime_ge(1 << (pbits - 1))
    K = (Q - 1).bit_length()
    mu = (1 << (2 * K)) // Q
    Lq, Lx = _limbs(pbits), _limbs(2 * pbits)
    dev = torch.device(device)
    mu_l = bigint.from_int(mu, _limbs(mu.bit_length()), dev)
    Q_l = bigint.from_int(Q, Lq, dev)
    Q_fit = bigint._fit(Q_l, Lx + 1)
    Q2_fit = bigint._fit(bigint.from_int(2 * Q, Lx, dev), Lx + 1)

    def randomized(dr, c_true, idx, keys):
        """Each chosen product replaced by random words within bit_length + 1."""
        chosen, gi = _take(c_true, idx)
        bl = bigint.bit_length(chosen) + 1
        return c_true.scatter(1, gi, bigint.mask_to_bits(dr.bits(keys, tuple(chosen.shape[1:])), bl))

    def body(dr, ks):
        a = _uniform_below(dr, ks[:, 0], vec_len, Q, Lq)
        b = _uniform_below(dr, ks[:, 1], vec_len, Q, Lq)
        c_true = bigint.mul(a, b, Lx)
        sum_red_ref = bigint.sum_mod_big(bigint.barrett_reduce_big(c_true, Q, mu, K, Lq), Q)
        if fault_model == 1:
            idx = dr.host(prng.randint, ks[:, 2], (), 0, vec_len)[:, None]
            c_f = randomized(dr, c_true, idx, ks[:, 3])
        elif fault_model == 2:
            c_f = randomized(dr, c_true, dr.choice(ks[:, 2], vec_len, (2,)), ks[:, 3])
        elif fault_model == 3:
            c_f = _FlipDraws(dr, ks[:, 2], vec_len, 1, 2).apply(c_true)
        else:
            c_f = _FlipDraws(dr, ks[:, 2], vec_len, 2, 1).apply(c_true)

        intra_ok = torch.ones(c_f.shape[0], dtype=torch.bool, device=dev)
        if use_intra:
            hi, lo = mul32_parts(bigint.fold_2s1(a, s_bits), bigint.fold_2s1(b, s_bits))
            prod_fold = bigint.fold_2s1(torch.stack([lo, hi], dim=-1), s_bits)
            intra_ok = (bigint.fold_2s1(c_f, s_bits) == prod_fold).all(dim=-1)
        # Barrett-reduce each faulty product, with its range windows
        s_ = bigint.shift_right(bigint.mul(c_f, mu_l), 2 * K, Lq + 1)
        sn = bigint.mul(s_, Q_l, Lx + 1)
        ci, borrow = bigint.sub(bigint._fit(c_f, Lx + 1), sn)
        ci_red = bigint.cond_sub_big(ci, Q_fit)
        inter_ok = torch.ones_like(intra_ok)
        if use_range:
            pre_ok = (borrow == 0) & ~bigint.cmp_ge(ci, Q2_fit)
            inter_ok &= (pre_ok & ~bigint.cmp_ge(ci_red, Q_fit)).all(dim=-1)
        if use_sum:
            sum_red = bigint.sum_mod_big(bigint._fit(ci_red, Lq), Q)
            inter_ok &= (sum_red == sum_red_ref).all(dim=-1)
        return ~intra_ok | ~inter_ok, ~intra_ok, ~inter_ok

    detected, intra_det, inter_det = _run(trials, seed, 5, vec_len, chunk, device, timing, body)
    return {
        "miss_rate": float((~detected).mean()),
        "det_intra_only": int((intra_det & ~inter_det).sum()),
        "det_sum_only": int((~intra_det & inter_det).sum()),
        "det_both": int((intra_det & inter_det).sum()),
        "undetected": int((~detected).sum()),
        "Q": Q,
    }


# ---------------------------------------------------------------------------
# outer_check campaign: intra against inter folds, eight fault modes
# ---------------------------------------------------------------------------

OUTER_MODES = ("SBF", "DBF", "SBF+SBF", "SBF+DBF", "MOF1", "MOF2", "MOF+SBF", "MOF+DBF")


def outer_check_campaign(fold_k: int, mode: str, trials: int, qbits: int = 37,
                         vec_len: int = 4096, word_bits: int = 64, seed: int = 4,
                         device: str = "cuda", chunk: Optional[int] = None,
                         timing: Optional[dict] = None) -> Dict:
    """Products are uniform word_bits-wide values; faults act on their low
    qbits.  Over M = 2^k + 1: intra = any element's fold changed, inter = the
    sum of the folds changed.  Miss rates of intra, inter and both."""
    Lw = _limbs(word_bits)
    M = (1 << fold_k) + 1

    def flip1(dr, keys, row):
        b = dr.host(prng.randint, keys, (), 0, qbits, np.uint32)
        return bigint.xor_bit(row, b)

    def flip2(dr, keys, row):
        k = prng.split(keys)
        b1 = dr.host(prng.randint, k[:, 0], (), 0, qbits, np.uint32)
        b2 = dr.host(prng.randint, k[:, 1], (), 0, qbits - 1, np.uint32)
        b2 = b2 + (b2 >= b1).long()
        return bigint.xor_bit(bigint.xor_bit(row, b1), b2)

    def randomize(dr, keys, row):
        # replace the low qbits, keep the high bits
        qb = torch.tensor(qbits, device=row.device)
        return row ^ bigint.mask_to_bits(row, qb) ^ bigint.mask_to_bits(dr.bits(keys, (Lw,)), qb)

    ops = {"SBF": [flip1], "DBF": [flip2], "SBF+SBF": [flip1, flip1],
           "SBF+DBF": [flip1, flip2], "MOF1": [randomize], "MOF2": [randomize, randomize],
           "MOF+SBF": [randomize, flip1], "MOF+DBF": [randomize, flip2]}[mode]

    def body(dr, ks):
        c = dr.bits(ks[:, 0], (vec_len, Lw))
        base_folds = bigint.fold_2s1(c, fold_k)
        idx = dr.choice(ks[:, 1], vec_len, (len(ops),))
        cf = c
        for oi, op in enumerate(ops):
            row, gi = _take(cf, idx[:, oi:oi + 1])
            cf = cf.scatter(1, gi, op(dr, ks[:, 2 + oi], row[:, 0])[:, None])
        folds = bigint.fold_2s1(cf, fold_k)
        return ((cf != c).any(dim=-1).any(dim=-1), (folds != base_folds).any(dim=-1),
                sum_mod(folds, M) != sum_mod(base_folds, M))

    harmful, intra, inter = _run(trials, seed, 2 + len(ops), vec_len, chunk, device, timing, body)
    nh = max(1, int(harmful.sum()))
    return {
        "miss_intra": float((harmful & ~intra).sum() / nh),
        "miss_inter": float((harmful & ~inter).sum() / nh),
        "miss_both": float((harmful & ~intra & ~inter).sum() / nh),
        "harmful": int(harmful.sum()),
    }
