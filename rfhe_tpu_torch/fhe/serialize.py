"""Ciphertext and key serialization with optional compression.

Counterpart of `rfhe_tpu/fhe/serialize.py`, with the same wire format byte
for byte: a versioned envelope around the residue arrays as uint32,
compression 'none' | 'zlib' | 'lzma'.

Envelope layout (little-endian):
    magic   b"RFHE"              4 bytes
    version u8                   (currently 2)
    comp    u8                   0=none 1=zlib 2=lzma
    hlen    u32                  JSON header length
    header  hlen bytes           JSON: kind, dtype, shapes, metadata
    payload (compressed) bytes   raw C-order array data, concatenated

A fresh symmetric-key encryption (`CkksContext.encrypt_seeded`) takes its c1
from a seeded SHAKE-256 stream (`sample_uniform_a`, part of the version-2
format), so its wire form carries c0 and the seed only.  Deserializing puts
the arrays on the `device` the caller names.
"""
from __future__ import annotations

import hashlib
import json
import lzma
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from ..device import to_numpy_u32, to_torch
from .ckks import Ciphertext
from .keys import KeySwitchKey, PublicKey
from .rns import RnsPoly

_MAGIC = b"RFHE"
_VERSION = 2
_COMP = {"none": 0, "zlib": 1, "lzma": 2}
_COMP_INV = {v: k for k, v in _COMP.items()}


def _compress(raw: bytes, comp: str) -> bytes:
    if comp == "none":
        return raw
    if comp == "zlib":
        return zlib.compress(raw, level=6)
    if comp == "lzma":
        return lzma.compress(raw, preset=1)
    raise ValueError(f"unknown compression {comp!r}")


def _decompress(payload: bytes, comp: str) -> bytes:
    if comp == "none":
        return payload
    if comp == "zlib":
        return zlib.decompress(payload)
    if comp == "lzma":
        return lzma.decompress(payload)
    raise ValueError(f"unknown compression {comp!r}")


def _pack(kind: str, arrays: List[np.ndarray], meta: Dict, comp: str) -> bytes:
    arrays = [np.ascontiguousarray(a).astype(a.dtype.newbyteorder("<"), copy=False)
              for a in arrays]
    header = {"kind": kind, "dtype": [a.dtype.str for a in arrays],
              "shape": [list(a.shape) for a in arrays], "meta": meta}
    hjson = json.dumps(header, separators=(",", ":")).encode()
    payload = _compress(b"".join(a.tobytes() for a in arrays), comp)
    return _MAGIC + struct.pack("<BBI", _VERSION, _COMP[comp], len(hjson)) + hjson + payload


def _unpack(data: bytes) -> Tuple[str, List[np.ndarray], Dict]:
    if data[:4] != _MAGIC:
        raise ValueError("not an RFHE serialized object")
    version, comp_id, hlen = struct.unpack("<BBI", data[4:10])
    if version not in (1, _VERSION):
        raise ValueError(f"unsupported version {version}")
    header = json.loads(data[10:10 + hlen])
    if version == 1 and header.get("kind") == "ciphertext_seeded":
        raise ValueError("seeded ciphertexts require version 2 blobs")
    raw = _decompress(data[10 + hlen:], _COMP_INV[comp_id])
    arrays, off = [], 0
    for dt, shp in zip(header["dtype"], header["shape"]):
        a = np.frombuffer(raw, dtype=np.dtype(dt), offset=off,
                          count=int(np.prod(shp, dtype=np.int64)))
        arrays.append(a.reshape(shp))
        off += a.nbytes
    return header["kind"], arrays, header["meta"]


def _expect(data: bytes, kind: str) -> Tuple[List[np.ndarray], Dict]:
    got, arrays, meta = _unpack(data)
    if got != kind:
        raise ValueError(f"expected {kind}, got {got}")
    return arrays, meta


# -- ciphertexts --------------------------------------------------------------

def serialize_ciphertext(ct: Ciphertext, compression: str = "none") -> bytes:
    meta = {"scale": ct.scale, "correction": ct.correction,
            "is_ntt": [bool(p.is_ntt) for p in ct.c]}
    return _pack("ciphertext", [to_numpy_u32(p.data) for p in ct.c], meta, compression)


def deserialize_ciphertext(data: bytes, *, device) -> Ciphertext:
    arrays, meta = _expect(data, "ciphertext")
    return Ciphertext([RnsPoly(to_torch(a, device), ntt) for a, ntt in zip(arrays, meta["is_ntt"])],
                      meta["scale"], meta["correction"])


# -- keys ----------------------------------------------------------------------

def serialize_public_key(pk: PublicKey, compression: str = "none") -> bytes:
    return _pack("public_key", [to_numpy_u32(pk.b), to_numpy_u32(pk.a)], {}, compression)


def deserialize_public_key(data: bytes, *, device) -> PublicKey:
    arrays, _ = _expect(data, "public_key")
    return PublicKey(b=to_torch(arrays[0], device), a=to_torch(arrays[1], device))


def serialize_keyswitch_key(ksk: KeySwitchKey, compression: str = "none") -> bytes:
    return _pack("keyswitch_key", [to_numpy_u32(ksk.b), to_numpy_u32(ksk.a)], {}, compression)


def deserialize_keyswitch_key(data: bytes, *, device) -> KeySwitchKey:
    arrays, _ = _expect(data, "keyswitch_key")
    return KeySwitchKey(b=to_torch(arrays[0], device), a=to_torch(arrays[1], device))


# -- seeded fresh ciphertexts ----------------------------------------------------

def serialize_ciphertext_seeded(ct: Ciphertext, seed: int, moduli,
                                compression: str = "none") -> bytes:
    """A fresh symmetric encryption whose c1 was expanded from `seed`
    (`CkksContext.encrypt_seeded`): c0 and the seed only.  Raises if the seed
    does not regenerate c1, as for a public-key encryption."""
    if ct.size != 2:
        raise ValueError("seeded form requires a fresh 2-poly ciphertext")
    c1 = to_numpy_u32(ct.c[1].data)
    if not np.array_equal(c1, sample_uniform_a(seed, c1.shape, moduli)):
        raise ValueError("seed does not regenerate c1: only ciphertexts produced by "
                         "encrypt_seeded(seed=...) can use the seeded wire form")
    meta = {"scale": ct.scale, "correction": ct.correction,
            "is_ntt": [bool(ct.c[0].is_ntt)], "seed": int(seed),
            "c1_shape": list(c1.shape), "c1_is_ntt": bool(ct.c[1].is_ntt)}
    return _pack("ciphertext_seeded", [to_numpy_u32(ct.c[0].data)], meta, compression)


def deserialize_ciphertext_seeded(data: bytes, moduli, *, device) -> Ciphertext:
    """Regenerate c1 from the stored seed."""
    arrays, meta = _expect(data, "ciphertext_seeded")
    a = sample_uniform_a(meta["seed"], tuple(meta["c1_shape"]), moduli)
    c0 = RnsPoly(to_torch(arrays[0], device), meta["is_ntt"][0])
    c1 = RnsPoly(to_torch(a, device), meta["c1_is_ntt"])
    return Ciphertext([c0, c1], meta["scale"], meta["correction"])


def sample_uniform_a(seed: int, shape, moduli) -> np.ndarray:
    """Uniform RNS sample (limb i < moduli[i]) of the seeded wire form
    (version-2 stream, frozen): limb i is rejection-sampled from
    little-endian u32 words of SHAKE-256(seed_32le || i_4le || counter_4le),
    seed_32le = seed mod 2^256.  Returns uint32 (shape)."""
    seed_b = (int(seed) % (1 << 256)).to_bytes(32, "little")
    out = np.empty(shape, dtype=np.uint32)
    n_el = int(np.prod(shape[1:], dtype=np.int64))
    for i, q in enumerate(int(m) for m in moduli[:shape[0]]):
        bound = ((1 << 32) // q) * q
        vals, ctr, need = [], 0, n_el
        while need > 0:
            xof = hashlib.shake_256(seed_b + i.to_bytes(4, "little") + ctr.to_bytes(4, "little"))
            words = np.frombuffer(xof.digest(4 * (need + need // 4 + 16)), dtype="<u4")
            vals.append(words[words < bound][:need])
            need -= len(vals[-1])
            ctr += 1
        out[i] = (np.concatenate(vals) % q).reshape(shape[1:])
    return out
