"""The span-and-counter recorder (rfhe_tpu_torch/trace/spans.py) on the CPU:
names, parents, request ids and the `since` arithmetic, host spans on
`time.time_ns`, the off path, the marks a rotation would enqueue on a card,
the mod-down's phases once per special prime, the protected evaluator's
phases and detector phases and its flag counter, the bytes a `Graph` counts
against the shapes, and the phase names shared with trace/profiled.py.  The marks themselves run on a card only
(tests/test_torch_gpu.py)."""
import time

import numpy as np
import pytest
import torch

from rfhe_tpu_torch.fhe import CkksContext, CkksParams
from rfhe_tpu_torch.trace import profiled, spans
from rfhe_tpu_torch.utils import jitcache

torch.set_num_threads(1)


@pytest.fixture
def tracing():
    spans.enable("cpu")
    try:
        yield spans
    finally:
        spans.disable()
        spans.request(None)


@pytest.fixture(scope="module")
def rotation():
    """A context of 4 ciphertext limbs at n = 256 and a ciphertext, its
    Galois key made."""
    ctx = CkksContext(CkksParams.make(n=256, levels=3, q0_bits=30, scale_bits=26), seed=1,
                      device="cpu")
    ct = ctx.encrypt(*ctx.encode(np.zeros(128)))
    ctx.rotate(ct, 1)
    return ctx, ct


def test_names_parents_requests_and_since(tracing):
    snap = spans.snapshot()
    spans.request(3)
    with spans.span("outer"):
        with spans.phases("KS") as phase:
            phase("A")
            phase("B")
        with spans.host_span("inner", "detail"):
            pass
    spans.request(4)
    with spans.span("outer"):
        pass
    got = spans.since(snap)
    assert {k: (v["count"], v["parent"]) for k, v in got.items()} == {
        "A": (1, "KS"), "B": (1, "KS"), "KS": (1, "outer"), "inner": (1, "outer"),
        "outer": (2, None)}
    recs = spans.records(snap)
    assert [(r[0], r[1], r[2], r[5]) for r in recs] == [
        ("A", "KS", 3, None), ("B", "KS", 3, None), ("KS", "outer", 3, None),
        ("inner", "outer", 3, "detail"), ("outer", None, 3, None), ("outer", None, 4, None)]
    ns = {name: sum(r[4] - r[3] for r in recs if r[0] == name) for name in got}
    assert all(got[name]["host_ns"] == ns[name] for name in got)
    assert got["KS"]["self_host_ns"] == ns["KS"] - ns["A"] - ns["B"]
    assert got["outer"]["self_host_ns"] == ns["outer"] - ns["KS"] - ns["inner"]
    assert all(v["device_count"] == v["device_ns"] == 0 for v in got.values())
    # a later snapshot sees only what closed after it
    later = spans.snapshot()
    with spans.span("A"):
        pass
    assert list(spans.since(later)) == ["A"] and spans.since(later)["A"]["count"] == 1
    assert [r[0] for r in spans.records(later)] == ["A"]


def test_host_spans_on_time_ns(tracing):
    snap = spans.snapshot()
    t0 = time.time_ns()
    with spans.span("timed"):
        time.sleep(0.002)
    t1 = time.time_ns()
    (rec,) = spans.records(snap)
    assert t0 <= rec[3] and rec[3] + 2_000_000 <= rec[4] <= t1


def test_ring_keeps_the_newest(tracing, monkeypatch):
    monkeypatch.setattr(spans, "RING", 4)
    monkeypatch.setattr(spans, "_ring", [None] * 4)
    snap = spans.snapshot()
    for i in range(6):
        spans.request(i)
        with spans.span("r"):
            pass
    assert [r[2] for r in spans.records(snap)] == [2, 3, 4, 5]
    assert spans.since(snap)["r"]["count"] == 6


def test_off_records_nothing(rotation):
    ctx, ct = rotation
    assert not spans.ENABLED and spans.MARKING is None
    assert spans.span("a") is spans.phases("b") is spans.host_span("c")
    snap = spans.snapshot()
    ctx.rotate(ct, 1)
    assert spans.since(snap) == {} and spans.records(snap) == []


def test_rotation_spans_and_marks(rotation, tracing, monkeypatch):
    """A rotation's spans on the CPU carry the phase names of the profiled
    rotation and the mod-down's four, one DISPATCH around them, and would
    enqueue 13 marks on a card (8, and 5 for the one special prime's
    mod-down phases), each span opened before it closes."""
    ctx, ct = rotation
    marks = []
    monkeypatch.setattr(spans, "_mark", lambda closes, opens: marks.append((closes, opens)))
    snap = spans.snapshot()
    spans.request(11)
    ctx.rotate(ct, 1)
    got = spans.since(snap)
    assert profiled.PHASES is spans.PHASES
    assert set(got) == set(spans.PHASES + spans.MODDOWN_PHASES) | {spans.KEYSWITCH,
                                                                   spans.DISPATCH}
    assert all(v["count"] == 1 for v in got.values())
    assert {k: got[k]["parent"] for k in ("BASECONV", "NTT", "MULTEVK", "MODDOWN")} == \
        dict.fromkeys(("BASECONV", "NTT", "MULTEVK", "MODDOWN"), spans.KEYSWITCH)
    assert got[spans.KEYSWITCH]["parent"] == got["PERMUTE"]["parent"] == spans.DISPATCH
    assert {r[2] for r in spans.records(snap)} == {11}
    assert len(marks) == 13
    bit = {name: spans._bit(name) for name in got if name != spans.DISPATCH}
    open_now = 0
    for closes, opens in marks:
        assert closes & open_now == closes
        open_now = (open_now & ~closes) | opens
    assert open_now == 0 and sum(opens for _, opens in marks) == sum(bit.values())


@pytest.mark.parametrize("levels, dnum", [(3, None), (3, 2), (5, 2)])
def test_moddown_phases_once_per_special_prime(levels, dnum, tracing, monkeypatch):
    """Each `drop_limb` of a keyswitch's mod-down records MD_INTT, MD_LIFT,
    MD_NTT and MD_SCALE under MODDOWN, once per special prime (1 per-limb,
    ceil(L/dnum) grouped), in 4 marks a special prime and one to close the
    last; the result is the untraced one bit for bit.  A rescale records
    none of them."""
    ctx = CkksContext(CkksParams.make(n=256, levels=levels, q0_bits=30, scale_bits=26), seed=1,
                      dnum=dnum, device="cpu")
    ct = ctx.encrypt(*ctx.encode(np.linspace(-1, 1, 128)))
    spans.disable()
    want = ctx.rotate(ct, 3)
    spans.enable("cpu")
    specials = len(ctx.ctx.moduli) - (levels + 1)
    assert specials == (1 if dnum is None else -(-(levels + 1) // dnum))
    marks = []
    monkeypatch.setattr(spans, "_mark", lambda closes, opens: marks.append((closes, opens)))
    snap = spans.snapshot()
    got = ctx.rotate(ct, 3)
    read = spans.since(snap)
    assert all(torch.equal(x.data, y.data) for x, y in zip(got.c, want.c))
    for name in spans.MODDOWN_PHASES:
        assert (read[name]["count"], read[name]["parent"]) == (specials, "MODDOWN"), name
    assert read["MODDOWN"]["count"] == 1
    assert read["MODDOWN"]["self_host_ns"] >= 0
    assert [r[0] for r in spans.records(snap) if r[1] == "MODDOWN"] == \
        list(spans.MODDOWN_PHASES) * specials
    assert len(marks) == 8 + 4 * specials + 1
    snap = spans.snapshot()
    ctx.rescale(ctx.multiply_plain(ct, ctx.encode(np.ones(128))[0], 1.0))
    assert not set(spans.since(snap)) & set(spans.MODDOWN_PHASES + ("MODDOWN",))


def test_signature_keys_the_marking_card(rotation, monkeypatch):
    ctx, ct = rotation
    off = jitcache.signature((ct,))
    monkeypatch.setattr(spans, "MARKING", 0)
    assert jitcache.signature((ct,)) != off


def test_graph_bytes_against_the_shapes(rotation):
    """The bytes a Graph counts for one replay of each op of the BSGS
    circuit (d = 64: 14 rotations, 64 multiply_plain, 63 add, 1 rescale)
    from its argument and output tensors: the circuit's 15,916 residue rows,
    at every ring and at 21 limbs (8,344,567,808 bytes at n = 65536)."""
    ctx21 = CkksContext(CkksParams.make(n=256, levels=20, q0_bits=30, scale_bits=26),
                        seed=2, device="cpu")
    ct = ctx21.encrypt(*ctx21.encode(np.zeros(128)))
    pt, _ = ctx21.encode(np.ones(128))
    ops = {"rotate": ((ct, ctx21.galois_key(ctx21.rotation_galois_element(1))),
                      lambda: ctx21.rotate(ct, 1)),
           "multiply_plain": ((ct, pt), lambda: ctx21.multiply_plain(ct, pt, 1.0)),
           "add": ((ct, ct), lambda: ctx21.add(ct, ct)),
           "rescale": ((ct,), lambda: ctx21.rescale(ct))}
    per_op = {}
    for name, (args, run) in ops.items():
        g = jitcache.Graph(graph=None, inputs=jitcache.flatten(args)[0], held=[], out_def=(),
                           outputs=jitcache.flatten(run())[0], counts={}, capture_s=0.0)
        per_op[name] = g.in_bytes + g.out_bytes
    row = 256 * 8
    assert {k: v // row for k, v in per_op.items()} == {
        "rotate": 42 + 42, "multiply_plain": 63 + 42, "add": 84 + 42, "rescale": 42 + 40}
    rows = (14 * per_op["rotate"] + 64 * per_op["multiply_plain"] + 63 * per_op["add"]
            + per_op["rescale"]) // row
    assert rows == 15916 and rows * 65536 * 8 == 8_344_567_808


@pytest.fixture(scope="module")
def protected_bgv():
    """A ProtectedBgv over 4 ciphertext limbs at n = 256 with dnum = 2 (two
    special primes), a ciphertext, and each op's untraced result."""
    from rfhe_tpu_torch.fhe import BgvContext, BgvParams
    from rfhe_tpu_torch.fhe.protected import ProtectedBgv
    ctx = BgvContext(BgvParams.make(n=256, levels=3), seed=5, dnum=2, device="cpu")
    pb = ProtectedBgv(ctx)
    ct = ctx.encrypt(ctx.encode(np.random.default_rng(2).integers(0, ctx.t, (2, 128))))
    ops = {"rotate_rows": lambda: pb.rotate_rows(ct, 1),
           "multiply_relin": lambda: pb.multiply_relin(ct, ct)}
    return ctx, ops, {name: op() for name, op in ops.items()}


# the plain phases each protected op opens, and the detector phases after them
_PROTECTED_PHASES = {
    "rotate_rows": ("PERMUTE", "CHK_PERMUTE", "INTT", "CHK_INTT"),
    "multiply_relin": ("INTT", "CHK_INTT")}
_KS_PHASES = ("BASECONV", "CHK_BASECONV", "NTT", "MULTEVK", "CHK_KS_CORE", "MODDOWN")
_MD_PHASES = ("MD_INTT", "CHK_MD_INTT", "MD_LIFT", "CHK_MD_LIFT", "MD_NTT", "MD_SCALE",
              "CHK_MD_PROJ", "CHK_MD_RANGE")


@pytest.mark.parametrize("op", sorted(_PROTECTED_PHASES))
def test_protected_op_spans_and_flags(protected_bgv, op, tracing, monkeypatch):
    """A traced protected BGV op gives the untraced arrays and flags bit for
    bit; each plain and detector phase closes once, the mod-down's once per
    special prime under MODDOWN, each name under one parent, in the order
    the work runs; the op counts the flags it returns; tracing off records
    and counts the flags alone."""
    ctx, ops, want = protected_bgv
    specials = len(ctx.ctx.moduli) - ctx.L
    marks = []
    monkeypatch.setattr(spans, "_mark", lambda closes, opens: marks.append((closes, opens)))
    snap, counts = spans.snapshot(), spans.COUNTS.snapshot()
    got, flags = ops[op]()
    read = spans.since(snap)
    (want_ct, want_flags) = want[op]
    assert all(torch.equal(x.data, y.data) for x, y in zip(got.c, want_ct.c))
    assert list(flags) == list(want_flags)
    assert all(torch.equal(flags[k], want_flags[k]) for k in flags)
    assert spans.COUNTS.since(counts)["detector_flags"] == len(flags) == 4 + 4 * specials
    top = _PROTECTED_PHASES[op]
    assert set(read) == set(top + _KS_PHASES + _MD_PHASES) | {spans.KEYSWITCH, spans.DISPATCH}
    assert set(spans.CHECK_PHASES) - set(read) == (
        {"CHK_PERMUTE"} if op == "multiply_relin" else set())
    parents = {**dict.fromkeys(top + (spans.KEYSWITCH,), spans.DISPATCH),
               **dict.fromkeys(_KS_PHASES, spans.KEYSWITCH),
               **dict.fromkeys(_MD_PHASES, "MODDOWN")}
    for name, parent in parents.items():
        assert read[name]["parent"] == parent, name
        assert read[name]["count"] == (specials if parent == "MODDOWN" else 1), name
    order = [r[0] for r in spans.records(snap)]
    assert [n for n in order if n in top] == list(top)
    assert [n for n in order if n in _KS_PHASES] == list(_KS_PHASES)
    assert [n for n in order if n in _MD_PHASES] == list(_MD_PHASES) * specials
    # one mark a boundary: the top phases and the close of the last,
    # KEYSWITCH's six and its close, each mod-down's eight and the close of
    # the last
    assert len(marks) == len(top) + 1 + 7 + 8 * specials + 1
    spans.disable()
    snap, counts = spans.snapshot(), spans.COUNTS.snapshot()
    marks.clear()
    ops[op]()
    assert spans.since(snap) == {} and spans.records(snap) == [] and marks == []
    assert spans.COUNTS.since(counts) == dict(
        dict.fromkeys(spans.Counters.FIELDS, 0), detector_flags=len(flags))
