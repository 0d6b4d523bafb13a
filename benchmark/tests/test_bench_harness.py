"""BENCHMARK.json against the files it names, cells, schemes and circuit kinds
found by name, the keyswitch layout a configuration states, the metric readers on synthetic
records and spans, the traced run's spans, the import guard and the missing
card."""
import ast
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import circuits, harness, trace as tracing, yardstick
from benchmark.reference import scheme
from benchmark.tests import tiny
from rfhe_tpu_torch.trace import spans as program_spans

ROOT = harness.ROOT
BENCH = ROOT / "benchmark"
SPEC = tiny.SPEC
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert all(len(w["why"]) <= 200 for w in SPEC["workloads"])
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, required in keys.items():
        for entry in SPEC[section]:
            extra = set(entry) - required
            assert set(entry) >= required and extra <= {"workloads"}, (section, entry["name"])
            assert "workloads" not in extra or section in ("end_to_end", "per_layer")
    one_line = [c["why"] for c in SPEC["configs"]] + [c["source"] for c in SPEC["configs"]] \
        + [w["why"] for w in SPEC["workloads"]] + [m["layer"] for m in SPEC["per_layer"]] \
        + list(SPEC["command"])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in one_line)
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert all(m["source"] in ("host_clock", "device_trace") for m in SPEC["end_to_end"])
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_every_cell_resolves_to_its_files(name):
    w, cfg, mix, limits = harness.cell(tiny.SPEC_ALL, name)
    assert cfg["name"] == w["config"]
    assert circuits.kind_class(mix["kind"]).scheme == cfg["deployment"]["scheme"]
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in SPEC[k]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs/ckks_n65536_l21.json").read_text())
    cfg["name"] = "ckks_tiny"
    cfg["deployment"].update(tiny.TINY["ckks"])
    (b / "configs/ckks_tiny.json").write_text(json.dumps(cfg))
    (b / "traffic/bsgs_d8.json").write_text(json.dumps(
        {"kind": "bsgs_matvec", "d": 8, "pool": 2, "sample": 2}))
    (b / "limits/ckks_tiny.bsgs_d8.json").write_text(json.dumps(
        {"slot_err": 0.01, "limb_mismatch": 0}))
    (b / "metrics/circuits_total.py").write_text("def read(run):\n    return len(run.ends)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ckks_tiny", "source": "a test",
                            "file": "benchmark/configs/ckks_tiny.json", "reduced": []})
    spec["workloads"].append({"name": "ckks_tiny.bsgs_d8", "config": "ckks_tiny",
                              "traffic": "bsgs_d8", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "circuits_total", "unit": "circuits",
                               "better": "higher", "bound": 0.05, "source": "host_clock"})
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    parts = harness.cell(spec, "ckks_tiny.bsgs_d8", tmp_path)
    correct, failed, checks, r = tiny.run("ckks_tiny.bsgs_d8", cut=parts)
    assert correct, checks
    got = {m["name"]: harness.reader(m["name"], tmp_path)(r) for m in spec["end_to_end"]}
    assert got["circuits_total"] == len(r.ends) and got["circuits_per_s"] > 0


KIND_FILE = """from benchmark import circuits


@circuits.kind("scratch_kind")
class ScratchKind(circuits.Circuit):
    scheme = "bfv"
"""


def test_a_bfv_cell_and_a_circuit_kind_are_new_files_only(tmp_path, monkeypatch):
    """A BFV configuration, a product-tree mix, its limits and a circuit kind
    of its own, all added as files and entries: nothing that was there
    changes, the BFV cell runs correct, and the kind is found by its name."""
    monkeypatch.setattr(circuits, "KINDS", dict(circuits.KINDS))
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    files, entries = tiny.bfv_cell()
    for rel, obj in files.items():
        (tmp_path / "benchmark" / rel).write_text(json.dumps(obj))
    (tmp_path / "benchmark/kinds/scratch_kind.py").write_text(KIND_FILE)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for section, entry in entries.items():
        spec[section].append(entry)
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    correct, failed, checks, r = tiny.run(tiny.BFV_CELL, root=tmp_path,
                                          cut=harness.cell(spec, tiny.BFV_CELL, tmp_path))
    assert correct and failed == 0 and checks["slot_mismatch"][0] == 0, checks
    assert 0 < checks["noise_bits"][0] < checks["noise_bits"][1]
    with pytest.raises(ValueError, match="unknown circuit kind 'scratch_kind'"):
        circuits.kind_class("scratch_kind")
    assert circuits.kind_class("scratch_kind", tmp_path).__name__ == "ScratchKind"
    (tmp_path / "benchmark/kinds/silent_kind.py").write_text("X = 1\n")
    with pytest.raises(ValueError, match="registers no kind 'silent_kind'"):
        circuits.kind_class("silent_kind", tmp_path)


def test_an_unknown_scheme_raises():
    dep = dict(tiny.bfv_parts()[1]["deployment"], scheme="tfhe")
    with pytest.raises(ValueError, match="unknown scheme 'tfhe'; known: bfv, bgv, ckks"):
        scheme.Basis.make(dep, "cpu")


# Two circuits in a 1000 µs window: an NTT kernel (100 µs, overlapping a
# residue kernel of 100 µs by 50), a copy of 50 µs and a fill of 40, so 760 µs
# idle; the longest gap, 450 µs, opens while the client waits.
_SYNTHETIC = [
    ("cudaGraphLaunch", False, 20, 25), ("cudaMemcpyAsync", False, 30, 32),
    ("cudaLaunchKernel", False, 510, 512), ("cudaStreamSynchronize", False, 240, 700),
    ("void ntt_fwd_cluster_kernel(long const*)", True, 100, 200),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::remainder>",
     True, 150, 250),
    ("Memcpy DtoD (Device -> Device)", True, 700, 750),
    ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<long>>", True, 760, 800),
    ("void ntt_inv_kernel<4>(long const*)", True, 2000, 2100),     # after the window
]
_SYNTHETIC_SPANS = [(10_000, 60_000, 480_000), (500_000, 600_000, 990_000)]


def _synthetic_trace():
    return tracing.collect(_SYNTHETIC, (0, 1_000_000), _SYNTHETIC_SPANS,
                           ntt_by_shape={("fwd_large", 1, 2, 65536): 3})


def test_readers_give_known_answers_on_synthetic_records():
    t = _synthetic_trace()
    run = harness.Run(setup_s=12.5, starts=[0.0, 1.0, 2.0], ends=[0.5, 1.5, 4.0],
                      window_s=4.0, peak_bytes=3 * 2 ** 30, trace=t)
    read = lambda m: harness.reader(m)(run)
    assert read("circuits_per_s") == 3 / 4.0
    assert read("peak_mem_gib") == 3.0 and read("setup_s") == 12.5
    assert read("circuit_p95_ms") == pytest.approx(500 + 1500 * 0.9)
    assert read("host_enqueue_ms_per_circuit") == pytest.approx((50 + 100) / 2 * 1e-3)
    assert read("host_launches_per_circuit") == 3 / 2
    assert read("ntt_device_ms_per_circuit") == pytest.approx(100e-3 / 2)
    assert read("residue_device_ms_per_circuit") == pytest.approx(100e-3 / 2)
    assert read("device_busy_ms_per_circuit") == pytest.approx(240e-3 / 2)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 240 / 1000))
    least = 3 * 2 * yardstick.ntt_least_s(65536)[0]
    assert read("ntt_roofline_pct") == pytest.approx(100 * least / 100e-6)
    assert yardstick.ntt_least_s(65536)[1] == "operations"
    assert t.gaps[0] == ["wait: cudaStreamSynchronize", pytest.approx(450e-6)]
    assert t.top_ops(1)[0][1] == pytest.approx(100e-6)


def test_readers_find_nothing_without_a_trace():
    run = harness.Run(setup_s=1.0, starts=[0.0], ends=[1.0], window_s=1.0, peak_bytes=0)
    for m in SPEC["per_layer"]:
        assert harness.reader(m["name"])(run) is None


def test_p95_is_of_every_circuit():
    run = harness.Run(setup_s=1.0, starts=[0.0] * 100, ends=[i / 1000 for i in range(1, 101)],
                      window_s=1.0, peak_bytes=0)
    assert harness.reader("circuit_p95_ms")(run) == pytest.approx(95.05)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"rfhe_tpu_torch", "rfhe_tpu", "jax", "benchmark"}, path
    code = ("import sys, benchmark.reference.ntt, benchmark.reference.scheme; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & {"rfhe_tpu_torch", "rfhe_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax_and_no_jax_package():
    code = ("import sys, json; from benchmark.tests import tiny; "
            "[tiny.run(c, seconds=0.05) for c in tiny.CELLS]; "
            "from benchmark import run; print(json.dumps(run.forbidden_modules())); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env=env).stdout.splitlines()
    assert json.loads(out[-2]) == []
    loaded = set(json.loads(out[-1]))
    assert "rfhe_tpu_torch" in loaded and not loaded & {"jax", "jaxlib", "flax", "rfhe_tpu"}


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", tiny.CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, env=dict(os.environ,
                                                                   CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2 and proc.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", tiny.CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           tiny.SPEC["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
                           "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0


# -- the keyswitch layout ------------------------------------------------------

@pytest.mark.parametrize("name,digits,levels,groups", [
    ("ckks_n65536_l21.bsgs_d64", 2, 3, [[0, 1], [2, 3]]),
    ("ckks_n65536_l21.bsgs_d64", 2, 4, [[0, 1, 2], [3, 4]]),
    ("bgv_n16384_l10.dotprod", 2, 3, [[0, 1], [2, 3]])])
def test_grouped_digits_run_correct(name, digits, levels, groups):
    """n = 256: L = 4 in groups of 2 limbs over 2 special primes, and L = 5
    with a ragged last group (3 + 2 limbs over 3 special primes); keys the
    program's contexts take."""
    cut = tiny.parts(name)
    cut[1]["deployment"].update(digits=digits, levels=levels)
    basis = scheme.Basis.make(cut[1]["deployment"], "cpu")
    assert basis.groups() == groups and len(basis.special) == len(groups[0])
    correct, failed, checks, r = tiny.run(name, cut=cut)
    assert correct and failed == 0, checks
    assert checks["limb_mismatch"][0] == 0


def _old_switching_key(keys, s_prime_slots):
    """`Keys.switching_key` as it was with per-limb digits alone."""
    b_, tab = keys.basis, keys.basis.tables
    L, n, dev = b_.L, b_.n, tab.q.device
    a = scheme.uniform(keys.gen, (L, len(tab.primes), n), tab)
    e = tab.fwd(scheme.residues(keys.nf * scheme.gaussian(keys.gen, (L, n), dev, keys.sigma),
                                tab))
    b = (e - tab.mont(a, keys.s_slots)) % tab.q
    P = math.prod(b_.special)
    p_mod = torch.tensor([P % q for q in b_.ct], device=dev)
    j = torch.arange(L, device=dev)
    b[j, j] = (b[j, j] + p_mod[:, None] * s_prime_slots[:L] % tab.q[:L]) % tab.q[:L]
    return b, a


@pytest.mark.parametrize("config", ["ckks_n65536_l21", "bgv_n16384_l10"])
def test_per_limb_keys_are_bit_identical_to_the_old_ones(config, monkeypatch):
    dep = harness.load_json(harness.ROOT / f"benchmark/configs/{config}.json")["deployment"]
    dep.update(tiny.TINY[dep["scheme"]])
    assert dep["digits"] == "per_limb"
    basis = scheme.Basis.make(dep, "cpu")
    assert len(basis.special) == 1 and basis.groups() == [[j] for j in range(basis.L)]

    def draw():
        keys = scheme.Keys(basis, torch.Generator().manual_seed(2 ** 31 + 7), dep["sigma"])
        return [keys.galois_key(5), keys.relin_key(), keys.galois_key(25), keys.encrypt(
            scheme.residues(torch.arange(basis.n), basis.level_tables(basis.L - 1))[None],
            basis.L - 1)]

    new = draw()
    monkeypatch.setattr(scheme.Keys, "switching_key", _old_switching_key)
    old = draw()
    for x, y in zip(new, old):
        assert all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("digits", ["grouped", "3", 0, -2, 2.0, True, None])
def test_an_unknown_digits_value_raises(digits):
    dep = dict(tiny.parts("ckks_n65536_l21.bsgs_d64")[1]["deployment"], digits=digits)
    with pytest.raises(ValueError, match=re.escape(repr(digits))):
        scheme.Basis.make(dep, "cpu")


# -- spans and counters --------------------------------------------------------

def test_an_untraced_run_leaves_the_spans_off():
    assert not program_spans.ENABLED
    correct, _, checks, r = tiny.run("ckks_n65536_l21.bsgs_d64")
    assert correct, checks
    assert not program_spans.ENABLED and r.spans is None and r.counters is None


def test_a_traced_run_reads_the_programs_spans(monkeypatch):
    """The traced path on the CPU, the profiler left out (it traces the card
    alone): the spans are on through the run and off after it, and the
    window's spans and counters reach the Run."""
    seen = []
    monkeypatch.setattr(harness.torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(harness.tracing, "records", lambda prof: [])
    run = harness.circuits.BsgsMatvec.run
    monkeypatch.setattr(harness.circuits.BsgsMatvec, "run",
                        lambda self, i, fault=None: (seen.append(program_spans.ENABLED),
                                                     run(self, i, fault))[1])
    r, per_sample, extra, limits = harness.run_cell(
        tiny.parts("ckks_n65536_l21.bsgs_d64"), 2 ** 31 + 5, 0.3, True, "cpu",
        time.perf_counter())
    assert harness.judgement(per_sample, extra, limits)[0]
    assert all(seen) and not program_spans.ENABLED
    assert r.counters is not None and r.counters["captures"] == 0
    ks = r.spans["KEYSWITCH"]
    assert ks["count"] == 6 * len(r.ends)           # d = 16: 3 baby and 3 giant rotations
    assert r.spans["dispatch"]["count"] > 0 and r.spans["dispatch"]["host_ns"] > 0
    assert harness.reader("dispatch_host_ms_per_circuit")(r) > 0
    # the CPU times host spans only: the card's readers find nothing
    assert harness.reader("keyswitch_device_ms_per_circuit")(r) is None


SPANS = {"KEYSWITCH": 30e6, "BASECONV": 6e6, "MULTEVK": 9e6, "MODDOWN": 12e6}
READS = {"keyswitch_device_ms_per_circuit": 10.0, "ks_baseconv_device_ms_per_circuit": 2.0,
         "ks_multevk_device_ms_per_circuit": 3.0, "ks_moddown_device_ms_per_circuit": 4.0,
         "dispatch_host_ms_per_circuit": 7.0, "graph_copy_gb_per_circuit": 2.5,
         "graph_captures_in_window": 2}


@pytest.mark.parametrize("metric", sorted(READS))
def test_span_and_counter_readers_read_per_circuit(metric):
    entry = lambda ns, host=0: {"count": 3, "host_ns": host, "device_count": 3,
                                "device_ns": ns, "parent": None}
    spans = {k: entry(v) for k, v in SPANS.items()}
    spans["dispatch"] = entry(0, 21e6)
    counters = {f: 0 for f in program_spans.Counters.FIELDS}
    counters.update(copy_in_bytes=5e9, clone_out_bytes=2.5e9, captures=2)
    run = harness.Run(setup_s=1.0, starts=[0.0, 1.0, 2.0], ends=[0.5, 1.5, 2.5],
                      window_s=3.0, peak_bytes=0, spans=spans, counters=counters)
    assert harness.reader(metric)(run) == pytest.approx(READS[metric])
    bare = harness.Run(setup_s=1.0, starts=run.starts, ends=run.ends, window_s=3.0,
                       peak_bytes=0)
    assert harness.reader(metric)(bare) is None


def test_span_marks_are_set_apart():
    """Marks added to the synthetic records change no busy time, kernel sum,
    top op, gap or launch count; the program's open host span names a gap."""
    plain = _synthetic_trace()
    recs = [("rfhe_span_mark(long*, unsigned long, unsigned long)", True, t, t + 1.4)
            for t in (120.0, 260.0, 600.0, 900.0)]
    host = [("KEYSWITCH", None, 0, 100_000, 400_000, None),
            ("dispatch", None, 0, 240_000, 300_000, "rotate")]
    marked = tracing.collect(_SYNTHETIC + recs, (0, 1_000_000), _SYNTHETIC_SPANS,
                             {("fwd_large", 1, 2, 65536): 3}, host)
    assert marked.marks == 4 and plain.marks == 0
    assert marked.busy_s() == plain.busy_s() and marked.top_ops() == plain.top_ops()
    assert marked.device_s(lambda n: True) == plain.device_s(lambda n: True)
    assert marked.launches == plain.launches and marked.device == plain.device
    assert marked.gaps[0] == [plain.gaps[0][0] + " | dispatch rotate", plain.gaps[0][1]]
    assert [g[1] for g in marked.gaps] == [g[1] for g in plain.gaps]
