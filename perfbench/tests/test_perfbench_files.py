"""The benchmark's files: found by name, consistent with BENCHMARK.json,
within the contract's limits, and free of the reference package."""
import ast
import json
import re

import pytest

from perfbench import harness

BENCH = harness.BENCH
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_reference_package_import(path):
    """Whole top-level names: ``repro_torch`` is not ``repro``."""
    bad = _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert not bad, f"{path} imports {bad}"
    if "reference" in path.parts:
        assert "repro_torch" not in _imports(path), path


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_loaded(["repro_torch", "repro_torch.core",
                                     "jaxtyping", "reproduce"]) == []
    assert harness.forbidden_loaded(["repro.core", "jax.numpy", "flax",
                                     "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                    "repro"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    cell = harness.load_json("workloads", w["name"])
    assert cell == {"config": w["config"], "traffic": w["traffic"],
                    "chips": w["chips"]}
    assert w["chips"] in (1, 4)
    assert (BENCH / "configs" / f"{w['config']}.json").is_file()
    mix = harness.load_json("traffic", w["traffic"])
    assert (BENCH / "traffic" / f"{mix['kind']}.py").is_file()
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"perfbench/configs/{c['name']}.json"
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert cfg["source"] == c["source"]
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def _reports(cell, metric):
    m = next(e for e in SPEC["end_to_end"] if e["name"] == metric)
    return "workloads" not in m or cell in m["workloads"]


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    reader = harness.load_module(BENCH / "metrics" / f"{m['name']}.py")
    assert reader.UNIT == m["unit"]
    assert m["source"] in SOURCES
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert m["workloads"], "every metric lists its cells"
    for cell in m["workloads"]:
        assert _reports(cell, m["moves"]), (cell, m["moves"])
    assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_every_metric_has_a_reader():
    files = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert {m["name"] for m in SPEC["per_layer"]} <= files


def test_configurations_state_the_generator():
    """Each file holds the generator's parameters as run; only the scale
    is cut, and the source names the scale run."""
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == ["SCALE"]
        assert cfg["SCALE"] < cfg["source_SCALE"]
        assert f"SCALE {cfg['SCALE']} " in c["source"]
        p = cfg["initiator"]
        assert sum(p.values()) == pytest.approx(1.0)
        assert (p["A"], p["B"], p["C"], cfg["edgefactor"]) == \
            (0.57, 0.19, 0.19, 16)


def test_end_to_end_metrics():
    names = {e["name"] for e in SPEC["end_to_end"]}
    assert "setup_s" in names
    for e in SPEC["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for w in SPEC["workloads"]:
        e2e = [e["name"] for e in SPEC["end_to_end"]
               if _reports(w["name"], e["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in SPEC["workloads"]] + \
            [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_files_named_from_names():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = str(p.relative_to(ROOT))
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
