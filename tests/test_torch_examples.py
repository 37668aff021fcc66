"""The port's three examples (``examples/torch_*.py``) on the CPU.

``torch_peeling_decomposition`` prints byte for byte what the reference
script prints. ``torch_quickstart`` and ``torch_end_to_end_analytics``
(whose reference scripts stop at their approximate line) are held
against ``tests/data/torch_examples_reference.json``, the JAX library's
values for the same calls: every returned value with ``==`` (integers,
and estimates from the same float operations in the same order), and
every printed line, bracketed timings removed."""
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
PIN = os.path.join(ROOT, "tests", "data", "torch_examples_reference.json")
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def pin():
    with open(PIN) as f:
        return json.load(f)


def load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed(text):
    """The printed lines, each bracketed span (a clock time, seconds)
    removed."""
    return [re.sub(r"\[[^\]]*\]", "", line).rstrip()
            for line in text.splitlines()]


def run_script(path, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", PYTHONIOENCODING="utf-8")
    out = subprocess.run([sys.executable, path, *args], cwd=ROOT, env=env,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr.decode()
    return out.stdout


def test_peeling_decomposition_prints_what_the_reference_prints(pin):
    got = run_script(os.path.join(EXAMPLES, "torch_peeling_decomposition.py"),
                     *CPU)
    want = run_script(os.path.join(EXAMPLES, "peeling_decomposition.py"))
    assert got == want
    assert printed(got.decode()) == pin["peeling_decomposition"]["lines"]


def test_peeling_decomposition_values(pin, capsys):
    values = load("torch_peeling_decomposition").main(CPU)
    entry = pin["peeling_decomposition"]
    assert values == entry["values"]
    assert printed(capsys.readouterr().out) == entry["lines"]


def test_quickstart(pin, capsys):
    values = load("torch_quickstart").main(CPU)
    entry = pin["quickstart"]
    assert values == entry["values"]
    assert printed(capsys.readouterr().out) == entry["lines"]


def test_end_to_end_analytics(pin, capsys):
    entry = next(e for e in pin["end_to_end_analytics"]
                 if e["argv"] == ["--edges", "20000", "--peel-edges", "3000"])
    values = load("torch_end_to_end_analytics").main(entry["argv"] + CPU)
    assert values == entry["values"]
    assert printed(capsys.readouterr().out) == entry["lines"]


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_peeling_decomposition",
                                  "torch_end_to_end_analytics"])
def test_examples_default_to_the_card(name, monkeypatch):
    """No CPU fallback: with no card, the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main([])
