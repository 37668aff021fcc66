"""Import layering of the PyTorch/CUDA port: nothing in
``src/repro_torch/``, ``chip_smoke.py`` or the port's examples
``examples/torch_*.py`` imports ``jax`` or the reference package
``repro``, and the concrete kernel bindings
(``repro_torch.kernels.cuda``) are imported only by the dispatch module
``repro_torch/kernels/ops.py``. The reference's rule R2
(``scripts/check_layering.py``, which scans only ``src/repro``) holds
for the port too: ``repro_torch.core`` never imports
``repro_torch.launch``."""
import ast
import glob
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
KERNEL_MODULES = {"repro_torch.kernels.cuda"}
DISPATCH = "repro_torch.kernels.ops"
CORE = "repro_torch.core"
LAUNCH = "repro_torch.launch"


def _module_name(path):
    rel = os.path.relpath(path, os.path.join(ROOT, "src"))
    parts = rel[:-3].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports(path):
    """Every module a file imports, relative imports resolved; a
    ``from x import y`` yields both ``x`` and ``x.y``."""
    is_pkg = path.endswith("__init__.py")
    me = _module_name(path) if path.startswith(PKG) else "__main__"
    tree = ast.parse(open(path).read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = me.split(".")
                base = base[: len(base) - node.level + (1 if is_pkg else 0)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            out.append(mod)
            out += [f"{mod}.{a.name}" for a in node.names]
    return out


def _files():
    for dirpath, _dirs, names in os.walk(PKG):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield from sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))


def test_port_files_are_found():
    files = list(_files())
    assert len(files) >= 46
    assert any(f.endswith(os.path.join("kernels", "ops.py")) for f in files)
    assert sum(os.sep + "examples" + os.sep in f for f in files) == 3


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_only_ops_imports_the_kernel_bindings():
    importers = {
        _module_name(p) if p.startswith(PKG) else "chip_smoke"
        for p in _files()
        if KERNEL_MODULES & set(_imports(p))
    }
    assert importers == {DISPATCH}


def test_core_never_imports_launch():
    """R2: the algorithm layer stays runnable without the launch
    substrate; ``launch.mesh`` builds the ``core.device.DeviceMesh``
    that ``core.distributed`` takes, never the other way round."""
    core = [p for p in _files()
            if p.startswith(PKG) and _module_name(p).startswith(CORE)]
    assert any(p.endswith("distributed.py") for p in core)
    for path in core:
        for mod in _imports(path):
            assert not (mod == LAUNCH or mod.startswith(LAUNCH + ".")), (
                path, mod)
    launch = [p for p in _files()
              if p.startswith(PKG) and _module_name(p).startswith(LAUNCH)]
    assert any(p.endswith(os.path.join("launch", "mesh.py")) for p in launch)
