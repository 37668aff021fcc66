"""Loads the ten LM-seed config modules of ``contrib/configs/`` into a
configs package, for the port's configs and roofline parity tests."""
import importlib.util
import os
import sys

CONTRIB = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "contrib", "configs")


def register_contrib_configs(monkeypatch, package: str) -> dict:
    """Load every ``contrib/configs/<mod>.py`` as ``<package>.<mod>``
    (its ``from .base import ArchConfig`` binds to that package's base)
    and register it in ``sys.modules`` for this test only. Returns
    ``{mod: module}``."""
    importlib.import_module(package)
    out = {}
    for name in sorted(os.listdir(CONTRIB)):
        if not name.endswith(".py"):
            continue
        mod = name[:-3]
        spec = importlib.util.spec_from_file_location(
            f"{package}.{mod}", os.path.join(CONTRIB, name))
        module = importlib.util.module_from_spec(spec)
        monkeypatch.setitem(sys.modules, spec.name, module)
        spec.loader.exec_module(module)
        out[mod] = module
    return out
