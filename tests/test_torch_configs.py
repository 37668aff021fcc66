"""The port's config dataclasses and registry against the reference's.

Each of the ten LM-seed configs in ``contrib/configs/`` (the published
widths) is loaded twice, once into each package, and its fields,
parameter counts, reduced config and properties compared with ``==``:
every value is an integer, a string or a float from the same literal.
Without the modules in place both registries raise the same
``KeyError``."""
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

import repro.configs as ref_configs  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from torch_contrib_configs import register_contrib_configs  # noqa: E402

PROPERTIES = ("attention_free", "subquadratic", "is_moe", "is_encdec")


@pytest.fixture
def both_registered(monkeypatch):
    return (register_contrib_configs(monkeypatch, "repro_torch.configs"),
            register_contrib_configs(monkeypatch, "repro.configs"))


def _same_config(got, want):
    assert type(got).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    for prop in PROPERTIES:
        assert getattr(got, prop) == getattr(want, prop), prop


def test_registry_ids_and_exports():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10
    assert registry._MODULES == importlib.import_module(
        "repro.configs.registry")._MODULES
    assert configs.__all__ == ref_configs.__all__


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_matches_reference(arch, both_registered):
    got, want = configs.get_config(arch), ref_configs.get_config(arch)
    _same_config(got, want)
    _same_config(got.reduced(), want.reduced())
    # the underscore spelling resolves to the same module
    assert configs.get_config(arch.replace("-", "_")) == got


def test_all_configs(both_registered):
    got, want = configs.all_configs(), ref_configs.all_configs()
    assert list(got) == list(want)
    for arch in want:
        _same_config(got[arch], want[arch])


def test_shape_cells():
    assert [dataclasses.asdict(c) for c in configs.SHAPE_CELLS] == [
        dataclasses.asdict(c) for c in ref_configs.SHAPE_CELLS]


def test_arch_config_defaults():
    kw = dict(name="t", family="dense", n_layers=3, d_model=96, n_heads=6,
              n_kv_heads=2, d_ff=256, vocab=1000)
    got, want = configs.ArchConfig(**kw), ref_configs.ArchConfig(**kw)
    assert got.head_dim == 16
    _same_config(got, want)
    _same_config(got.reduced(), want.reduced())


def _key_error(get, arch):
    with pytest.raises(KeyError) as e:
        get(arch)
    return str(e.value)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS + ("no-such-arch",))
def test_missing_config_raises_the_reference_error(arch):
    got = _key_error(configs.get_config, arch)
    assert got == _key_error(ref_configs.get_config, arch)
    if arch in ref_configs.ARCH_IDS:
        assert "contrib/configs/" in got
