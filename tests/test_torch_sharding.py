"""The port's sharding rules against the reference's.

The same rules run over the port's device-free ``abstract_mesh`` and the
reference's, at the mesh shapes the reference uses (one device, a test
mesh, one pod of 16x16 and two pods). Specs are compared as tuples,
leaf by leaf: exact equality, as the reference's ``PartitionSpec``
compares."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
from jax.sharding import PartitionSpec as RefP  # noqa: E402

from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.sharding import constraints as ref_constraints  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.sharding import constraints, rules  # noqa: E402
from repro_torch.sharding.rules import PartitionSpec as P  # noqa: E402

MESHES = (
    ((1,), ("model",)),
    ((1,), ("data",)),
    ((2, 1), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
)
MESH_IDS = ["x".join(map(str, s)) + "-" + ".".join(a) for s, a in MESHES]
L, D, F, V, E, B = 2, 64, 96, 250, 4, 8


def _leaf(*shape):
    return (tuple(shape), "bfloat16")


def spec_tree(array):
    """Every ``_RULES`` leaf, a ``moe`` subtree, a stacked layer dim,
    norms and scalars; ``array(shape)`` makes the tensor leaves."""
    return {
        "emb": array((V, D)),
        "head": {"emb": _leaf(D, V)},
        "blocks": {
            "attn": {"wq": _leaf(L, D, D), "wk": _leaf(L, D, 32),
                     "wv": _leaf(L, D, 32), "wo": _leaf(L, D, D),
                     "bq": _leaf(L, D), "bk": _leaf(L, 32),
                     "bv": _leaf(L, 32)},
            "mlp": {"w1": _leaf(L, D, F), "w3": _leaf(L, D, F),
                    "w2": _leaf(L, F, D)},
            "dense": {"w1d": _leaf(L, D, F), "w3d": _leaf(L, D, F),
                      "w2d": _leaf(L, F, D)},
            "moe": {"router": _leaf(L, D, E), "w1": _leaf(L, E, D, F),
                    "w3": _leaf(L, E, D, F), "w2": _leaf(L, E, F, D)},
            "mamba": {"in_proj": _leaf(L, D, 4 * D),
                      "out_proj": _leaf(L, 2 * D, D),
                      "conv_w": _leaf(L, 2 * D, 4), "conv_b": _leaf(L, 2 * D),
                      "a_log": _leaf(L, 8), "dt_bias": _leaf(L, 8),
                      "d_skip": _leaf(L, 8), "gate_norm": _leaf(L, 2 * D)},
            "rwkv": {"wr": _leaf(L, D, D), "wg": _leaf(L, D, D),
                     "a_w": _leaf(L, D, 32), "b_w": _leaf(L, 32, D),
                     "w0": _leaf(L, D), "wck": _leaf(L, D, F),
                     "wcv": _leaf(L, F, D), "wcr": _leaf(L, D, D),
                     "u": _leaf(L, 4, 16), "mu": _leaf(L, 5, D),
                     "mu_c": _leaf(L, 2, D)},
            "norm1": _leaf(L, D),
            "layers": [{"wq": _leaf(D, D)}, {"w2": _leaf(F, D)}],
        },
        "final_norm": array((D,)),
        "step": ((), "int32"),
    }


def state_tree(batch):
    return {
        "k": _leaf(L, batch, 128, 32), "v": _leaf(L, batch, 128, 32),
        "memory": _leaf(batch, 64, D), "conv": _leaf(L, batch, 3, 2 * D),
        "h": _leaf(L, batch, 8, 16, 16), "wkv": _leaf(L, batch, 4, 16, 16),
        "shift_a": _leaf(L, batch, D), "shift_c": _leaf(L, batch, D),
        "length": ((), "int32"), "other": _leaf(L, batch),
        "cross": {"k": _leaf(L, batch, 64, 32)},
    }


def meshes(shape, axes):
    return mesh_mod.abstract_mesh(shape, axes), ref_mesh.abstract_mesh(
        shape, axes)


def as_tuples(tree):
    """Spec leaves as plain tuples, the tree as nested dicts/lists."""
    if isinstance(tree, (P, RefP)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_tuples(v) for v in tree]
    return tree


def test_partition_spec_compares_and_prints_as_the_reference():
    for args in [(), (None,), ("data",), ("data", None), (("data",),),
                 (("pod", "data"), None, "model")]:
        got, want = P(*args), RefP(*args)
        assert tuple(got) == tuple(want) and got == want
        assert repr(got) == repr(want)
    assert P("data", None) != P("data")


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_axes_and_batch_pspec(shape, axes):
    m, rm = meshes(shape, axes)
    assert rules.dp_axes(m) == ref_rules.dp_axes(rm)
    assert rules.tp_axis(m) == ref_rules.tp_axis(rm)
    for batch in (1, 2, 3, 4, 8, 16, 24, 32, 256, 512, 1024):
        got, want = rules.batch_pspec(m, batch), ref_rules.batch_pspec(
            rm, batch)
        assert tuple(got) == tuple(want), batch


def on_mesh(entry, axes):
    """A spec entry cut to the mesh's axes (None when none is left)."""
    if entry is None:
        return None
    kept = tuple(a for a in ((entry,) if isinstance(entry, str) else entry)
                 if a in axes)
    return kept or None


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_best_effort(shape, axes):
    m, rm = meshes(shape, axes)
    specs = [("model", None), (None, "model"), ("data",), (axes, None),
             (("pod", "data"), "model"), (("data", "model"),), (), (None,)]
    for spec in specs:
        spec = tuple(on_mesh(a, axes) for a in spec)
        for dims in [(40, 3), (64, 96), (2, 32), (512, 250), (1,), (256,),
                     (16, 16, 16)]:
            got = rules.best_effort(m, spec, dims)
            want = ref_rules.best_effort(rm, spec, dims)
            assert tuple(got) == tuple(want), (spec, dims)


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_param_and_zero_pspecs(shape, axes):
    m, rm = meshes(shape, axes)
    tree = spec_tree(lambda s: torch.zeros(s))
    ref_tree = spec_tree(lambda s: np.zeros(s))
    got = rules.param_pspecs(tree, None, m)
    assert as_tuples(got) == as_tuples(
        ref_rules.param_pspecs(ref_tree, None, rm))
    assert as_tuples(rules.zero_pspecs(tree, None, m)) == as_tuples(
        ref_rules.zero_pspecs(ref_tree, None, rm))
    shardings = rules.param_shardings(tree, None, m)
    assert shardings["blocks"]["moe"]["w1"] == rules.NamedSharding(
        m, got["blocks"]["moe"]["w1"])
    assert shardings["blocks"]["layers"][1]["w2"].spec == got["blocks"][
        "layers"][1]["w2"]


def test_expert_and_tensor_parallel_rules():
    m, _ = meshes((2, 4), ("data", "model"))
    got = rules.param_pspecs(spec_tree(lambda s: torch.zeros(s)), None, m)
    assert got["blocks"]["moe"]["w1"] == P(None, "model", None, None)
    assert got["blocks"]["mlp"]["w1"] == P(None, None, "model")
    assert got["emb"] == P(None, None)  # 250 rows: 4 does not divide
    assert got["blocks"]["norm1"] == P(None, None)
    zero = rules.zero_pspecs(spec_tree(lambda s: torch.zeros(s)), None, m)
    assert zero["blocks"]["mlp"]["w1"] == P(None, "data", "model")


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_state_pspecs(shape, axes):
    m, rm = meshes(shape, axes)
    for batch in (1, 2, 8, 32, 512):
        got = rules.state_pspecs(state_tree(batch), None, m, batch)
        want = ref_rules.state_pspecs(state_tree(batch), None, rm, batch)
        assert as_tuples(got) == as_tuples(want), batch


def test_substrate_cases():
    """The two cases of the reference's ``tests/test_substrate.py``."""
    m = mesh_mod.make_test_mesh((1,), ("model",), device="cpu")
    assert rules.best_effort(m, ("model", None), (40, 3)) == P("model", None)
    rm = ref_mesh.make_test_mesh((1,), ("model",))
    assert tuple(ref_rules.best_effort(rm, ("model", None), (40, 3))) == (
        "model", None)
    m, _ = meshes((2, 1), ("data", "model"))
    assert rules.batch_pspec(m, 4) == P("data")
    assert rules.batch_pspec(m, 3) == P(None)


def test_constrain_returns_its_input():
    x = torch.arange(12).reshape(3, 4)
    assert constraints.current_axes() == ()
    assert constraints.constrain(x, "data", "model") is x
    assert constraints.constrain(x) is x
    # the reference's own behaviour with no mesh set
    assert ref_constraints.current_axes() == ()
    rx = jax.numpy.zeros((3, 4))
    assert ref_constraints.constrain(rx, "data", "model") is rx
