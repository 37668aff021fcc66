"""Logical -> physical sharding rules with best-effort divisibility.

The port's counterpart of the reference's ``repro.sharding.rules``: the
same rules over the port's :class:`~repro_torch.core.device.DeviceMesh`
(``repro_torch.launch.mesh.abstract_mesh`` builds a device-free one)
where the reference takes a JAX mesh. The rules only name mesh axes per
dimension: :class:`PartitionSpec` is a tuple that compares and prints as
the reference's ``PartitionSpec``, and :class:`NamedSharding` pairs one
with its mesh. Neither places any tensor.

Spec trees are nested dicts (lists and tuples also nest) whose leaves
are ``(shape, dtype)`` tuples or tensors; a leaf's rule is looked up by
the dict keys on its path.

Conventions:
  - "tp"  = the ``model`` mesh axis (tensor / expert parallel)
  - "dp"  = the data axes: ("pod", "data") on multi-pod meshes
  - projections are merged-2D so the fused feature dim shards even when
    head counts don't divide the TP degree
  - MoE expert stacks shard their E dim over ``model`` (expert
    parallelism); attention/MLP weights inside dense blocks shard their
    feature dim over ``model`` (tensor parallelism)
  - ZeRO-1: optimizer moments additionally shard a free dim over "dp"

``best_effort`` drops mesh axes from any dim they don't divide — the
resolver that makes one rule set serve all ten architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.device import DeviceMesh

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "dp_axes",
    "tp_axis",
    "best_effort",
    "param_pspecs",
    "param_shardings",
    "zero_pspecs",
    "batch_pspec",
    "state_pspecs",
]


class PartitionSpec(tuple):
    """Mesh axes per tensor dimension: ``None`` (replicated), one axis
    name, or a tuple of names. A one-name tuple is stored as the name,
    so specs compare (with each other and with plain tuples) and print
    as the reference's ``PartitionSpec``."""

    def __new__(cls, *partitions):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in partitions))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh; places nothing."""

    mesh: DeviceMesh
    spec: PartitionSpec


def _is_spec_leaf(x) -> bool:
    return (
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
    ) or hasattr(x, "shape")


def _tree_map(fn, tree, *rest, is_leaf=_is_spec_leaf, path=()):
    """``fn(path, leaf, *rest_leaves)`` over ``tree``, with ``rest`` of
    the same structure walked alongside; ``path`` holds the dict keys
    down to the leaf. ``None`` is an empty subtree."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf,
                             path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf,
                      path=path)
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _shape(leaf) -> tuple:
    return tuple(leaf[0] if isinstance(leaf, tuple) else leaf.shape)


def dp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis(mesh: DeviceMesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def _axis_size(mesh: DeviceMesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def best_effort(mesh: DeviceMesh, spec: Sequence,
                shape: Sequence[int]) -> PartitionSpec:
    """Keep each dim's axes only if their product divides the dim."""
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axes is None:
            out.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        while tup and dim % _axis_size(mesh, tup) != 0:
            tup = tup[:-1]
        out.append(tup[0] if len(tup) == 1 else (tuple(tup) if tup else None))
    return P(*out)


# rule table: leaf name -> logical spec for the *unstacked* shape.
# "tp" resolves to the model axis; dims beyond the listed ones replicate.
_RULES: Dict[str, Tuple] = {
    # embeddings / head
    "emb": ("tp", None),
    # attention (merged 2D)
    "wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
    "wo": ("tp", None),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    # dense mlp
    "w1": (None, "tp"), "w3": (None, "tp"), "w2": ("tp", None),
    # arctic dense-residual branch
    "w1d": (None, "tp"), "w3d": (None, "tp"), "w2d": ("tp", None),
    # moe (leading E dim -> expert parallel)
    "router": (None, None),
    # mamba2
    "in_proj": (None, "tp"), "out_proj": ("tp", None),
    "conv_w": ("tp", None), "conv_b": ("tp",),
    "a_log": ("tp",), "dt_bias": ("tp",), "d_skip": ("tp",),
    "gate_norm": ("tp",),
    # rwkv
    "wr": (None, "tp"), "wg": (None, "tp"),
    "a_w": (None, None), "b_w": (None, None), "w0": (None,),
    "wck": (None, "tp"), "wcv": ("tp", None), "wcr": (None, "tp"),
    "u": (None, None), "mu": (None, None), "mu_c": (None, None),
}

_MOE_EXPERT_LEAVES = ("w1", "w3", "w2")


def _leaf_rule(path, shape, cfg) -> Tuple:
    names = list(path)
    name = names[-1] if names else ""
    in_moe = "moe" in names
    if in_moe and name in _MOE_EXPERT_LEAVES:
        # (E, D, F)/(E, F, D): expert parallelism on E
        rule = ("tp", None, None)
    elif name in _RULES:
        rule = _RULES[name]
    else:
        rule = ()  # norms, scalars: replicate
    # stacked layer dim? leaf rank exceeds rule length by the L axis
    extra = len(shape) - len(rule)
    if extra > 0:
        rule = (None,) * extra + tuple(rule)
    return rule


def param_pspecs(spec_tree, cfg, mesh: DeviceMesh):
    """PartitionSpec tree for a (shape, dtype) spec tree."""
    tp = tp_axis(mesh)

    def resolve(path, leaf):
        shape = _shape(leaf)
        rule = _leaf_rule(path, shape, cfg)
        rule = tuple(tp if a == "tp" else a for a in rule)
        if tp is None:
            rule = tuple(None for _ in rule)
        return best_effort(mesh, rule, shape)

    return _tree_map(resolve, spec_tree)


def param_shardings(spec_tree, cfg, mesh: DeviceMesh):
    return _tree_map(
        lambda _path, ps: NamedSharding(mesh, ps),
        param_pspecs(spec_tree, cfg, mesh),
        is_leaf=lambda x: isinstance(x, PartitionSpec),
    )


def zero_pspecs(spec_tree, cfg, mesh: DeviceMesh):
    """ZeRO-1 sharding for optimizer moments: the param spec plus the
    data axes on the largest still-unsharded divisible dim. Gradients
    stay reduce-scattered into this layout, so per-device optimizer
    state is 1/|dp| of the unsharded size."""
    base = param_pspecs(spec_tree, cfg, mesh)
    dp = dp_axes(mesh)
    dpn = _axis_size(mesh, dp)

    def extend(_path, leaf_spec, ps):
        shape = _shape(leaf_spec)
        entries = list(ps) + [None] * (len(shape) - len(ps))
        if not dp:
            return P(*entries)
        cands = [
            i
            for i, (d, a) in enumerate(zip(shape, entries))
            if a is None and d > 0 and d % dpn == 0
        ]
        if cands:
            i = max(cands, key=lambda i: shape[i])
            entries[i] = dp if len(dp) > 1 else dp[0]
        return P(*entries)

    return _tree_map(extend, spec_tree, base)


def batch_pspec(mesh: DeviceMesh, batch_size: int) -> PartitionSpec:
    """Shard the batch dim over as many data axes as divide it."""
    dp = dp_axes(mesh)
    tup = dp
    while tup and batch_size % _axis_size(mesh, tup) != 0:
        tup = tup[1:]  # drop the pod axis first
    if not tup:
        return P(None)
    return P(tup if len(tup) > 1 else tup[0])


def state_pspecs(state_spec_tree, cfg, mesh: DeviceMesh, batch_size: int):
    """Decode-state shardings: caches shard (L, B, S, KVD) as
    (None, dp, None, tp); recurrent states shard batch + heads."""
    tp = tp_axis(mesh)
    bspec = batch_pspec(mesh, batch_size)
    b_ax = bspec[0] if len(bspec) else None

    def resolve(path, leaf):
        shape = _shape(leaf)
        name = path[-1] if path else ""
        if name == "length":
            return P()
        if name in ("k", "v"):  # (L, B, S, KVD)
            return best_effort(mesh, (None, b_ax, None, tp), shape)
        if name == "memory":  # (B, S, D)
            return best_effort(mesh, (b_ax, None, None), shape)
        if name in ("conv",):  # (L, B, K-1, C)
            return best_effort(mesh, (None, b_ax, None, tp), shape)
        if name in ("h",):  # (L, B, H, P, N)
            return best_effort(mesh, (None, b_ax, tp, None, None), shape)
        if name in ("wkv",):  # (L, B, H, hd, hd)
            return best_effort(mesh, (None, b_ax, tp, None, None), shape)
        if name in ("shift_a", "shift_c"):  # (L, B, D)
            return best_effort(mesh, (None, b_ax, tp), shape)
        return best_effort(mesh, (None,) * len(shape), shape)

    return _tree_map(resolve, state_spec_tree)
