"""The batch aggregations of the port (``aggregation="batch"|"batch_wa"``
on the ``torch`` engine, on the CPU) against the reference package's
``count_butterflies(engine="xla")``: every mode, ``batch_rows`` in
{1, 3, 8} and both wedge directions, bit for bit in int32 (both
packages' default count dtype) and in int64 (the reference under
``jax_enable_x64``, set in a subprocess so the flag never reaches this
process). Tolerance 0: counts are integers."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro.core.count import _batch_bounds as ref_batch_bounds  # noqa: E402
from repro.core.count import count_from_ranked as ref_count_from_ranked  # noqa: E402
from repro.core.graph import preprocess as ref_preprocess  # noqa: E402
from repro.core.ranking import make_order as ref_make_order  # noqa: E402
from repro.data import graphs as ref_graphs  # noqa: E402
from repro_torch.core import BipartiteGraph, count_butterflies  # noqa: E402
from repro_torch.core.count import _batch_bounds, count_from_ranked  # noqa: E402
from repro_torch.core.graph import preprocess  # noqa: E402
from repro_torch.core.ranking import make_order  # noqa: E402
from torch_parity import MODE_FIELDS, assert_same  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = (300, 200, 2_500, 3)  # powerlaw_bipartite(n_u, n_v, m, seed)
AGGS = ("batch", "batch_wa")
MODES = ("global", "vertex", "edge", "all")
ROWS = (1, 3, 8)


def graphs():
    ref_g = ref_graphs.powerlaw_bipartite(*GRAPH[:3], seed=GRAPH[3])
    return ref_g, BipartiteGraph(ref_g.n_u, ref_g.n_v, ref_g.edges)


@pytest.mark.parametrize("cache_opt", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("aggregation", AGGS)
def test_batch_matches_reference_int32(aggregation, mode, rows, cache_opt):
    ref_g, g = graphs()
    kw = dict(mode=mode, aggregation=aggregation, batch_rows=rows,
              cache_opt=cache_opt)
    want = ref_core.count_butterflies(ref_g, engine="xla", **kw)
    got = count_butterflies(g, engine="torch", device="cpu", **kw)
    assert_same(got, want, kw, MODE_FIELDS[mode])
    assert got.report.final_rung == "torch" and not got.report.degraded
    assert [a.rung for a in got.report.attempts] == ["torch"]
    assert got.report.plan is None and want.report.plan is None


@pytest.fixture(scope="module")
def reference_int64(tmp_path_factory):
    """The reference's int64 batch counts for every case of
    :func:`test_batch_matches_reference_int64`, from one subprocess."""
    out = tmp_path_factory.mktemp("batch") / "ref.npz"
    script = (
        "import sys, numpy as np, jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import jax.numpy as jnp\n"
        "from repro.core import count_butterflies\n"
        "from repro.data.graphs import powerlaw_bipartite\n"
        f"g = powerlaw_bipartite({GRAPH[0]}, {GRAPH[1]}, {GRAPH[2]}, "
        f"seed={GRAPH[3]})\n"
        "res = {}\n"
        f"for agg in {AGGS!r}:\n"
        "    for mode in ('global', 'all'):\n"
        f"        for rows in {ROWS!r}:\n"
        "            for co in (False, True):\n"
        "                r = count_butterflies(\n"
        "                    g, mode=mode, aggregation=agg, batch_rows=rows,\n"
        "                    cache_opt=co, count_dtype=jnp.int64)\n"
        "                for f in ('total', 'per_u', 'per_v', 'per_edge'):\n"
        "                    v = getattr(r, f)\n"
        "                    if v is not None:\n"
        "                        res[f'{agg}.{mode}.{rows}.{co}.{f}'] = (\n"
        "                            np.asarray(v))\n"
        "np.savez(sys.argv[1], **res)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                   check=True, timeout=600)
    return dict(np.load(out))


@pytest.mark.parametrize("cache_opt", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("mode", ["global", "all"])
@pytest.mark.parametrize("aggregation", AGGS)
def test_batch_matches_reference_int64(reference_int64, aggregation, mode,
                                       rows, cache_opt):
    _, g = graphs()
    got = count_butterflies(g, mode=mode, aggregation=aggregation,
                            batch_rows=rows, cache_opt=cache_opt,
                            count_dtype=torch.int64, device="cpu")
    for f in MODE_FIELDS[mode]:
        want = reference_int64[f"{aggregation}.{mode}.{rows}.{cache_opt}.{f}"]
        a = np.asarray(getattr(got, f))
        assert want.dtype == a.dtype == np.int64, f
        assert np.array_equal(a, want), f


@pytest.mark.parametrize("target", [1, 64, 1 << 14])
@pytest.mark.parametrize("cache_opt", [False, True])
def test_count_from_ranked_batch_target_matches_reference(target,
                                                          cache_opt):
    """``count_from_ranked``'s ``batch_target`` bounds the wedge-aware
    blocks: a heavy vertex alone, small blocks, or the default; the
    rank-space outputs equal the reference's."""
    ref_g, g = graphs()
    rrg = ref_preprocess(ref_g, ref_make_order(ref_g, "degree"))
    rg = preprocess(g, make_order(g, "degree", device="cpu"))
    kw = dict(aggregation="batch_wa", mode="all", batch_rows=5,
              batch_target=target, cache_opt=cache_opt)
    want = ref_count_from_ranked(rrg, **kw)
    got = count_from_ranked(rg, device="cpu", **kw)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.int32


@pytest.mark.parametrize("seed", range(3))
def test_batch_bounds_equal_reference(seed):
    rng = np.random.default_rng(seed)
    wv = rng.integers(0, 200, 500) * (rng.random(500) < 0.6)
    wv[rng.integers(0, 500, 3)] = 5_000  # heavy vertices
    for aware in (False, True):
        for rows in (1, 3, 8, 64):
            for target in (1, 100, 1 << 14):
                got = _batch_bounds(wv, 500, aware, rows, target)
                want = ref_batch_bounds(wv, 500, aware, rows, target)
                assert np.array_equal(got[0], want[0]) and got[1] == want[1]
