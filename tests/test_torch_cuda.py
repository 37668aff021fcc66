"""Card tests of the port's hand-written CUDA kernels.

Every test here needs an NVIDIA card: the ``card`` fixture skips when
there is none, so on a CPU-only host they all skip. On the card run
them with ``python -m pytest -m cuda tests/test_torch_cuda.py``. Each
kernel is held against its plain PyTorch version on the same inputs,
bit for bit (integer outputs, tolerance 0), and the counting engines on
the card against the plain ``torch`` engine on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import count_butterflies  # noqa: E402
from repro_torch.core.graph import BipartiteGraph, preprocess  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    fused_tile_inputs,
    plan_count,
)
from repro_torch.core.ranking import make_order  # noqa: E402
from repro_torch.core.wedges import device_graph, host_wedge_counts  # noqa: E402
from repro_torch.data.graphs import powerlaw_bipartite  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def test_wedge_histogram_kernel_matches_plain(card):
    rng = np.random.default_rng(0)
    n, buckets = 300_000, 5_000
    keys = torch.as_tensor(rng.integers(-50, buckets + 50, n), dtype=torch.int32,
                           device=card)
    valid = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.int32,
                            device=card)
    before = ops.LAUNCHES["wedge_histogram"]
    got = ops.wedge_histogram(keys, valid, buckets)
    assert ops.LAUNCHES["wedge_histogram"] == before + 1
    _equal([got], [ref.wedge_histogram_ref(keys, valid, buckets)])


def test_butterfly_combine_kernel_matches_plain(card):
    rng = np.random.default_rng(1)
    n = 200_000
    d = rng.integers(0, 2**31 - 1, n)
    d[:4] = [0, 1, 2**31 - 1, 65536]
    d = torch.as_tensor(d, dtype=torch.int32, device=card)
    rep = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.bool, device=card)
    valid = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.bool,
                            device=card)
    _equal(ops.butterfly_combine(d, rep, valid),
           ref.butterfly_combine_ref(d, rep, valid))


@pytest.mark.parametrize("direction", ["low", "high"])
@pytest.mark.parametrize("mode", ["global", "vertex", "edge", "all"])
@pytest.mark.parametrize("budget", [512, 1 << 18])
def test_fused_count_tiles_kernel_matches_plain(card, direction, mode,
                                                budget):
    g = powerlaw_bipartite(3000, 2000, 20000, seed=3)
    rg = preprocess(g, make_order(g, "degree"), "degree")
    dg = device_graph(rg, card)
    wv = host_wedge_counts(rg, direction)
    plan = plan_count(rg, mode=mode, direction=direction, budget=budget,
                      engine="fused_cuda", wv_slots=wv)
    tb, w_off = fused_tile_inputs(plan, rg.offsets, wv, card)
    args = (tb, dg.offsets, dg.neighbors, dg.edge_src, dg.undirected_id,
            w_off)
    kw = dict(n_pad=dg.n_pad, m=dg.m, direction=direction, mode=mode)
    got = ops.fused_count_tiles(*args, tile_cap=plan.chunk_cap, **kw)
    want = ref.fused_count_tiles_ref(torch.as_tensor(tb), *args[1:], **kw)
    _equal(got, want)


@pytest.mark.parametrize("engine,aggregation", [
    ("torch", "sort"), ("torch", "hash"), ("cuda", "hash"),
    ("cuda", "histogram"), ("fused", "auto"), ("fused_cuda", "sort"),
])
@pytest.mark.parametrize("cache_opt", [False, True])
def test_engines_on_card_match_cpu(card, engine, aggregation, cache_opt):
    rng = np.random.default_rng(5)
    e = np.stack([rng.integers(0, 120, 2500), rng.integers(0, 90, 2500)], 1)
    g = BipartiteGraph(120, 90, e)
    kw = dict(mode="all", count_dtype=torch.int64, cache_opt=cache_opt,
              max_chunk=700)
    want = count_butterflies(g, engine="torch", device="cpu", **kw)
    ops.reset_launches()
    got = count_butterflies(g, engine=engine, aggregation=aggregation,
                            device=card, **kw)
    assert got.report.final_rung == engine
    for field in ("total", "per_u", "per_v", "per_edge"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    if engine == "fused_cuda":
        assert ops.LAUNCHES["fused_count_tiles"] > 0
    if engine == "cuda":
        assert ops.LAUNCHES["wedge_histogram"] > 0
        assert ops.LAUNCHES["butterfly_combine"] > 0


@pytest.mark.parametrize("engine", ["cuda", "fused_cuda"])
def test_complete_bipartite_above_int32_on_card(card, engine):
    """K_{320,320}: C(a,2) C(b,2) = 2,605,081,600 > 2^31, and the
    per-vertex and per-edge closed forms, through the kernels."""
    a = b = 320
    e = np.stack([np.repeat(np.arange(a), b), np.tile(np.arange(b), a)], 1)
    g = BipartiteGraph(a, b, e, on_duplicate="assume_unique")
    r = count_butterflies(g, mode="all", engine=engine, aggregation="hash",
                          count_dtype=torch.int64, device=card)
    c2 = a * (a - 1) // 2
    assert r.report.final_rung == engine
    assert int(r.total) == c2 * c2 > 2**31
    assert (r.per_u == (b - 1) * c2).all() and (r.per_v == (a - 1) * c2).all()
    assert (r.per_edge == (a - 1) * (b - 1)).all()


def test_fused_cuda_capacity_overflow_descends_on_card(card):
    rng = np.random.default_rng(6)
    e = np.stack([rng.integers(0, 60, 900), rng.integers(0, 50, 900)], 1)
    g = BipartiteGraph(60, 50, e)
    want = count_butterflies(g, mode="all", engine="torch", device="cpu")
    with faults.inject("capacity_overflow", site="count.fused_cuda"):
        got = count_butterflies(g, mode="all", engine="fused_cuda",
                                device=card)
    assert [a.outcome for a in got.report.attempts] == [
        "capacity-overflow", "ok"]
    assert got.report.final_rung == "fused"
    for field in ("total", "per_u", "per_v", "per_edge"):
        assert np.array_equal(getattr(got, field), getattr(want, field))


def test_device_ranking_on_card(card):
    g = powerlaw_bipartite(800, 600, 5000, seed=2)
    host = make_order(g, "approx_complement_degeneracy")
    dev = make_order(g, "approx_complement_degeneracy_device", device=card)
    assert np.array_equal(host, dev)
