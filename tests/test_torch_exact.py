"""Exactness of the port's counts beyond the parity matrix: agreement
with the dense oracle on every engine, counts above 2^31 on K_{320,320}
against closed forms, int64 parity with the reference package under
x64, the refusal of int32 counts that leave the int32 range (where the
reference wraps), and the rule that an entry point never runs on the
CPU unasked."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402

from repro_torch.core import BipartiteGraph, count_butterflies  # noqa: E402
from repro_torch.core import count as count_mod  # noqa: E402
from repro_torch.core import oracle  # noqa: E402
from repro_torch.core.graph import preprocess  # noqa: E402
from repro_torch.core.ranking import make_order  # noqa: E402
from repro_torch.core.resilience import AccumulatorOverflowRisk  # noqa: E402
from repro_torch.data.graphs import powerlaw_bipartite  # noqa: E402
from torch_parity import FIELDS, rand_edges  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("engine", count_mod.ENGINES)
def test_engines_agree_with_oracle(seed, engine):
    g = BipartiteGraph(18, 15, rand_edges(18, 15, 90, seed))
    r = count_butterflies(g, mode="all", engine=engine, max_chunk=48,
                          count_dtype=torch.int64, device="cpu")
    pu, pv = oracle.per_vertex_counts(g)
    assert int(r.total) == oracle.global_count(g)
    assert np.array_equal(r.per_u, pu) and np.array_equal(r.per_v, pv)
    assert np.array_equal(r.per_edge, oracle.per_edge_counts(g))
    assert r.total.dtype == np.int64


@pytest.fixture
def one_thread():
    """The suite runs in several worker processes at once: keep this
    test's 16M-wedge torch work on one core instead of oversubscribing
    the machine with intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_complete_bipartite_counts_above_int32(one_thread):
    """K_{320,320}: the total C(a,2) C(b,2) = 2,605,081,600 needs int64;
    per-vertex (a-1) C(b,2) and per-edge (a-1)(b-1) are closed forms.
    Its 16M wedges run through the fused_cuda engine (the fused kernel's
    plain version here); tests/test_torch_cuda.py runs the same graph
    through the kernels on the card."""
    a = b = 320
    e = np.stack([np.repeat(np.arange(a), b), np.tile(np.arange(b), a)], 1)
    g = BipartiteGraph(a, b, e, on_duplicate="assume_unique")
    r = count_butterflies(g, mode="all", engine="fused_cuda",
                          max_chunk=1 << 20, count_dtype=torch.int64,
                          device="cpu")
    c2 = lambda x: x * (x - 1) // 2  # noqa: E731
    assert int(r.total) == c2(a) * c2(b) > 2**31
    assert r.per_u.dtype == np.int64
    assert (r.per_u == (b - 1) * c2(a)).all()
    assert (r.per_v == (a - 1) * c2(b)).all()
    assert (r.per_edge == (a - 1) * (b - 1)).all()


def test_int64_counts_match_reference_under_x64(tmp_path):
    """The reference's 64-bit paths need jax_enable_x64; it is set in a
    subprocess so the flag never reaches this process."""
    out = tmp_path / "ref.npz"
    script = (
        "import sys, numpy as np, jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import jax.numpy as jnp\n"
        "from repro.core import count_butterflies\n"
        "from repro.data.graphs import powerlaw_bipartite\n"
        "g = powerlaw_bipartite(400, 300, 4000, seed=11)\n"
        "res = {}\n"
        "for eng in ('xla', 'pallas', 'fused', 'fused_pallas'):\n"
        "    r = count_butterflies(g, mode='all', engine=eng,\n"
        "                          aggregation='hash', max_chunk=2048,\n"
        "                          count_dtype=jnp.int64)\n"
        "    for f in ('total', 'per_u', 'per_v', 'per_edge'):\n"
        "        res[eng + '.' + f] = np.asarray(getattr(r, f))\n"
        "np.savez(sys.argv[1], **res)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                   check=True, timeout=300)
    ref = np.load(out)
    g = powerlaw_bipartite(400, 300, 4000, seed=11)
    for ref_engine, engine in count_mod.ENGINE_MAP.items():
        r = count_butterflies(g, mode="all", engine=engine,
                              aggregation="hash", max_chunk=2048,
                              count_dtype=torch.int64, device="cpu")
        for f in FIELDS:
            want = ref[f"{ref_engine}.{f}"]
            got = np.asarray(getattr(r, f))
            assert want.dtype == got.dtype == np.int64, (engine, f)
            assert np.array_equal(got, want), (engine, f)


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = BipartiteGraph(10, 8, rand_edges(10, 8, 30, 0))
    rg = preprocess(g, make_order(g, "degree"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        count_butterflies(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        count_mod.count_from_ranked(rg, engine="fused_cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_order(g, "approx_complement_degeneracy_device")
    # asked for, the host runs
    assert count_butterflies(g, device="cpu").total is not None


def test_default_count_dtype_is_int64():
    assert count_mod.default_count_dtype() is torch.int64


def test_unported_aggregations_raise():
    """An aggregation neither package has is refused; the batch
    aggregations run only on the ``torch`` engine, as the reference's
    only on ``xla``: any other engine raises ValueError."""
    g = BipartiteGraph(10, 8, rand_edges(10, 8, 30, 0))
    with pytest.raises(ValueError, match="aggregation"):
        count_butterflies(g, aggregation="bucketed", device="cpu")
    for agg in ("batch", "batch_wa"):
        for engine in ("cuda", "fused", "fused_cuda"):
            with pytest.raises(ValueError, match="engine='torch'"):
                count_butterflies(g, aggregation=agg, engine=engine,
                                  device="cpu")
        assert int(count_butterflies(g, aggregation=agg,
                                     device="cpu").total) == \
            oracle.global_count(g)


# K_{2,65537}: every butterfly is the one pair of U vertices with a pair
# of the 65,537 V vertices, C(65537, 2) = 2,147,516,416 > INT32_MAX in
# the total and in both U counts; V and edge counts are 65,536.
K2_B = 65537
K2_TOTAL = K2_B * (K2_B - 1) // 2


def _k2_edges():
    return np.stack([np.repeat(np.arange(2), K2_B),
                     np.tile(np.arange(K2_B), 2)], 1)


@functools.lru_cache(maxsize=None)
def _k2_reference(mode):
    """The reference's default int32 counts of K_{2,65537}."""
    g = ref_core.BipartiteGraph(2, K2_B, _k2_edges(),
                                on_duplicate="assume_unique")
    return ref_core.count_butterflies(g, mode=mode, engine="fused")


@pytest.mark.parametrize("mode", ["global", "vertex", "edge", "all"])
@pytest.mark.parametrize("engine", count_mod.ENGINES)
def test_int32_counts_refuse_instead_of_wrapping(engine, mode):
    """``count_dtype=None`` (int32) on a graph whose total and U counts
    leave int32: the reference returns a wrong int32 value, the port
    raises naming the value and the dtype. Its per-edge counts fit, and
    there the port's int32 result equals the reference's bit for bit."""
    want = _k2_reference(mode)
    g = BipartiteGraph(2, K2_B, _k2_edges(), on_duplicate="assume_unique")
    if mode == "edge":
        got = count_butterflies(g, mode=mode, engine=engine, device="cpu")
        assert got.per_edge.dtype == want.per_edge.dtype == np.int32
        assert np.array_equal(got.per_edge, want.per_edge)
        assert (got.per_edge == K2_B - 1).all()
        return
    wrapped = want.total if mode != "vertex" else want.per_u
    assert np.asarray(wrapped).dtype == np.int32
    assert (np.asarray(wrapped) != K2_TOTAL).all()  # a silent wrong answer
    with pytest.raises(AccumulatorOverflowRisk,
                       match=f"{K2_TOTAL} does not fit .*int32"):
        count_butterflies(g, mode=mode, engine=engine, device="cpu")
    # int64, asked for, is exact
    r = count_butterflies(g, mode=mode, engine=engine, device="cpu",
                          count_dtype=torch.int64)
    assert int((r.per_u if mode == "vertex" else r.total).max()) == K2_TOTAL


# The reference's int32 total of K_{310,310}: count_butterflies(g,
# engine="fused") on the JAX package without x64 returns C(310, 2)^2 =
# 2,293,931,025 wrapped modulo 2^32 (pinned, not recomputed here, to
# keep the file short; K_{2,65537} above runs the reference live).
K310_REFERENCE_INT32 = -2_001_036_271


def test_k310_int32_count_refuses(one_thread):
    a = 310
    total = (a * (a - 1) // 2) ** 2
    assert K310_REFERENCE_INT32 == total - 2**32
    e = np.stack([np.repeat(np.arange(a), a), np.tile(np.arange(a), a)], 1)
    g = BipartiteGraph(a, a, e, on_duplicate="assume_unique")
    with pytest.raises(AccumulatorOverflowRisk, match=f"{total} does not fit"):
        count_butterflies(g, engine="fused_cuda", device="cpu")
