"""Exactness of the port's counts beyond the parity matrix: agreement
with the dense oracle on every engine, counts above 2^31 on K_{320,320}
against closed forms, int64 parity with the reference package under
x64, and the rule that an entry point never runs on the CPU unasked."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np  # noqa: E402

from repro_torch.core import BipartiteGraph, count_butterflies  # noqa: E402
from repro_torch.core import count as count_mod  # noqa: E402
from repro_torch.core import oracle  # noqa: E402
from repro_torch.core.graph import preprocess  # noqa: E402
from repro_torch.core.ranking import make_order  # noqa: E402
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
    g = BipartiteGraph(10, 8, rand_edges(10, 8, 30, 0))
    with pytest.raises(ValueError, match="aggregation"):
        count_butterflies(g, aggregation="batch", device="cpu")
