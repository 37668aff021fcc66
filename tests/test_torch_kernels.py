"""The port's three counting kernels (plain PyTorch versions, the path
``kernels/ops`` takes for CPU tensors) against the reference package's
Pallas kernels in interpret mode, on seeded numpy inputs. Integer
outputs must agree bit for bit (tolerance 0); the reference's 64-bit
values come as (lo, hi) int32 limbs and are recombined in numpy."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import make_order as ref_make_order  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.core.wedges import device_graph as ref_device_graph  # noqa: E402
from repro.data.graphs import powerlaw_bipartite as ref_powerlaw  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core.graph import RankedGraph  # noqa: E402
from repro_torch.core.pipeline import fused_tile_inputs, plan_count  # noqa: E402
from repro_torch.core.wedges import device_graph, host_wedge_counts  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CPU = torch.device("cpu")


def limbs_to_int64(lo, hi):
    lo = np.asarray(lo).astype(np.uint32).astype(np.int64)
    return lo + (np.asarray(hi).astype(np.int64) << 32)


@pytest.mark.parametrize("n,buckets,seed", [
    (1, 1, 0), (700, 37, 1), (1500, 600, 2), (2049, 1024, 3),
])
def test_wedge_histogram_matches_pallas(n, buckets, seed):
    rng = np.random.default_rng(seed)
    # keys straddle both ends of [0, buckets): out-of-range keys drop
    keys = rng.integers(-20, buckets + 20, n).astype(np.int32)
    valid = rng.integers(0, 2, n).astype(np.int32)
    want = ref_ops.wedge_histogram(jnp.asarray(keys), jnp.asarray(valid),
                                   buckets, use_pallas=True)
    before = dict(ops.LAUNCHES)
    got = ops.wedge_histogram(torch.as_tensor(keys), torch.as_tensor(valid),
                              buckets)
    assert ops.LAUNCHES == before  # a CPU tensor launches no kernel
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,dmax,seed", [
    (5, 10, 0), (1000, 70_000, 1), (3000, 2**31 - 1, 2),
])
def test_butterfly_combine_matches_pallas(n, dmax, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, dmax, n, endpoint=True).astype(np.int32)
    d[: min(n, 4)] = np.array([0, 1, 2**31 - 1, 65536], np.int32)[: min(n, 4)]
    rep = rng.integers(0, 2, n).astype(np.int32)
    valid = rng.integers(0, 2, n).astype(np.int32)
    dm1_r, lo_r, hi_r, _tot = ref_ops.butterfly_combine(
        jnp.asarray(d), jnp.asarray(rep), jnp.asarray(valid), use_pallas=True
    )
    dm1, c2 = ops.butterfly_combine(torch.as_tensor(d), torch.as_tensor(rep),
                                    torch.as_tensor(valid))
    assert dm1.dtype == torch.int32 and c2.dtype == torch.int64
    assert np.array_equal(dm1.numpy(), np.asarray(dm1_r))
    assert np.array_equal(c2.numpy(), limbs_to_int64(lo_r, hi_r))
    # the limb split itself, as the reference kernel emits it
    live = (valid > 0) & (rep > 0) & (d > 0)
    lo, hi = ref.choose2_limbs(torch.as_tensor(np.where(live, d, 0)))
    assert np.array_equal(lo.numpy(), np.asarray(lo_r))
    assert np.array_equal(hi.numpy(), np.asarray(hi_r))


@pytest.mark.parametrize("direction", ["low", "high"])
def test_fused_count_tiles_matches_pallas(direction):
    """The fused tile kernel's plain version against the reference's
    fused Pallas kernel on one multi-tile plan, every mode: the same
    graph, the same plan, the reference's limbs recombined."""
    g = ref_powerlaw(40, 30, 160, seed=4)
    ref_rg = ref_preprocess(g, ref_make_order(g, "degree"), "degree")
    rg = RankedGraph.from_arrays(**vars(ref_rg))
    wv = host_wedge_counts(rg, direction)
    plan = plan_count(rg, mode="all", direction=direction, budget=64,
                      wv_slots=wv)
    assert plan.n_tiles >= 2 and plan.chunk_cap <= 512
    tb, w_off = fused_tile_inputs(plan, rg.offsets, wv, CPU)
    dg = device_graph(rg, CPU)
    rdg = ref_device_graph(ref_rg)
    for mode in ("global", "vertex", "edge", "all"):
        tot, vert, edge = ref_ops.fused_count_tiles(
            jnp.asarray(tb.astype(np.int32)), rdg.offsets, rdg.neighbors,
            rdg.edge_src, rdg.undirected_id,
            jnp.asarray(w_off.numpy().astype(np.int32)),
            tile_cap=512, n_pad=rdg.n_pad, m=rdg.m, direction=direction,
            mode=mode, use_pallas=True,
        )
        got = ops.fused_count_tiles(
            tb, dg.offsets, dg.neighbors, dg.edge_src, dg.undirected_id,
            w_off, tile_cap=plan.chunk_cap, n_pad=dg.n_pad, m=dg.m,
            direction=direction, mode=mode,
        )
        tot = np.asarray(tot)
        want = (limbs_to_int64(tot[0], tot[1]),
                limbs_to_int64(np.asarray(vert)[:, 0], np.asarray(vert)[:, 1]),
                limbs_to_int64(np.asarray(edge)[:, 0], np.asarray(edge)[:, 1]))
        for a, b in zip(got, want):
            assert a.dtype == torch.int64
            assert np.array_equal(a.numpy(), b), (direction, mode)


def test_fused_count_tiles_rejects_tile_over_cap():
    g = ref_powerlaw(40, 30, 160, seed=4)
    ref_rg = ref_preprocess(g, ref_make_order(g, "degree"), "degree")
    rg = RankedGraph.from_arrays(**vars(ref_rg))
    wv = host_wedge_counts(rg, "low")
    plan = plan_count(rg, mode="all", budget=64, wv_slots=wv)
    tb, w_off = fused_tile_inputs(plan, rg.offsets, wv, CPU)
    dg = device_graph(rg, CPU)
    widest = int((tb[:, 1] - tb[:, 0]).max())
    with pytest.raises(ValueError, match="tile_cap"):
        ops.fused_count_tiles(
            tb, dg.offsets, dg.neighbors, dg.edge_src, dg.undirected_id,
            w_off, tile_cap=widest - 1, n_pad=dg.n_pad, m=dg.m,
        )


def test_wrappers_refuse_other_devices():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken."""
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        ops.wedge_histogram(keys, keys, 8)
    with pytest.raises(ValueError, match="not supported"):
        ops.butterfly_combine(keys, keys, keys)
