"""The port's plan layer and wedge retrieval against the reference:
per-slot wedge counts, the materialized wedges, chunk planning, and the
``WedgePlan`` dict (field for field, with the engine name mapped), plus
the reference's golden plan snapshot, read only."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import wedges as ref_wedges  # noqa: E402
from repro.core.graph import preprocess as ref_preprocess  # noqa: E402
from repro.core.ranking import make_order as ref_make_order  # noqa: E402
from repro.data.graphs import powerlaw_bipartite as ref_powerlaw  # noqa: E402
from repro_torch.core import pipeline, wedges  # noqa: E402
from repro_torch.core.count import ENGINE_MAP  # noqa: E402
from repro_torch.core.graph import RankedGraph  # noqa: E402
from repro_torch.data.graphs import powerlaw_bipartite  # noqa: E402
from repro_torch.core.graph import preprocess  # noqa: E402
from repro_torch.core.ranking import make_order  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")


def _ranked(order="degree", args=(300, 200, 2500), seed=2):
    g = ref_powerlaw(*args, seed=seed)
    ref_rg = ref_preprocess(g, ref_make_order(g, order), order_name=order)
    return ref_rg, RankedGraph.from_arrays(**vars(ref_rg))


@pytest.mark.parametrize("direction", ["low", "high"])
@pytest.mark.parametrize("order", ["degree", "side"])
def test_wedge_counts_and_wedges_match_reference(direction, order):
    ref_rg, rg = _ranked(order)
    want = ref_wedges.host_wedge_counts(ref_rg, direction)
    assert np.array_equal(wedges.host_wedge_counts(rg, direction), want)
    dg = wedges.device_graph(rg, CPU)
    rdg = ref_wedges.device_graph(ref_rg)
    cnt = wedges.slot_wedge_counts(dg, direction)
    assert np.array_equal(
        cnt.numpy(), np.asarray(ref_wedges.slot_wedge_counts(rdg, direction))
    )
    w_cap = int(want.sum()) + 77  # padding lanes get the sentinels
    got = wedges.gather_wedges(dg, cnt, w_cap, direction)
    ref = ref_wedges.gather_wedges(
        rdg, ref_wedges.slot_wedge_counts(rdg, direction), w_cap, direction
    )
    for field in ref._fields:
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(ref, field))), field


@pytest.mark.parametrize("budget", [64, 1000, 1 << 18])
@pytest.mark.parametrize("direction", ["low", "high"])
def test_plan_wedge_chunks_matches_reference(budget, direction):
    ref_rg, rg = _ranked()
    rb, rc = ref_wedges.plan_wedge_chunks(ref_rg, direction, budget)
    pb, pc = wedges.plan_wedge_chunks(rg, direction, budget)
    assert np.array_equal(pb, rb) and pc == rc


@pytest.mark.parametrize("engine", sorted(ENGINE_MAP))
@pytest.mark.parametrize("aggregation", ["sort", "hash", "auto"])
@pytest.mark.parametrize("mode,direction,budget", [
    ("all", "low", 256), ("global", "high", 4096), ("vertex", "low", 1),
])
def test_plan_dict_matches_reference(engine, aggregation, mode, direction,
                                     budget):
    ref_rg, rg = _ranked()
    ref_plan = ref_pipeline.plan_count(
        ref_rg, mode=mode, direction=direction, aggregation=aggregation,
        budget=budget, engine=engine, dtype="int32",
    )
    plan = pipeline.plan_count(
        rg, mode=mode, direction=direction, aggregation=aggregation,
        budget=budget, engine=ENGINE_MAP[engine], dtype=torch.int32,
    )
    want = ref_plan.to_dict()
    want["engine"] = ENGINE_MAP[engine]
    assert plan.to_dict() == want
    assert plan.summary() == ref_plan.summary().replace(
        f"engine={engine}", f"engine={ENGINE_MAP[engine]}")
    # the reference's dict is taken as it is, and round-trips
    again = pipeline.WedgePlan.from_dict(ref_plan.to_dict())
    assert again.to_dict() == ref_plan.to_dict()
    assert pipeline.WedgePlan.from_json(plan.to_json()) == plan
    for n in (1, 3, 64):
        ref_parts = ref_pipeline.plan_partition(ref_plan, n)
        parts = pipeline.plan_partition(plan, n)
        assert [p.to_dict() | {"engine": engine} for p in parts] == \
            [p.to_dict() for p in ref_parts]


def test_golden_plan_snapshot():
    """The reference's pinned pl_small plan, read only: the port's
    planner reproduces it byte for byte."""
    g = powerlaw_bipartite(2_000, 1_500, 12_000, seed=1)
    rg = preprocess(g, make_order(g, "degree"))
    plan = pipeline.plan_count(rg, mode="all", aggregation="auto",
                               budget=4096, engine="fused")
    with open(os.path.join(HERE, "data", "golden_plan_pl_small.json")) as f:
        golden = json.load(f)
    assert plan.to_dict() == golden


def test_auto_chunk_budget_off_the_card_is_the_reference_default():
    assert wedges.auto_chunk_budget(CPU) == wedges.DEFAULT_CHUNK_BUDGET
    assert wedges.DEFAULT_CHUNK_BUDGET == ref_wedges.DEFAULT_CHUNK_BUDGET
    for b, s in ((4096, 0), (4096, 3), (1000, 9)):
        assert wedges.shrink_budget(b, s) == ref_wedges.shrink_budget(b, s)


def test_degree_sorted_csr_matches_reference():
    ref_rg, rg = _ranked()
    n = 2 * rg.m
    args = (rg.offsets.astype(np.int64), rg.neighbors[:n].astype(np.int64),
            rg.undirected_id[:n].astype(np.int64))
    for a, b in zip(wedges.degree_sorted_csr(*args),
                    ref_wedges.degree_sorted_csr(*args)):
        assert np.array_equal(a, np.asarray(b))


def test_combine_helpers_match_reference():
    d = np.array([0, 1, 2, 5, 70_000, 2**31 - 1], np.int32)
    want = np.asarray(ref_pipeline.choose2(jnp.asarray(d), jnp.int32))
    got = pipeline.choose2(torch.as_tensor(d), torch.int32)
    assert np.array_equal(got.numpy(), want)
