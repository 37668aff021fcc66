"""The port's device wing engine past int32 triple indexing, on the CPU.

The fused path indexes no decomposition total: a round's flat triple
ids start at 0 and its ``roff`` prefix, tile bounds and flat ids are
int64. So a decomposition whose triple space L passes 2^31 stays on the
``device`` rung, and what still refuses a graph is what really is
32-bit: the counts, the edge slots and, under ``subtract="materialize"``,
the expansion totals.

Graph 500 Kronecker graphs (the benchmark's generator) at SCALE 6-8 with
a tile budget small enough that most rounds take several
``wing_subtract`` tiles; the port's host engine and the benchmark's
plain reference (``perfbench/reference/wings.py``) are the oracles.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.core.peel as peel  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BipartiteGraph,
    count_butterflies,
    peel_wings,
)
from repro_torch.core.peel import _csr, _wing_work_totals  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))  # the benchmark's generator
from perfbench.generator import cell_graph  # noqa: E402
from perfbench.reference.wings import wing_numbers  # noqa: E402

# SCALE -> a tile budget under most rounds' triple space
TILE_BUDGET = {6: 128, 7: 256, 8: 1024}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Kron:
    """A Graph 500 graph at ``scale``, its int64 per-edge counts, the
    host engine's exact and range decompositions and the plain
    reference's wing numbers."""

    def __init__(self, scale):
        cfg = {"SCALE": scale, "edgefactor": 16,
               "initiator": {"A": 0.57, "B": 0.19, "C": 0.19}}
        n_u, n_v, e = cell_graph(cfg, 2**31 + scale)
        self.g = BipartiteGraph(n_u, n_v, e)
        self.counts = np.asarray(count_butterflies(
            self.g, mode="edge", count_dtype=torch.int64,
            device="cpu").per_edge)
        self.host = {m: peel_wings(self.g, counts=self.counts, peel_mode=m,
                                   device="cpu") for m in ("exact", "range")}
        self.plain = wing_numbers(n_u, n_v, e, self.counts)
        l2 = _wing_work_totals(self.g, *_csr(self.g)[:2])[3]
        self.triples = int(l2.sum())


@pytest.fixture(scope="module", params=sorted(TILE_BUDGET))
def kron(request):
    return request.param, Kron(request.param)


def _recorded_tiles(monkeypatch):
    """Wrap ``ops.wing_subtract``: each call's round (its ``roff``, kept
    alive so no two rounds share an id) and bounds."""
    calls = []
    orig = ops.wing_subtract

    def spy(counts, ts, te, roff, *args):
        calls.append((roff, ts, te))
        return orig(counts, ts, te, roff, *args)

    monkeypatch.setattr(ops, "wing_subtract", spy)
    return calls


@pytest.mark.parametrize("peel_mode", ["exact", "range"])
@pytest.mark.parametrize("decrease_key", ["bucket", "scatter"])
def test_multi_tile_rounds_equal_host_and_plain(kron, decrease_key,
                                                peel_mode, monkeypatch):
    """A tile budget below most rounds' triple space: the device engine
    gives the host engine's numbers, rounds, sub-rounds and round sizes
    and the plain reference's numbers, and ``multi_tile_rounds`` counts
    the rounds that called the wing subtract two or more times."""
    scale, k = kron
    calls = _recorded_tiles(monkeypatch)
    got = peel_wings(k.g, counts=k.counts, engine="device",
                     decrease_key=decrease_key, peel_mode=peel_mode,
                     tile_budget=TILE_BUDGET[scale], device="cpu")
    want = k.host[peel_mode]
    assert got.report.final_rung == "device"
    assert np.array_equal(got.numbers, want.numbers)
    assert np.array_equal(got.numbers, k.plain.numbers.numpy())
    assert (got.rounds, got.sub_rounds) == (want.rounds, want.sub_rounds)
    assert got.sub_rounds == k.plain.rounds
    assert np.array_equal(got.round_sizes, want.round_sizes)
    per_round = {}
    for roff, ts, te in calls:
        assert 0 <= ts < te <= int(roff[-1])
        per_round[id(roff)] = per_round.get(id(roff), 0) + 1
    multi = sum(n >= 2 for n in per_round.values())
    c = got.report.counters
    assert c["multi_tile_rounds"] == multi > 0
    assert c["tiles"] == len(calls) > len(per_round)


def test_default_tiles_take_no_round_twice(kron):
    """At the default tile target (2^20 lanes) no round of these small
    graphs takes a second tile: the counter is there and reads 0."""
    _scale, k = kron
    got = peel_wings(k.g, counts=k.counts, engine="device", device="cpu")
    assert got.report.counters["multi_tile_rounds"] == 0
    assert np.array_equal(got.numbers, k.host["exact"].numbers)


def _attempts(r):
    return [(a.rung, a.outcome, a.detail) for a in r.report.attempts]


def test_counts_beyond_int32_take_the_host_rung(kron):
    """Counts at INT32_MAX or above: κ and the carried min are int32."""
    _scale, k = kron
    wide = k.counts + 2**31
    got = peel_wings(k.g, counts=wide, engine="device", device="cpu")
    assert got.report.final_rung == "host"
    (rung, outcome, detail), _host = _attempts(got)
    assert (rung, outcome) == ("device", "unavailable")
    assert "counts beyond int32" in detail
    want = peel_wings(k.g, counts=wide, device="cpu")
    assert np.array_equal(got.numbers, want.numbers)


def test_edge_slots_beyond_int32_take_the_host_rung(kron, monkeypatch):
    """2m edge slots at the limit (the limit lowered to 2m, above every
    count): the per-edge count's CSR holds int32 offsets and ids."""
    _scale, k = kron
    assert int(k.counts.max()) < 2 * k.g.m
    monkeypatch.setattr(peel, "_I32_MAX", 2 * k.g.m)
    got = peel_wings(k.g, counts=k.counts, engine="device", device="cpu")
    assert got.report.final_rung == "host"
    assert "edge slots beyond int32" in _attempts(got)[0][2]
    assert np.array_equal(got.numbers, k.host["exact"].numbers)


@pytest.mark.parametrize("schedule", ["fixed", "adaptive"])
def test_triple_space_past_the_limit_stays_on_the_fused_path(
        kron, schedule, monkeypatch):
    """The limit lowered to the graph's triple space L (above every
    count and the edge slots): the fused path still answers on the
    device rung, with the host engine's numbers, rounds and round sizes;
    the materializing path, whose one tile a round is sized by int32
    capacities, descends to the host rung."""
    _scale, k = kron
    assert max(int(k.counts.max()), 2 * k.g.m) < k.triples
    monkeypatch.setattr(peel, "_I32_MAX", k.triples)
    want = k.host["exact"]
    fused = peel_wings(k.g, counts=k.counts, engine="device",
                       capacity_schedule=schedule, device="cpu")
    assert fused.report.final_rung == "device"
    assert np.array_equal(fused.numbers, want.numbers)
    assert fused.rounds == want.rounds
    assert np.array_equal(fused.round_sizes, want.round_sizes)
    mat = peel_wings(k.g, counts=k.counts, engine="device",
                     subtract="materialize", capacity_schedule=schedule,
                     device="cpu")
    assert mat.report.final_rung == "host"
    assert "materialized expansion totals" in _attempts(mat)[0][2]
    assert np.array_equal(mat.numbers, want.numbers)
