"""The wing subtract of the port's device wing engine
(``kernels.ops.wing_subtract``) on the CPU, where it runs its plain
version ``kernels.ref.wing_subtract_ref``.

The oracle is independent of the flat-id recovery: the host engine's
butterfly location (``core.peel._wing_triples``, level-1 and level-2
numpy expansion) finds a round's butterflies, and ``np.add.at`` takes 1
from each of their three other edges. Counts must be equal, integer
for integer, in int32 and in int64, whatever the tiles.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import count_butterflies, peel_wings  # noqa: E402
from repro_torch.core.peel import (  # noqa: E402
    _csr,
    _wing_graph,
    _wing_triples,
    _wing_work_totals,
)
from repro_torch.core.pipeline import prefix_offsets  # noqa: E402
from repro_torch.core.wedges import degree_sorted_csr  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the wing graphs of tests/test_torch_peel.py
GRAPHS = {
    "peel_small": ("powerlaw_bipartite", (600, 500, 4_000), 7),
    "random": ("random_bipartite", (150, 120, 1_500), 3),
}


class Round:
    """One wing round of a graph: the static arrays, the counts, an
    alive set with a fifth of the edges already peeled, and a peel set
    of every alive edge at or below the alive counts' 15th percentile
    (many ties, so the ``x > a`` rule decides which peeled edge owns a
    butterfly)."""

    def __init__(self, name):
        gen, shape, seed = GRAPHS[name]
        g = getattr(graphs, gen)(*shape, seed=seed)
        self.g = g
        off, nbr, uid = _csr(g)
        _eu, _ev, _l1, l2 = _wing_work_totals(g, off, nbr)
        self.wg = _wing_graph(g, (off, nbr, uid),
                              degree_sorted_csr(off, nbr, uid), "cpu")
        self.locate = _wing_triples(g, off, nbr, uid)
        self.counts = np.asarray(count_butterflies(
            g, mode="edge", count_dtype=torch.int64, device="cpu").per_edge)
        rng = np.random.default_rng(seed)
        self.alive = rng.random(g.m) >= 0.2
        kappa = np.quantile(self.counts[self.alive], 0.15)
        self.peel = self.alive & (self.counts <= kappa)
        self.ids = np.flatnonzero(self.peel)
        self.l2 = l2[self.ids]
        self.roff = prefix_offsets(torch.as_tensor(self.l2))
        self.total = int(self.roff[-1])

    def want(self, dtype):
        alive, peel = self.alive, self.peel

        def present(x, a):
            return alive[x] & (~peel[x] | (x > a))

        a2, tri = self.locate(self.ids, present)
        assert a2.size > 0 and np.unique(a2).size > 1
        out = self.counts.astype(dtype)
        np.add.at(out, tri.reshape(-1), -1)
        return out

    def run(self, dtype, bounds):
        b = torch.as_tensor(self.counts.astype(dtype))
        before = dict(ops.LAUNCHES)
        for ts, te in bounds:
            got = ops.wing_subtract(
                b, ts, te, self.roff, torch.as_tensor(self.ids),
                torch.as_tensor(self.alive), torch.as_tensor(self.peel),
                self.wg)
            assert got is b
        assert ops.LAUNCHES == before  # a CPU tensor launches no kernel
        return b.numpy()


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def rnd(request):
    return Round(request.param)


def _cut_inside_edge(r):
    """Two tiles cut strictly inside the triple space of the peeled edge
    with the largest one."""
    j = int(np.argmax(r.l2))
    assert r.l2[j] >= 2
    cut = int(r.roff[j]) + int(r.l2[j]) // 2
    return [(0, cut), (cut, r.total)]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("tiles", ["whole", "cut_inside_edge", "odd_97",
                                   "empty"])
def test_wing_subtract_matches_host_triples(rnd, tiles, dtype):
    """One whole tile, two tiles cut inside one edge's space, 97-lane
    tiles, and empty tiles (which change nothing) against the host
    engine's triples."""
    if tiles == "whole":
        bounds = [(0, rnd.total)]
    elif tiles == "cut_inside_edge":
        bounds = _cut_inside_edge(rnd)
    elif tiles == "odd_97":
        bounds = [(s, min(s + 97, rnd.total))
                  for s in range(0, rnd.total, 97)]
    else:
        bounds = [(0, 0), (rnd.total // 2, rnd.total // 2),
                  (rnd.total, rnd.total)]
    got = rnd.run(dtype, bounds)
    assert got.dtype == dtype
    want = rnd.counts.astype(dtype) if tiles == "empty" else rnd.want(dtype)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("aggregation", ["sort", "hash"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_device_wings_equal_host_wings(name, aggregation):
    """The device engine (the wing subtract a tile) and the host engine
    (numpy triples, one scatter a round) give the same numbers, rounds
    and round sizes, whatever the aggregation knob."""
    gen, shape, seed = GRAPHS[name]
    g = getattr(graphs, gen)(*shape, seed=seed)
    want = peel_wings(g, engine="host", device="cpu")
    got = peel_wings(g, engine="device", aggregation=aggregation,
                     device="cpu")
    assert got.report.final_rung == "device"
    assert np.array_equal(got.numbers, want.numbers)
    assert (got.rounds, got.sub_rounds) == (want.rounds, want.sub_rounds)
    assert np.array_equal(got.round_sizes, want.round_sizes)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shift", [2**31, 2**31 + 12_345, 3 * 2**32])
def test_wing_subtract_shifted_past_int32(rnd, shift, dtype):
    """``roff``, ``ts`` and ``te`` moved past 2^31 by one int64 base (a
    round's space placed anywhere in a decomposition's): the same counts
    as at their own place, tile for tile."""
    bounds = [(s, min(s + 97, rnd.total)) for s in range(0, rnd.total, 97)]
    want = rnd.run(dtype, bounds)
    b = torch.as_tensor(rnd.counts.astype(dtype))
    roff = rnd.roff + shift
    for ts, te in bounds:
        ops.wing_subtract(b, ts + shift, te + shift, roff,
                          torch.as_tensor(rnd.ids),
                          torch.as_tensor(rnd.alive),
                          torch.as_tensor(rnd.peel), rnd.wg)
    assert np.array_equal(b.numpy(), want)
    assert np.array_equal(want, rnd.want(dtype))
