"""Card tests of the port's hand-written CUDA kernels and the peeling
engines that launch them.

Every test here needs an NVIDIA card: the ``card`` fixture skips when
there is none, so on a CPU-only host they all skip. On the card run
them with ``python -m pytest -m cuda tests/test_torch_cuda.py``. Each
kernel is held against its plain PyTorch version on the same inputs,
bit for bit (integer outputs, tolerance 0), and the counting engines on
the card against the plain ``torch`` engine on the CPU.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import (  # noqa: E402
    count_butterflies,
    peel_tips,
    peel_tips_stored,
    peel_wings,
)
from repro_torch.core.graph import BipartiteGraph, preprocess  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    fused_host_inputs,
    fused_tile_inputs,
    plan_count,
)
from repro_torch.core.ranking import make_order  # noqa: E402
from repro_torch.core.wedges import device_graph, host_wedge_counts  # noqa: E402
from repro_torch.data.graphs import powerlaw_bipartite  # noqa: E402
from repro_torch.kernels import cuda as kcuda  # noqa: E402
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


S = 1 << kcuda.HIST_PART_BITS  # the histogram's shared-memory bins per block


def _dirty(card, n, dtype=torch.int32):
    """Leave a freed block of ``n`` garbage entries in the caching
    allocator, so an output the kernel fails to write shows."""
    torch.full((n,), -7, dtype=dtype, device=card)


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("num_buckets", [1, S - 1, S, S + 1, 1 << 20,
                                         256 * S + 1, 1 << 28])
def test_wedge_histogram_regimes_match_plain(card, num_buckets, key_dtype):
    """Both regimes (at most S buckets: shared; above: partitioned, with
    one partition per coarse group up to 256 partitions and more above
    it), with negative keys,
    keys >= num_buckets and, for int64, keys >= 2^31 that an int32 cast
    would wrap into range."""
    rng = np.random.default_rng(num_buckets % 9973)
    n = 400_000
    keys = rng.integers(-50, num_buckets + 50, n)
    if key_dtype == torch.int64:
        keys[::97] = (1 << 32) + rng.integers(0, num_buckets, keys[::97].size)
        keys[1::89] = rng.integers(1 << 31, 1 << 40, keys[1::89].size)
    keys = torch.as_tensor(keys, dtype=key_dtype, device=card)
    valid = torch.as_tensor(rng.random(n) < 0.7, device=card)
    _dirty(card, num_buckets)
    before = ops.LAUNCHES["wedge_histogram"]
    got = ops.wedge_histogram(keys, valid, num_buckets)
    assert ops.LAUNCHES["wedge_histogram"] == before + 1
    _equal([got], [ref.wedge_histogram_ref(keys, valid, num_buckets)])


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("num_buckets", [S - 1, 1 << 20, 1 << 28])
def test_wedge_histogram_skew_and_nothing_valid(card, num_buckets,
                                                key_dtype):
    rng = np.random.default_rng(11)
    n = 300_000
    part = min(5, (num_buckets - 1) // S)  # every key in one partition
    keys = torch.as_tensor(part * S + rng.integers(0, min(S, num_buckets), n),
                           dtype=key_dtype, device=card)
    keys = torch.clamp(keys, max=num_buckets - 1)
    valid = torch.ones(n, dtype=torch.bool, device=card)
    for v in (valid, torch.zeros_like(valid), valid[:0]):
        k = keys[: v.numel()]
        _dirty(card, num_buckets)
        _equal([ops.wedge_histogram(k, v, num_buckets)],
               [ref.wedge_histogram_ref(k, v, num_buckets)])
    _dirty(card, num_buckets)
    assert not ops.wedge_histogram(keys, torch.zeros_like(valid),
                                   num_buckets).any()


@pytest.mark.parametrize("part_bits,coarse_bits,num_buckets,blocks", [
    (16, 0, 1 << 20, 4),       # S = 2^16 bins: 256 KiB of shared memory
    (1, 0, 100, 4),
    (14, 10, 1 << 28, 4),      # F = 1024 partitions per coarse group
    (14, 0, (1 << 23) + 1, 4),  # C = 513 coarse groups
    (14, 6, 1 << 28, 0),
])
def test_wedge_histogram_entry_rejects_out_of_limits(card, part_bits,
                                                     coarse_bits, num_buckets,
                                                     blocks):
    """The C entry checks the limits of its shared-memory tables itself,
    so a plan that outgrows them is an error, not an overrun."""
    lib = kcuda.build()
    buf = torch.zeros(1 << 20, dtype=torch.int64, device=card)
    p = kcuda._ptr(buf)
    code = lib.bf_wedge_histogram(p, 1, p, 0, num_buckets, part_bits,
                                  coarse_bits, blocks, p, p, p, p,
                                  torch.cuda.current_stream(card).cuda_stream)
    assert lib.bf_error_string(code).decode() == "invalid argument"


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


def _double_stars(hubs, leaves, spokes):
    """``hubs`` disjoint double stars: hub h joins its ``leaves`` V
    vertices, leaf i also joins spoke ``i % spokes`` of its hub. Under
    the degree order and ``direction="low"`` every wedge starts at a hub
    (``leaves`` wedges each)."""
    e = []
    for h in range(hubs):
        v = h * leaves + np.arange(leaves)
        e.append(np.stack([np.full(leaves, h), v], 1))
        e.append(np.stack([hubs + h * spokes + np.arange(leaves) % spokes,
                           v], 1))
    return BipartiteGraph(hubs * (1 + spokes), hubs * leaves,
                          np.concatenate(e))


@functools.lru_cache(maxsize=None)
def _work_graph(kind):
    """A ranked graph that drives one part of the fused kernel's work
    list (``direction="low"``): light batches only, one heavy hub split
    over many chunks, 40 hubs in three rounds (of at most 16 counters
    in flight), or both light and heavy work."""
    g = {
        "light": lambda: powerlaw_bipartite(800, 600, 5000, seed=2),
        "hub": lambda: _double_stars(1, 40_000, 50),
        "rounds": lambda: _double_stars(40, 15_000, 20),
        "mixed": lambda: powerlaw_bipartite(20_000, 15_000, 200_000, seed=7),
    }[kind]()
    return preprocess(g, make_order(g, "degree"), "degree")


@pytest.mark.parametrize("direction", ["low", "high"])
@pytest.mark.parametrize("mode", ["global", "vertex", "edge", "all"])
@pytest.mark.parametrize("kind", ["light", "hub", "rounds", "mixed",
                                  "empty_tiles"])
def test_fused_count_tiles_work_shapes_match_plain(card, kind, direction,
                                                   mode):
    """Each part of the redesigned kernel, bit for bit against the plain
    version: light shared-memory batches, a heavy segment over many
    blocks, heavy rounds that reuse their counters (which must come back
    zeroed), a mix, and tile bounds with empty tiles and a tile that cuts
    a vertex (grouped per tile, as the plain version groups)."""
    rg = _work_graph("mixed" if kind == "empty_tiles" else kind)
    dg = device_graph(rg, card)
    wv = host_wedge_counts(rg, direction)
    plan = plan_count(rg, mode=mode, direction=direction, budget=1 << 22,
                      engine="fused_cuda", wv_slots=wv)
    tb, w_off_h = fused_host_inputs(plan, rg.offsets, wv)
    if kind == "empty_tiles":
        w = int(w_off_h[-1])
        tb = np.array([[0, 0], [0, 777], [777, 777], [777, w // 2],
                       [w // 2, w], [w, w]], np.int64)
    work = ops.fused_work(tb, rg.offsets, w_off_h, card)
    if direction == "low":
        shape = {"light": (True, 0), "hub": (False, 1), "rounds": (False, 3),
                 "mixed": (True, 4)}.get(kind)
        if shape is not None:
            assert (work.light.shape[0] > 0, work.rounds.shape[0] - 1) == shape
        if kind == "hub":
            assert work.heavy.shape[0] > 100  # one segment, many blocks
    w_off = torch.as_tensor(w_off_h, device=card)
    args = (tb, dg.offsets, dg.neighbors, dg.edge_src, dg.undirected_id,
            w_off)
    kw = dict(n_pad=dg.n_pad, m=dg.m, direction=direction, mode=mode)
    cap = max(int((tb[:, 1] - tb[:, 0]).max()), 1)
    want = ref.fused_count_tiles_ref(torch.as_tensor(tb), *args[1:], **kw)
    before = ops.LAUNCHES["fused_count_tiles"]
    for _ in range(2):  # the second call finds the first's scratch reused
        _equal(ops.fused_count_tiles(*args, tile_cap=cap, work=work, **kw),
               want)
    assert ops.LAUNCHES["fused_count_tiles"] == before + 2


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


def _bucket_inputs(card, n, k, dtype, seed):
    rng = np.random.default_rng(seed)
    hi = 1 << 40 if dtype == torch.int64 else 1 << 30
    counts = torch.as_tensor(rng.integers(-5, hi, n), dtype=dtype,
                             device=card)
    alive = torch.as_tensor(rng.random(n) < 0.6, device=card)
    idx = torch.as_tensor(rng.integers(-3, n + 4, k), dtype=torch.int64,
                          device=card)
    dec = torch.as_tensor(rng.integers(0, 1 << 20, k), dtype=dtype,
                          device=card)
    return counts, alive, idx, dec


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 4097, 300_000])
def test_bucket_min_kernel_matches_plain(card, dtype, n):
    counts, alive, _, _ = _bucket_inputs(card, n, 0, dtype, 7)
    before = ops.LAUNCHES["bucket_min"]
    got = ops.bucket_min(counts, alive)
    assert ops.LAUNCHES["bucket_min"] == before + 1
    _equal([got], [ref.bucket_min_ref(counts, alive)])
    none = torch.zeros_like(alive)
    assert int(ops.bucket_min(counts, none)) == 2**31 - 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["ragged", "view", "view_counts_only",
                                  "nothing_alive", "wide_only",
                                  "empty"])
def test_bucket_min_edge_cases_match_plain(card, dtype, case):
    """One launch per call, bit for bit: lengths off the 16-element
    vector width, views whose data is not 16-byte aligned (the flags
    aligned with the counts or not), nothing alive, only counts above
    INT32_MAX alive (int64), an empty array. The kernel writes its own
    output (the allocator hands it a dirty block) and its cross-block
    scratch is clean again for the next call."""
    for n in (1, 15, 17, 45_000, 300_001):
        counts, alive, _, _ = _bucket_inputs(card, n, 0, dtype, n)
        if case == "view":
            counts, alive = counts[1:], alive[1:]
        elif case == "view_counts_only":
            counts, alive = counts[3:], alive[3:].clone()
        elif case == "nothing_alive":
            alive = torch.zeros_like(alive)
        elif case == "wide_only":  # int32: INT32_MAX itself
            counts = (counts.abs() + (2**31 - 1) if dtype == torch.int64
                      else torch.full_like(counts, 2**31 - 1))
        elif case == "empty":
            counts, alive = counts[:0], alive[:0]
        _dirty(card, 1)
        before = ops.LAUNCHES["bucket_min"]
        got = ops.bucket_min(counts, alive)
        assert ops.LAUNCHES["bucket_min"] == before + 1
        _equal([got], [ref.bucket_min_ref(counts, alive)])
        if case in ("nothing_alive", "wide_only", "empty"):
            assert int(got) == 2**31 - 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,k", [(1, 0), (5000, 1), (45_000, 70_000),
                                 (300_000, 4096)])
def test_bucket_update_kernel_matches_plain(card, dtype, n, k):
    args = _bucket_inputs(card, n, k, dtype, 8)
    before = ops.LAUNCHES["bucket_update"]
    got = ops.bucket_update(*args)
    assert ops.LAUNCHES["bucket_update"] == before + 1
    _equal(got, ref.bucket_update_ref(*args))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["nothing_alive", "empty_batch",
                                  "all_out_of_range", "one_index",
                                  "largest_batch"])
def test_bucket_update_edge_cases_match_plain(card, dtype, case):
    """One launch each, bit for bit; the kernel seeds its own min and
    bins (the allocator hands it a dirty block) and leaves its input
    unchanged."""
    n = 45_000
    k = {"empty_batch": 0, "one_index": 100_000,
         "largest_batch": 3_145_728}.get(case, 5_000)
    counts, alive, idx, dec = _bucket_inputs(card, n, k, dtype, 9)
    if case == "nothing_alive":
        alive = torch.zeros_like(alive)
    elif case == "all_out_of_range":
        idx = torch.as_tensor(
            np.random.default_rng(9).choice([-5, -1, n, n + 7, 1 << 40], k),
            dtype=torch.int64, device=card)
    elif case == "one_index":
        idx = torch.full((k,), 17, dtype=torch.int64, device=card)
        dec = torch.remainder(dec, 1024)
    kept = counts.clone()
    _dirty(card, 33)
    before = ops.LAUNCHES["bucket_update"]
    got = ops.bucket_update(counts, alive, idx, dec)
    assert ops.LAUNCHES["bucket_update"] == before + 1
    _equal(got, ref.bucket_update_ref(counts, alive, idx, dec))
    assert torch.equal(counts, kept)
    if case == "nothing_alive":
        assert int(got[1]) == 2**31 - 1 and not got[2].any()


@pytest.mark.parametrize("decrease_key,kernel", [("bucket", "bucket_update"),
                                                 ("scatter", "bucket_min")])
@pytest.mark.parametrize("peel_mode", ["exact", "range"])
def test_peel_device_on_card_launches_and_matches_cpu(card, decrease_key,
                                                      kernel, peel_mode):
    """The device peeling engines on the card, with default (int64)
    counts, launch their kernel and give the CPU port's numbers."""
    g = powerlaw_bipartite(600, 500, 4000, seed=7)
    for fn in (peel_tips, peel_wings):
        want = fn(g, engine="device", peel_mode=peel_mode, device="cpu")
        ops.reset_launches()
        got = fn(g, engine="device", decrease_key=decrease_key,
                 peel_mode=peel_mode, device=card)
        assert ops.LAUNCHES[kernel] > 0, fn.__name__
        assert got.report.final_rung == "device"
        assert got.numbers.dtype == np.int64
        assert np.array_equal(got.numbers, want.numbers), fn.__name__
        assert (got.rounds, got.sub_rounds) == (want.rounds, want.sub_rounds)
        assert np.array_equal(got.round_sizes, want.round_sizes)


def test_peel_wings_host_on_card_launches_bucket_min(card):
    g = powerlaw_bipartite(300, 250, 2000, seed=7)
    want = peel_wings(g, engine="host", device="cpu")
    ops.reset_launches()
    got = peel_wings(g, engine="host", device=card)
    assert ops.LAUNCHES["bucket_min"] == got.rounds > 0
    assert np.array_equal(got.numbers, want.numbers)


@pytest.mark.parametrize("kind,knobs,kernel", [
    ("stored", dict(decrease_key="bucket"), "bucket_update"),
    ("stored", dict(decrease_key="scatter", subtract="materialize",
                    capacity_schedule="adaptive"), "bucket_min"),
    ("tips", dict(decrease_key="scatter", subtract="materialize",
                  capacity_schedule="adaptive"), "bucket_min"),
    ("tips", dict(decrease_key="bucket", subtract="materialize",
                  peel_mode="range"), "bucket_update"),
    ("tips", dict(decrease_key="bucket", capacity_schedule="adaptive"),
     "bucket_update"),
    ("wings", dict(decrease_key="bucket", subtract="materialize",
                   capacity_schedule="adaptive"), "bucket_update"),
    ("wings", dict(decrease_key="scatter", subtract="materialize"),
     "bucket_min"),
])
def test_peel_new_paths_on_card_launch_and_match_cpu(card, kind, knobs,
                                                     kernel):
    """Stored-wedge tips, the materializing subtract and the adaptive
    schedule on the card launch their kernel and give the CPU port's
    numbers, rounds and capacity segments."""
    g = powerlaw_bipartite(600, 500, 4000, seed=7)
    fn = {"tips": peel_tips, "stored": peel_tips_stored,
          "wings": peel_wings}[kind]
    kw = dict(engine="device", **knobs)
    want = fn(g, device="cpu", **kw)
    ops.reset_launches()
    got = fn(g, device=card, **kw)
    assert ops.LAUNCHES[kernel] > 0
    assert got.report.final_rung == "device" and not got.report.degraded
    assert got.numbers.dtype == np.int64
    assert np.array_equal(got.numbers, want.numbers)
    assert (got.rounds, got.sub_rounds) == (want.rounds, want.sub_rounds)
    assert np.array_equal(got.round_sizes, want.round_sizes)
    assert got.report.segments == want.report.segments
    assert got.report.frontier_lanes == want.report.frontier_lanes


def test_stored_materialize_overflow_descends_on_card(card):
    g = powerlaw_bipartite(600, 500, 4000, seed=7)
    want = peel_tips_stored(g, device="cpu")
    got = peel_tips_stored(g, engine="device", subtract="materialize",
                           max_frontier=1, device=card)
    assert [(a.rung, a.outcome) for a in got.report.attempts] == [
        ("device", "capacity-overflow"), ("host", "ok")]
    assert np.array_equal(got.numbers, want.numbers)


@pytest.mark.parametrize("dtype", [None, torch.int64])
@pytest.mark.parametrize("cache_opt", [False, True])
@pytest.mark.parametrize("mode", ["global", "vertex", "edge", "all"])
@pytest.mark.parametrize("aggregation", ["batch", "batch_wa"])
def test_batch_on_card_matches_cpu(card, aggregation, mode, cache_opt, dtype):
    """The batch aggregations on the card (int32 and int64 counts) give
    the CPU port's counts."""
    g = powerlaw_bipartite(800, 600, 6000, seed=2)
    kw = dict(mode=mode, aggregation=aggregation, cache_opt=cache_opt,
              count_dtype=dtype, batch_rows=3)
    want = count_butterflies(g, device="cpu", **kw)
    got = count_butterflies(g, device=card, **kw)
    assert got.report.final_rung == "torch"
    for field in ("total", "per_u", "per_v", "per_edge"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if b is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("kw", [
    dict(method="edges", p=0.5, reps=3),
    dict(method="colorful", p=0.3, reps=2),
    dict(method="colorful", eps=0.2, reps=2),
    dict(method="sample", eps=0.1),
])
def test_approx_count_on_card_matches_cpu(card, kw):
    """The approximate tier on the card gives the CPU port's estimate
    bit for bit; each sparsified repetition launches the fused kernel
    once."""
    from repro_torch.core import approx_count

    g = powerlaw_bipartite(800, 600, 6000, seed=2)
    want = approx_count(g, seed=4, device="cpu", **kw)
    ops.reset_launches()
    got = approx_count(g, seed=4, device=card, **kw)
    for f in ("estimate", "stddev", "ci95", "p", "n_samples"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.report.estimator == want.report.estimator
    reps = 0 if kw["method"] == "sample" else kw["reps"]
    assert ops.LAUNCHES["fused_count_tiles"] == reps


def test_service_on_card_matches_cpu(card):
    """The query service on the card: count, peel and approximate
    queries give the CPU service's answers; a count query launches the
    fused kernel, a device peel query its bucket kernel, and a cache hit
    launches nothing."""
    from repro_torch.serve import ButterflyService, Query

    g1 = powerlaw_bipartite(800, 600, 6000, seed=2)
    g2 = powerlaw_bipartite(600, 500, 4000, seed=7)
    queries = [Query(graph="g1", mode=m)
               for m in ("global", "vertex", "edge", "all")]
    queries += [Query(graph="g2", kind=k, engine="device")
                for k in ("peel_tips", "peel_tips_stored", "peel_wings")]
    # g2's global count is not cached, so the sample rung answers
    queries += [Query(graph="g2", accuracy="approx", deadline_s=1e-6,
                      allow_stale=False)]
    out = {}
    for dev in ("cpu", card):
        with ButterflyService(workers=1, device=dev,
                              refine_approx=False) as svc:
            svc.register("g1", g1)
            svc.register("g2", g2)
            out[str(dev)] = []
            for q in queries:
                ops.reset_launches()
                r = svc.query(q)
                out[str(dev)].append((r, dict(ops.LAUNCHES)))
            ops.reset_launches()
            assert svc.query(queries[0]).service.cache == "hit"
            assert sum(ops.LAUNCHES.values()) == 0
    assert out[str(card)][-1][0].service.final_rung == "sample"
    for (want, _), (got, used) in zip(out["cpu"], out[str(card)]):
        assert got.service.rungs_tried == want.service.rungs_tried
        if got.service.approximate:
            assert got.result.estimate == want.result.estimate
            continue
        for f in ("total", "per_u", "per_v", "per_edge", "numbers"):
            a, b = getattr(got.result, f, None), getattr(want.result, f, None)
            assert (a is None) == (b is None), f
            if b is not None:
                assert np.array_equal(a, b), f
        if got.service.kind == "count":
            assert used["fused_count_tiles"] == 1
        else:
            assert used["bucket_update"] > 0
