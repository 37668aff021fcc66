"""The port's counting and peeling kernels (plain PyTorch versions, the
path ``kernels/ops`` takes for CPU tensors) against the reference
package's Pallas kernels in interpret mode and its jnp references, on
seeded numpy inputs. Integer outputs must agree bit for bit (tolerance
0); the reference's 64-bit values come as (lo, hi) int32 limbs and are
recombined in numpy. JAX runs without x64 here, so the int64 peeling
contracts (clamp, no wrap) are held against the reference on the
clamped int32 values and against numpy on the int64 ones."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import make_order as ref_make_order  # noqa: E402
from repro.core import preprocess as ref_preprocess  # noqa: E402
from repro.core.wedges import device_graph as ref_device_graph  # noqa: E402
from repro.data.graphs import powerlaw_bipartite as ref_powerlaw  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.bucket_min import bucket_min_pallas  # noqa: E402
from repro.kernels.bucket_update import (  # noqa: E402
    bit_length as ref_bit_length,
    bucket_update_pallas,
    bucket_upper_bound as ref_bucket_upper_bound,
    lowest_nonempty_bucket as ref_lowest_nonempty_bucket,
)
from repro_torch.core.graph import RankedGraph  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    fused_host_inputs,
    fused_tile_inputs,
    plan_count,
)
from repro_torch.core.wedges import device_graph, host_wedge_counts  # noqa: E402
from repro_torch.kernels import cuda as kcuda  # noqa: E402
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


def test_wedge_histogram_drops_wide_int64_keys():
    """An int64 key at or above 2^31 is out of range, never wrapped into
    it (2^32 + 3 would wrap to 3 through an int32 cast)."""
    keys = torch.tensor([3, 2**32 + 3, 2**31, -(2**32) + 5, 5], dtype=torch.int64)
    got = ops.wedge_histogram(keys, torch.ones(5, dtype=torch.bool), 8)
    assert got.tolist() == [0, 0, 0, 1, 0, 1, 0, 0]


S14 = 1 << 14  # kcuda.HIST_PART_BITS: the histogram's bins per block


# (num_buckets, regime, parts, last_bins, coarse, coarse_bits, offsets,
#  scratch bytes) for the hash path's 77,453,696 keys on a 132-SM card:
# 264 count/scatter blocks, 6 B of scratch per key plus 8 B per offset.
@pytest.mark.parametrize(
    "num_buckets,regime,parts,last_bins,coarse,coarse_bits,offsets,scratch", [
        (1, "shared", 1, 1, 1, 0, 0, 0),
        (S14 - 1, "shared", 1, S14 - 1, 1, 0, 0, 0),
        (S14, "shared", 1, S14, 1, 0, 0, 0),
        (S14 + 1, "partitioned", 2, 1, 2, 0, 534, 464_726_448),
        (1 << 20, "partitioned", 64, S14, 64, 0, 17_026, 464_858_384),
        ((1 << 22) + 1, "partitioned", 257, 1, 129, 1, 34_444, 464_997_728),
        (1 << 28, "partitioned", 16_384, S14, 256, 6, 84_226, 465_395_984),
        (2**31 - 1, "partitioned", 131_072, S14 - 1, 256, 9, 198_914,
         466_313_488),
    ])
def test_wedge_histogram_plan(num_buckets, regime, parts, last_bins, coarse,
                              coarse_bits, offsets, scratch):
    """The histogram's regime, partitions and scratch at S = 2^14 bins."""
    plan = kcuda.histogram_plan(num_buckets, 77_453_696, 132)
    assert plan == kcuda.HistogramPlan(
        regime, parts, num_buckets if regime == "shared" else S14, last_bins,
        coarse, coarse_bits, 132 if regime == "shared" else 264, offsets,
        scratch)


def test_wedge_histogram_plan_within_kernel_limits():
    """Every plan stays inside the shared-memory tables that the C entry
    checks (at most 512 coarse groups of at most 512 partitions) and
    covers the table exactly, for every table size from 2^14 + 1 to
    2^31 - 1."""
    sizes = [(1 << b) + d for b in range(14, 31) for d in (-1, 0, 1)]
    for num_buckets in sizes[1:] + [2**31 - 1]:
        plan = kcuda.histogram_plan(num_buckets, 1000, 132)
        fine = 1 << plan.coarse_bits
        assert plan.coarse <= 512 and fine <= 512
        assert (plan.coarse - 1) * fine < plan.parts <= plan.coarse * fine
        assert (plan.parts - 1) * plan.part_bins + plan.last_bins == num_buckets
        assert 0 < plan.last_bins <= plan.part_bins


def test_wedge_histogram_plan_rejects_bad_sizes():
    for bad in (-1, 0, 2**31):
        with pytest.raises(ValueError, match="num_buckets"):
            kcuda.histogram_plan(bad, 10, 132)


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


def _synthetic_csr(slot_wedges, slots_per_vertex):
    """CSR offsets and the wedge prefix of a made-up graph, from each
    slot's wedge count and each vertex's slot count."""
    offsets = np.concatenate([[0], np.cumsum(slots_per_vertex)]).astype(np.int32)
    w_off = np.concatenate([[0], np.cumsum(slot_wedges)]).astype(np.int64)
    return offsets, w_off


def test_fused_work_splits_light_and_heavy_at_the_threshold():
    """Seven vertices, one tile: v0 (6,000 + 4,000 wedges) and v1
    (4,000) pack into one light batch; v2 (20,000, across a zero slot)
    and v6 (14,337) are heavy; v3 has no wedges; v4 holds exactly
    FUSED_LIGHT_CAP = 14,336 wedges and is light, a batch of its own,
    and v5's one wedge starts the next. Both heavy vertices fit one
    round (2 counters of 7 entries); a round of 34,337 wedges on 132
    SMs gets the smallest chunk, 256 wedges."""
    assert kcuda.FUSED_LIGHT_CAP == 14_336
    offsets, w_off = _synthetic_csr(
        [6000, 4000, 4000, 10000, 0, 10000, 0, 14336, 1, 14337],
        [2, 1, 3, 1, 1, 1, 1])
    work = kcuda.fused_work(np.array([[0, 62_674]]), offsets, w_off, 132)
    assert work.light.tolist() == [[0, 14_000, 0, 3],
                                   [34_000, 48_336, 7, 8],
                                   [48_336, 48_337, 8, 9]]
    heavy = work.heavy.tolist()
    assert len(heavy) == 79 + 57
    assert heavy[0] == [14_000, 14_256, 3, 4, 0]
    assert heavy[39] == [23_984, 24_240, 3, 6, 0]  # spans the zero slot 4
    assert heavy[78] == [33_968, 34_000, 5, 6, 0]
    assert heavy[79] == [48_337, 48_593, 9, 10, 1]
    assert heavy[135] == [62_673, 62_674, 9, 10, 1]
    assert work.rounds.tolist() == [0, 136]
    assert (work.in_flight, work.scratch_bytes) == (2, 2 * 8 * 7)
    assert work.device is None


def test_fused_work_rounds_respect_the_l2_budget():
    """n_pad = 2^20: a counter is 8 MiB, so a segment of 262,144 wedges
    or more can touch all of it, and three fill the 24 MiB budget. The
    heavy segments, largest first: 700k, 600k, 500k in round 0; 400k,
    300k, then 20k (640,000 B of sectors) and 15k (480,000 B) still fit
    round 1. Chunks: ceil(1.8M / 1,056) = 1,705 wedges in round 0, ceil(
    735,000 / 1,056) = 697 in round 1."""
    assert kcuda.FUSED_L2_BYTES == 24 << 20
    n_pad = 1 << 20
    wedges = np.zeros(n_pad, np.int64)
    wedges[:7] = [20_000, 300_000, 700_000, 15_000, 500_000, 400_000,
                  600_000]
    offsets, w_off = _synthetic_csr(wedges, np.ones(n_pad, np.int64))
    work = kcuda.fused_work(np.array([[0, 2_535_000]]), offsets, w_off, 132)
    assert work.light.shape == (0, 4)
    assert work.rounds.tolist() == [0, 411 + 352 + 294,
                                    411 + 352 + 294 + 574 + 431 + 29 + 22]
    heavy = work.heavy
    r0, r1 = heavy[:1057], heavy[1057:]
    assert heavy[0].tolist() == [320_000, 321_705, 2, 3, 0]  # v2, 700k
    assert sorted(set(r0[:, 4].tolist())) == [0, 1, 2]
    assert sorted(set(r1[:, 4].tolist())) == [0, 1, 2, 3]
    assert r1[0].tolist() == [1_535_000, 1_535_697, 5, 6, 0]  # v5, 400k
    assert r1[-1].tolist() == [1_034_637, 1_035_000, 3, 4, 3]  # v3, 15k
    assert (work.in_flight, work.scratch_bytes) == (4, 4 * 8 * n_pad)


def test_fused_work_keeps_one_counter_in_flight_when_it_outgrows_l2():
    """n_pad = 2^22: one counter (32 MiB) is larger than the budget, so
    each heavy segment is a round of its own, cut into chunks of
    ceil(3M / 1,056) = 2,841 and ceil(2M / 1,056) = 1,894 wedges."""
    n_pad = 1 << 22
    wedges = np.zeros(n_pad, np.int64)
    wedges[[5, 9]] = [2_000_000, 3_000_000]
    offsets, w_off = _synthetic_csr(wedges, np.ones(n_pad, np.int64))
    work = kcuda.fused_work(np.array([[0, 5_000_000]]), offsets, w_off, 132)
    assert work.rounds.tolist() == [0, 1056, 2112]
    assert work.heavy[0].tolist() == [2_000_000, 2_002_841, 9, 10, 0]
    assert work.heavy[1056].tolist() == [0, 1_894, 5, 6, 0]
    assert (work.in_flight, work.scratch_bytes) == (1, 8 * n_pad)


@pytest.mark.parametrize("direction", ["low", "high"])
@pytest.mark.parametrize("tiles", ["plan", "cut_empty_and_repeated"])
def test_fused_work_covers_every_wedge_of_every_tile_once(direction, tiles):
    """Every wedge of every tile lies in exactly one light batch or heavy
    chunk (a repeated tile counts twice, as the plain version counts
    it); every row's slot range brackets its wedges; a round never puts
    two segments on one counter."""
    g = ref_powerlaw(300, 250, 3000, seed=5)
    ref_rg = ref_preprocess(g, ref_make_order(g, "degree"), "degree")
    rg = RankedGraph.from_arrays(**vars(ref_rg))
    wv = host_wedge_counts(rg, direction)
    plan = plan_count(rg, mode="all", direction=direction, budget=512,
                      wv_slots=wv)
    tb, w_off = fused_host_inputs(plan, rg.offsets, wv)
    w = int(w_off[-1])
    if tiles == "cut_empty_and_repeated":
        tb = np.array([[0, 0], [0, w // 3], [w // 3, w], [w, w],
                       [w // 5, w // 2]], np.int64)
    work = kcuda.fused_work(tb, rg.offsets, w_off, 132)
    rows = np.concatenate([work.light, work.heavy[:, :4]])
    got = np.sort(np.concatenate([np.arange(a, b) for a, b, _l, _h in rows]))
    want = np.sort(np.concatenate([np.arange(a, b) for a, b in tb]))
    assert np.array_equal(got, want)
    assert (w_off[rows[:, 2]] <= rows[:, 0]).all()
    assert (w_off[rows[:, 3]] >= rows[:, 1]).all()
    assert ((work.light[:, 1] - work.light[:, 0]) <= kcuda.FUSED_LIGHT_CAP).all()
    src = rg.edge_src
    for r in range(work.rounds.shape[0] - 1):
        chunk = work.heavy[work.rounds[r]:work.rounds[r + 1]]
        owner = {}
        for t0, _t1, e_lo, _e_hi, buf in chunk.tolist():
            assert owner.setdefault(buf, src[e_lo]) == src[e_lo]
    assert ops.fused_work(tb, rg.offsets, w_off, CPU) is None


def test_ctypes_signatures_match_the_c_entries():
    """Each exported C entry takes exactly the arguments its ctypes
    signature lists, the stream last; a missing one would truncate the
    stream pointer."""
    import re

    text = "".join((kcuda.CSRC / name).read_text() for name in kcuda.SOURCES)
    for name, argtypes in kcuda._SIGNATURES.items():
        m = re.search(rf"BF_EXPORT int {name}\(([^)]*)\)", text)
        assert m is not None, name
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), name
        assert params[-1] == "void* stream", name


def test_wrappers_refuse_other_devices():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken."""
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        ops.wedge_histogram(keys, keys, 8)
    with pytest.raises(ValueError, match="not supported"):
        ops.butterfly_combine(keys, keys, keys)
    with pytest.raises(ValueError, match="not supported"):
        ops.bucket_min(keys, keys)
    with pytest.raises(ValueError, match="not supported"):
        ops.bucket_update(keys, keys, keys, keys)


I32_MAX = np.iinfo(np.int32).max


def _bucket_inputs(n, k, seed, wide=False, p_alive=0.6):
    """Seeded peeling-kernel inputs: counts (int64 up to 2^40 when
    ``wide``, else int32 below 2^30 with a few negatives), an alive
    mask, and a decrease-key batch whose targets straddle ``[0, n)``
    (negatives, the ``n`` sentinel and beyond are all dropped)."""
    rng = np.random.default_rng(seed)
    if wide:
        c = rng.integers(-5, 1 << 40, n).astype(np.int64)
        c[: min(n, 3)] = np.array([I32_MAX, I32_MAX + 1, 7])[: min(n, 3)]
    else:
        c = rng.integers(-5, 1 << 30, n).astype(np.int32)
    alive = (rng.random(n) < p_alive).astype(np.int32)
    idx = rng.integers(-3, n + 4, k).astype(np.int32)
    idx[: min(k, 2)] = np.array([n, -1])[: min(k, 2)]
    dec = rng.integers(0, 1 << 20, k).astype(c.dtype)
    return c, alive, idx, dec


def _hist_oracle(v64, alive):
    bl = np.array([max(int(x), 0).bit_length() for x in v64], np.int64)
    return np.bincount(bl, weights=alive, minlength=32).astype(np.int64)


@pytest.mark.parametrize("n,seed,p_alive", [
    (1, 0, 0.5), (700, 1, 0.5), (2049, 2, 0.0), (4096, 3, 0.9),
])
def test_bucket_min_matches_pallas(n, seed, p_alive):
    c, alive, _, _ = _bucket_inputs(n, 0, seed, p_alive=p_alive)
    want = bucket_min_pallas(jnp.asarray(c), jnp.asarray(alive))
    want_ref = ref_ref.bucket_min_ref(jnp.asarray(c), jnp.asarray(alive))
    before = dict(ops.LAUNCHES)
    got = ops.bucket_min(torch.as_tensor(c), torch.as_tensor(alive))
    assert ops.LAUNCHES == before  # a CPU tensor launches no kernel
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want) == int(want_ref)
    if not alive.any():
        assert int(got) == I32_MAX


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_min_int64_clamps(seed):
    """int64 counts are clamped to INT32_MAX, not wrapped: the result
    equals the reference on the clamped int32 values; with only wide
    counts alive the min is INT32_MAX itself."""
    c, alive, _, _ = _bucket_inputs(3000, 0, seed, wide=True)
    c32 = np.minimum(c, I32_MAX).astype(np.int32)
    want = ref_ref.bucket_min_ref(jnp.asarray(c32), jnp.asarray(alive))
    got = ops.bucket_min(torch.as_tensor(c), torch.as_tensor(alive))
    assert int(got) == int(want)
    only_wide = (c >= I32_MAX).astype(np.int32)
    assert int(ops.bucket_min(torch.as_tensor(c),
                              torch.as_tensor(only_wide))) == I32_MAX
    assert int(ops.bucket_min(torch.as_tensor(c[:0]),
                              torch.as_tensor(alive[:0]))) == I32_MAX


@pytest.mark.parametrize("n,k,seed", [
    (1, 1, 0), (500, 64, 1), (1500, 300, 2), (4096, 4096, 3),
])
def test_bucket_update_matches_pallas(n, k, seed):
    c, alive, idx, dec = _bucket_inputs(n, k, seed)
    args = [jnp.asarray(x) for x in (c, alive, idx, dec)]
    want = bucket_update_pallas(*args)
    want_ref = ref_ref.bucket_update_ref(*args)
    got = ops.bucket_update(*(torch.as_tensor(x) for x in (c, alive, idx,
                                                             dec)))
    for a, b, r in zip(got, want, want_ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(a.numpy(), np.asarray(r))
    new, mn, hist = got
    assert new.dtype == torch.int32 and mn.dtype == torch.int32
    assert hist.dtype == torch.int32 and hist.shape == (32,)
    keep = (idx >= 0) & (idx < n)
    exp = c.astype(np.int64)
    np.subtract.at(exp, idx[keep], dec[keep].astype(np.int64))
    assert np.array_equal(new.numpy().astype(np.int64), exp)
    assert np.array_equal(hist.numpy(), _hist_oracle(exp, alive))


@pytest.mark.parametrize("n,k,seed", [(1, 0, 0), (3000, 0, 1),
                                      (3000, 5000, 2), (257, 9000, 3)])
def test_bucket_update_int64_and_unbounded_batch(n, k, seed):
    """int64 counts stay int64 and exact; the min and histogram follow
    the clamp contract (held against the reference on the clamped
    values); an empty batch and a batch above the TPU kernel's
    4096-entry cap both work."""
    c, alive, idx, dec = _bucket_inputs(n, k, seed, wide=True)
    new, mn, hist = ops.bucket_update(*(torch.as_tensor(x) for x in (
        c, alive, idx, dec)))
    keep = (idx >= 0) & (idx < n)
    exp = c.copy()
    np.subtract.at(exp, idx[keep], dec[keep])
    assert new.dtype == torch.int64 and np.array_equal(new.numpy(), exp)
    exp32 = np.minimum(exp, I32_MAX).astype(np.int32)
    want_mn, want_hist = ref_ref.bucket_state_ref(jnp.asarray(exp32),
                                                  jnp.asarray(alive))
    assert int(mn) == int(want_mn)
    assert np.array_equal(hist.numpy(), np.asarray(want_hist))
    state = ops.bucket_state(new, torch.as_tensor(alive))
    assert int(state[0]) == int(mn) and torch.equal(state[1], hist)


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_state_matches_reference(seed):
    c, alive, _, _ = _bucket_inputs(2500, 0, seed)
    mn, hist = ops.bucket_state(torch.as_tensor(c), torch.as_tensor(alive))
    want_mn, want_hist = ref_ops.bucket_state(jnp.asarray(c),
                                              jnp.asarray(alive))
    assert int(mn) == int(want_mn)
    assert np.array_equal(hist.numpy(), np.asarray(want_hist))


def test_bucket_helpers_match_reference():
    v = np.array([-7, 0, 1, 2, 3, 4, 1023, 1024, 1 << 30, I32_MAX], np.int32)
    assert np.array_equal(ops.bit_length(torch.as_tensor(v)).numpy(),
                          np.asarray(ref_bit_length(jnp.asarray(v))))
    for k in (0, 1, 5, 30, 31, 32):
        assert ops.bucket_upper_bound(k) == int(
            ref_bucket_upper_bound(jnp.int32(k)))
    rng = np.random.default_rng(4)
    for _ in range(5):
        h = (rng.random(32) < 0.2).astype(np.int32) * rng.integers(1, 9, 32)
        assert int(ops.lowest_nonempty_bucket(torch.as_tensor(h))) == int(
            ref_lowest_nonempty_bucket(jnp.asarray(h, jnp.int32)))
    assert int(ops.lowest_nonempty_bucket(
        torch.zeros(32, dtype=torch.int32))) == ops.NUM_BUCKETS
