"""``repro_torch.core.count_butterflies`` against the reference package's
``repro.core.count_butterflies``, bit for bit in value and dtype, for
the materializing engines (reference ``xla``/``pallas``, port
``torch``/``cuda``; the fused pair is in test_torch_fused.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

from torch_parity import assert_same, both, check_mode, rand_edges  # noqa: E402


@pytest.mark.parametrize("ref_engine", ["xla", "pallas"])
@pytest.mark.parametrize("cache_opt", [False, True])
@pytest.mark.parametrize("aggregation", ["sort", "hash", "histogram", "auto"])
@pytest.mark.parametrize("mode", ["global", "vertex", "edge", "all"])
def test_materializing_engines_match_reference(ref_engine, cache_opt,
                                               aggregation, mode):
    """A forced multi-tile plan (max_chunk=64 against 342 wedges)."""
    check_mode((30, 25, 160, 0), ref_engine, mode, aggregation, cache_opt,
               max_chunk=64)


@pytest.mark.parametrize("ref_engine", ["xla", "pallas"])
@pytest.mark.parametrize("aggregation", ["sort", "hash", "histogram"])
def test_materializing_whole_array_matches_reference(ref_engine, aggregation):
    """max_chunk=None: the whole wedge array in one batch."""
    e = rand_edges(24, 20, 120, 7)
    got, want = both(e, 24, 20, ref_engine, mode="all",
                     aggregation=aggregation)
    assert_same(got, want, (ref_engine, aggregation))
