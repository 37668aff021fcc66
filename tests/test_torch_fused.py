"""``repro_torch.core.count_butterflies`` against the reference package's
``repro.core.count_butterflies``, bit for bit in value and dtype, for
the fused engines (reference ``fused``/``fused_pallas``, port
``fused``/``fused_cuda``, whose kernel takes its plain PyTorch version
on the CPU), and the fused ladder under injected faults."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import repro.core as ref_core  # noqa: E402
from repro.testing import faults as ref_faults  # noqa: E402
from repro_torch.core import BipartiteGraph, count_butterflies  # noqa: E402
from repro_torch.core import count as count_mod  # noqa: E402
from repro_torch.core import resilience  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from torch_parity import assert_same, check_mode, rand_edges  # noqa: E402


@pytest.mark.parametrize("ref_engine", ["fused", "fused_pallas"])
@pytest.mark.parametrize("cache_opt", [False, True])
@pytest.mark.parametrize("aggregation", ["sort", "hash", "histogram", "auto"])
@pytest.mark.parametrize("mode", ["global", "vertex", "edge", "all"])
def test_fused_engines_match_reference(ref_engine, cache_opt, aggregation,
                                       mode):
    """A forced multi-tile plan (max_chunk=64); under fused_pallas the
    reference runs its Pallas kernel in interpret mode and the port its
    fused kernel's plain version."""
    check_mode((30, 25, 160, 1), ref_engine, mode, aggregation, cache_opt,
               max_chunk=64)


def _outcomes(report):
    return [(a.rung, a.outcome, a.retries) for a in report.attempts]


@pytest.mark.parametrize("kind,site,times,params", [
    ("capacity_overflow", "count.{engine}", None, {}),
    ("poison", "ops.fused_count_tiles", None, {}),
    ("oom", "count.{engine}", 1, {}),
    ("oom", "count.{engine}", None, {}),
    ("hash_overflow", "count.", None, {"bits": 2}),
])
def test_ladder_under_faults_matches_reference(kind, site, times, params):
    """The same fault on the reference's fused_pallas ladder and the
    port's fused_cuda ladder: the same rungs fire with the same
    outcomes (names mapped), and the counts still match bit for bit."""
    e = rand_edges(20, 16, 90, 3)
    kw = dict(mode="all", aggregation="hash", max_chunk=128,
              resilience=ref_core.ResiliencePolicy(backoff_base_s=0.0))
    with ref_faults.inject(kind, site=site.format(engine="fused_pallas"),
                           times=times, **params):
        want = ref_core.count_butterflies(
            ref_core.BipartiteGraph(20, 16, e), engine="fused_pallas", **kw)
    kw["resilience"] = resilience.ResiliencePolicy(backoff_base_s=0.0)
    with faults.inject(kind, site=site.format(engine="fused_cuda"),
                       times=times, **params) as f:
        got = count_butterflies(BipartiteGraph(20, 16, e),
                                engine="fused_cuda", device="cpu", **kw)
    assert f.fired >= 1
    assert_same(got, want, kind)
    mapped = [(count_mod.ENGINE_MAP[r], o, n)
              for r, o, n in _outcomes(want.report)]
    assert _outcomes(got.report) == mapped
