"""The port's resilience layer against the reference's: the same
synthetic ladders (rungs that succeed, overflow, run out of memory,
return invalid results, or raise input errors) walk the same rungs with
the same outcomes and retries, and PyTorch's CUDA out-of-memory error
takes the shrink-retry path."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

from repro.core import resilience as ref_res  # noqa: E402
from repro_torch.core import resilience as res  # noqa: E402

# each script: per rung, the list of things its successive calls do
SCRIPTS = {
    "first rung ok": [["ok"]],
    "overflow descends": [["overflow"], ["ok"]],
    "oom retries then ok": [["oom", "oom", "ok"]],
    "oom exhausts retries": [["oom", "oom", "oom"], ["ok"]],
    "unavailable then invalid then ok": [["unavailable"], ["bad"], ["ok"]],
    "every rung invalid": [["bad"], ["bad"]],
    "every rung overflows": [["overflow"], ["overflow"]],
    "input error propagates": [["input"], ["ok"]],
}


def _walk(mod, script, oom_error):
    calls = []

    def rung(name, actions):
        def run(shrinks):
            calls.append((name, shrinks))
            act = actions[min(len(calls_of(name)) - 1, len(actions) - 1)]
            if act == "overflow":
                raise mod.CapacityOverflow("tile too big")
            if act == "unavailable":
                raise mod.RungUnavailable("not here")
            if act == "oom":
                raise oom_error("RESOURCE_EXHAUSTED: out of memory")
            if act == "input":
                raise mod.GraphValidationError("bad graph")
            return -1 if act == "bad" else 7
        return mod.Rung(name, run)

    def calls_of(name):
        return [c for c in calls if c[0] == name]

    policy = mod.ResiliencePolicy(backoff_base_s=0.0)
    rungs = [rung(f"r{i}", a) for i, a in enumerate(script)]
    try:
        out, report = policy.execute(
            "test", rungs, lambda v: "negative" if v < 0 else None)
        err = None
    except mod.ResilienceError as e:
        out, report, err = None, e.report, type(e).__name__
    trail = [(a.rung, a.outcome, a.retries, a.budget_shrinks)
             for a in report.attempts]
    return out, err, trail, report.final_rung, calls


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ladder_walk_matches_reference(name):
    want = _walk(ref_res, SCRIPTS[name], ref_res.ResourceExhausted)
    got = _walk(res, SCRIPTS[name], res.ResourceExhausted)
    assert got == want


def test_torch_cuda_oom_takes_the_shrink_retry_path():
    assert res.is_resource_exhausted(torch.cuda.OutOfMemoryError("CUDA oom"))
    assert res.is_resource_exhausted(res.ResourceExhausted("x"))
    assert not res.is_resource_exhausted(RuntimeError("something else"))
    _, err, trail, final, _ = _walk(
        res, SCRIPTS["oom retries then ok"], torch.cuda.OutOfMemoryError)
    assert err is None and final == "r0" and trail == [("r0", "ok", 2, 2)]


def test_deadline_and_policy_resolution_match_reference():
    clock = iter([0.0, 0.25, 2.0]).__next__
    d = res.Deadline(1.0, clock=clock)
    assert d.remaining_s() == 0.75 and d.expired()
    with pytest.raises(ValueError):
        res.Deadline(0)
    assert res.resolve_policy(None) == res.resolve_policy(True)
    assert res.resolve_policy(False).validate_results is False
    with pytest.raises(ValueError):
        res.resolve_policy("yes")
    assert sorted(res.__all__) == sorted(ref_res.__all__)
