"""Closed loop of tip decompositions: one client calls ``peel_tips`` on
the cell's graph, the next call when the last has returned, for the
whole window; the last call runs to its end. Each call counts the
butterflies it starts from.

Mix parameters: ``call``, the keyword arguments of the call; ``trace_s``,
how long the trace runs; ``trace_host``, whether it records the host's
operations.

End-to-end: ``peel_s``, the seconds from the window's start to the end
of its last call over the decompositions made. Correct: every call peels
the reference's side and gives every vertex of it the reference's tip
number.
"""
import numpy as np

from perfbench.compare import value_diffs
from perfbench.loop import closed_loop, graph_state, per_call_s
from perfbench.reference.counting import count_all
from perfbench.reference.tips import peel_side, tip_numbers


def _call(run, st):
    from repro_torch.core import peel_tips

    with run.span("peel_tips"):
        return peel_tips(st["graph"], device=run.device, **run.mix["call"])


def setup(run):
    st = graph_state(run)
    _call(run, st)  # warm: the kernels' library, the allocator
    run.spans.clear()
    return st


def window(run, st):
    closed_loop(run, st, "peel", _call)


def end_to_end(run):
    t = per_call_s(run)
    return {} if t is None else {"peel_s": (t, "s")}


def verify(run, st):
    n_u, n_v = run.sizes
    edges = st["edges"]
    st.clear()
    side = peel_side(n_u, n_v, edges)
    ref = count_all(n_u, n_v, edges, device=run.device)
    want = tip_numbers(n_u, n_v, edges, side,
                       ref.per_u if side == 0 else ref.per_v,
                       device=run.device).numbers.numpy()
    missing = side_diff = tip_diff = 0
    for c in run.calls:
        if "result" not in c:
            missing += 1
            continue
        r = c.pop("result")
        if r.side != side:
            side_diff += 1
            tip_diff += int(want.size)
            continue
        tip_diff += value_diffs(np.asarray(r.numbers), want)
    return [("missing", missing, 0), ("side_diff", side_diff, 0),
            ("tip_diff", tip_diff, 0)]
