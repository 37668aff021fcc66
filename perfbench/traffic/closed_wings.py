"""Closed loop of wing decompositions: one client calls ``peel_wings``
on the cell's graph, the next call when the last has returned, for the
whole window; the last call runs to its end. Each call counts the
butterflies of every edge it starts from. A call that the program
answers on another rung than ``device`` counts as failed: the cell
measures the device engine.

Mix parameters: ``call``, the keyword arguments of the call; ``trace_s``,
how long the trace runs; ``trace_host``, whether it records the host's
operations.

End-to-end: ``peel_s``, the seconds from the window's start to the end
of its last call over the decompositions made. Correct: every call gives
every edge the reference's wing number.
"""
import numpy as np

from perfbench.compare import value_diffs
from perfbench.loop import closed_loop, graph_state, per_call_s
from perfbench.reference.counting import count_all
from perfbench.reference.wings import wing_numbers
from perfbench.wing_roofline import wing_triples


def _call(run, st):
    from repro_torch.core import peel_wings

    with run.span("peel_wings"):
        r = peel_wings(st["graph"], device=run.device, **run.mix["call"])
    if r.report.final_rung != "device":
        raise RuntimeError(f"answered on rung {r.report.final_rung!r}, "
                           "not 'device'")
    return r


def setup(run):
    st = graph_state(run)
    _call(run, st)  # warm: the kernels' library, the allocator
    run.spans.clear()
    return st


def window(run, st):
    closed_loop(run, st, "wings", _call)


def end_to_end(run):
    t = per_call_s(run)
    return {} if t is None else {"peel_s": (t, "s")}


def verify(run, st):
    n_u, n_v = run.sizes
    edges = st["edges"]
    st.clear()
    run.facts.update(m=len(edges), triples=wing_triples(n_u, n_v, edges))
    ref = count_all(n_u, n_v, edges, device=run.device)
    want = wing_numbers(n_u, n_v, edges, ref.per_edge,
                        device=run.device).numbers.numpy()
    missing = wing_diff = 0
    for c in run.calls:
        if "result" not in c:
            missing += 1
            continue
        wing_diff += value_diffs(np.asarray(c.pop("result").numbers), want)
    return [("missing", missing, 0), ("wing_diff", wing_diff, 0)]
