"""Closed loop of exact counts: one client calls ``count_butterflies``
on the cell's graph, the next call when the last has returned, for the
whole window; the last call runs to its end.

Mix parameters: ``call``, the keyword arguments of the call
(``count_dtype`` by name); ``trace_s``, how long the trace runs.

End-to-end: ``count_s``, the seconds from the window's start to the end
of its last call over the calls made. Correct: every call's total,
per-vertex and per-edge counts equal the reference's.
"""
import torch

from perfbench.compare import count_diffs
from perfbench.loop import closed_loop, graph_state, per_call_s
from perfbench.reference.counting import count_all, wedge_total


def _call(run, st):
    from repro_torch.core import count_butterflies

    kw = dict(run.mix["call"])
    kw["count_dtype"] = getattr(torch, kw["count_dtype"])
    with run.span("count_butterflies"):
        return count_butterflies(st["graph"], device=run.device, **kw)


def setup(run):
    st = graph_state(run)
    _call(run, st)  # warm: the kernels' library, the allocator
    run.spans.clear()
    return st


def window(run, st):
    closed_loop(run, st, "count", _call)


def after_window(run, st):
    """Traced runs only: the ranking and CSR layer alone, three times."""
    from repro_torch.core import make_order, preprocess

    order = run.mix["call"]["order"]
    for _ in range(3):
        with run.span("prep"):
            preprocess(st["graph"], make_order(st["graph"], order,
                                               device=run.device),
                       order_name=order)


def end_to_end(run):
    t = per_call_s(run)
    return {} if t is None else {"count_s": (t, "s")}


def verify(run, st):
    n_u, n_v = run.sizes
    edges = st["edges"]
    st.clear()
    ref = count_all(n_u, n_v, edges, device=run.device)
    run.facts.update(n=n_u + n_v, m=len(edges),
                     wedges=wedge_total(n_u, n_v, torch.as_tensor(
                         edges, device=run.device)))
    diffs = {"total_diff": 0, "vertex_diff": 0, "edge_diff": 0}
    missing = 0
    mode = run.mix["call"]["mode"]
    for c in run.calls:
        if "result" not in c:
            missing += 1
            continue
        for k, v in count_diffs(c.pop("result"), ref, mode).items():
            diffs[k] += v
    return [("missing", missing, 0)] + [(k, v, 0) for k, v in diffs.items()]
