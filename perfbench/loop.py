"""What the closed-loop traffic kinds share: the cell's graph, and one
client calling the program back to back for the whole window."""
import time

from perfbench.generator import cell_graph

__all__ = ["graph_state", "closed_loop", "per_call_s"]


def graph_state(run) -> dict:
    """The run's edge arrays and the program's graph built from them;
    ``run.sizes`` is ``(n_u, n_v)``."""
    from repro_torch.core import BipartiteGraph

    n_u, n_v, edges = cell_graph(run.cfg, run.seed)
    run.sizes = (n_u, n_v)
    return {"edges": edges, "graph": BipartiteGraph(n_u, n_v, edges)}


def closed_loop(run, st, op: str, call) -> None:
    """``call(run, st)`` back to back until ``run.seconds`` have passed;
    the last call runs to its end. Each call is one record of
    ``run.calls``: its start and end (seconds into the window), whether
    the trace was on, and its result and report or its error."""
    run.tracer.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        rec = {"op": op, "t0": time.perf_counter() - t0,
               "traced": run.tracer.active}
        try:
            r = call(run, st)
            rec.update(result=r, report=r.report)
        except Exception as e:  # a failed call is counted, not fatal
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["t1"] = time.perf_counter() - t0
        run.calls.append(rec)
        run.tracer.call_done(rec["t1"])


def per_call_s(run) -> dict:
    """Window start to the end of the last call, over the calls that
    answered."""
    done = [c for c in run.calls if "result" in c]
    return run.calls[-1]["t1"] / len(done) if done else None
