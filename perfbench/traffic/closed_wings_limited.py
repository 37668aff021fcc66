"""Closed loop of wing decompositions with a call limit: what
``closed_wings`` does (one client, the next call when the last has
returned, a call answered off the ``device`` rung fails, ``peel_s``, and
every answer against the plain reference), under its own op
``wings_limited``, with no call running past ``call_limit_s`` seconds.

A call still running at its limit is cut (``SIGALRM``, which Python
delivers between two bytecodes of the main thread, so the program's
round loop stops within one of its operations):

* in the window it is a failed call (in ``missing``), and after the
  window the reference is not run: each answered call's edges count in
  ``wing_diff`` as not compared;
* in set-up (the warm call) the run ends non-zero.

Either way the process ends within about ``call_limit_s`` of the call's
start, so a program that cannot serve the cell's graph on the device
fails the cell instead of holding it.

Mix parameters: those of ``closed_wings``, and ``call_limit_s``.
"""
import contextlib
import signal

from perfbench.loop import closed_loop, graph_state
from perfbench.traffic import closed_wings as wings

OP = "wings_limited"


class CallCut(BaseException):
    """A call reached its limit. Not an ``Exception``, as
    ``KeyboardInterrupt`` is not, so no handler inside the program takes
    it for one of its own errors."""


@contextlib.contextmanager
def _limited(seconds: float):
    """Raise :class:`CallCut` in the body once ``seconds`` have passed."""

    def cut(_signum, _frame):
        raise CallCut

    before = signal.signal(signal.SIGALRM, cut)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, before)


def _call(run, st):
    limit = float(run.mix["call_limit_s"])
    try:
        with _limited(limit):
            return wings._call(run, st)
    except CallCut:
        st["cut"] = True
        raise RuntimeError(f"call cut at its limit of {limit} s") from None


def setup(run):
    st = graph_state(run)
    _call(run, st)  # warm, as closed_wings; a cut here ends the run
    run.spans.clear()
    return st


def window(run, st):
    closed_loop(run, st, OP, _call)


end_to_end = wings.end_to_end


def verify(run, st):
    if not st.get("cut"):
        return wings.verify(run, st)
    m = len(st["edges"])
    st.clear()
    answered = sum(1 for c in run.calls if c.pop("result", None) is not None)
    return [("missing", len(run.calls) - answered, 0),
            ("wing_diff", m * answered, 0)]
