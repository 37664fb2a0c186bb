"""Seconds of the traced window in which the card ran nothing and some
thread was inside the program's `cns.prep` span, per polished megabase
(the card's idle gaps, devtrace.idle_gaps, against the spans placed on
the profiler's clock)."""
from npbench.metrics import _spans


def read(ctx):
    got = _spans.idle(ctx, lambda name: name == "cns.prep")
    return None if got is None else got[1] / (ctx["bases"] / 1e6)
