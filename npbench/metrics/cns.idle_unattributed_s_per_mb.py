"""Seconds of the traced window in which the card ran nothing and no
stage span of the program (any span but those that hold a whole job,
_spans.OUTER) was open on any thread, per polished megabase:
the idle time the spans do not cover."""
from npbench.metrics import _spans


def read(ctx):
    got = _spans.idle(ctx, lambda name: name not in _spans.OUTER)
    return None if got is None else (got[0] - got[1]) / (ctx["bases"] / 1e6)
