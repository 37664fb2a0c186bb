"""Thread CPU seconds of the program's `cns.prep` spans per polished
megabase, summed over the threads that prep.  Its gap to
cns.prep_s_per_mb is the time the prep threads held a span but did not
run: the interpreter lock, other locks, the host's other work."""
from npbench.metrics import _spans


def read(ctx):
    return _spans.per_mb(ctx, "cns.prep", cpu=True)
