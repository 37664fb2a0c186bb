"""Wall seconds of the program's `cns.repair` spans (window_repair: the
LQ repair of a window's consensus) per polished megabase, summed over
the threads."""
from npbench.metrics import _spans


def read(ctx):
    return _spans.per_mb(ctx, "cns.repair")
