"""Wall seconds of the program's `cns.prep.struct` spans per polished
megabase, summed over the threads: window_prep's structural pass
(depth track, low-depth regions, gap clusters, supplementary
realignment, gap sequences, split points)."""
from npbench.metrics import _spans


def read(ctx):
    return _spans.per_mb(ctx, "cns.prep.struct")
