"""Wall seconds of the program's `cns.prep.reads` spans per polished
megabase, summed over the threads: window_prep's read pass (the
region mask, the per-read loop to its last row, or the native tag
walker)."""
from npbench.metrics import _spans


def read(ctx):
    return _spans.per_mb(ctx, "cns.prep.reads")
