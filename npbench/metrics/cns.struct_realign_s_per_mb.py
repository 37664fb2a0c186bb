"""Wall seconds of the program's `cns.prep.struct.realign` spans per
polished megabase, summed over the threads: the structural pass's
realignment of each gap cluster's supplementary segments into the
window as rows of their own (realign_cluster_sups)."""
from npbench.metrics import _spans


def read(ctx):
    return _spans.per_mb(ctx, "cns.prep.struct.realign")
