"""Wall seconds of the program's `cns.prep.struct.cluster` spans per
polished megabase, summed over the threads: the structural pass's
low-depth regions (update_ld_regs and its ref-qv variant) and gap
clusters (update_gap_cluster)."""
from npbench.metrics import _spans


def read(ctx):
    return _spans.per_mb(ctx, "cns.prep.struct.cluster")
