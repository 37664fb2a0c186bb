"""Device nanoseconds of task 1 per chain cell: every kernel and memset
on the card in the traced window (the buffer copies left out) over the
cells the program counted (task1.chain_cells).  It counts all of task
1's device work, not only the chain DP's: kernels are not told apart by
the stage that launched them, so work moved onto the card by a later
change (inflate, pileup, flags) reads here too."""
from npbench.metrics import _buckets


def read(ctx):
    tr = ctx.get("trace")
    cells = _buckets.total(ctx, "task1.chain_cells")
    if tr is None or not cells:
        return None
    s = tr.kernel_seconds()
    return s / cells * 1e9 if s > 0 else None
