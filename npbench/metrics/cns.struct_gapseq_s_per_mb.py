"""Wall seconds of the program's `cns.prep.struct.gapseq` spans per
polished megabase, summed over the threads: the structural pass's gap
sequences (generate_gapseqs) and contig split points
(update_split_p)."""
from npbench.metrics import _spans


def read(ctx):
    return _spans.per_mb(ctx, "cns.prep.struct.gapseq")
