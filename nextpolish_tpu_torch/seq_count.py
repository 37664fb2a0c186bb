"""seq_count CLI (util/seq_count.c parity): read-length histogram, N10-N90,
raw/filtered/clean depth, suggested seed cutoff.

Usage: python -m nextpolish_tpu_torch.seq_count [-f len] [-g size] [-d depth]
       input.fofn|reads.fq[.gz] [...]
"""
from __future__ import annotations

import argparse
import os
import sys

from .io.seqstat import format_stats, seq_stats
from .kit import parse_num_unit


def _expand_fofn(path: str) -> list[str]:
    """A .fofn lists one read file per line (relative to the fofn's dir)."""
    if not path.endswith(".fofn"):
        return [path]
    base = os.path.dirname(os.path.abspath(path))
    out = []
    for line in open(path):
        line = line.strip()
        if not line:
            continue
        out.append(line if os.path.isabs(line) else os.path.join(base, line))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="seq_count",
        description="read-length stats (util/seq_count.c:142-148 flags)")
    ap.add_argument("-f", dest="filter_len", default="1k",
                    help="filter length [1k]")
    ap.add_argument("-g", dest="genome_size", default="5m",
                    help="genome size [5Mb]")
    ap.add_argument("-d", dest="depth", type=int, default=35,
                    help="expected seed depth [35]")
    ap.add_argument("input", nargs="+", help="fofn or read files")
    args = ap.parse_args(argv)
    files = [f for p in args.input for f in _expand_fofn(p)]
    for f in files:
        if not os.path.exists(f):
            sys.stderr.write(f"Error! {f} does not exist!\n")
            return 1
    stats = seq_stats(files, genome_size=int(parse_num_unit(args.genome_size)),
                      min_len=int(parse_num_unit(args.filter_len)),
                      top_depth=args.depth)
    sys.stdout.write(format_stats(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
