"""Resume support for the polishing workers."""
from __future__ import annotations

import os


def read_polished_names(outfile: str) -> set:
    """Scan a partial output FASTA; the last (possibly truncated) record is
    dropped and re-polished (lib/nextpolish1.py:163-179)."""
    if not os.path.exists(outfile):
        return set()
    names = []
    offsets = []
    off = 0
    with open(outfile, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                names.append(line.split()[0][1:].decode())
                offsets.append(off)
            off += len(line)
    if not names:
        return set()
    # truncate the file at the last record start and drop it
    with open(outfile, "rb+") as fh:
        fh.truncate(offsets[-1])
    return set(names[:-1])
