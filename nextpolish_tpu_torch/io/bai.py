"""BAI index writer (SAM spec §5.2) so external htslib-based tools can
region-query BAMs we produce (used by the reference-parity test harness)."""
from __future__ import annotations

import struct

import numpy as np

from .bam import CONSUMES_R


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def write_bai(path: str, n_ref: int, records):
    """records: iterable of (tid, pos, ref_end, voff_start, voff_end),
    sorted by (tid, pos).  voff_* are BGZF virtual offsets."""
    per_ref_bins = [dict() for _ in range(n_ref)]
    per_ref_lin = [dict() for _ in range(n_ref)]
    for tid, pos, rend, vs, ve in records:
        if tid < 0:
            continue
        b = reg2bin(pos, max(rend, pos + 1))
        chunks = per_ref_bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == vs:
            chunks[-1][1] = ve
        else:
            chunks.append([vs, ve])
        for w in range(pos >> 14, ((max(rend - 1, pos)) >> 14) + 1):
            lin = per_ref_lin[tid]
            if w not in lin or vs < lin[w]:
                lin[w] = vs
    with open(path, "wb") as fh:
        fh.write(b"BAI\x01" + struct.pack("<i", n_ref))
        for r in range(n_ref):
            bins = per_ref_bins[r]
            fh.write(struct.pack("<i", len(bins)))
            for b, chunks in sorted(bins.items()):
                fh.write(struct.pack("<Ii", b, len(chunks)))
                for vs, ve in chunks:
                    fh.write(struct.pack("<QQ", vs, ve))
            lin = per_ref_lin[r]
            n_intv = (max(lin) + 1) if lin else 0
            fh.write(struct.pack("<i", n_intv))
            filled = 0
            for w in range(n_intv):
                if w in lin:
                    filled = lin[w]
                fh.write(struct.pack("<Q", filled))
