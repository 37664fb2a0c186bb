"""Minimizer index over a genome: sorted-array hash join (no python dicts).

Plays the role of `bwa index` / `minimap2 -d` (source/nextPolish:189-197).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .minimizer import minimizers, seq_codes


@dataclass
class GenomeIndex:
    k: int
    w: int
    names: list
    lengths: np.ndarray  # int64 [n_contigs]
    starts: np.ndarray  # int64 [n_contigs] offsets into the concatenated genome
    codes: np.ndarray  # uint8 concatenated 2-bit codes (4 = N separator)
    hashes: np.ndarray  # uint64 sorted
    positions: np.ndarray  # int64 global pos, grouped by hash
    strands: np.ndarray  # uint8
    max_occ: int = 200

    @classmethod
    def build(cls, contigs: list[tuple[str, bytes]], k: int = 17, w: int = 7,
              max_occ: int = 200) -> "GenomeIndex":
        names = [n for n, _ in contigs]
        lengths = np.array([len(s) for _, s in contigs], dtype=np.int64)
        # separate contigs with a run of invalid bases so k-mers never span
        sep = np.full(k, 4, dtype=np.uint8)
        parts = []
        starts = np.zeros(len(contigs), dtype=np.int64)
        off = 0
        for i, (_, s) in enumerate(contigs):
            starts[i] = off
            parts.append(seq_codes(s))
            off += len(s)
            if i + 1 < len(contigs):
                parts.append(sep)
                off += k
        codes = np.concatenate(parts) if parts else np.empty(0, np.uint8)
        h, p, st = minimizers(codes, k, w)
        order = np.argsort(h, kind="stable")
        h, p, st = h[order], p[order], st[order]
        # drop over-represented minimizers (repeat masking, like mm2 -f)
        if h.size:
            uniq, first, counts = np.unique(h, return_index=True,
                                            return_counts=True)
            bad = counts > max_occ
            if bad.any():
                keep = np.ones(h.size, dtype=bool)
                for f, c in zip(first[bad], counts[bad]):
                    keep[f : f + c] = False
                h, p, st = h[keep], p[keep], st[keep]
        return cls(k, w, names, lengths, starts, codes, h, p, st, max_occ)

    def global_to_contig(self, gpos: np.ndarray):
        """Map global positions to (tid, local pos)."""
        tid = np.searchsorted(self.starts, gpos, side="right") - 1
        return tid.astype(np.int32), gpos - self.starts[tid]

    def contig_to_global(self, tid: int, pos: int) -> int:
        return int(self.starts[tid]) + int(pos)

    def lookup(self, query_hashes: np.ndarray):
        """For each query hash: (lo, hi) slice into positions/strands."""
        lo = np.searchsorted(self.hashes, query_hashes, side="left")
        hi = np.searchsorted(self.hashes, query_hashes, side="right")
        return lo, hi

    def fetch_codes(self, gstart: int, gend: int) -> np.ndarray:
        gstart = max(gstart, 0)
        gend = min(gend, self.codes.size)
        return self.codes[gstart:gend]
