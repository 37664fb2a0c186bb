"""The alignment columns the engine-2 reference reads: one contig's read
records (the generator's dicts) as flat arrays, with the record accessors
and the region filter the copied modules call.  Written for the
benchmark; the port's AlnBatch (nextpolish_tpu_torch/io/bam.py) has the
same fields."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP = 0, 1, 2, 3, 4, 5
CONSUMES_R = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                      dtype=np.int64)


@dataclass
class AlnBatch:
    tid: np.ndarray
    pos: np.ndarray
    flag: np.ndarray
    lqseq: np.ndarray
    cigar: np.ndarray
    cigar_off: np.ndarray
    cigar_len: np.ndarray
    seq: np.ndarray
    seq_off: np.ndarray
    tags: None = None  # the generator writes no tags (no SA: no split reads)

    @classmethod
    def of(cls, records: list, tid: int = 0) -> "AlnBatch":
        cig = [np.asarray(r["cigar"], dtype=np.uint32) for r in records]
        seq = [np.asarray(r["seq_nib"], dtype=np.uint8) for r in records]
        clen = np.fromiter(map(len, cig), np.int64, len(cig))
        slen = np.fromiter(map(len, seq), np.int64, len(seq))
        return cls(
            tid=np.full(len(records), tid, dtype=np.int32),
            pos=np.array([r["pos"] for r in records], dtype=np.int32),
            flag=np.array([r.get("flag", 0) for r in records],
                          dtype=np.uint16),
            lqseq=slen.astype(np.int32),
            cigar=(np.concatenate(cig) if cig else np.zeros(0, np.uint32)),
            cigar_off=np.cumsum(clen) - clen,
            cigar_len=clen.astype(np.int32),
            seq=np.concatenate(seq) if seq else np.zeros(0, np.uint8),
            seq_off=np.cumsum(slen) - slen)

    def __len__(self):
        return len(self.pos)

    def rec_cigar(self, i: int) -> np.ndarray:
        o, n = self.cigar_off[i], self.cigar_len[i]
        return self.cigar[o:o + n]

    def rec_seq_nib(self, i: int) -> np.ndarray:
        o, n = self.seq_off[i], self.lqseq[i]
        return self.seq[o:o + n]

    def rec_tags(self, i: int) -> bytes:
        return b""

    def ref_span(self) -> np.ndarray:
        contrib = (self.cigar >> 4).astype(np.int64) * CONSUMES_R[
            self.cigar & 0xF]
        cum = np.concatenate([[0], np.cumsum(contrib)])
        return cum[self.cigar_off + self.cigar_len] - cum[self.cigar_off]

    def clip_lens(self) -> tuple:
        """(left, right) soft + hard clip length per record."""
        n = len(self)
        left = np.zeros(n, dtype=np.int64)
        right = np.zeros(n, dtype=np.int64)
        has = self.cigar_len > 0
        first = self.cigar[self.cigar_off[has]]
        last = self.cigar[self.cigar_off[has] + self.cigar_len[has] - 1]
        fo, lo = first & 0xF, last & 0xF
        left[has] = np.where((fo == CSOFT_CLIP) | (fo == CHARD_CLIP),
                             first >> 4, 0)
        right[has] = np.where((lo == CSOFT_CLIP) | (lo == CHARD_CLIP),
                              last >> 4, 0)
        return left, right


def region_overlap_mask(batch: AlnBatch, tid: int, start: int, end: int
                        ) -> np.ndarray:
    """Reads a BAM region query [start, end + 1) would return."""
    return ((batch.tid == tid)
            & (batch.pos.astype(np.int64) + batch.ref_span() > start)
            & (batch.pos <= end))
