"""Alignment columns ("align tags") for the consensus engine.

Column semantics follow bam2aln + get_align_tags (lib/ctg_cns.c:2403-2456,
:1213-1256): every aligned column of a read is (t_pos, delta, q_base) with
q_base in {A=0, T=1, G=2, C=3, -=4, N=5}; delta counts the read's own
insertion run after t_pos.  Anchor trimming keeps the alignment between its
first/last runs of 8 exact matches (get_align_shift :139-201); window
clipping drops columns outside [s, e) (clip_aln :2809-2826).

All reads are expanded at once into flat column arrays (read_of, t_pos,
delta, q_base) plus per-position coverage / l_ins / l_del / max-delta
tracks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...io.bam import (
    CDEL,
    CHARD_CLIP,
    CINS,
    CMATCH,
    CREF_SKIP,
    CSOFT_CLIP,
    AlnBatch,
)

# q_base codes (base_to_int, lib/ctg_cns.c:58-67)
A, T, G, C, GAP, N = 0, 1, 2, 3, 4, 5
NIB_TO_CNS = np.full(16, N, dtype=np.uint8)
NIB_TO_CNS[1] = A  # A
NIB_TO_CNS[8] = T  # T
NIB_TO_CNS[4] = G  # G
NIB_TO_CNS[2] = C  # C
CNS_TO_ASCII = np.frombuffer(b"ATGC-NM", dtype=np.uint8).copy()
ASCII_TO_CNS = np.full(256, N, dtype=np.uint8)
for _i, _c in enumerate(b"ATGC-NM"):
    ASCII_TO_CNS[_c] = _i
    ASCII_TO_CNS[_c + 32] = _i if _i < 6 else N


@dataclass
class TagColumns:
    """Flat per-column arrays for a set of reads in one window."""

    read_of: np.ndarray  # int32 [T] row id
    t_pos: np.ndarray  # int32 [T] window-local position
    delta: np.ndarray  # int16 [T]
    q_base: np.ndarray  # uint8 [T]
    row_off: np.ndarray  # int64 [n_rows+1]
    aln_t_s: np.ndarray  # int32 [n_rows] window-local first position
    aln_t_e: np.ndarray  # int32 [n_rows] last position (inclusive)
    ridx: np.ndarray  # read index into the source batch (-1 = reference row)

    def row(self, r: int):
        lo, hi = self.row_off[r], self.row_off[r + 1]
        return (self.t_pos[lo:hi], self.delta[lo:hi], self.q_base[lo:hi])

    def n_rows(self) -> int:
        return len(self.row_off) - 1


def read_columns(batch: AlnBatch, r: int):
    """One read's raw alignment columns (t_pos in contig coords, q_base),
    before trimming.  Returns (t_pos[int64], qbase[uint8], is_ins[bool])."""
    return expand_columns(int(batch.pos[r]), batch.rec_cigar(r),
                          batch.rec_seq_nib(r))


def expand_columns(pos: int, cig: np.ndarray, nib: np.ndarray):
    """bam2aln role for raw (pos, cigar, nibble-seq) (lib/ctg_cns.c:2403)."""
    ops = (cig & 0xF).astype(np.int64)
    lens = (cig >> 4).astype(np.int64)
    # per-op query/ref starts
    qcon = np.where(
        (ops == CMATCH) | (ops == CINS) | (ops == CSOFT_CLIP)
        | (ops == CHARD_CLIP), lens, 0)
    rcon = np.where((ops == CMATCH) | (ops == CDEL) | (ops == CREF_SKIP),
                    lens, 0)
    qs = np.cumsum(qcon) - qcon
    rs = np.cumsum(rcon) - rcon + pos
    emit = (ops == CMATCH) | (ops == CINS) | (ops == CDEL)
    eops = ops[emit]
    elens = lens[emit]
    eqs = qs[emit]
    ers = rs[emit]
    tot = int(elens.sum())
    rep = np.repeat(np.arange(len(eops)), elens)
    j = np.arange(tot) - np.repeat(np.cumsum(elens) - elens, elens)
    opr = eops[rep]
    tpos = np.where(opr == CINS, ers[rep] + j, ers[rep] + j)
    # for I columns t_pos stays at the op's ref start - 1?  bam2aln emits
    # '-' in target: the insertion anchors at the PREVIOUS consumed t base,
    # i.e. tags keep t_pos of the last match/del column; handled downstream
    # via delta runs.  Here: t index where the column "lands":
    tpos = np.where(opr == CINS, ers[rep] - 1, ers[rep] + j)
    qidx = np.where(opr == CDEL, -1, eqs[rep] + j)
    qbase = np.where(qidx >= 0, NIB_TO_CNS[nib[np.maximum(qidx, 0)]], GAP
                     ).astype(np.uint8)
    is_ins = opr == CINS
    return tpos, qbase, is_ins, qidx


def _match_run_bounds(is_match: np.ndarray, k: int = 8):
    """(first_end, last_start) of the first/last runs of k consecutive
    matches; returns (-1, -1) when none exists."""
    if is_match.size < k:
        return -1, -1
    m = is_match.astype(np.int32)
    run = np.convolve(m, np.ones(k, dtype=np.int32), mode="valid")
    hits = np.flatnonzero(run == k)
    if not hits.size:
        return -1, -1
    return int(hits[0]), int(hits[-1]) + k - 1


def trim_read_columns(tpos, qbase, is_ins, qidx, ref_cns, win_s, win_e,
                      anchor_k: int = 8, min_span: int = 500):
    """Window clip (clip_aln :2809, which runs first) then anchor trim
    (get_align_shift :139) then the 500-position span filter (:3542).
    Returns (t_local[int32], delta[int16], qbase, q_s) or None."""
    if not tpos.size:
        return None
    # a clipped read with <= 501 columns left is dropped (clip_aln's
    # aln_len=10 path)
    clipped = tpos[0] < win_s or tpos[-1] >= win_e
    if clipped:
        inwin = (tpos >= win_s) & (tpos < win_e)
        if not inwin.any():
            return None
        lo = int(np.argmax(inwin))
        hi = len(inwin) - int(np.argmax(inwin[::-1]))
        if hi - lo <= 501:
            return None
        tpos = tpos[lo:hi]
        qbase = qbase[lo:hi]
        is_ins = is_ins[lo:hi]
        qidx = qidx[lo:hi]
        # clip_aln skips leading insertions
        while is_ins.size and is_ins[0]:
            tpos, qbase, is_ins, qidx = (tpos[1:], qbase[1:], is_ins[1:],
                                         qidx[1:])
    # anchor trim: keep between the first/last runs of 8 exact matches
    tmatch = (~is_ins) & (qbase != GAP) & (
        qbase == ref_cns[np.clip(tpos, 0, len(ref_cns) - 1)]
    ) & (tpos >= 0) & (tpos < len(ref_cns))
    s_i, e_i = _match_run_bounds(tmatch, anchor_k)
    if s_i < 0:
        return None
    tpos = tpos[s_i : e_i + 1]
    qbase = qbase[s_i : e_i + 1]
    is_ins = is_ins[s_i : e_i + 1]
    q_s = int(qidx[s_i])  # first kept column is an anchor match
    # span filter: keep when aln_t_s <= aln_t_e - 500 (exclusive end),
    # i.e. span count >= 500 positions
    if not tpos.size or tpos[-1] - tpos[0] + 1 < min_span:
        return None
    t_local = (tpos - win_s).astype(np.int32)
    # delta within insertion runs
    delta = np.zeros(len(t_local), dtype=np.int16)
    if is_ins.any():
        ins_i = np.flatnonzero(is_ins)
        brk = np.flatnonzero(np.diff(ins_i) != 1)
        starts = np.concatenate([[0], brk + 1])
        run_id = np.zeros(len(ins_i), dtype=np.int64)
        run_id[starts[1:]] = 1
        run_id = np.cumsum(run_id)
        run_start = ins_i[starts][run_id]
        delta[ins_i] = (ins_i - run_start + 1).astype(np.int16)
    return t_local, delta, qbase, q_s


class WindowAccum:
    """Per-window MSA row accumulator with the coverage/l_ins/l_del/
    max-delta tracks (the msa_p side of get_align_tags).  Row 0 is the
    reference row; coverage excludes it (cov_at adds the +1)."""

    def __init__(self, contig_ascii: np.ndarray, win_s: int, win_e: int,
                 gap_min_len: int):
        self.win_s = win_s
        self.win_e = win_e
        self.L = win_e - win_s
        self.gap_min_len = gap_min_len
        self.ref_cns = ASCII_TO_CNS[contig_ascii]
        self.all_t, self.all_d, self.all_q = [], [], []
        self.aln_s, self.aln_e, self.ridx = [], [], []
        # L+1: the C indexes msa[aln_t_e] with the exclusive end
        self.coverage = np.zeros(self.L + 1, dtype=np.int32)
        self.l_ins = np.zeros(self.L, dtype=np.int32)
        self.l_del = np.zeros(self.L, dtype=np.int32)
        self.max_delta = np.zeros(self.L, dtype=np.int32)
        rt, rd, rq = reference_row(contig_ascii, win_s, win_e)
        self.all_t.append(rt)
        self.all_d.append(rd)
        self.all_q.append(rq)
        self.aln_s.append(0)
        self.aln_e.append(self.L - 1)
        self.ridx.append(-1)
        self._cols = None  # finish()'s result while no row is added

    @classmethod
    def holding(cls, contig_ascii: np.ndarray, win_s: int, win_e: int,
                gap_min_len: int, cols: TagColumns, coverage: np.ndarray,
                l_ins: np.ndarray, l_del: np.ndarray,
                max_delta: np.ndarray) -> "WindowAccum":
        """An accumulator that holds the rows of `cols` (the reference
        row first) and the tracks that adding them row by row leaves
        (the native tag walker's output); finish() returns `cols` until
        a row is added."""
        self = cls.__new__(cls)
        self.win_s = win_s
        self.win_e = win_e
        self.L = win_e - win_s
        self.gap_min_len = gap_min_len
        self.ref_cns = ASCII_TO_CNS[contig_ascii]
        cut = cols.row_off[1:-1]
        self.all_t = np.split(cols.t_pos, cut)
        self.all_d = np.split(cols.delta, cut)
        self.all_q = np.split(cols.q_base, cut)
        self.aln_s = cols.aln_t_s.tolist()
        self.aln_e = cols.aln_t_e.tolist()
        self.ridx = cols.ridx.tolist()
        self.coverage = coverage
        self.l_ins = l_ins
        self.l_del = l_del
        self.max_delta = max_delta
        self._cols = cols
        return self

    def n_rows(self) -> int:
        return len(self.aln_s)

    def cov_at(self, i: int) -> int:
        return int(self.coverage[i]) + (1 if i < self.L else 0)

    def row_span(self, row: int):
        return self.aln_s[row], self.aln_e[row]

    def row(self, row: int):
        return self.all_t[row], self.all_d[row], self.all_q[row]

    def add_row(self, t_local, delta, qbase, source: int) -> int:
        row_id = len(self.aln_s)
        self._cols = None
        self.all_t.append(t_local)
        self.all_d.append(delta)
        self.all_q.append(qbase)
        self.aln_s.append(int(t_local[0]))
        self.aln_e.append(int(t_local[-1]))
        self.ridx.append(source)
        d0 = delta == 0
        np.add.at(self.coverage, t_local[d0], 1)
        np.add.at(self.l_del, t_local[d0 & (qbase == GAP)], 1)
        np.maximum.at(self.max_delta, t_local, delta.astype(np.int32))
        big = delta >= self.gap_min_len
        if big.any():
            first = big & ~np.concatenate([[False], big[:-1]])
            np.add.at(self.l_ins, t_local[np.flatnonzero(first)], 1)
        return row_id

    def finish(self) -> TagColumns:
        if self._cols is not None:
            return self._cols
        t_pos = np.concatenate(self.all_t).astype(np.int32)
        delta = np.concatenate(self.all_d)
        q_base = np.concatenate(self.all_q)
        lens = np.array([len(x) for x in self.all_t], dtype=np.int64)
        row_off = np.concatenate([[0], np.cumsum(lens)])
        read_of = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
        return TagColumns(read_of, t_pos, delta, q_base, row_off,
                          np.array(self.aln_s, dtype=np.int32),
                          np.array(self.aln_e, dtype=np.int32),
                          np.array(self.ridx, dtype=np.int64))


def build_tags(batch: AlnBatch, ridx: np.ndarray, contig_ascii: np.ndarray,
               win_s: int, win_e: int, anchor_k: int = 8,
               min_span: int = 500, gap_min_len: int = 3):
    """Expand + trim + clip the selected reads into TagColumns (without
    the reference row), plus tracks — compatibility wrapper over
    WindowAccum for tests/tools; the production path is in window.py."""
    L = win_e - win_s
    accum = WindowAccum(contig_ascii, win_s, win_e, gap_min_len)
    kept = []
    for r in ridx:
        tr = None
        cols = read_columns(batch, int(r))
        tr = trim_read_columns(*cols, accum.ref_cns, win_s, win_e,
                               anchor_k, min_span)
        if tr is None:
            kept.append(False)
            continue
        kept.append(True)
        accum.add_row(tr[0], tr[1], tr[2], int(r))
    kept = np.array(kept, dtype=bool)
    cols = accum.finish()
    # strip the reference row for the legacy return shape
    off = cols.row_off
    stripped = TagColumns(cols.read_of[off[1]:] - 1, cols.t_pos[off[1]:],
                          cols.delta[off[1]:], cols.q_base[off[1]:],
                          off[1:] - off[1],
                          cols.aln_t_s[1:], cols.aln_t_e[1:],
                          cols.ridx[1:])
    return (stripped, accum.coverage[:L].copy(), accum.l_ins, accum.l_del,
            accum.max_delta, kept)


def reference_row(contig_ascii: np.ndarray, win_s: int, win_e: int):
    """The draft itself as row 0 (ctg_cns_core seeds the MSA with the
    window's reference sequence, lib/ctg_cns.c:3457-3468)."""
    L = win_e - win_s
    t = np.arange(L, dtype=np.int32)
    d = np.zeros(L, dtype=np.int16)
    q = ASCII_TO_CNS[contig_ascii[win_s:win_e]]
    return t, d, q
