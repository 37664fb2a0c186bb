"""Pileup tensor construction for the score-chain engine.

Reformulates the reference's pointer-chasing pileup (per-position `Base` cells
with insert lists and kmer multisets, lib/contig.c:81-399 + lib/base.c:60-146)
as dense tensors over a *cell chain*:

  cell chain = [pos 0][ins 0,0..][pos 1][ins 1,0..] ... for a region, where
  ins_len[p] = max insertion length observed after position p
  (contig_create_insert semantics, lib/contig.c:170-245).

Key structural fact exploited here: a read's emissions into the cell chain
(contig_parse_read, lib/contig.c:247-331) form a *contiguous* cell range with
exactly one symbol per cell — read bases at M/I cells and DEL everywhere else
(deletions, insert-slot padding, and insert pass-through all emit BASE_DEL).
So each read is a dense symbol row, the rolling 3-mer is a vectorized shift,
and the pileup is one scatter-add of (cell, 3-mer) pairs.

The builder is fully vectorized across reads (numpy); `slow_pileup` is a
direct per-base transcription of the C walk used as a property-test oracle.

A copy of nextpolish_tpu/ops/pileup.py: only its imports may differ,
and none had to (they are relative).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.bam import CDEL, CHARD_CLIP, CINS, CMATCH, CSOFT_CLIP, AlnBatch
from .symbols import DEL, K3, NIB_TO_SYM, PAD, S, rolling_kmers

# per-op advance rules exactly as the reference walk implements them
# (M/I/S/H advance qpos — including hard clips, lib/contig.c:321-324;
#  M/D advance pos; N/P/=/X are ignored entirely by the C switch)
_QCON = np.zeros(16, dtype=np.int64)
_QCON[[CMATCH, CINS, CSOFT_CLIP, CHARD_CLIP]] = 1
_RCON = np.zeros(16, dtype=np.int64)
_RCON[[CMATCH, CDEL]] = 1


@dataclass
class CellIndex:
    """Cell-chain coordinates for a region [start, end] (inclusive)."""

    start: int
    end: int
    ins_len: np.ndarray  # [end-start+1] insertions anchored after each pos
    cell_of: np.ndarray  # [end-start+1] cell index of each ref position
    n_cells: int  # including trailing inserts of `end`
    n_cells_dp: int  # cells the chain DP covers: up to cell_of[end] inclusive

    def cell_pos(self) -> np.ndarray:
        """For each cell, its anchor reference position (inserts -> anchor).
        Memoized: link-walk callers ask per read and the index is
        immutable once built (snp_phase walks were O(reads x L) without
        this)."""
        cached = getattr(self, "_cell_pos_cache", None)
        if cached is not None:
            return cached
        pos = np.zeros(self.n_cells, dtype=np.int64)
        pos[self.cell_of] = 1
        pos[0] = 0
        out = np.cumsum(pos) + self.start
        self._cell_pos_cache = out
        return out

    def is_insert_cell(self) -> np.ndarray:
        cached = getattr(self, "_ins_cell_cache", None)
        if cached is not None:
            return cached
        m = np.ones(self.n_cells, dtype=bool)
        m[self.cell_of] = False
        self._ins_cell_cache = m
        return m

    def region_view(self, s: int, e: int) -> "CellIndex":
        """A [s, e] sub-region sharing this index's insert structure, with
        region-local cell ids (0 = cell of position s).  `cell0()` of the view
        gives the global offset."""
        assert self.start <= s <= e <= self.end
        lo = s - self.start
        hi = e - self.start
        cell0 = int(self.cell_of[lo])
        cell_of = self.cell_of[lo : hi + 1] - cell0
        ins_len = self.ins_len[lo : hi + 1]
        n_dp = int(cell_of[-1]) + 1
        return CellIndex(s, e, ins_len, cell_of, n_dp + int(ins_len[-1]), n_dp)


@dataclass
class Pileup:
    index: CellIndex
    counts: np.ndarray  # [n_cells, 512] uint16 — 3-mer multiset per cell
    total: np.ndarray  # [n_cells] int32 — reference's Base.count
    refkmer: np.ndarray  # [n_cells] int32 — contig-as-read rolling 3-mer
    ref_sym: np.ndarray  # [n_cells] uint8 — compact symbol of the draft
    rank: np.ndarray | None = None  # [n_cells, 512] uint16 — per-cell
    # first-observation ordinal of each kmer (the reference's SeqList data
    # insertion order, lib/base.c:60-71); 0xFFFF where unobserved


RANK_NONE = np.uint16(0xFFFF)


def event_ranks(cells: np.ndarray, kmers: np.ndarray, n: int,
                base_ndistinct: np.ndarray | None = None,
                base_rank: np.ndarray | None = None) -> np.ndarray:
    """Dense [n, K3] first-observation ranks from an event stream given in
    exact observation order (= the reference's per-cell kmer insertion
    order).  When base_rank/base_ndistinct are given, new kmers rank after
    the base pileup's existing ones (re-parse accumulation semantics,
    lib/contig.c:721-733 — base_clean_data is never called in between)."""
    rank = (base_rank.copy() if base_rank is not None
            else np.full((n, K3), RANK_NONE, dtype=np.uint16))
    if not len(cells):
        return rank
    keys = cells * K3 + kmers
    uniq, first_idx = np.unique(keys, return_index=True)
    if base_rank is not None:
        fresh = rank.reshape(-1)[uniq] == RANK_NONE
        uniq, first_idx = uniq[fresh], first_idx[fresh]
    ucell = uniq // K3
    order = np.lexsort((first_idx, ucell))
    oc = ucell[order]
    seg_change = np.empty(len(order), dtype=bool)
    if len(order):
        seg_change[0] = True
        seg_change[1:] = oc[1:] != oc[:-1]
    seg_first = np.flatnonzero(seg_change)
    seg_id = np.cumsum(seg_change) - 1
    pos_in_seg = np.arange(len(order)) - seg_first[seg_id]
    if base_ndistinct is not None:
        pos_in_seg = pos_in_seg + base_ndistinct[oc]
    rank.reshape(-1)[uniq[order]] = np.minimum(pos_in_seg, 0xFFFE)
    return rank


# ---------------------------------------------------------------------------
# read filters (lib/contig.c:632-686)
# ---------------------------------------------------------------------------

def clip_rate(batch: AlnBatch) -> np.ndarray:
    """(leading+trailing soft clip)/l_qseq (contig_read_cliprate :632-646)."""
    left, right = batch.soft_clip_lens()
    lq = batch.lqseq.astype(np.float64)
    return np.where(batch.lqseq > 0, (left + right) / np.maximum(lq, 1), 0.0)


def filter_sgs(batch: AlnBatch, read_tlen: int, max_clip_ratio_sgs: float,
               min_map_quality: int) -> np.ndarray:
    """contig_read_fliter (:648-665): levels 0/1/2 for kmer_count & friends."""
    ok = (batch.flag & 0xC04) == 0
    tlen = np.abs(batch.tlen.astype(np.int64))
    clip = clip_rate(batch)
    lvl1 = ok & (((tlen > 0) & (tlen < read_tlen)) | (clip < max_clip_ratio_sgs))
    lvl2 = lvl1 & (batch.mapq >= min_map_quality) & (
        clip < max_clip_ratio_sgs + 0.05
    )
    return lvl1.astype(np.uint8) + lvl2.astype(np.uint8)


def filter_sgs_chain(batch: AlnBatch) -> np.ndarray:
    """contig_read_fliter1 (:667-677): any primary mapped read -> level 1."""
    return ((batch.flag & 0xC04) == 0).astype(np.uint8)


def filter_lgs(batch: AlnBatch, max_clip_ratio_lgs: float) -> np.ndarray:
    """contig_read_fliter2 (:679-686)."""
    ok = ((batch.flag & 0xD04) == 0) & (clip_rate(batch) <= max_clip_ratio_lgs)
    return ok.astype(np.uint8)


def region_overlap_mask(batch: AlnBatch, tid: int, start: int, end: int
                        ) -> np.ndarray:
    """Reads the BAM region iterator [start, end+1) would return."""
    span = batch.ref_span()
    return (
        (batch.tid == tid)
        & (batch.pos.astype(np.int64) + span > start)
        & (batch.pos <= end)
    )


# ---------------------------------------------------------------------------
# vectorized expansion
# ---------------------------------------------------------------------------

def _flat_ops(batch: AlnBatch, ridx: np.ndarray):
    """Concatenate cigar ops of the selected reads with per-op read ids and
    per-op ref/query start offsets (query offsets follow the C advance rules).
    """
    lens = batch.cigar_len[ridx].astype(np.int64)
    n_ops = int(lens.sum())
    op_read = np.repeat(np.arange(len(ridx)), lens)
    # gather flat cigar words
    starts = batch.cigar_off[ridx]
    idx = np.repeat(starts + lens - np.add.accumulate(lens), lens) + np.arange(n_ops)
    # idx formula: for each read segment, starts[r] + (global_i - seg_begin)
    words = batch.cigar[idx]
    op_type = (words & 0xF).astype(np.int64)
    op_len = (words >> 4).astype(np.int64)
    qadv = op_len * _QCON[op_type]
    radv = op_len * _RCON[op_type]
    seg_first = np.zeros(n_ops, dtype=bool)
    if n_ops:
        seg_first[np.concatenate([[0], np.cumsum(lens)[:-1]])[lens > 0]] = True
    def seg_excl_cumsum(x):
        c = np.cumsum(x) - x
        base = np.zeros_like(c)
        firsts = np.flatnonzero(seg_first)
        base_vals = c[firsts]
        base = np.repeat(base_vals, lens[lens > 0])
        return c - base
    qs = seg_excl_cumsum(qadv)
    rs = seg_excl_cumsum(radv) + batch.pos[ridx].astype(np.int64)[op_read]
    return op_read, op_type, op_len, qs, rs


def _read_trims(batch: AlnBatch, ridx: np.ndarray, trim_len_edge: int,
                op_read, op_type, op_len, rs):
    """qstart/qend per read with homopolymer extension and the
    leading-insertion shift (contig_cut_read :333-358 + :315-318)."""
    n = len(ridx)
    lqs = batch.lqseq[ridx].astype(np.int64)
    first = batch.cigar[batch.cigar_off[ridx]]
    lens_arr = batch.cigar_len[ridx]
    last = batch.cigar[batch.cigar_off[ridx] + np.maximum(lens_arr, 1) - 1]
    lsoft = np.where((first & 0xF) == CSOFT_CLIP, first >> 4, 0).astype(np.int64)
    rsoft = np.where((last & 0xF) == CSOFT_CLIP, last >> 4, 0).astype(np.int64)
    qstart = trim_len_edge + lsoft
    qend = lqs - trim_len_edge - rsoft - 1
    if trim_len_edge > 0:
        # homopolymer extension over the read sequence
        for r in range(n):
            seq = batch.rec_seq_nib(ridx[r])
            qs_ = qstart[r]
            while 0 < qs_ < len(seq) and seq[qs_] == seq[qs_ - 1]:
                qs_ += 1
            qstart[r] = qs_
            qe_ = qend[r]
            while 0 <= qe_ < len(seq) - 1 and seq[qe_] == seq[qe_ + 1]:
                qe_ -= 1
            qend[r] = qe_
    # leading insertions at ref pos 0 shift qstart (lib/contig.c:315-318)
    at0 = (op_type == CINS) & (rs == 0)
    if at0.any():
        shift = np.bincount(op_read[at0], weights=op_len[at0], minlength=n)
        qstart = qstart + shift.astype(np.int64)
    return qstart, qend


def build_cell_index(batch: AlnBatch, ins_levels: np.ndarray, tid: int,
                     start: int, end: int) -> CellIndex:
    """Insertion-slot discovery (contig_create_insert, lib/contig.c:170-245):
    ins_len[p] = max insertion length anchored after p over qualifying reads.
    """
    mask = (ins_levels >= 1) & region_overlap_mask(batch, tid, start, end)
    mask &= batch.cigar_len > 0
    ridx = np.flatnonzero(mask)
    width = end - start + 1
    ins_len = None
    if len(ridx):
        from .. import native

        ins_len = native.cell_index(ridx, batch.pos, batch.cigar,
                                    batch.cigar_off, batch.cigar_len,
                                    start, end)
    if ins_len is None:
        ins_len = np.zeros(width, dtype=np.int64)
        if len(ridx):
            op_read, op_type, op_len, qs, rs = _flat_ops(batch, ridx)
            ins = (op_type == CINS) & (rs > start) & (rs <= end)
            if ins.any():
                anchors = rs[ins] - 1 - start
                np.maximum.at(ins_len, anchors, op_len[ins])
    cell_of = np.zeros(width, dtype=np.int64)
    if width > 1:
        np.cumsum(1 + ins_len[:-1], out=cell_of[1:])
    n_cells = int(cell_of[-1] + 1 + ins_len[-1])
    return CellIndex(start, end, ins_len, cell_of, n_cells, int(cell_of[-1] + 1))


@dataclass
class Expanded:
    """Dense per-read emission rows over a region's cell chain."""

    ridx: np.ndarray  # selected read indices into the batch
    c0: np.ndarray  # [n_sel] first emitted cell (undefined when row_len==0)
    row_len: np.ndarray  # [n_sel]
    row_off: np.ndarray  # [n_sel+1] offsets into the flat arrays
    cells: np.ndarray  # [T] region-local cell ids
    syms: np.ndarray  # [T] compact symbols
    qidx: np.ndarray  # [T] query base index, -1 for DEL emissions
    read_of: np.ndarray  # [T] row index (into ridx) per entry

    def kmers(self) -> np.ndarray:
        """Rolling 3-mers with per-read PAD reset."""
        total = len(self.syms)
        prev1 = np.empty(total, dtype=np.uint8)
        prev2 = np.empty(total, dtype=np.uint8)
        prev1[1:] = self.syms[:-1]
        prev2[2:] = self.syms[:-2]
        firsts = self.row_off[:-1][self.row_len > 0]
        prev1[firsts] = PAD
        prev2[firsts] = PAD
        second = firsts + 1
        ok = second < self.row_off[:-1][self.row_len > 0] + self.row_len[
            self.row_len > 0
        ]
        prev2[second[ok]] = PAD
        return (
            prev2.astype(np.int32) * (S * S)
            + prev1.astype(np.int32) * S
            + self.syms.astype(np.int32)
        )


def _empty_expanded() -> Expanded:
    z = np.zeros(0, dtype=np.int64)
    return Expanded(z, z, z, np.zeros(1, dtype=np.int64), z,
                    np.zeros(0, dtype=np.uint8), z, z)


def build_cell_index_regions(batch: AlnBatch, ins_levels: np.ndarray,
                             tid: int, regions, L: int) -> CellIndex:
    """Contig-wide cell index with insert slots discovered only inside the
    given [s, e] regions (contig_create_insert_region, lib/contig.c:182-200).
    """
    ins_len = np.zeros(L, dtype=np.int64)
    mask = (ins_levels >= 1) & (batch.tid == tid) & (batch.cigar_len > 0)
    ridx = np.flatnonzero(mask)
    if len(ridx) and regions:
        op_read, op_type, op_len, qs, rs = _flat_ops(batch, ridx)
        ins = op_type == CINS
        if ins.any():
            pos = rs[ins]
            ln = op_len[ins]
            keep = np.zeros(len(pos), dtype=bool)
            for s, e in regions:
                keep |= (pos > s) & (pos <= e)
            if keep.any():
                np.maximum.at(ins_len, pos[keep] - 1, ln[keep])
    cell_of = np.zeros(L, dtype=np.int64)
    if L > 1:
        np.cumsum(1 + ins_len[:-1], out=cell_of[1:])
    n_cells = int(cell_of[-1] + 1 + ins_len[-1])
    return CellIndex(0, L - 1, ins_len, cell_of, n_cells, int(cell_of[-1] + 1))


def expand_reads(batch: AlnBatch, levels: np.ndarray, level: int,
                 index: CellIndex, tid: int, trim_len_edge: int = 2,
                 order_by_pos: bool = False) -> Expanded:
    """Expand reads at exactly `level` into dense per-read symbol rows.

    Each selected read contributes one contiguous run of cells; symbols
    follow contig_parse_read (lib/contig.c:247-331).
    """
    start, end = index.start, index.end
    mask = (levels == level) & region_overlap_mask(batch, tid, start, end)
    mask &= (batch.cigar_len > 0) & (batch.lqseq > 0)
    ridx = np.flatnonzero(mask)
    if order_by_pos:
        ridx = ridx[np.argsort(batch.pos[ridx], kind="stable")]
    if not len(ridx):
        return _empty_expanded()
    op_read, op_type, op_len, qs, rs = _flat_ops(batch, ridx)
    qstart, qend = _read_trims(batch, ridx, trim_len_edge, op_read, op_type,
                               op_len, rs)
    qstart_o = qstart[op_read]
    qend_o = qend[op_read]

    ins_of = np.zeros(end - start + 2, dtype=np.int64)
    ins_of[: end - start + 1] = index.ins_len
    cell_of = index.cell_of

    def _cells_for(pos):
        return cell_of[pos - start]

    cand_cells = []
    cand_q = []  # query index for base lookup (-1 -> DEL)
    cand_read = []

    # M bases -------------------------------------------------------------
    m = op_type == CMATCH
    if m.any():
        rep = np.repeat(np.flatnonzero(m), op_len[m])
        j = np.arange(len(rep)) - np.repeat(
            np.cumsum(op_len[m]) - op_len[m], op_len[m]
        )
        pos = rs[rep] + j
        qpos = qs[rep] + j
        g = (pos >= start) & (pos <= end) & (qpos >= qstart_o[rep]) & (
            qpos <= qend_o[rep]
        )
        cand_cells.append(_cells_for(pos[g]))
        cand_q.append(qpos[g])
        cand_read.append(op_read[rep[g]])

    # D bases -------------------------------------------------------------
    d = op_type == CDEL
    if d.any():
        rep = np.repeat(np.flatnonzero(d), op_len[d])
        j = np.arange(len(rep)) - np.repeat(
            np.cumsum(op_len[d]) - op_len[d], op_len[d]
        )
        pos = rs[rep] + j
        qpos = qs[rep]  # D does not consume query
        g = (pos >= start) & (pos <= end) & (qpos >= qstart_o[rep]) & (
            qpos <= qend_o[rep]
        )
        cand_cells.append(_cells_for(pos[g]))
        cand_q.append(np.full(int(g.sum()), -1, dtype=np.int64))
        cand_read.append(op_read[rep[g]])

    # I bases and padding --------------------------------------------------
    i_ = (op_type == CINS) & (rs > start) & (rs <= end) & (rs > 0)
    if i_.any():
        iops = np.flatnonzero(i_)
        # own bases
        rep = np.repeat(iops, op_len[iops])
        j = np.arange(len(rep)) - np.repeat(
            np.cumsum(op_len[iops]) - op_len[iops], op_len[iops]
        )
        qpos = qs[rep] + j
        g = (qpos >= qstart_o[rep]) & (qpos <= qend_o[rep])
        anchor = rs[rep] - 1 - start
        # clip insertions longer than the anchor's slot count — happens when
        # the parsed read set differs from the slot-creating set (e.g. lgs
        # reads over an sgs-built index in snp_phase); the reference's
        # equivalent walk would index past its insert list here
        g &= j < ins_of[anchor]
        cand_cells.append(cell_of[anchor[g]] + 1 + j[g])
        cand_q.append(qpos[g])
        cand_read.append(op_read[rep[g]])
        # DEL padding up to the anchor's insert length
        anchor_ops = rs[iops] - 1 - start
        padn = np.maximum(ins_of[anchor_ops] - op_len[iops], 0)
        qafter = qs[iops] + op_len[iops]
        pg = (qafter > qstart[op_read[iops]]) & (qafter <= qend[op_read[iops]] + 1)
        padn = np.where(pg, padn, 0)
        if padn.sum():
            rep = np.repeat(np.arange(len(iops)), padn)
            j = np.arange(len(rep)) - np.repeat(np.cumsum(padn) - padn, padn)
            cand_cells.append(cell_of[anchor_ops[rep]] + 1 + op_len[iops][rep] + j)
            cand_q.append(np.full(len(rep), -1, dtype=np.int64))
            cand_read.append(op_read[iops[rep]])

    cells = np.concatenate(cand_cells) if cand_cells else np.zeros(0, np.int64)
    qv = np.concatenate(cand_q) if cand_q else np.zeros(0, np.int64)
    rd = np.concatenate(cand_read) if cand_read else np.zeros(0, np.int64)
    if not len(cells):
        return _empty_expanded()

    # per-read contiguous range [c0, c1] — pass-through cells are always
    # interior, so candidates suffice to determine the range
    nsel = len(ridx)
    c0 = np.full(nsel, np.iinfo(np.int64).max, dtype=np.int64)
    c1 = np.full(nsel, -1, dtype=np.int64)
    np.minimum.at(c0, rd, cells)
    np.maximum.at(c1, rd, cells)
    used = c1 >= 0
    c0 = np.where(used, c0, 0)
    row_len = np.where(used, c1 - c0 + 1, 0)
    row_off = np.concatenate([[0], np.cumsum(row_len)])
    total = int(row_off[-1])

    # dense symbol rows, default DEL; scatter read bases (q >= 0)
    syms = np.full(total, DEL, dtype=np.uint8)
    qidx = np.full(total, -1, dtype=np.int64)
    hasq = qv >= 0
    if hasq.any():
        rr = rd[hasq]
        seq_off = batch.seq_off[ridx]
        base_nib = batch.seq[seq_off[rr] + qv[hasq]]
        slot = row_off[rr] + (cells[hasq] - c0[rr])
        syms[slot] = NIB_TO_SYM[base_nib]
        qidx[slot] = qv[hasq]

    rows_used = np.flatnonzero(used)
    rep = np.repeat(rows_used, row_len[rows_used])
    within = np.arange(total) - np.repeat(row_off[rows_used], row_len[rows_used])
    out_cells = c0[rep] + within
    return Expanded(ridx, c0, row_len, row_off, out_cells, syms, qidx, rep)


def ref_stream(index: CellIndex, contig_nib: np.ndarray):
    """Contig-as-read (lib/contig.c:373-383): symbols over cells
    [0, n_cells_dp), ref bases at pos cells and DEL at insert cells."""
    n = index.n_cells_dp
    syms = np.full(index.n_cells, DEL, dtype=np.uint8)
    syms[index.cell_of] = NIB_TO_SYM[contig_nib[index.start : index.end + 1]]
    kmers = np.zeros(index.n_cells, dtype=np.int32)
    kmers[:n] = rolling_kmers(syms[:n])
    return syms, kmers


def sparse_counts(cells: np.ndarray, kmers: np.ndarray, n: int) -> np.ndarray:
    """[n, K3] uint16 counts from (cell, kmer) event streams via sorted
    unique keys (avoids the n*K3 int64 scratch a bincount would need)."""
    counts = np.zeros((n, K3), dtype=np.uint16)
    if len(cells):
        keys = cells * K3 + kmers
        uk, cn = np.unique(keys, return_counts=True)
        counts.reshape(-1)[uk] = np.minimum(cn, np.iinfo(np.uint16).max)
    return counts


@dataclass
class SparsePileup:
    """Pileup as sorted (cell*K3+kmer) event keys with counts — avoids the
    dense [n_cells, K3] tensor on the score-chain hot path."""

    index: CellIndex
    uk: np.ndarray  # int64 sorted unique keys
    cn: np.ndarray  # int64 counts per key
    total: np.ndarray  # int32 per-cell totals (incl. contig-as-read)
    refkmer: np.ndarray
    ref_sym: np.ndarray
    rk: np.ndarray  # uint16 per-key first-observation rank (see event_ranks)

    def ndistinct(self, lo: int, hi: int) -> np.ndarray:
        """Distinct observed kmers per cell in [lo, hi)."""
        a = np.searchsorted(self.uk, lo * K3)
        b = np.searchsorted(self.uk, hi * K3)
        out = np.bincount((self.uk[a:b] // K3 - lo).astype(np.int64),
                          minlength=hi - lo)
        return out.astype(np.int64)

    def rank_window(self, lo: int, hi: int) -> np.ndarray:
        """[hi-lo, K3] uint16 dense ranks for a cell window."""
        a = np.searchsorted(self.uk, lo * K3)
        b = np.searchsorted(self.uk, hi * K3)
        out = np.full((hi - lo, K3), RANK_NONE, dtype=np.uint16)
        out.reshape(-1)[self.uk[a:b] - lo * K3] = self.rk[a:b]
        return out

    def dense_window(self, lo: int, hi: int) -> np.ndarray:
        """[hi-lo, K3] uint16 counts for a cell window."""
        a = np.searchsorted(self.uk, lo * K3)
        b = np.searchsorted(self.uk, hi * K3)
        out = np.zeros((hi - lo, K3), dtype=np.uint16)
        out.reshape(-1)[self.uk[a:b] - lo * K3] = np.minimum(
            self.cn[a:b], np.iinfo(np.uint16).max)
        return out


def build_pileup_sparse(batch: AlnBatch, levels: np.ndarray, level: int,
                        index: CellIndex, tid: int, contig_nib: np.ndarray,
                        trim_len_edge: int = 2,
                        include_ref: bool = True) -> SparsePileup:
    """Sparse full pileup: reads at `level` + the contig-as-read.

    Uses the native single-pass walker (native/pileup.cpp) when available;
    the vectorized-numpy expansion below is the fallback and the oracle the
    native path is tested against.  `include_ref=False` drops the
    contig-as-read row — used by the reads-sharded multi-chip path, where
    only shard 0 carries it (it must count exactly once after the psum
    merge, lib/contig.c:373)."""
    native = _native_pileup(batch, levels, level, index, tid, contig_nib,
                            trim_len_edge, include_ref)
    if native is not None:
        return native
    ex = expand_reads(batch, levels, level, index, tid, trim_len_edge)
    ref_sym, refkmer = ref_stream(index, contig_nib)
    n = index.n_cells
    ndp = index.n_cells_dp
    keys = ex.cells * K3 + ex.kmers()
    if include_ref:
        refkeys = np.arange(ndp, dtype=np.int64) * K3 + refkmer[:ndp]
        # observation order: contig-as-read first, then reads
        # (contig_as_read runs before contig_parse_region,
        # lib/contig.c:714-716)
        ordered_cells = np.concatenate([np.arange(ndp, dtype=np.int64),
                                        ex.cells])
        ordered_kmers = np.concatenate([refkmer[:ndp].astype(np.int64),
                                        ex.kmers().astype(np.int64)])
        allkeys = np.concatenate([keys, refkeys])
    else:
        ordered_cells, ordered_kmers = ex.cells, ex.kmers().astype(np.int64)
        allkeys = keys
    rank_dense = event_ranks(ordered_cells, ordered_kmers, n)
    uk, cn = np.unique(allkeys, return_counts=True)
    total = np.bincount(ex.cells, minlength=n).astype(np.int32)
    if include_ref:
        total[:ndp] += 1
    return SparsePileup(index, uk, cn, total, refkmer.astype(np.int32),
                        ref_sym, rank_dense.reshape(-1)[uk])


def _native_pileup(batch: AlnBatch, levels: np.ndarray, level: int,
                   index: CellIndex, tid: int, contig_nib: np.ndarray,
                   trim_len_edge: int,
                   include_ref: bool = True) -> SparsePileup | None:
    from .. import native

    if not native.available():
        return None
    mask = (levels == level) & region_overlap_mask(batch, tid, index.start,
                                                   index.end)
    mask &= (batch.cigar_len > 0) & (batch.lqseq > 0)
    ridx = np.flatnonzero(mask)
    ref_sym, refkmer = ref_stream(index, contig_nib)
    span = batch.ref_span()
    max_span = int(span[ridx].max()) if len(ridx) else 1
    out = native.pileup_sgs(
        ridx, batch.pos, batch.cigar, batch.cigar_off, batch.cigar_len,
        batch.seq, batch.seq_off, batch.lqseq, index.start, index.end,
        index.cell_of, index.ins_len, index.n_cells, index.n_cells_dp,
        refkmer if include_ref else None, trim_len_edge, max_span=max_span,
    )
    if out is None:
        return None
    uk, cn, rk, total = out
    return SparsePileup(index, uk, cn, total, refkmer.astype(np.int32),
                        ref_sym, rk)


def build_pileup_planes(batch: AlnBatch, levels: np.ndarray, level: int,
                        index: CellIndex, tid: int,
                        contig_nib: np.ndarray, trim_len_edge: int = 2,
                        n_threads: int = 0):
    """Task-1 hot-path pileup via the native slot walker
    (native/pileup.cpp npt_pileup_planes): emits the chain-DP transfer
    planes directly — no dense [cells*512] table, no dirty-list sort,
    no numpy re-pack.  Returns (upper, c0, totals, stats, ov, refkmer)
    for tropical.pack_chain_planes_parts, or None when the native lib
    is unavailable (callers fall back to build_pileup_sparse +
    pack_chain_planes, which is byte-equality-tested against this
    path)."""
    from .. import native

    if not native.available():
        return None
    mask = (levels == level) & region_overlap_mask(batch, tid, index.start,
                                                   index.end)
    mask &= (batch.cigar_len > 0) & (batch.lqseq > 0)
    ridx = np.flatnonzero(mask)
    ref_sym, refkmer = ref_stream(index, contig_nib)
    span = batch.ref_span()
    max_span = int(span[ridx].max()) if len(ridx) else 1
    out = native.pileup_planes(
        ridx, batch.pos, batch.cigar, batch.cigar_off, batch.cigar_len,
        batch.seq, batch.seq_off, batch.lqseq, index.start, index.end,
        index.cell_of, index.ins_len, index.n_cells, index.n_cells_dp,
        refkmer, trim_len_edge, max_span=max_span, n_threads=n_threads)
    if out is None:
        return None
    upper, c0, totals, stats, ov = out
    return upper, c0, totals, stats, ov, refkmer.astype(np.int32)


def build_pileup(batch: AlnBatch, levels: np.ndarray, level: int,
                 index: CellIndex, tid: int, contig_nib: np.ndarray,
                 trim_len_edge: int = 2) -> Pileup:
    """Full pileup for one region: reads at `level` + the contig-as-read."""
    ex = expand_reads(batch, levels, level, index, tid, trim_len_edge)
    ref_sym, refkmer = ref_stream(index, contig_nib)
    n = index.n_cells
    ndp = index.n_cells_dp
    counts = sparse_counts(ex.cells, ex.kmers(), n)
    # totals from the event stream (+1 per DP cell for the contig-as-read)
    total = np.bincount(ex.cells, minlength=n).astype(np.int32)
    dp = np.arange(ndp)
    counts[dp, refkmer[:ndp]] += 1
    total[:ndp] += 1
    ordered_cells = np.concatenate([np.arange(ndp, dtype=np.int64), ex.cells])
    ordered_kmers = np.concatenate([refkmer[:ndp].astype(np.int64),
                                    ex.kmers().astype(np.int64)])
    rank = event_ranks(ordered_cells, ordered_kmers, n)
    return Pileup(index, counts, total, refkmer.astype(np.int32), ref_sym,
                  rank)


def add_reads_to_pileup(pileup: Pileup, batch: AlnBatch, levels: np.ndarray,
                        level: int, tid: int, trim_len_edge: int = 2) -> Pileup:
    """Accumulate another filter level into an existing pileup
    (the no-depth rescue re-parse, lib/contig.c:721-733)."""
    ex = expand_reads(batch, levels, level, pileup.index, tid, trim_len_edge)
    n = pileup.index.n_cells
    extra = sparse_counts(ex.cells, ex.kmers(), n)
    counts = np.minimum(
        pileup.counts.astype(np.int32) + extra, np.iinfo(np.uint16).max
    ).astype(np.uint16)
    total = pileup.total + np.bincount(ex.cells, minlength=n).astype(np.int32)
    rank = pileup.rank
    if rank is not None:
        nd = (rank != RANK_NONE).sum(axis=1).astype(np.int64)
        rank = event_ranks(ex.cells, ex.kmers().astype(np.int64), n,
                           base_ndistinct=nd, base_rank=rank)
    return Pileup(pileup.index, counts, total, pileup.refkmer,
                  pileup.ref_sym, rank)


# ---------------------------------------------------------------------------
# oracle: direct transcription of the C walk, for property tests
# ---------------------------------------------------------------------------

def slow_pileup(batch: AlnBatch, levels: np.ndarray, level: int,
                ins_levels: np.ndarray, tid: int, start: int, end: int,
                contig_nib: np.ndarray, trim_len_edge: int = 2):
    """Reference-faithful per-base walk (contig_create_insert +
    contig_as_read + contig_parse_read).  Slow; tests only."""
    width = end - start + 1
    ins_len = np.zeros(width, dtype=np.int64)
    span = batch.ref_span()
    inregion = (
        (batch.tid == tid)
        & (batch.pos.astype(np.int64) + span > start)
        & (batch.pos <= end)
    )
    for r in np.flatnonzero((ins_levels >= 1) & inregion & (batch.cigar_len > 0)):
        pos = int(batch.pos[r])
        for word in batch.rec_cigar(r):
            op, ln = word & 0xF, int(word) >> 4
            if op in (CMATCH, CDEL):
                pos += ln
            elif op == CINS:
                if start < pos <= end:
                    a = pos - 1 - start
                    ins_len[a] = max(ins_len[a], ln)
    cell_of = np.zeros(width, dtype=np.int64)
    if width > 1:
        np.cumsum(1 + ins_len[:-1], out=cell_of[1:])
    n_cells = int(cell_of[-1] + 1 + ins_len[-1])
    n_dp = int(cell_of[-1] + 1)
    index = CellIndex(start, end, ins_len, cell_of, n_cells, n_dp)

    counts = np.zeros((n_cells, K3), dtype=np.int64)

    def kshift(kmer, sym):
        return ((kmer & 0o77) * S + sym) & 0x1FF  # (kmer & 0xff) << 4 | base

    # contig as read
    ref_sym, refkmer = ref_stream(index, contig_nib)
    for c in range(n_dp):
        counts[c, refkmer[c]] += 1

    for r in np.flatnonzero((levels == level) & inregion & (batch.cigar_len > 0)
                            & (batch.lqseq > 0)):
        seq = NIB_TO_SYM[batch.rec_seq_nib(r)]
        cig = batch.rec_cigar(r)
        lsoft = (cig[0] >> 4) if (cig[0] & 0xF) == CSOFT_CLIP else 0
        rsoft = (cig[-1] >> 4) if (cig[-1] & 0xF) == CSOFT_CLIP else 0
        qstart = trim_len_edge + int(lsoft)
        qend = int(batch.lqseq[r]) - trim_len_edge - int(rsoft) - 1
        if trim_len_edge > 0:
            while 0 < qstart < len(seq) and seq[qstart] == seq[qstart - 1]:
                qstart += 1
            while 0 <= qend < len(seq) - 1 and seq[qend] == seq[qend + 1]:
                qend -= 1
        pos, qpos = int(batch.pos[r]), 0
        kmer = 0
        lastcig = CINS
        for word in cig:
            op, ln = int(word) & 0xF, int(word) >> 4
            if op in (CMATCH, CDEL):
                for _ in range(ln):
                    if start <= pos <= end and qstart <= qpos <= qend:
                        if (lastcig != CINS and pos > start
                                and (qpos > qstart
                                     or (qpos == qstart and lastcig == CDEL))):
                            a = pos - 1 - start
                            for k in range(ins_len[a]):
                                kmer = kshift(kmer, DEL)
                                counts[cell_of[a] + 1 + k, kmer] += 1
                        sym = DEL if op == CDEL else int(seq[qpos])
                        kmer = kshift(kmer, sym)
                        counts[cell_of[pos - start], kmer] += 1
                    if op != CDEL:
                        qpos += 1
                    pos += op == CMATCH or op == CDEL  # pos++ every M/D base
                    lastcig = op
            elif op == CINS:
                if pos:
                    a = pos - 1 - start
                    j = 0
                    for j in range(ln):
                        if start < pos <= end and qstart <= qpos <= qend:
                            kmer = kshift(kmer, int(seq[qpos]))
                            counts[cell_of[a] + 1 + j, kmer] += 1
                        qpos += 1
                    j = ln
                    if start < pos <= end and qstart < qpos <= qend + 1:
                        while j < ins_len[a]:
                            kmer = kshift(kmer, DEL)
                            counts[cell_of[a] + 1 + j, kmer] += 1
                            j += 1
                    lastcig = op
                else:
                    qpos += ln
                    qstart += ln
                    lastcig = op
            elif op in (CSOFT_CLIP, CHARD_CLIP):
                qpos += ln
            if pos > end:
                break
    total = counts.sum(axis=1)
    return index, counts, total, refkmer, ref_sym
