"""Task 2 — k-mer vote repair of low-quality regions (lib/kmercount.c),
copied from nextpolish_tpu/models/kmer_count.py; the chain DPs of step 2
run on the device the caller names.

Per contig (kmer_count :93-126):
  1. find `nodepth` runs of FLAG_ZERO (lowercase from task 1) with
     con=min_len_ldr, and `kmerregion` runs with gap=min_len_inter_kmer and
     homopolymer-aware brim extension;
  2. create insert slots inside both region sets, then re-run the chain DP
     (filter level 2, with level-1 no-depth rescue) on nodepth regions;
  3. split long kmer regions at confident midpoints (ss_spilt_region :128) and
     replace each region with the winning spanning read string, voted by
     (count, sum mapq, sum mean-baseq) with a 50-read mapq-60 cap
     (ss_kmer_correct :175, ks_compare :63);
  4. emit with FLAG_ZERO lowercasing only.
"""
from __future__ import annotations

import numpy as np

from ..io.bam import AlnBatch
from ..io.fasta import ASCII_TO_NIB
from ..ops import pileup as pl
from .contig_state import (ContigState, find_regions, maybe_trace,
                           merge_regions)
from .flags import FLAG_ZERO
from .score_chain import AlgoConfig, score_correct_region

MAX_MAPQ = 60  # lib/config.h:22-23


def split_regions(state: ContigState, regions, flag_bit: int, max_len: int):
    """ss_spilt_region (lib/kmercount.c:128-173): regions wider than max_len
    are split at midpoints of interior non-flagged runs."""
    index = state.index
    cell_pos = index.cell_pos()
    out = []
    for s, e in regions:
        pieces = [s]
        if e - s > max_len:
            c = int(index.cell_of[s - index.start])
            c_hi = int(index.cell_of[e - index.start])
            # skip to the first flagged cell
            while c <= c_hi and (state.flag[c] & flag_bit) == 0:
                c += 1
            runs = []
            qstart = qend = -1
            while c <= c_hi:
                p = int(cell_pos[c])
                if (state.flag[c] & flag_bit) == 0:
                    if qstart == -1:
                        qstart = p
                    qend = p
                elif qstart != -1:
                    runs.append((qstart, qend))
                    qstart = qend = -1
                c += 1
            for qs, qe in runs:
                mid = (qs + qe) >> 1
                pieces.append(mid)
                pieces.append(mid)
        pieces.append(e)
        out.extend(
            (pieces[i], pieces[i + 1]) for i in range(0, len(pieces), 2)
        )
    return out


def kmer_vote_region(state: ContigState, batch: AlnBatch, levels: np.ndarray,
                     tid: int, s: int, e: int, cfg: AlgoConfig,
                     flagzero: int = 0) -> bool:
    """ss_kmer_correct for one region (lib/kmercount.c:175-261).

    Returns True if any spanning read voted (region replaced)."""
    index = state.index
    view = index.region_view(s, e)
    cell0 = int(index.cell_of[s - index.start])
    length = view.n_cells_dp

    def collect(level):
        ex = pl.expand_reads(batch, levels, level, view, tid,
                             cfg.trim_len_edge, order_by_pos=True)
        return ex

    ex = collect(2)
    groups, processed_rows, cap_hit = _vote(ex, batch, view, length, cfg)
    if not groups:
        # level-1 fallback (lib/kmercount.c:210-219).  Note: the reference
        # has a stale-variable bug here (it re-tests the previous loop's last
        # read); we implement the evident intent — iterate level-1 reads.
        ex = collect(1)
        groups, processed_rows, cap_hit = _vote(ex, batch, view, length, cfg,
                                                cap=None)

    # FLAG_ZERO clearing on cells touched by processed reads
    if flagzero == 0 and len(processed_rows):
        keep = np.isin(ex.read_of, processed_rows)
        state.flag[cell0 + ex.cells[keep]] &= 0xFF ^ FLAG_ZERO
    if not groups:
        return False
    if flagzero:
        state.flag[cell0 : cell0 + length] &= 0xFF ^ FLAG_ZERO

    # winner selection (lib/kmercount.c:221-241): if the mapq-60 cap was hit,
    # prefer the first group whose summed mapq equals MAX_MAPQ * cap; else
    # first-wins max by (num, mapqual, qual)
    best = None
    if cap_hit:
        for g in groups.values():
            if g["mapqual"] == MAX_MAPQ * cfg.max_count_kmer:
                best = g
                break
    if best is None:
        for g in groups.values():
            if best is None or _ks_compare(best, g) < 0:
                best = g
    state.base[cell0 : cell0 + length] = best["syms"]
    return True


def _ks_compare(a, b) -> int:
    """(num, mapqual, qual) lexicographic (ks_compare, lib/kmercount.c:63-88).
    Returns -1 if a < b, 1 if a > b, 0 if equal."""
    for key in ("num", "mapqual", "qual"):
        if a[key] > b[key]:
            return 1
        if a[key] < b[key]:
            return -1
    return 0


def _vote(ex: pl.Expanded, batch: AlnBatch, view, length: int,
          cfg: AlgoConfig, cap: int | None = -1):
    """Group spanning read rows; honor the mapq-60 cap (cap=-1 -> cfg value).

    Returns (groups dict keyed by row bytes, processed row ids)."""
    if cap == -1:
        cap = cfg.max_count_kmer
    groups: dict[bytes, dict] = {}
    n60 = 0
    processed = []
    insert_cell = np.ones(view.n_cells, dtype=bool)
    insert_cell[view.cell_of] = False
    from ..ops.symbols import DEL

    nrows = len(ex.ridx)
    for row in range(nrows):
        lo, hi = ex.row_off[row], ex.row_off[row + 1]
        if lo == hi:
            continue
        processed.append(row)
        spanning = (hi - lo) == length and ex.cells[lo] == 0
        if not spanning:
            continue
        syms = ex.syms[lo:hi]
        rid = ex.ridx[row]
        mapq = int(batch.mapq[rid])
        qidx = ex.qidx[lo:hi]
        hasq = qidx >= 0
        qual_sum = int(batch.qual[batch.qual_off[rid] + qidx[hasq]].sum())
        n_ins_del = int(((syms == DEL) & insert_cell[ex.cells[lo:hi]]).sum())
        denom = length - n_ins_del
        qual = qual_sum // denom if denom > 0 else 0
        key = syms.tobytes()
        g = groups.get(key)
        if g is None:
            groups[key] = dict(syms=syms.copy(), num=1, mapqual=mapq,
                               qual=qual)
        else:
            g["num"] += 1
            g["mapqual"] += mapq
            g["qual"] += qual
        if mapq == MAX_MAPQ:
            n60 += 1
            if cap is not None and n60 >= cap:
                break
    cap_hit = cap is not None and n60 == cap
    return groups, np.asarray(processed, dtype=np.int64), cap_hit


def kmer_count_contig(name: str, draft: bytes, batch: AlnBatch,
                      cfg: AlgoConfig, device=None) -> bytes:
    """Task 2 entry for one contig (kmer_count, lib/kmercount.c:93-126);
    the chain DPs run on `device` (default cuda)."""
    tid = batch.header.name2id(name)
    L = len(draft)
    levels = pl.filter_sgs(batch, cfg.read_tlen, cfg.max_clip_ratio_sgs,
                           cfg.min_map_quality)
    # region discovery happens before any inserts exist
    flat_index = pl.CellIndex(
        0, L - 1, np.zeros(L, dtype=np.int64),
        np.arange(L, dtype=np.int64), L, L,
    )
    state0 = ContigState.from_draft(name, draft, flat_index)
    nodepth = find_regions(state0, 0, L - 1, gap=0, con=cfg.min_len_ldr,
                           flag_bit=FLAG_ZERO, extend=False,
                           ext_len_edge=cfg.ext_len_edge)
    kmerregion = find_regions(state0, 0, L - 1, gap=cfg.min_len_inter_kmer,
                              con=0, flag_bit=FLAG_ZERO, extend=True,
                              ext_len_edge=cfg.ext_len_edge)
    kmerregion = merge_regions(kmerregion)
    nodepth = merge_regions(nodepth)

    # build the real cell chain with inserts inside both region sets
    index = pl.build_cell_index_regions(batch, levels, tid,
                                        kmerregion + nodepth, L)
    state = ContigState.from_draft(name, draft, index)
    contig_nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]

    for s, e in nodepth:
        score_correct_region(state, batch, levels, tid, contig_nib, s, e,
                             filterlevel=2,
                             rate=cfg.indel_balance_factor_sgs, cfg=cfg,
                             device=device)

    if kmerregion:
        pieces = split_regions(state, kmerregion, FLAG_ZERO, cfg.max_len_kmer)
        for s, e in pieces:
            kmer_vote_region(state, batch, levels, tid, s, e, cfg)

    maybe_trace(cfg, name, state, draft)
    return state.emit(FLAG_ZERO)
