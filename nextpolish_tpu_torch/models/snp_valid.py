"""Task 4 — SNP re-validation (snp_valid, lib/snpvalid.c:3-35).

kmer_count-style re-vote restricted to FLAG_ZERO sites left by task 3:
regions from lowercase runs (with-extension brim), midpoint splitting, a
first vote pass that records vote-less regions, then a re-split of those
at FLAG_ZERO boundaries (fts_spilt_region :37-66) and a final vote.
Output has no lowercase marking (out flags = 0).

A copy of nextpolish_tpu/models/snp_valid.py: only its imports may differ,
and none had to (they are relative).  It runs no device code.
"""
from __future__ import annotations

import numpy as np

from ..io.bam import AlnBatch
from ..ops import pileup as pl
from .contig_state import (ContigState, find_regions, maybe_trace,
                           merge_regions)
from .flags import FLAG_ZERO
from .kmer_count import kmer_vote_region, split_regions
from .score_chain import AlgoConfig


def _fts_split(state: ContigState, s: int, e: int, flag_bit: int):
    """fts_spilt_region: boundaries at midpoints of non-flagged runs."""
    index = state.index
    cell_pos = index.cell_pos()
    pts = []
    qstart = qend = -1
    c = int(index.cell_of[s - index.start])
    c_hi = int(index.cell_of[e - index.start])
    while c <= c_hi:
        p = int(cell_pos[c])
        if (state.flag[c] & flag_bit) == 0:
            if qstart == -1:
                qstart = p
            qend = p
        elif qstart != -1:
            count = 2
            if qstart == s:
                qend = s
                count -= 1
            mid = (qstart + qend) // 2
            for _ in range(count):
                pts.append(mid)
                if qstart != qend:
                    mid += 1
            qstart = qend = -1
        c += 1
    pts.append(e)
    return [(pts[i], pts[i + 1]) for i in range(0, len(pts) - 1, 2)]


def snp_valid_contig(name: str, draft: bytes, sgs_batch: AlnBatch,
                     lgs_batch, cfg: AlgoConfig) -> bytes:
    batch = sgs_batch
    tid = batch.header.name2id(name)
    L = len(draft)
    levels = pl.filter_sgs(batch, cfg.read_tlen, cfg.max_clip_ratio_sgs,
                           cfg.min_map_quality)
    flat = pl.CellIndex(0, L - 1, np.zeros(L, dtype=np.int64),
                        np.arange(L, dtype=np.int64), L, L)
    state0 = ContigState.from_draft(name, draft, flat)
    kmerregion = merge_regions(
        find_regions(state0, 0, L - 1, gap=cfg.min_len_inter_kmer, con=0,
                     flag_bit=FLAG_ZERO, extend=True,
                     ext_len_edge=cfg.ext_len_edge)
    )
    if not kmerregion:
        return state0.emit(0)

    index = pl.build_cell_index_regions(batch, levels, tid, kmerregion, L)
    state = ContigState.from_draft(name, draft, index)
    pieces = split_regions(state, kmerregion, FLAG_ZERO, cfg.max_len_kmer)
    no_votes = []
    for s, e in pieces:
        ok = kmer_vote_region(state, batch, levels, tid, s, e, cfg,
                              flagzero=1)
        if not ok:
            no_votes.append((s, e))
    for s, e in no_votes:
        for s2, e2 in _fts_split(state, s, e, FLAG_ZERO):
            kmer_vote_region(state, batch, levels, tid, s2, e2, cfg,
                             flagzero=0)
    maybe_trace(cfg, name, state, draft)
    return state.emit(0)
