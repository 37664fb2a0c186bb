"""Legacy task 5 — long-read score chain in engine 1 (lgspolish,
lib/lgspolish.c).

The chain DP generalized to long reads: because indels break implicit
cell adjacency, each observation is an explicit 3-tuple of (base, cell)
items (TdKmer, lib/lgspolish.h:6-18).  Scores follow
    score(tuple) = score(prev item's cell, prev base) + count - total*rate
with the reference kmer's count reduced by one and the insert-cell total
fallbacks of td_region_score (:168-227); traceback follows per-cell best
entries' previous items (td_region_correct :229-253).

The production task 5 is the nextpolish2-style consensus (models/ctg_cns);
this engine exists for worker1 -t 5 / `nextpolish1 lgspolish` parity.

A copy of nextpolish_tpu/models/lgs_polish.py: only its imports may
differ, and none had to (they are relative).  It runs no device code.
"""
from __future__ import annotations

import numpy as np

from ..io.bam import AlnBatch
from ..ops import pileup as pl
from .contig_state import ContigState, draft_to_syms, maybe_trace
from .score_chain import AlgoConfig

BASE_DEL = 3
NEG = float("-inf")


def lgspolish_contig(name: str, draft: bytes, lgs_batch: AlnBatch,
                     cfg: AlgoConfig) -> bytes:
    batch = lgs_batch
    tid = batch.header.name2id(name)
    L = len(draft)
    levels = pl.filter_lgs(batch, cfg.max_clip_ratio_lgs)
    index = pl.build_cell_index(batch, levels, tid, 0, L - 1)
    state = ContigState.from_draft(name, draft, index)
    contig_sym, _lower = draft_to_syms(draft)
    ex = pl.expand_reads(batch, levels, 1, index, tid, cfg.trim_len_edge)

    is_ins = index.is_insert_cell()
    n_cells = index.n_cells
    cell_pos = index.cell_pos()
    pos_cell = index.cell_of  # position -> its cell id

    # item streams: the reference row first (position cells only), then
    # reads in order; td_parse_read emits no pass-through padding, so
    # dense-row DELs at insert cells are dropped
    streams = [(pos_cell[:L].astype(np.int64),
                contig_sym.astype(np.int64))]
    for row in range(len(ex.ridx)):
        lo, hi = int(ex.row_off[row]), int(ex.row_off[row + 1])
        cells = ex.cells[lo:hi].astype(np.int64)
        syms = ex.syms[lo:hi].astype(np.int64)
        qidx = ex.qidx[lo:hi]
        keep = (~is_ins[cells]) | (qidx >= 0)
        if keep.any():
            streams.append((cells[keep], syms[keep]))

    # tuples per item: ((b2,c2),(b1,c1),(b0,c0)) with (0,0) heads
    cell_l, sym_l, p1c_l, p1s_l, p2c_l, p2s_l = [], [], [], [], [], []
    for cells, syms in streams:
        n = len(cells)
        if not n:
            continue
        p1c = np.concatenate([[0], cells[:-1]])
        p1s = np.concatenate([[0], syms[:-1]])
        p2c = np.concatenate([[0, 0], cells[:-2]]) if n > 1 else \
            np.zeros(n, np.int64)
        p2s = np.concatenate([[0, 0], syms[:-2]]) if n > 1 else \
            np.zeros(n, np.int64)
        p1c = np.where(p1s == 0, 0, p1c)
        p2c = np.where(p2s == 0, 0, p2c)
        cell_l.append(cells)
        sym_l.append(syms)
        p1c_l.append(p1c)
        p1s_l.append(p1s)
        p2c_l.append(p2c)
        p2s_l.append(p2s)
    if not cell_l:
        return state.emit(0)
    cell = np.concatenate(cell_l)
    sym = np.concatenate(sym_l)
    p1c = np.concatenate(p1c_l)
    p1s = np.concatenate(p1s_l)
    p2c = np.concatenate(p2c_l)
    p2s = np.concatenate(p2s_l)

    # group identical (cell, tuple) with counts, insertion order preserved
    C = np.int64(n_cells + 1)
    key = ((((p2s * C + p2c) * 16 + p1s) * C + p1c) * 16 + sym) * C + cell
    order = np.argsort(key, kind="stable")
    ks = key[order]
    change = np.ones(len(ks), dtype=bool)
    change[1:] = ks[1:] != ks[:-1]
    starts = np.flatnonzero(change)
    gid_sorted = np.cumsum(change) - 1
    counts = np.diff(np.concatenate([starts, [len(ks)]]))
    first = np.full(len(starts), np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(first, gid_sorted, order)
    # reorder groups by (cell, first-occurrence) — the C's per-cell
    # insertion-order seqlists
    g_order = np.lexsort((first, cell[first]))
    first = first[g_order]
    g_cnt = counts[g_order]
    g_cell = cell[first]
    g_sym = sym[first]
    g_p1c = p1c[first]
    g_p1s = p1s[first]
    g_p2s = p2s[first]
    grp_starts = np.concatenate(
        [np.flatnonzero(np.concatenate([[True], g_cell[1:] != g_cell[:-1]])),
         [len(g_cell)]])

    # per-cell totals (q->count) and parent position counts
    cell_total = np.zeros(n_cells, dtype=np.int64)
    np.add.at(cell_total, cell, 1)
    # reference 12-bit rolling kmer per position cell
    refk = np.zeros(L, dtype=np.int64)
    k = 0
    for i in range(L):
        k = ((k << 4) | int(contig_sym[i])) & 0xFFF
        refk[i] = k

    rate = cfg.indel_balance_factor_lgs
    ins_len = index.ins_len

    # DP over cells in chain order
    scores = [dict() for _ in range(n_cells)]  # base -> [score, gidx]

    def max_score_entry(d):
        best = None
        for b, v in d.items():
            if best is None or v[0] > best[1][0]:
                best = (b, v)
        return best

    for ci_s, ci_e in zip(grp_starts[:-1], grp_starts[1:]):
        c = int(g_cell[ci_s])
        total = int(cell_total[c])
        pos_i = int(cell_pos[c])
        if is_ins[c]:
            parent = int(cell_total[pos_cell[pos_i]])
            if int(ins_len[pos_i]) <= 4 or (parent and
                                            total / parent < 0.2):
                total = parent
            else:
                total = 1
        if total > 1:
            total -= 1
        sc = scores[c]
        for gi in range(int(ci_s), int(ci_e)):
            b1 = int(g_p1s[gi])
            if b1 == 0:
                if pos_i > 0:
                    prev = max_score_entry(scores[pos_cell[pos_i - 1]])
                    score = prev[1][0] if prev else 0.0
                else:
                    score = 0.0
            else:
                pd = scores[int(g_p1c[gi])]
                ent = pd.get(b1)
                score = ent[0] if ent else 0.0
            count = int(g_cnt[gi])
            kmer = ((int(g_p2s[gi]) << 8) | (b1 << 4) | int(g_sym[gi])) \
                & 0xFFF
            if (not is_ins[c]) and kmer == int(refk[pos_i]) \
                    and cell_total[c] > 1:
                count -= 1
            score += count - total * rate
            cur = sc.get(int(g_sym[gi]))
            if cur is None or cur[0] < score:
                sc[int(g_sym[gi])] = [score, gi]

    # traceback (td_region_correct)
    new_base = state.base.copy()
    c = int(pos_cell[L - 1])
    ent = max_score_entry(scores[c])
    if ent is None:
        return state.emit(0)
    b, (scv, gi) = ent
    while True:
        pos_i = int(cell_pos[c])
        j_ins = bool(is_ins[c])
        new_base[c] = int(g_sym[gi])
        b1 = int(g_p1s[gi])
        if b1:
            nc = int(g_p1c[gi])
        else:
            if pos_i - 1 < 0:
                break
            nc = int(pos_cell[pos_i - 1])
        # loop bound: stop after processing cell (0, 0)
        if c == int(pos_cell[0]):
            break
        d = scores[nc]
        if b1:
            ent2 = d.get(b1)
        else:
            e = max_score_entry(d)
            ent2 = e[1] if e else None
        if ent2 is None:
            break
        gi = ent2[1]
        c = nc
    state.base = new_base
    maybe_trace(cfg, name, state, draft)
    return state.emit(0)
