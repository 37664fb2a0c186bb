"""Task 3 — diploid SNP detection and phasing (snp_phase, lib/snpphase.c).

Exact mirror of the reference flow:
  1. single-base (shift-16) pileup from short reads at filter level 2
     with per-cell first-occurrence kmer order (:94);
  2. SNP detection walk with left/right clear-position bookkeeping
     (ts_find_snps :136-203, rule ts_check_snps :205-214);
  3. FLAG_DEPTH regions marked FLAG_INSERT; long-read insert-slot growth
     restricted to FLAG_INSERT|FLAG_SNP anchors (:97-107,
     contig_parse_read_insert lib/contig.c:202-245);
  4. SNP re-validation incl. the reference's length-field quirks: region
     strings compare on length-1 bytes, weak no-insert sites seed
     zero-length entries that soak up all long-read votes
     (ts_fliter_snps :216-349, ss_kmer_get_region lib/kmercount.c:332);
  5. low-depth chain rescue (ts_correct_lower_depth :797-841,
     ts_region_correct :843-871);
  6. linkage counting along reads with the confirm state machine
     (ts_find_snps_link :351-421, ts_snps_parse_read :615-760,
     ts_snps_deal_linkdata :762-786, ts_tranfer_link :423-449);
  7. the 2-haplotype Viterbi with mutually-exclusive pairing bookkeeping
     (ts_snps_score :451-516) and phase-consistent correction
     (ts_snps_correct :518-556).

The task is experimental in the reference (doc/FAQ.rst:24-27); this
implementation favours exactness over speed (per-read Python walks).

A copy of nextpolish_tpu/models/snp_phase.py: its imports are relative
(the lazy cns.tags import is the port's copy), and `device` (default
cuda) passes from snp_phase_contig through _correct_lower_depth to
run_chain_region, the one device step (the chain DP of step 5).
"""
from __future__ import annotations

import math

import numpy as np

from ..device import resolve_device
from ..io.bam import AlnBatch
from ..io.fasta import ASCII_TO_NIB
from ..ops import pileup as pl
from ..ops.symbols import DEL, NIB_TO_SYM, S
from .contig_state import (ContigState, find_regions, maybe_trace,
                           merge_regions)
from .flags import FLAG_DEPTH, FLAG_INSERT, FLAG_SNP, FLAG_THIRD, FLAG_ZERO
from .score_chain import AlgoConfig, run_chain_region

FLAG_LEFT = 0x40
FLAG_RIGHT = 0x80
SNP_NUM = 2
READ_MAPQ = 60
BASE_QUAL = 41


class Snps:
    __slots__ = ("pos", "left", "right", "length", "regions", "link",
                 "total", "score")

    def __init__(self, right, length=1):
        self.pos = 0
        self.left = 0
        self.right = right
        self.length = length
        self.regions = [b"", b""]
        self.link = []  # [key, num, mapqual, qual]
        self.total = 0

    def region_index(self, region: bytes) -> int:
        for i in range(SNP_NUM):
            if self.regions[i][: self.length] == region[: self.length]:
                return i
        return -1


def _check_snps(cfg: AlgoConfig, count: int, rate: float, is_ref: bool
                ) -> int:
    if rate < cfg.min_snp_factor_sgs and is_ref:
        return 0
    if rate == 0 or (count >= cfg.min_count_snp and not is_ref
                     and rate < cfg.min_snp_factor_sgs):
        return 2
    return 1


class CellCounts:
    """Per-cell single-base counts in first-occurrence order."""

    def __init__(self, n_cells):
        self.counts = np.zeros((n_cells, S), dtype=np.int64)
        self.order = np.full((n_cells, S), np.iinfo(np.int64).max,
                             dtype=np.int64)
        self.total = np.zeros(n_cells, dtype=np.int64)

    def add_events(self, cells, syms, base_rank):
        np.add.at(self.counts, (cells, syms), 1)
        np.add.at(self.total, cells, 1)
        np.minimum.at(self.order, (cells, syms), base_rank)

    def nlargest(self, c, n=SNP_NUM):
        """Kmers by (count desc, first-occurrence) — base_get_nlargest."""
        present = np.flatnonzero(self.counts[c])
        if not len(present):
            return []
        key = sorted(present,
                     key=lambda b: (-int(self.counts[c, b]),
                                    int(self.order[c, b])))
        return [(int(b), int(self.counts[c, b])) for b in key[:n]]


def _expand_rows(batch, levels, level, index, tid, cfg):
    return pl.expand_reads(batch, levels, level, index, tid,
                           cfg.trim_len_edge, order_by_pos=True)


def snp_phase_contig(name: str, draft: bytes, sgs_batch: AlnBatch,
                     lgs_batch, cfg: AlgoConfig, device=None) -> bytes:
    device = resolve_device(device)
    batch = sgs_batch
    tid = batch.header.name2id(name)
    L = len(draft)
    sgs_levels = pl.filter_sgs(batch, cfg.read_tlen, cfg.max_clip_ratio_sgs,
                               cfg.min_map_quality)
    index = pl.build_cell_index(batch, sgs_levels, tid, 0, L - 1)
    state = ContigState.from_draft(name, draft, index)
    contig_nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]

    # 1. shift-16 parse at level 2: single-base counts per cell
    ex = _expand_rows(batch, sgs_levels, 2, index, tid, cfg)
    cc = CellCounts(index.n_cells)
    cc.add_events(ex.cells, ex.syms, np.arange(len(ex.cells)))

    # 2. ts_find_snps
    sites = _find_snps(state, cc, cfg)

    # 3. FLAG_DEPTH regions -> FLAG_INSERT marking
    nodepth = find_regions(state, 0, L - 1, gap=cfg.ext_len_edge, con=0,
                           flag_bit=FLAG_DEPTH, extend=False,
                           ext_len_edge=cfg.ext_len_edge)
    nodepth = merge_regions(nodepth)
    for rs, re_ in nodepth:
        _update_flag_range(state, rs, re_, FLAG_INSERT)

    lgs_levels = (pl.filter_lgs(lgs_batch, cfg.max_clip_ratio_lgs)
                  if lgs_batch is not None else None)

    # 4. long-read insert growth at FLAG_INSERT|FLAG_SNP anchors
    if lgs_batch is not None:
        state, cc, index = _grow_inserts_lgs(state, cc, lgs_batch,
                                             lgs_levels, tid,
                                             FLAG_INSERT | FLAG_SNP)

    # 5. re-validation
    sites = _filter_snps(state, sites, batch, sgs_levels, lgs_batch,
                         lgs_levels, tid, cc, cfg)

    # 6. low-depth chain rescue
    if nodepth:
        _correct_lower_depth(state, batch, sgs_levels, lgs_batch,
                             lgs_levels, tid, contig_nib, nodepth, cfg,
                             device)

    if len(sites) > 1:
        _find_snps_link(state, sites, batch, sgs_levels, lgs_batch,
                        lgs_levels, tid, cfg)
        _snps_score(state, sites, cfg)
        _snps_correct(state, sites)

    maybe_trace(cfg, name, state, draft)
    return state.emit(FLAG_THIRD)


def _update_flag_range(state, rs, re_, flag):
    index = state.index
    c0 = int(index.cell_of[rs])
    c1 = int(index.cell_of[re_])  # inclusive position cell
    state.flag[c0 : c1 + 1] |= flag


def _find_snps(state, cc: CellCounts, cfg) -> list[Snps]:
    """ts_find_snps (:136-203), vectorized.

    The sequential walk's only cross-cell state is `lasti` (the most
    recent eligible position) and the pending-sites `right` assignment;
    both reduce to searchsorted over the eligible-position list, because
    an eligible cell is always the LAST cell of a position with no
    SNP-candidate cell, so the walk's visit order is position order."""
    index = state.index
    L = index.end - index.start + 1
    cell_pos = index.cell_pos()
    ins_len = index.ins_len
    n = index.n_cells
    pos_cell = index.cell_of
    total = cc.total[:n]
    flags = state.flag
    zero = total == 0
    flags[:n] = np.where(zero, flags[:n] | FLAG_ZERO,
                         flags[:n] & (0xFF ^ FLAG_ZERO))
    shallow = total <= cfg.min_depth_snp
    flags[:n] = np.where(shallow, flags[:n] | FLAG_DEPTH,
                         flags[:n] & (0xFF ^ FLAG_DEPTH))

    # per-cell top-2 symbols by (count desc, first-occurrence asc) —
    # base_get_nlargest with SNP_NUM=2
    BIG = np.iinfo(np.int64).max
    c8 = cc.counts[:n]
    order = cc.order[:n]
    mx1 = c8.max(axis=1)
    b1 = np.where(c8 == mx1[:, None], order, BIG).argmin(axis=1)
    rest = c8.copy()
    rest[np.arange(n), b1] = -1
    mx2 = rest.max(axis=1)
    b2 = np.where(rest == mx2[:, None], order, BIG).argmin(axis=1)
    has2 = mx2 > 0
    rate = np.where(has2, mx2 / np.maximum(mx1, 1), 0.0)
    is_ref = b1 == state.base[:n].astype(np.int64)
    msf = cfg.min_snp_factor_sgs
    fl = np.where((rate < msf) & is_ref, 0,
                  np.where((rate == 0)
                           | ((total >= cfg.min_count_snp) & ~is_ref
                              & (rate < msf)), 2, 1))
    fl = np.where(total > 0, fl, 0)
    upd = fl == 2
    state.base[:n][upd] = b1[upd]

    fl1 = fl == 1
    pos_of = cell_pos[:n]
    posf = np.zeros(L, dtype=bool)
    posf[pos_of[fl1]] = True
    state.flag[pos_cell[np.flatnonzero(posf)]] |= FLAG_SNP
    # creator cells: the first SNP-candidate cell of each position
    f1idx = np.flatnonzero(fl1)
    if not len(f1idx):
        return []
    first = np.ones(len(f1idx), dtype=bool)
    first[1:] = pos_of[f1idx[1:]] != pos_of[f1idx[:-1]]
    creators = f1idx[first]
    # eligible positions (lasti candidates): no SNP-candidate cell at all
    elig = np.flatnonzero(~posf)
    sites: list[Snps] = []
    for c in creators:
        i = int(pos_of[c])
        k = int(np.searchsorted(elig, i))
        s = Snps(L - 1)
        s.left = int(elig[k - 1]) if k > 0 else 0
        s.pos = i
        if k < len(elig):
            s.right = int(elig[k])
        s.regions = [bytes([int(b1[c])]), bytes([int(b2[c])])]
        sites.append(s)
    return sites


def _grow_inserts_lgs(state, cc, lgs_batch, lgs_levels, tid, flag_gate):
    """contig_create_insert with a flag filter: grow insert slots from
    long reads whose insertion anchor carries flag_gate; rebuild the cell
    index and remap per-cell state."""
    index = state.index
    L = index.end - index.start + 1
    mask = (lgs_levels >= 1) & pl.region_overlap_mask(lgs_batch, tid, 0,
                                                      L - 1)
    mask &= lgs_batch.cigar_len > 0
    ridx = np.flatnonzero(mask)
    grow = index.ins_len.copy()
    anchor_flag = state.flag[index.cell_of]
    if len(ridx):
        op_read, op_type, op_len, qs, rs = pl._flat_ops(lgs_batch, ridx)
        ins = (op_type == 1) & (rs > 0) & (rs <= L - 1)
        anchors = rs[ins] - 1
        ok = (anchor_flag[anchors] & flag_gate) != 0
        if ok.any():
            np.maximum.at(grow, anchors[ok], op_len[ins][ok])
    if np.array_equal(grow, index.ins_len):
        return state, cc, index
    new_index = pl.CellIndex(
        index.start, index.end, grow,
        np.concatenate([[0], np.cumsum(1 + grow[:-1])]).astype(np.int64),
        int(np.cumsum(1 + grow)[-1]),
        0,
    )
    new_index.n_cells_dp = new_index.n_cells
    # remap cells: new slot layout per position
    n_new = new_index.n_cells
    new_base = np.full(n_new, DEL, dtype=np.uint8)
    new_flag = np.zeros(n_new, dtype=np.uint8)
    new_cc = CellCounts(n_new)
    old_pos = index.cell_pos()
    old_slot = np.arange(index.n_cells) - index.cell_of[old_pos]
    dest = new_index.cell_of[old_pos] + old_slot
    new_base[dest] = state.base
    new_flag[dest] = state.flag
    new_cc.counts[dest] = cc.counts
    new_cc.order[dest] = cc.order
    new_cc.total[dest] = cc.total
    # fresh slots inherit the anchor's flag (contig_parse_read_insert)
    fresh = np.ones(n_new, dtype=bool)
    fresh[dest] = False
    if fresh.any():
        fpos = new_index.cell_pos()[fresh]
        new_flag[fresh] = new_flag[new_index.cell_of[fpos]]
    new_state = ContigState(state.name, new_index, new_base, new_flag)
    return new_state, new_cc, new_index


def _row_site_string(ex, row, batch, length):
    """ss_parse_read_kmer for a [pos, pos+1] site view: returns
    (string bytes, raw qual sum) when the row covers all `length` cells."""
    lo, hi = int(ex.row_off[row]), int(ex.row_off[row + 1])
    if hi - lo != length or (hi > lo and ex.cells[lo] != 0):
        return None
    syms = ex.syms[lo:hi]
    qidx = ex.qidx[lo:hi]
    rid = int(ex.ridx[row])
    hq = qidx >= 0
    qual = int(batch.qual[batch.qual_off[rid] + qidx[hq]].sum()) if hq.any() \
        else 0
    return syms.tobytes(), qual


class _RegionGroup:
    __slots__ = ("region", "length", "num", "mapqual", "qual")

    def __init__(self, region, length, num, mapqual, qual):
        self.region = region
        self.length = length  # comparison length (the C ks->length)
        self.num = num
        self.mapqual = mapqual
        self.qual = qual

    def matches(self, region, length):
        return self.region[: self.length] == region[: self.length] \
            if self.length <= length else False


def _groups_find(groups, region, length):
    """seqlist_find with ks_compare_region: the ELEMENT's length drives
    the comparison."""
    for g in groups:
        if g.region[: g.length] == region[: g.length]:
            return g
    return None


def _ts_get_nlargest(groups, n=SNP_NUM):
    """Insertion-order-stable n-largest by (num, mapqual, qual)."""
    maxn = []
    for g in groups:
        placed = False
        for j in range(len(maxn) - 1, -1, -1):
            if (g.num, g.mapqual, g.qual) > (maxn[j].num, maxn[j].mapqual,
                                             maxn[j].qual):
                if j < n - 1:
                    if len(maxn) <= j + 1:
                        maxn.append(maxn[j])
                    else:
                        maxn[j + 1] = maxn[j]
                maxn[j] = g
                placed = True
            else:
                if j < n - 1:
                    if len(maxn) <= j + 1:
                        maxn.append(g)
                    elif not placed:
                        maxn[j + 1] = g
                break
        if not maxn:
            maxn.append(g)
        if len(maxn) > n:
            del maxn[n:]
    return maxn


def _filter_snps(state, sites, batch, sgs_levels, lgs_batch, lgs_levels,
                 tid, cc: CellCounts, cfg):
    """ts_fliter_snps (:216-349)."""
    index = state.index
    kept = []
    for site in sites:
        p = site.pos
        c0 = int(index.cell_of[p])
        has_ins = index.ins_len[p] > 0
        groups: list[_RegionGroup] = []
        total = 0
        flag = 0
        if has_ins:
            # region [pos, pos+1], length = inserts + 2
            length = int(index.ins_len[p]) + 2
            view = index.region_view(p, min(p + 1, index.end))
            flag = 1
            ex = _expand_rows(batch, sgs_levels, 2, view, tid, cfg)
            for r in range(len(ex.ridx)):
                ss = _row_site_string(ex, r, batch, length)
                if ss is None:
                    continue
                region, qual = ss
                # FLAG_ZERO clearing side effect of ss_parse_read_kmer
                lo, hi = int(ex.row_off[r]), int(ex.row_off[r + 1])
                state.flag[c0 + ex.cells[lo:hi]] &= 0xFF ^ FLAG_ZERO
                mapq = int(batch.mapq[int(ex.ridx[r])])
                g = _groups_find(groups, region, length - 1)
                if g is None:
                    groups.append(_RegionGroup(region, length - 1, 1, mapq,
                                               qual))
                else:
                    g.num += 1
                    g.mapqual += mapq
                    g.qual += qual
                total += 1
        else:
            length = 1
            total = int(cc.total[c0])
        if total <= cfg.min_count_snp:
            if length == 1:
                # seed zero-comparison-length single-base groups in
                # first-occurrence kmer order (the C's ks->length stays 0)
                present = sorted(np.flatnonzero(cc.counts[c0]),
                                 key=lambda b: int(cc.order[c0, b]))
                for b in present:
                    n = int(cc.counts[c0, b])
                    groups.append(_RegionGroup(bytes([int(b)]), 0, n,
                                               READ_MAPQ * n,
                                               BASE_QUAL * n))
            flag1 = -1
            delkey = bytes([DEL]) * length
            for gi, g in enumerate(groups):
                if g.region[: g.length] == delkey[: g.length]:
                    flag1 = gi
                    break
            if lgs_batch is not None:
                view = (index.region_view(p, min(p + 1, index.end))
                        if has_ins else index.region_view(p, p))
                ex = _expand_rows(lgs_batch, lgs_levels, 1, view, tid, cfg)
                for r in range(len(ex.ridx)):
                    ss = _row_site_string(ex, r, batch=lgs_batch,
                                          length=length)
                    if ss is None:
                        continue
                    region, qual = ss
                    # left/right confirmation: read matches the contig
                    # base at site.left and site.right
                    rid = int(ex.ridx[r])
                    if not _confirm_read(state, lgs_batch, rid, site.left,
                                         site.right):
                        continue
                    mapq = int(lgs_batch.mapq[rid])
                    g = _groups_find(groups, region, length - 1)
                    if g is None:
                        groups.append(_RegionGroup(region, length - 1, 1,
                                                   mapq, qual))
                    else:
                        g.num += 1
                        g.mapqual += mapq
                        g.qual += qual
                    total += 1
            flag = 1
            if flag1 == -1:
                for gi, g in enumerate(groups):
                    if g.region[: g.length] == delkey[: g.length]:
                        del groups[gi]
                        break
        if flag:
            maxn = _ts_get_nlargest(groups, SNP_NUM)
            flag1 = len(maxn)
            rate = (maxn[1].num / maxn[0].num) if flag1 > 1 else 0.0
            cur = bytes([int(state.base[c0])]) + bytes([DEL]) * (length - 1)
            is_ref = (flag1 > 0
                      and maxn[0].region[: maxn[0].length]
                      == cur[: maxn[0].length])
            fl = _check_snps(cfg, total, rate, is_ref)
            if fl == 1:
                site.length = maxn[0].length
                site.regions = [m.region for m in maxn]
                if flag1 < SNP_NUM:
                    site.regions.append(cur)
                kept.append(site)
            else:
                if fl == 2 and maxn:
                    state.base[c0] = maxn[0].region[0]
                    if length > 1:
                        # contig_update_contig over [pos, pos+1)
                        nwrite = min(len(maxn[0].region), length - 1)
                        cells = c0 + np.arange(nwrite)
                        state.base[cells] = np.frombuffer(
                            maxn[0].region[:nwrite], dtype=np.uint8)
                state.flag[c0] &= 0xF7
        else:
            kept.append(site)
    return kept


def _confirm_read(state, batch, rid, left, right):
    """The pos==left/right base-match count in ss_parse_read_kmer: the
    read must match the contig base at both confirm positions."""
    index = state.index
    tpos, qbase, is_ins, qidx = _read_cols(batch, rid)
    result = 0
    for cp in (left, right):
        hit = np.flatnonzero((tpos == cp) & ~is_ins)
        for h in hit:
            if qidx[h] >= 0 and int(qbase[h]) == int(
                    state.base[index.cell_of[cp]]):
                result += 1
                break
    return result >= 2


def _read_cols(batch, rid):
    from .cns.tags import read_columns

    tpos, qbase_cns, is_ins, qidx = read_columns(batch, rid)
    # read_columns yields cns codes; convert to compact syms via nibbles
    nib = batch.rec_seq_nib(rid)
    qbase = np.where(qidx >= 0, NIB_TO_SYM[nib[np.maximum(qidx, 0)]], DEL)
    return tpos, qbase, is_ins, qidx


def _correct_lower_depth(state, batch, sgs_levels, lgs_batch, lgs_levels,
                         tid, contig_nib, regions, cfg, device=None):
    """ts_correct_lower_depth (:797-841) + ts_region_correct (:843-871);
    each region's chain DP runs on `device` (default cuda)."""
    index = state.index
    for s_, e_ in regions:
        view = index.region_view(s_, e_)
        cell0 = int(index.cell_of[s_ - index.start])
        p = pl.build_pileup(batch, sgs_levels, 2, view, tid, contig_nib,
                            cfg.trim_len_edge)
        if lgs_batch is not None:
            p = pl.add_reads_to_pileup(p, lgs_batch, lgs_levels, 1, tid,
                                       cfg.trim_len_edge)
        n_dp = view.n_cells_dp
        choice = run_chain_region(p.counts, p.refkmer, p.total, n_dp,
                                  cfg.indel_balance_factor_lgs, rank=p.rank,
                                  device=device)
        cells = cell0 + np.arange(n_dp)
        is_ins = view.is_insert_cell()[:n_dp]
        zero = (state.flag[cells] & FLAG_ZERO) != 0
        use = zero | (~is_ins & (choice != DEL))
        state.base[cells[use]] = choice[use]
        # FLAG_THIRD from merged per-base counts (base_merge_kmer +
        # nlargest 2)
        bcc = p.counts[:n_dp].reshape(n_dp, S * S, S).sum(
            axis=1, dtype=np.int64)
        order = np.argsort(-bcc, axis=1, kind="stable")
        c1 = np.take_along_axis(bcc, order[:, :1], axis=1)[:, 0]
        c2 = np.take_along_axis(bcc, order[:, 1:2], axis=1)[:, 0]
        nz2 = bcc.astype(bool).sum(axis=1) >= 2
        rate = np.where(c1 > 0, c2 / np.maximum(c1, 1), 0.0)
        b = state.base[cells]
        cond = nz2 & ((order[:, 0] != b) | (rate > cfg.max_indel_factor_lgs))
        third = cond & ((b == DEL) | is_ins | (order[:, 0] != b)
                        | (rate > cfg.max_snp_factor_lgs))
        clear = cond & ~third
        state.flag[cells[third]] |= FLAG_THIRD
        state.flag[cells[clear]] &= 0xFF ^ FLAG_THIRD


def _find_snp_region(state, sites, gap, use_snp_flag):
    """ts_find_snp_region (:558-613)."""
    regions = []
    flag1 = FLAG_LEFT | FLAG_RIGHT
    index = state.index
    qstart = qend = None
    for s in sites:
        f = int(state.flag[index.cell_of[s.pos]])
        if (use_snp_flag and (f & FLAG_SNP)) or (f & flag1):
            if qstart is None:
                qstart = qend = s
            elif use_snp_flag or (f & FLAG_RIGHT):
                temp = (s.pos - qend.pos) if use_snp_flag \
                    else (s.right - qend.left)
                if temp < gap:
                    qend = s
                else:
                    if qstart is not qend:
                        if use_snp_flag:
                            regions.append((qstart.pos, qend.pos + 1))
                        else:
                            regions.append((qstart.left, qend.right))
                    if use_snp_flag or (f & FLAG_LEFT):
                        qstart = qend = s
                    else:
                        qstart = qend = None
    if qstart is not None and qstart is not qend:
        if use_snp_flag:
            regions.append((qstart.pos, qend.pos))
        else:
            regions.append((qstart.left, qend.right))
    return regions


def _find_snps_link(state, sites, batch, sgs_levels, lgs_batch, lgs_levels,
                    tid, cfg):
    """ts_find_snps_link (:351-421)."""
    index = state.index
    site_pos = [s.pos for s in sites]

    ks_state = [0]  # the C's persistent ks->num

    def run_pass(b, levels, level, flagbrim, regions):
        for rs, re_ in regions:
            view = index.region_view(rs, min(re_, index.end))
            ex = _expand_rows(b, levels, level, view, tid, cfg)
            for r in range(len(ex.ridx)):
                lo, hi = int(ex.row_off[r]), int(ex.row_off[r + 1])
                if lo == hi:
                    continue
                linkdata = _parse_read_links(state, ex, r, b, rs, re_,
                                             flagbrim, cfg, ks_state)
                _deal_linkdata(state, linkdata, sites, site_pos, flagbrim)

    regions = _find_snp_region(state, sites, cfg.read_len or 100, True)
    run_pass(batch, sgs_levels, 2, 0, regions)

    # weak-link flanking markers
    for i in range(1, len(sites)):
        if sites[i].total <= cfg.min_count_snp_link:
            prev, cur = sites[i - 1], sites[i]
            state.flag[index.cell_of[prev.left]] |= FLAG_LEFT
            state.flag[index.cell_of[prev.pos]] |= FLAG_LEFT
            state.flag[index.cell_of[prev.right]] |= FLAG_RIGHT
            state.flag[index.cell_of[cur.left]] |= FLAG_LEFT
            state.flag[index.cell_of[cur.pos]] |= FLAG_RIGHT
            state.flag[index.cell_of[cur.right]] |= FLAG_RIGHT

    if lgs_batch is not None:
        regions = _find_snp_region(state, sites,
                                   cfg.max_variant_count_lgs, False)
        run_pass(lgs_batch, lgs_levels, 1, 1, regions)


def _parse_read_links(state, ex, row, batch, start, end, flagbrim, cfg,
                      ks_state):
    """ts_snps_parse_read (:615-760) over one expanded row.

    The expanded row already contains the insert padding; we walk its
    cells replaying the C's per-site string extraction with the confirm
    state machine.  ks_state holds the persistent ks->num (the C reuses
    one KmerScore across reads and regions)."""
    index = state.index
    lo, hi = int(ex.row_off[row]), int(ex.row_off[row + 1])
    rid = int(ex.ridx[row])
    mapq = int(batch.mapq[rid])
    qoff = int(batch.qual_off[rid])
    cell0 = int(index.cell_of[start - index.start])
    fl = FLAG_LEFT | FLAG_RIGHT

    # hoist ALL per-cell array indexing into one vectorized gather per
    # row (the scalar-index version cost ~5 numpy indexings per cell and
    # dominated the dense-SNP link pass)
    c_arr = cell0 + ex.cells[lo:hi].astype(np.int64)
    syms_l = ex.syms[lo:hi].tolist()
    qidx_a = ex.qidx[lo:hi]
    pos_l = index.cell_pos()[c_arr].tolist()
    flag_l = state.flag[c_arr].tolist()
    ins_l = index.is_insert_cell()[c_arr].tolist()
    base_l = state.base[c_arr].tolist()
    qv = np.zeros(hi - lo, dtype=np.int64)
    hasq = qidx_a >= 0
    qv[hasq] = batch.qual[qoff + qidx_a[hasq].astype(np.int64)]
    qv_l = qv.tolist()
    hasq_l = hasq.tolist()
    inslen_l = index.ins_len

    linkdata = []  # [region bytes, pos, qual, mapq, valid_len]
    region = bytearray()  # current ks buffer
    qual_acc = 0
    dels = 0
    curpos = 0
    sign = 0
    comfirmindex = 0

    def finalize(pos_i):
        nonlocal curpos, qual_acc
        q = qual_acc
        r = region
        if ks_state[0] != pos_i:
            if len(r) != dels:
                q = int(q / (len(r) - dels))
            else:
                q = 0
            r = r[:-1]
        linkdata.append([bytes(r), ks_state[0], q, mapq, len(r)])
        curpos = 0

    for k in range(hi - lo):
        pos_i = pos_l[k]
        sym = syms_l[k]
        has_q = hasq_l[k]
        if ins_l[k]:
            # read I bases and insert padding (BAM_CINS branch + the
            # pre-position padding block, both gated on curpos)
            if curpos:
                region.append(sym)
                if has_q:
                    qual_acc += qv_l[k]
                else:
                    dels += 1
            continue
        base_flag = flag_l[k]
        if flagbrim == 0 or (base_flag & fl):
            if base_flag & FLAG_SNP:
                if curpos == 0:
                    region = bytearray()
                    qual_acc = 0
                    dels = 0
                    ks_state[0] = pos_i
                    curpos = 1
                    if flagbrim == 0:
                        sign = 1
                else:
                    sign += 1
            elif flagbrim:
                if has_q and sym == base_l[k]:
                    sign += 1
            else:
                sign += 1
            if curpos:
                region.append(sym)
                if has_q and sym != DEL:
                    qual_acc += qv_l[k]
                if ks_state[0] != pos_i or inslen_l[pos_i] == 0:
                    finalize(pos_i)
            if ks_state[0] != pos_i:
                if base_flag & FLAG_SNP:
                    # new site starts here, reusing the just-appended
                    # byte as region[0] (the C's q-pointer dance)
                    region = bytearray([sym])
                    qual_acc = qv_l[k] if has_q else 0
                    dels = 0
                    ks_state[0] = pos_i
                    curpos = 1
                    if flagbrim == 0:
                        comfirmindex += 1
                        sign = 1
                elif base_flag & FLAG_RIGHT:
                    if sign == 2:
                        comfirmindex = len(linkdata)
                    else:
                        for t in range(comfirmindex, len(linkdata)):
                            linkdata[t][4] = 0
                        comfirmindex = len(linkdata)
                    curpos = 0
                    sign = 1 if (base_flag & FLAG_LEFT) else 0
    return linkdata


def _deal_linkdata(state, linkdata, sites, site_pos, flagbrim):
    """ts_snps_deal_linkdata (:762-786) + ts_tranfer_link (:423-449)."""
    if len(linkdata) <= 1:
        return
    index = state.index
    import bisect

    for i in range(1, len(linkdata)):
        p = linkdata[i]
        p0 = linkdata[i - 1]
        if not (p[4] and p0[4]):
            continue
        if flagbrim:
            if not ((int(state.flag[index.cell_of[p[1]]]) & FLAG_RIGHT)
                    and (int(state.flag[index.cell_of[p0[1]]])
                         & FLAG_LEFT)):
                continue
        idx = bisect.bisect_left(site_pos, p[1])
        if idx >= len(site_pos) or site_pos[idx] != p[1] or idx == 0:
            continue
        s0, s1 = sites[idx - 1], sites[idx]
        # ts_tranfer_link: the length FIELD (entry[4]) must match; the C
        # then clobbers the second entry's length with the packed key, so
        # a read only links alternating pairs (:423-449, bug-compatible)
        if p0[4] != s0.length or p[4] != s1.length:
            continue
        i0 = s0.region_index(p0[0])
        if i0 == -1:
            continue
        p[4] = (i0 + 1) << 4
        i1 = s1.region_index(p[0])
        if i1 == -1:
            continue
        p[4] += i1 + 1
        key = p[4]
        for ent in s1.link:
            if ent[0] == key:
                ent[1] += 1
                ent[2] += p[3]
                ent[3] += p[2]
                break
        else:
            s1.link.append([key, 1, p[3], p[2]])
        s1.total += 1


def _snps_score(state, sites, cfg):
    """ts_snps_score (:451-516): the link[0]/link[1] exclusive pairing."""
    n = len(sites)
    for s in sites:
        s.score = {}
    # the C seeds the first site with Score{kmer=i, score=0} per state
    # (kmer >> 4 == 0)
    sites[0].score = {i: (0.0, i) for i in range(1, SNP_NUM + 1)}
    for i in range(1, n):
        q = sites[i]
        prev = sites[i - 1]
        q.score = {}
        if q.link:
            link0 = [0] * (SNP_NUM + 1)  # from -> claimed to
            link1 = [0] * (SNP_NUM + 1)  # to -> claiming from
            for key, num, mapqual, qual in q.link:
                frm = key >> 4
                to = key & 0xF
                ps = prev.score.get(frm)
                if ps is None:
                    continue
                score = ps[0] + num * math.log10(
                    (mapqual + qual) / num + 2) - q.total / cfg.ploidy
                cur = q.score.get(to)
                if cur is None or cur[0] < score:
                    if link0[frm]:
                        if q.score[link0[frm]][0] >= score:
                            continue
                        link1[link0[frm]] = 0
                    if cur is not None:
                        link0[cur[1] >> 4] = 0
                    q.score[to] = (score, key)
                    link0[frm] = to
                    link1[to] = frm
            k = 1
            for j in range(1, SNP_NUM + 1):
                if link1[j] == 0:
                    # the C's inner for breaks without advancing k, so the
                    # same free from-state can serve several to-states
                    while k <= SNP_NUM:
                        if link0[k] == 0:
                            ps = prev.score.get(k)
                            base_score = ps[0] if ps else 0.0
                            q.score[j] = (base_score - q.total / cfg.ploidy,
                                          (k << 4) + j)
                            break
                        k += 1
        else:
            for j in range(1, SNP_NUM + 1):
                q.score[j] = (0.0, j)


def _snps_correct(state, sites):
    """ts_snps_correct (:518-556)."""
    index = state.index
    score = None
    i = len(sites) - 1
    while i > 0:
        q = sites[i]
        if q.link:
            if score is None:
                best = None
                for to, (sc, key) in q.score.items():
                    if best is None or sc > best[0]:
                        best = (sc, key, to)
                if best is None:
                    i -= 1
                    continue
                score = (best[0], best[1])
                _write_site(state, index, q, best[2])
            idx = (score[1] >> 4)
            if idx == 0:
                idx = 1
            prev = sites[i - 1]
            _write_site(state, index, prev, idx)
            if prev.link:
                ent = prev.score.get(idx)
                score = ent if ent else None
            else:
                score = None
        else:
            score = None
        i -= 1


def _write_site(state, index, site: Snps, hap: int):
    region = site.regions[hap - 1] if hap - 1 < len(site.regions) else None
    if region is None:
        return
    c0 = int(index.cell_of[site.pos])
    if site.length <= 1:
        if len(region):
            state.base[c0] = region[0]
    else:
        nwrite = min(len(region), site.length)
        state.base[c0 : c0 + nwrite] = np.frombuffer(
            region[:nwrite], dtype=np.uint8)
