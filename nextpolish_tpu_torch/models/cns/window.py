"""Window loop for the consensus engine (ctg_cns_core, lib/ctg_cns.c:3399).

Per window [s, e): reference row + filtered read tags -> MSA edges -> link
DP -> consensus; low-quality regions are re-built from candidate substrings
via POA seeding + re-alignment (lqrepair.py).  Windows overlap by `overlap`
and are stitched on an exact-match anchor (link_consensus :3121).

For contigs over 100 kb with enough (split) reads, the structural layer
(structural.py) adds the random-read depth track, SA-tag gap clusters with
supplementary realignment, low-depth regions and contig split points;
split-read gap candidates also bypass the clip-ratio filter for any
contig size (ctg_cns_core :3487-3514).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ...device import resolve_device
from ...io.bam import AlnBatch
from ...ops.pileup import region_overlap_mask
from ...runtime import trace
from . import structural as st
from .dp import Consensus, link_dp, traceback
from .msa import build_edges
from .tags import (
    ASCII_TO_CNS,
    TagColumns,
    WindowAccum,
    expand_columns,
    read_columns,
    reference_row,
    trim_read_columns,
)

MAX_CLIP_RATIO = {"hifi": 0.1, "ont": 0.7, "clr": 0.7, "rs": 0.7}
GAP_MIN_LEN = {"ont": 3, "hifi": 5, "clr": 5, "rs": 5}


@dataclass
class StructState:
    """Per-contig structural-layer state (ctg_cns_core locals)."""

    brk_g: bool
    depth: st.DepthTrack
    qv: list  # parsed ref-qv hints [(p, ide, ort, irt)]
    ref_ide: int = 0
    ref_d: int = 0
    split_ps: list = field(default_factory=list)
    ide_t: float = 0.8
    ort_t: int = 800
    irt_t: int = 800


def cal_win_len(w: int, s: int, length: int) -> int:
    """Balanced window length (lib/ctg_cns.c:2800-2807)."""
    if length <= w:
        return length
    n = int((length - s) / (w - s) + 0.999)
    return int((length + (n - 1) * s) / n + 0.999)


def select_window_reads(batch: AlnBatch, tid: int, s: int, e: int,
                        read_type: str) -> np.ndarray:
    """Plain window read filter (no SA-gap bypass) — kept for tools."""
    m = region_overlap_mask(batch, tid, s, max(e - 1, s))
    m &= (batch.flag & 0xD04) == 0
    left, right = batch.clip_lens()
    lq = np.maximum(batch.lqseq.astype(np.int64), 1)
    aligned_frac = (lq - left - right) / lq
    m &= aligned_frac > MAX_CLIP_RATIO[read_type]
    return np.flatnonzero(m)


def window_prep(batch: AlnBatch, tid: int, contig_ascii: np.ndarray,
                s: int, e: int, read_type: str,
                struct_ctx: StructState | None = None,
                contig_name: str = "") -> "WindowWork":
    """Host preparation of one window (pos window-local): read filtering,
    tag expansion, structural pass — everything in the per-window body of
    ctg_cns_core before the link DP.  Returns a WindowWork for
    window_dp (host engines) or the batcher + window_repair.

    The read pass runs through the native tag walker (cns_tags.cpp), with
    the structural layer on or off; the Python read loop, its oracle,
    runs only where the native library is not built.  The counters
    cns.prep.walker_windows and cns.prep.loop_windows count the windows
    of each path."""
    from ... import native

    L = e - s
    brk_g = struct_ctx is not None and struct_ctx.brk_g
    walker = native.available()
    trace.count("cns.prep.walker_windows" if walker
                else "cns.prep.loop_windows", 1)
    with trace.timed("cns.prep.reads"):
        read_pass = _read_pass_walker if walker else _read_pass_loop
        accum, gaps, sup_alns = read_pass(
            batch, tid, contig_ascii, s, e, read_type,
            struct_ctx if brk_g else None, contig_name)
    clusters: list[st.GapCluster] = []
    if brk_g:
        with trace.timed("cns.prep.struct"):
            clusters = _struct_pass(struct_ctx, accum, gaps, sup_alns, s, e)
    merged = accum.finish()
    coverage = accum.coverage[:L] + 1
    return WindowWork(merged, coverage, L, accum.l_ins, accum.l_del,
                      clusters)


def _read_pass_loop(batch: AlnBatch, tid: int, contig_ascii: np.ndarray,
                    s: int, e: int, read_type: str,
                    struct_ctx: StructState | None, contig_name: str):
    """The read pass one read at a time (ctg_cns_core :3474-3552): the
    window's rows in a WindowAccum; with the structural layer on
    (`struct_ctx`), also the depth track, and the split reads' gaps and
    supplementary alignments.  Returns (accum, gaps, sup_alns)."""
    brk_g = struct_ctx is not None
    gaps: list[st.GapInfo] = []
    sup_alns: list[st.SupAln] = []
    accum = WindowAccum(contig_ascii, s, e, GAP_MIN_LEN[read_type])
    has_tags = batch.tags is not None
    max_clip = MAX_CLIP_RATIO[read_type]
    # window 0 extends the fetch so the depth track can sample 15 Mb
    rege_limit = max(e, st.INS_RADOM_LEN) if (s == 0 and brk_g) else e
    if brk_g:
        struct_ctx.depth.reset_window(e - s)
    ridx = np.flatnonzero(region_overlap_mask(batch, tid, s,
                                              max(rege_limit - 1, s)))
    flags = batch.flag
    poss = batch.pos
    lqs = batch.lqseq
    for r in ridx:
        r = int(r)
        rege_flag = int(poss[r]) < e
        g = (st.read_gap_candidate(batch, r, contig_name)
             if has_tags else st.GapCand())
        flag = int(flags[r])
        cig = batch.rec_cigar(r)
        l_qseq = int(lqs[r])
        if l_qseq == 0 and len(cig):
            ops, lens = cig & 0xF, cig >> 4
            l_qseq = int(lens[np.isin(ops, (0, 1, 4, 5, 7, 8))].sum())
        if l_qseq == 0:
            continue

        def clip(end):
            if not len(cig):
                return 0
            c = cig[-1] if end else cig[0]
            return int(c >> 4) if (c & 0xF) in (4, 5) else 0

        rd_s = clip(0)
        rd_e = l_qseq - clip(1)
        if flag & 0xD04:
            if rege_flag and brk_g and g.score:
                sup_alns.append(st.SupAln(int(poss[r]), rd_s, cig.copy()))
            continue
        if (not g.score) and (rd_e - rd_s) / l_qseq <= max_clip:
            continue
        if brk_g:
            struct_ctx.depth.add_read(int(poss[r]), st._endpos(batch, r), s)
        if not rege_flag:
            continue
        tr = trim_read_columns(*read_columns(batch, r), accum.ref_cns, s, e)
        if tr is None:
            continue
        t_local, delta, qbase, q_s = tr
        cov_s = accum.cov_at(int(t_local[0]))
        cov_e = accum.cov_at(int(t_local[-1]) + 1)
        if ((cov_s > 3000 and cov_e > 3000)
                or (cov_s > 500 and cov_e > 500
                    and rd_e - rd_s < l_qseq * 0.9)):
            continue
        row_id = accum.add_row(t_local, delta, qbase, r)
        if brk_g and g.score and g.gap_s >= s and g.gap_e <= e:
            gaps.append(st.GapInfo(g.gap_s, g.gap_e, row_id, q_s,
                                   g.fs, g.ds, 0,
                                   batch.rec_seq_nib(r).copy()))
    return accum, gaps, sup_alns


# cigar ops whose lengths give l_qseq where a record stores no sequence
# (M, I, S, H, =, X: the read loop's rule)
_QUERY_OPS = np.zeros(16, dtype=np.int64)
_QUERY_OPS[[0, 1, 4, 5, 7, 8]] = 1


def _query_lens(batch: AlnBatch, ridx: np.ndarray) -> np.ndarray:
    """l_qseq of the records `ridx`, summed from the cigar where the
    record stores no sequence."""
    lq = batch.lqseq[ridx].astype(np.int64)
    z = np.flatnonzero((lq == 0) & (batch.cigar_len[ridx] > 0))
    if len(z):
        n = batch.cigar_len[ridx[z]].astype(np.int64)
        first = np.cumsum(n) - n
        words = batch.cigar[np.repeat(batch.cigar_off[ridx[z]] - first, n)
                            + np.arange(int(n.sum()))]
        lq[z] = np.add.reduceat(
            (words >> 4).astype(np.int64) * _QUERY_OPS[words & 0xF], first)
    return lq


def _read_pass_walker(batch: AlnBatch, tid: int, contig_ascii: np.ndarray,
                      s: int, e: int, read_type: str,
                      struct_ctx: StructState | None, contig_name: str):
    """_read_pass_loop's result through the native tag walker: the read
    filters, the depth track and the split reads' gaps and supplementary
    alignments as whole-array steps over the region's reads (SA tags are
    parsed only on the records that hold the bytes of one), then one
    native walk over the window's row candidates in BAM order (it holds
    the sequential coverage-overload check)."""
    from ... import native

    brk_g = struct_ctx is not None
    gaps: list[st.GapInfo] = []
    sup_alns: list[st.SupAln] = []
    L = e - s
    # window 0 extends the fetch so the depth track can sample 15 Mb
    rege_limit = max(e, st.INS_RADOM_LEN) if (s == 0 and brk_g) else e
    ridx = np.flatnonzero(region_overlap_mask(batch, tid, s,
                                              max(rege_limit - 1, s)))
    pos = batch.pos[ridx].astype(np.int64)
    lq = _query_lens(batch, ridx)
    left, right = batch.clip_lens()
    rd_s = left[ridx]
    rd_e = lq - right[ridx]
    has_seq = lq > 0
    primary = (batch.flag[ridx] & 0xD04) == 0
    rege = pos < e
    pass_clip = np.zeros(len(ridx), dtype=bool)
    pass_clip[has_seq] = ((rd_e[has_seq] - rd_s[has_seq]) / lq[has_seq]
                          > MAX_CLIP_RATIO[read_type])
    # split-read gap candidates (score > 0), by position in ridx
    cands = {}
    need = has_seq & batch.sa_tagged()[ridx]
    if not brk_g:  # only the clip filter's bypass reads them
        need &= primary & ~pass_clip
    for i in np.flatnonzero(need).tolist():
        g = st.read_gap_candidate(batch, int(ridx[i]), contig_name)
        if g.score:
            cands[i] = g
    split = np.zeros(len(ridx), dtype=bool)
    split[list(cands)] = True
    passed = has_seq & primary & (pass_clip | split)
    if brk_g:
        for i in np.flatnonzero(has_seq & ~primary & rege & split).tolist():
            r = int(ridx[i])
            sup_alns.append(st.SupAln(int(pos[i]), int(rd_s[i]),
                                      batch.rec_cigar(r).copy()))
        struct_ctx.depth.reset_window(L)
        span = batch.ref_span()[ridx[passed]].astype(np.int64)
        struct_ctx.depth.add_reads(pos[passed], pos[passed] + span, s)
    # a record that stores no sequence makes no row (the loop's
    # read_columns has no bases to read there)
    rows = np.flatnonzero(passed & rege & (batch.lqseq[ridx] > 0))
    sel = ridx[rows]
    out = native.cns_tags(
        sel, batch.pos, batch.cigar, batch.cigar_off, batch.cigar_len,
        batch.seq, batch.seq_off, batch.lqseq, rd_s[rows], rd_e[rows],
        ASCII_TO_CNS[contig_ascii[s:e]], s, e,
        gap_min_len=GAP_MIN_LEN[read_type])
    if out is None:
        raise RuntimeError("the native tag walker failed")
    keep = out["keep"]
    if brk_g and cands:
        row_id = np.cumsum(keep)  # 1 + rank among kept rows (0: the draft)
        for k in np.flatnonzero(keep & split[rows]).tolist():
            g = cands[int(rows[k])]
            if g.gap_s >= s and g.gap_e <= e:
                gaps.append(st.GapInfo(
                    g.gap_s, g.gap_e, int(row_id[k]), int(out["q_s"][k]),
                    g.fs, g.ds, 0, batch.rec_seq_nib(int(sel[k])).copy()))
    # the reference row first (WindowAccum seeds the MSA with the draft,
    # lib/ctg_cns.c:3457-3468)
    rt, rd, rq = reference_row(contig_ascii, s, e)
    row_off = np.concatenate([[0], out["row_off"] + L])
    read_of = np.repeat(np.arange(len(row_off) - 1, dtype=np.int32),
                        np.diff(row_off))
    cols = TagColumns(
        read_of, np.concatenate([rt, out["t_pos"]]),
        np.concatenate([rd, out["delta"]]),
        np.concatenate([rq, out["q_base"]]), row_off.astype(np.int64),
        np.concatenate([[0], out["aln_s"]]).astype(np.int32),
        np.concatenate([[L - 1], out["aln_e"]]).astype(np.int32),
        np.concatenate([[-1], sel[keep]]).astype(np.int64))
    accum = WindowAccum.holding(contig_ascii, s, e, GAP_MIN_LEN[read_type],
                                cols, out["coverage"], out["l_ins"],
                                out["l_del"], out["max_delta"])
    return accum, gaps, sup_alns


def _struct_pass(struct_ctx: StructState, accum: WindowAccum, gaps: list,
                 sup_alns: list, s: int, e: int) -> list:
    """The structural pass after a window's reads: the depth track, the
    low-depth regions, the gap clusters with their supplementary
    realignment and gap sequences, and the split points.  Turns the
    contig's structural layer off (and returns no clusters) where the
    window has too few rows, random reads or split reads.

    Spans (inside the caller's cns.prep.struct): cns.prep.struct.cluster
    (low-depth regions, gap clusters), cns.prep.struct.realign (the
    clusters' supplementary rows), cns.prep.struct.gapseq (gap
    sequences, split points).  Counters a window: cns.struct.gaps and
    cns.struct.sup_alns (the read pass's split-read gaps and
    supplementary alignments), cns.struct.off_windows (the layer turned
    itself off), cns.struct.clusters, cns.struct.sup_rows (rows added
    with read id -2), cns.struct.split_points."""
    trace.count("cns.struct.gaps", len(gaps))
    trace.count("cns.struct.sup_alns", len(sup_alns))
    rr = struct_ctx.depth
    rr_count = (st.INS_RADOM_COUNT if rr.rreads_w
                else len(rr.rreads))
    if accum.n_rows() < 150 or rr_count < 150 or not sup_alns:
        struct_ctx.brk_g = False
        trace.count("cns.struct.off_windows", 1)
        return []
    d = struct_ctx.depth
    d.finish_reads(s)
    nbins = (e - s) // st.INS_WIN_STEP
    if not struct_ctx.ref_d:
        struct_ctx.ref_d = st.cal_ref_d(d.ref_ds, nbins)
    with trace.timed("cns.prep.struct.cluster"):
        ld = st.update_ld_regs(d.ref_ds, nbins, d.rreads_w,
                               struct_ctx.ref_d)
        if struct_ctx.ref_ide:
            st.update_ld_regs_with_refqv(
                ld, d.ref_ds, struct_ctx.qv, d.rreads_w * st.INS_WIN_DIV,
                s, e,
                int(struct_ctx.ref_d * st.INS_MIN_DEPTH_RATIO_REFQV),
                int(struct_ctx.ref_ide * struct_ctx.ide_t),
                struct_ctx.ort_t, struct_ctx.irt_t)
        clusters = st.update_gap_cluster(gaps, d.ref_ds, d.rreads_w,
                                         struct_ctx.ref_d, s)
    trace.count("cns.struct.clusters", len(clusters))

    def add_sup_row(fs, cigar, nib):
        tr = trim_read_columns(*expand_columns(fs, cigar, nib),
                               accum.ref_cns, s, e)
        if tr is None:
            return None
        rid = accum.add_row(tr[0], tr[1], tr[2], -2)
        return rid, tr[3]

    rows = accum.n_rows()
    with trace.timed("cns.prep.struct.realign"):
        st.realign_cluster_sups(clusters, sup_alns, accum, accum.ref_cns,
                                s, e, add_sup_row)
    trace.count("cns.struct.sup_rows", accum.n_rows() - rows)
    split_ps = len(struct_ctx.split_ps)
    with trace.timed("cns.prep.struct.gapseq"):
        st.generate_gapseqs(clusters, accum, s)
        if struct_ctx.ref_d > 15:
            st.update_split_p(struct_ctx.split_ps, clusters, ld, s, e - s,
                              struct_ctx.qv)
    trace.count("cns.struct.split_points",
                len(struct_ctx.split_ps) - split_ps)
    return clusters


@dataclass
class WindowWork:
    """Host-prepped window awaiting its DP — the unit the batched device
    scan consumes (the window axis is the launch's block dimension,
    lib/ctg_cns.c:3455-3594)."""

    merged: object  # TagColumns
    coverage: np.ndarray
    L: int
    l_ins: np.ndarray
    l_del: np.ndarray
    clusters: list


def default_engine(device=None) -> str:
    """NPT_CNS_ENGINE wins; otherwise, on a card, the MEASURED faster of
    the device and native engines (calib.choose_engine probes both on
    first use and caches the choice); the CPU runs native."""
    eng = os.environ.get("NPT_CNS_ENGINE")
    if eng:
        return eng
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "native"
    from .calib import choose_engine

    return choose_engine("ont", dev)


def window_dp(work: WindowWork, read_type: str, min_cov: int,
              engine: str | None = None, device=None):
    """One window's link DP through a host engine (no repair): the native
    C++ DP, or the numpy one for engine "numpy".  The device engine runs
    through the batcher in consensus_for_contig."""
    lq_min_qv = 80 if read_type == "hifi" else 20
    eng = engine or default_engine(device)
    cns = None
    if eng != "numpy":
        from ...native import cns_dp as native_cns_dp

        nat = native_cns_dp(work.merged.t_pos, work.merged.delta,
                            work.merged.q_base, work.merged.row_off,
                            work.coverage, work.L, read_type, min_cov,
                            lq_min_qv)
        if nat is not None:
            cns = Consensus(nat[0], nat[1], nat[2])
    if cns is None:
        edges = build_edges(work.merged)
        score, best = link_dp(edges, work.coverage, read_type)
        cns = traceback(edges, score, best, work.coverage, work.L,
                        read_type, min_cov, lq_min_qv=lq_min_qv)
    return cns


def window_repair(work: WindowWork, cns, read_type: str):
    """Per-window LQ repair (POA reseeding + realignment)."""
    if not len(cns.pos):
        return cns
    if read_type == "hifi":
        from .lqrepair import repair_hifi

        return repair_hifi(cns, work.merged, work.coverage, work.clusters)
    from .lqrepair import repair as exact_repair

    return exact_repair(cns, work.merged, work.coverage, work.l_ins,
                        work.l_del, read_type, work.clusters)


def stitch(parts: list[tuple[int, Consensus]], overlap: int, k: int = 50,
           split: int = 0, split_ps: list | None = None) -> list[bytes]:
    """Join window consensi on a k-base exact anchor inside the overlap —
    exact port of link_consensus (lib/ctg_cns.c:3121-3223).

    parts: [(window_start aka uncorrected_len, Consensus)] in order.
    split=0: one sequence; split=1: separate parts at split points;
    split=2: N-joined.  Returns the list of output sequences."""
    n = len(parts)
    if n == 0:
        return [b""]
    lstrip = [0] * n
    rstrip = [0] * n
    s_half = overlap // 2
    for i in range(n - 1):
        cur_p, cur = parts[i]
        nxt_p, nxt = parts[i + 1]
        cpos, cbase = cur.pos, cur.base
        npos, nbase = nxt.pos, nxt.base
        cl = len(cpos)
        rs = ls = s_half
        while cpos[cl - rs] < cpos[cl - 1] - s_half:
            rs -= 1
        while cpos[cl - rs] > cpos[cl - 1] - s_half:
            rs += 1
        while npos[ls] < npos[0] + s_half:
            ls += 1
        while npos[ls] > npos[0] + s_half:
            ls -= 1
        l = 0
        p = nxt_p - cur_p
        guard = 0
        limit = (cl + len(npos)) * 2 + 1000
        while l < k:
            guard += 1
            if guard > limit:
                raise RuntimeError("window stitch found no anchor")
            j = int(cpos[cl - rs]) - int(npos[ls])
            if j == p and cbase[cl - rs] == nbase[ls]:
                l += 1
                ls -= 1
                rs += 1
            else:
                l = 0
                if j > p:
                    ls += 1
                elif j < p:
                    ls -= 1
                else:
                    d = int(cpos[cl - rs]) + cur_p - 1
                    while int(cpos[cl - rs]) + cur_p > d:
                        rs += 1
                    while int(npos[ls]) + nxt_p > d:
                        ls -= 1
        rstrip[i] = rs
        lstrip[i + 1] = ls
    if n > 1:
        rstrip[n - 2] -= k
        lstrip[n - 1] += k

    split_ps = split_ps or []
    if not split or not split_ps:
        # no split machinery active: the per-base loop below reduces to
        # emitting each window's kept slice — bulk-copy it
        out = bytearray()
        for i in range(n):
            cns = parts[i][1]
            j = lstrip[i]
            end_j = len(cns.pos) - rstrip[i]
            out += cns.base[j:end_j].tobytes()
        return [bytes(out)]
    outs: list[bytearray] = [bytearray()]
    li = 0
    sp = ((split_ps[0][0] + split_ps[0][1]) // 2 if split_ps else -1)
    li += 1
    for i in range(n):
        cns = parts[i][1]
        p = parts[i][0]
        pos, base = cns.pos, cns.base
        j = lstrip[i]
        end_j = len(pos) - rstrip[i]
        while j < end_j:
            gp = int(pos[j]) + p
            if (split and gp >= sp and j >= 1
                    and int(pos[j - 1]) + p < sp):
                if split == 1 and len(outs[-1]):
                    outs.append(bytearray())
                elif split == 2:
                    outs[-1].append(0x4E)
                while j < end_j and int(pos[j]) + p == sp:
                    j += 1
                if j >= end_j:
                    break
                # the C emits no base on the split iteration (:3196-3203)
                gp = int(pos[j]) + p
            else:
                outs[-1].append(int(base[j]))
            if gp > sp and li < len(split_ps):
                sp = (split_ps[li][0] + split_ps[li][1]) // 2
                li += 1
            j += 1
    return [bytes(o) for o in outs]


def consensus_for_contig(batch: AlnBatch, tid: int, contig: bytes,
                         read_type: str, window: int = 5_000_000,
                         overlap: int = 1_000_000, min_cov: int = 4,
                         repair: bool = True, split: int = 0,
                         contig_name: str = "", qv_desc: str | None = None,
                         batcher=None, device=None) -> list[bytes]:
    """Whole-contig consensus: window loop + stitch (ctg_cns_core).
    Returns the list of output sequences (>1 only when split=1 fires).

    `batch` may also be a region fetcher (anything with
    .fetch(tid, start, end) -> AlnBatch, e.g. io.bamregion.RegionFetcher):
    each window then reads only its own BAM region — the out-of-core
    analog of bam_merge_iter_init per window (lib/ctg_cns.c:3474).

    A window's spans serve the request `<contig_name>:<window start>`:
    cns.fetch, cns.prep (cns.prep.reads, cns.prep.struct and the spans
    inside it, _struct_pass), cns.densify, cns.queue (in the batcher),
    cns.dp (the submit, then the wait; the host engines' DP of a group),
    cns.finish (cns.repair)."""
    contig_ascii = np.frombuffer(contig.upper(), dtype=np.uint8)
    length = len(contig)
    b = cal_win_len(window, overlap, length)
    qv = st.parse_ref_qv(qv_desc)
    struct_ctx = StructState(
        brk_g=length > st.INS_MIN_CHECK_LEN,
        depth=st.DepthTrack(max(b, min(length, st.INS_RADOM_LEN))),
        qv=qv,
    )
    if struct_ctx.brk_g:
        struct_ctx.ref_ide = st.cal_ref_ide(qv)
    fetcher = batch if hasattr(batch, "fetch") else None
    # window starts (the structural pass is stateful across windows, so
    # prep stays in order; the DP batches across windows)
    starts = []
    s = 0
    e = 0
    while e < length:
        e = min(s + b, length)
        starts.append((s, e))
        s = e - overlap

    # group size: how many prepped windows fit one device launch
    # (runtime.budget — replaces nextpolish2.py's RAM-driven -p)
    from ...runtime.budget import cns_device_batch, host_available_bytes

    eng = default_engine(device)
    # per-window device bytes, sized as dense [Lt, 6E] A+M slabs (Lt ≈ 1.6
    # levels per draft base, E ≈ 15): 1152 B per base.  The compact launch
    # needs less: ≈ 7 entries per base × (10 B of stream + 12 B of chain
    # results) + levels × 38 B ≈ 215 B.  Host engines size by host memory.
    lvl_bytes = min(b, length) * 1152
    group = cns_device_batch(
        lvl_bytes, len(starts), device=device,
        free_bytes=None if eng == "device" else host_available_bytes())

    lq_min_qv = 80 if read_type == "hifi" else 20

    def fetch(s, e):
        if fetcher is None:
            return batch
        # window 0 extends the fetch so the depth track can sample 15 Mb
        lim = max(e, st.INS_RADOM_LEN) if (s == 0 and struct_ctx.brk_g) \
            else e
        with trace.timed("cns.fetch"):
            return fetcher.fetch(tid, s, max(lim - 1, s))

    def prep(s, e):
        wbatch = fetch(s, e)
        with trace.timed("cns.prep"):
            return window_prep(wbatch, tid, contig_ascii, s, e, read_type,
                               struct_ctx, contig_name)

    def finish(work, cns):
        if repair:
            with trace.timed("cns.repair"):
                cns = window_repair(work, cns, read_type)
        return cns

    parts = []
    if eng == "device":
        # every prepped window goes straight to the shared batcher: groups
        # of B windows — across contigs, when `batcher` is shared — leave
        # in one kernel launch while the host preps the next windows.
        from collections import deque

        from .batcher import CnsBatcher
        from .device_dp import prepare_window

        bat = batcher if batcher is not None else CnsBatcher(
            read_type, device=device)
        futs: deque = deque()

        def finish_one():
            (s, e), work, edges, fut = futs.popleft()
            with trace.request(f"{contig_name}:{s}"):
                with trace.timed("cns.dp"):
                    r = fut.result()
                with trace.timed("cns.finish"):
                    cns = None
                    if r is not None:
                        cns = traceback(edges, r[0], r[1], work.coverage,
                                        work.L, read_type, min_cov,
                                        lq_min_qv=lq_min_qv)
                    if cns is None:
                        cns = window_dp(work, read_type, min_cov,
                                        engine="native")
                    parts.append((s, finish(work, cns)))

        with bat.contig():
            for s, e in starts:
                with trace.request(f"{contig_name}:{s}"):
                    work = prep(s, e)
                    with trace.timed("cns.densify"):
                        edges, dw = prepare_window(work.merged,
                                                   work.coverage, work.L)
                    with trace.timed("cns.dp"):
                        futs.append(((s, e), work, edges, bat.submit(dw)))
                while len(futs) > group:
                    finish_one()
        while futs:
            finish_one()
    else:
        for glo in range(0, len(starts), group):
            works = []
            for s, e in starts[glo:glo + group]:
                with trace.request(f"{contig_name}:{s}"):
                    works.append(prep(s, e))
            with trace.timed("cns.dp"):
                cnss = [window_dp(w, read_type, min_cov, engine=eng)
                        for w in works]
            for (s, e), work, cns in zip(starts[glo:glo + group], works,
                                         cnss):
                with trace.request(f"{contig_name}:{s}"), \
                        trace.timed("cns.finish"):
                    parts.append((s, finish(work, cns)))
    return stitch(parts, overlap, split=split,
                  split_ps=struct_ctx.split_ps)
