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

from dataclasses import dataclass, field

import numpy as np

from npbench.ref.cns import structural as st
from npbench.ref.cns.bam import AlnBatch, region_overlap_mask
from npbench.ref.cns.dp import Consensus, link_dp, traceback
from npbench.ref.cns.msa import build_edges
from npbench.ref.cns.tags import (
    WindowAccum,
    expand_columns,
    read_columns,
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


def window_prep(batch: AlnBatch, tid: int, contig_ascii: np.ndarray,
                s: int, e: int, read_type: str,
                struct_ctx: StructState | None = None,
                contig_name: str = "") -> "WindowWork":
    """Host preparation of one window (pos window-local): read filtering,
    tag expansion, structural pass — everything in the per-window body of
    ctg_cns_core before the link DP.  Returns a WindowWork for
    window_dp (host engines) or the batcher + window_repair."""
    L = e - s
    brk_g = struct_ctx is not None and struct_ctx.brk_g
    accum = WindowAccum(contig_ascii, s, e, GAP_MIN_LEN[read_type])
    has_tags = batch.tags is not None
    max_clip = MAX_CLIP_RATIO[read_type]
    # window 0 extends the fetch so the depth track can sample 15 Mb
    rege_limit = max(e, st.INS_RADOM_LEN) if (s == 0 and brk_g) else e
    if brk_g:
        struct_ctx.depth.reset_window(e - s)

    gaps: list[st.GapInfo] = []
    sup_alns: list[st.SupAln] = []
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
                sup_alns.append(st.SupAln(int(poss[r]), rd_s,
                                          cig.copy()))
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

    clusters: list[st.GapCluster] = []
    if brk_g:
        rr = struct_ctx.depth
        rr_count = (st.INS_RADOM_COUNT if rr.rreads_w
                    else len(rr.rreads))
        if accum.n_rows() < 150 or rr_count < 150 or not sup_alns:
            struct_ctx.brk_g = False
            brk_g = False
    if brk_g:
        d = struct_ctx.depth
        d.finish_reads(s)
        nbins = (e - s) // st.INS_WIN_STEP
        if not struct_ctx.ref_d:
            struct_ctx.ref_d = st.cal_ref_d(d.ref_ds, nbins)
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

        def add_sup_row(fs, cigar, nib):
            tr = trim_read_columns(*expand_columns(fs, cigar, nib),
                                   accum.ref_cns, s, e)
            if tr is None:
                return None
            rid = accum.add_row(tr[0], tr[1], tr[2], -2)
            return rid, tr[3]

        st.realign_cluster_sups(clusters, sup_alns, accum, accum.ref_cns,
                                s, e, add_sup_row)
        st.generate_gapseqs(clusters, accum, s)
        if struct_ctx.ref_d > 15:
            st.update_split_p(struct_ctx.split_ps, clusters, ld, s, e - s,
                              struct_ctx.qv)

    merged = accum.finish()
    coverage = accum.coverage[:L] + 1
    return WindowWork(merged, coverage, L, accum.l_ins, accum.l_del,
                      clusters)


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


def window_dp(work: WindowWork, read_type: str, min_cov: int,
              dtype=np.int64):
    """One window's link DP (no repair), its scores held in `dtype`."""
    lq_min_qv = 80 if read_type == "hifi" else 20
    edges = build_edges(work.merged)
    score, best = link_dp(edges, work.coverage, read_type, dtype=dtype)
    return traceback(edges, score, best, work.coverage, work.L, read_type,
                     min_cov, lq_min_qv=lq_min_qv)


def window_repair(work: WindowWork, cns, read_type: str):
    """Per-window LQ repair (POA reseeding + realignment)."""
    if not len(cns.pos):
        return cns
    if read_type == "hifi":
        from npbench.ref.cns.lqrepair import repair_hifi

        return repair_hifi(cns, work.merged, work.coverage, work.clusters)
    from npbench.ref.cns.lqrepair import repair as exact_repair

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
                         contig_name: str = "",
                         qv_desc: str | None = None,
                         dtype=np.int64) -> list[bytes]:
    """Whole-contig consensus: window loop + stitch (ctg_cns_core).
    Returns the list of output sequences (>1 only when split=1 fires)."""
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
    starts = []
    s = 0
    e = 0
    while e < length:
        e = min(s + b, length)
        starts.append((s, e))
        s = e - overlap
    parts = []
    for s, e in starts:
        work = window_prep(batch, tid, contig_ascii, s, e, read_type,
                           struct_ctx, contig_name)
        cns = window_dp(work, read_type, min_cov, dtype)
        if repair:
            cns = window_repair(work, cns, read_type)
        parts.append((s, cns))
    return stitch(parts, overlap, split=split,
                  split_ps=struct_ctx.split_ps)
