"""Long-read mapper: minimizer anchors -> score-based chain DP
(align/chain.py, mm_chain_dp semantics) -> batched global banded alignment
of inter-anchor segments + ksw-style read-end extensions
(the role of minimap2 map-ont/map-pb in source/nextPolish:208-216).

Anchors are exact k-mer matches, so the final CIGAR is assembled from anchor
match-runs plus globally-aligned gap segments; read ends beyond the terminal
anchors are soft-clipped.  Primary selection among close chains is
identity-aware (final alignment score), and mapq follows minimap2's
s1/s2 ambiguity model.
"""
from __future__ import annotations

import numpy as np

from ..io import bam as bamio
from .extend import band_align_ops
from .index import GenomeIndex
from .leftalign import left_align_runs
from .mapper import NIB_OF_CODE, _finalize, _revcomp_codes
from .minimizer import kmer_hashes, seq_codes

_M, _I, _D, _S = 0, 1, 2, 4

# segment buckets: (max qlen, band)
_BUCKETS = [(16, 32), (32, 32), (64, 64), (128, 64), (256, 128), (512, 128),
            (1024, 256), (2048, 256), (4096, 512)]


def _anchors(idx: GenomeIndex, codes: np.ndarray, k: int):
    """All (qpos, rpos, orientation, unique) minimizer matches for one
    read; `unique` marks anchors whose minimizer occurs once in the
    genome."""
    h, st = kmer_hashes(codes, k)
    ok = h != np.uint64(0xFFFFFFFFFFFFFFFF)
    qpos = np.flatnonzero(ok)
    if not qpos.size:
        return (np.empty(0, np.int64),) * 3 + (np.empty(0, bool),)
    hq = h[qpos]
    lo, hi = idx.lookup(hq)
    n = hi - lo
    tot = int(n.sum())
    if not tot:
        return (np.empty(0, np.int64),) * 3 + (np.empty(0, bool),)
    rep = np.repeat(np.arange(qpos.size), n)
    flat = np.repeat(lo, n) + (np.arange(tot) - np.repeat(np.cumsum(n) - n, n))
    rpos = idx.positions[flat]
    same = idx.strands[flat] == st[qpos][rep]
    uniq = (n == 1)[rep]
    return qpos[rep].astype(np.int64), rpos.astype(np.int64), same, uniq


MAX_SPLIT_PARTS = 4  # split-read parts per read (primary + supplementaries)
# net indel above this breaks the chain into split parts + SA tags;
# below it the event stays in-CIGAR as an I/D run — minimap2's boundary
# is its max_gap (-g 5000), and the reference's structural layer expects
# SA tags only for events minimap2 itself would split (check_indel,
# lib/ctg_cns.c:3487-3508)
MAX_EVENT_LEN = 5000


def _split_chain(cq: np.ndarray, cr: np.ndarray,
                 idx: GenomeIndex | None = None, k: int = 15):
    """Break a colinear chain at net-indel jumps > MAX_EVENT_LEN — such
    events are structural, and must surface as split parts + SA tags (the
    signal check_indel consumes), not as giant I/D CIGAR ops.

    Chains are also broken at CONTIG BOUNDARIES of the concatenated
    genome: contigs that abut in the underlying sequence chain straight
    through the junction in global coordinates, and a junction-crossing
    read must yield one record per contig (as minimap2 does), not be
    dropped — otherwise both contigs lose their edge coverage."""
    if cq.size == 0:
        return []
    jump = np.abs(np.diff(cr) - np.diff(cq))
    brk = set(np.flatnonzero(jump > MAX_EVENT_LEN).tolist())
    if idx is not None and len(idx.starts) > 1:
        tid = np.searchsorted(idx.starts, cr, side="right") - 1
        # anchor t and t+1 on different contigs (or an anchor's k-mer
        # straddling the boundary) ends the part at t
        tid_end = np.searchsorted(idx.starts, cr + k - 1, side="right") - 1
        brk |= set(np.flatnonzero(np.diff(tid) != 0).tolist())
        brk |= set((np.flatnonzero(tid_end != tid) - 1).tolist())
    out = []
    s = 0
    for b in sorted(brk):
        if b < s:
            continue
        out.append((cq[s : b + 1], cr[s : b + 1]))
        s = b + 1
    out.append((cq[s:], cr[s:]))
    return [(q, r) for q, r in out if q.size]


MAX_JOIN_GAP = 5000  # colinear chains this close merge into one alignment


def _join_colinear(chains):
    """Merge separately-extracted chains that are colinear continuations
    of each other (ascending in both query and reference, gaps under
    MAX_JOIN_GAP): the chain DP's bandwidth rejects multi-kb indel jumps,
    but minimap2 represents such events as in-CIGAR I/D runs inside ONE
    record (its bw-long join), and fragmenting them into split parts
    instead starves the consensus of the surrounding coverage.

    chains: [(score, cq, cr)] best-first.  Returns the same shape."""
    if len(chains) <= 1:
        return chains
    order = sorted(range(len(chains)), key=lambda i: int(chains[i][1][0]))
    merged = []
    cur = None
    for i in order:
        sc, cq, cr = chains[i]
        if cur is None:
            cur = [sc, [cq], [cr]]
            continue
        pq, pr = cur[1][-1], cur[2][-1]
        qgap = int(cq[0]) - int(pq[-1])
        rgap = int(cr[0]) - int(pr[-1])
        if 0 < qgap <= MAX_JOIN_GAP and 0 < rgap <= MAX_JOIN_GAP:
            cur[0] += sc
            cur[1].append(cq)
            cur[2].append(cr)
        else:
            merged.append(cur)
            cur = [sc, [cq], [cr]]
    merged.append(cur)
    return [(sc, np.concatenate(qs), np.concatenate(rs))
            for sc, qs, rs in merged]


def _find_parts(idx: GenomeIndex, codes: np.ndarray, k: int, min_chain: int):
    """Score-based chaining for one read: every chain from the chain DP
    (align/chain.py, mm_chain_dp semantics) becomes a candidate; the
    best-scoring non-query-overlapping ones survive as primary +
    supplementary parts (the multi-part output that feeds SA tags,
    util/minimap2 + lib/ctg_cns.c:2158 set_satags).  Returns a list of
    (strand, cq, cr, oriented_codes, score, sub_score) ordered
    best-first; sub_score is the best rejected overlapping competitor
    (mapq's s2, as in minimap2's mapping-quality model)."""
    from .chain import chain_anchors

    qpos, rpos, same, uniq = _anchors(idx, codes, k)
    L = codes.size
    cands = []  # (score, strand, cq, cr)
    for strand in (0, 1):
        m = same if strand == 0 else ~same
        qo = qpos[m]
        ro = rpos[m]
        qp = qo if strand == 0 else L - k - qo
        chains = [(sc, qp[sel], ro[sel])
                  for sc, sel in chain_anchors(qp, ro, k)]
        for sc, cq, cr in _join_colinear(chains):
            cands.append((sc, strand, cq, cr))
    cands.sort(key=lambda t: -t[0])
    parts = []
    spans = []  # kept query spans in original-read coords, + score
    used = np.zeros(max(L, 1), dtype=bool)
    rc = None
    for sc, strand, cq, cr in cands:
        if cq.size < min_chain or len(parts) >= MAX_SPLIT_PARTS:
            continue
        q0, q1 = int(cq[0]), int(cq[-1]) + k
        lo, hi = (L - q1, L - q0) if strand else (q0, q1)
        if used[lo:hi].mean() > 0.3:
            # repeat competitor of an already-kept part: record it as
            # that part's s2 so mapq reflects the ambiguity
            for si, (slo, shi, _) in enumerate(spans):
                if min(hi, shi) - max(lo, slo) > 0.3 * (hi - lo):
                    parts[si] = parts[si][:5] + (
                        max(parts[si][5], sc),)
                    break
            continue
        used[lo:hi] = True
        if strand and rc is None:
            rc = _revcomp_codes(codes)
        oriented = rc if strand else codes
        # pieces of a confident chain (structural events / contig
        # boundaries) keep minimap2's low per-piece floor (min_cnt=3);
        # highly divergent reads anchor sparsely, and the chain DP's
        # score>=40 gate (chain.MIN_SC) is the principled guard now
        piece_min = min(min_chain, 3)
        for scq, scr in _split_chain(cq, cr, idx, k):
            if scq.size >= piece_min and len(parts) < MAX_SPLIT_PARTS:
                parts.append((strand, scq, scr, oriented, sc, 0))
                spans.append((lo, hi, sc))
    return parts


def _cigar_str(cig: np.ndarray) -> str:
    ops = "MIDNSHP=X"
    return "".join(f"{int(w) >> 4}{ops[int(w) & 0xF]}" for w in cig)


def _sa_aux(parts_info, skip: int) -> bytes:
    """Raw BAM aux bytes for SA:Z listing every part except `skip`
    (rname,pos,strand,CIGAR,mapQ,NM; — the format set_satags parses,
    lib/ctg_cns.c:2158-2231)."""
    ents = []
    for j, (rname, pos, strand, cig, mapq) in enumerate(parts_info):
        if j == skip:
            continue
        ents.append(
            f"{rname},{pos + 1},{'-' if strand else '+'},"
            f"{_cigar_str(cig)},{mapq},0;"
        )
    return b"SAZ" + "".join(ents).encode() + b"\x00"


def map_long_batch(idx: GenomeIndex, seqs: list, names: list | None = None,
                   k: int = 15, w: int = 10, min_chain: int = 3,
                   match=2, mismatch=4, gapo=4, gape=2, device=None):
    """Map long reads; returns BAM-style record dicts (unpaired).

    Reads whose anchors chain into multiple disjoint query spans (split
    reads over a structural break in the draft) produce one primary plus
    supplementary records (FSUPPLEMENTARY, full soft-clipped seq), each
    carrying an SA:Z tag over the other parts."""
    n = len(seqs)
    chains = []  # flat parts: (read, strand, cq, cr, codes_oriented)
    chain_sc = []  # (chain_score, best_rejected_competitor_score)
    read_parts = [[] for _ in range(n)]  # read -> part ids (best first)
    for i, s in enumerate(seqs):
        codes = seq_codes(s)
        for strand, cq, cr, oriented, sc, sub in _find_parts(
                idx, codes, k, min_chain):
            read_parts[i].append(len(chains))
            chains.append((i, strand, cq, cr, oriented))
            chain_sc.append((sc, sub))

    # build per-part op skeletons + segment jobs
    np_parts = len(chains)
    skels = [None] * np_parts  # list of ('M'|'I'|'D', len) or ('SEG', job_id)
    jobs = []  # (part, qa, qlen, ra, tlen)
    for i in range(np_parts):
        _, strand, cq, cr, codes = chains[i]
        sk = []
        # merge anchors into match runs and gap segments
        qa, ra = int(cq[0]), int(cr[0])
        cur_m = k
        qe, re_ = qa + k, ra + k  # aligned-through coordinates
        for t in range(1, cq.size):
            q1, r1 = int(cq[t]), int(cr[t])
            gq, gr = q1 - qe, r1 - re_  # gap (or overlap) to next anchor
            if gq == gr:
                if gq + k > 0:  # colinear (possibly overlapping): extend run
                    cur_m += gq + k
                    qe, re_ = q1 + k, r1 + k
                continue
            if gq < 0 or gr < 0:
                continue  # conflicting overlap: drop anchor
            sk.append((_M, cur_m))
            if gq == 0:
                sk.append((_D, gr))
            elif gr == 0:
                sk.append((_I, gq))
            else:
                bucket = _pick_bucket(gq, gr)
                if bucket is None:
                    sk.append((_I, gq))
                    sk.append((_D, gr))
                else:
                    jobs.append((i, qe, gq, re_, gr, bucket))
                    sk.append(("SEG", len(jobs) - 1))
            cur_m = k
            qe, re_ = q1 + k, r1 + k
        sk.append((_M, cur_m))
        skels[i] = (sk, qa, qe, ra, re_)

    seg_ops = _run_segments(idx, jobs, chains, match, mismatch, gapo, gape,
                            device)
    head_ext, tail_ext = _run_end_extensions(idx, chains, skels, match,
                                             mismatch, gapo, gape, device)

    # assemble one candidate record per part
    part_recs = [None] * np_parts
    for i in range(np_parts):
        if skels[i] is None:
            continue
        sk, qa, qe, ra, re_ = skels[i]
        _, strand, cq, cr, codes = chains[i]
        runs = []

        def add(op, ln):
            if ln <= 0:
                return
            if runs and runs[-1][0] == op:
                runs[-1][1] += ln
            else:
                runs.append([op, ln])

        ok = True
        for op, v in sk:
            if op == "JOIN":
                continue
            if op == "SEG":
                res = seg_ops.get(v)
                if res is None:
                    ok = False
                    break
                for o, ln in res:
                    add(o, ln)
            else:
                add(op, v)
        if not ok:
            continue
        L = codes.size
        # splice the read-end extensions around the anchored runs
        qa_eff, ra_eff, qe_eff, re_eff = qa, ra, qe, re_
        h = head_ext.get(i)
        t_ = tail_ext.get(i)
        parts_ops = []
        if h:
            parts_ops.extend(h[0])
            qa_eff -= h[1]
            ra_eff -= h[2]
        parts_ops.extend((op, ln) for op, ln in runs)
        if t_:
            parts_ops.extend(t_[0])
            qe_eff += t_[1]
            re_eff += t_[2]
        merged = []
        for op, ln in parts_ops:
            if ln <= 0:
                continue
            if merged and merged[-1][0] == op:
                merged[-1][1] += ln
            else:
                merged.append([op, ln])
        # canonical indel placement: all reads carrying the same event
        # must pile it in the same column (see left_align_runs)
        merged = left_align_runs(merged, codes, idx.codes, qa_eff, ra_eff)
        cig = []
        if qa_eff > 0:
            cig.append((qa_eff << 4) | _S)
        cig.extend((ln << 4) | op for op, ln in merged)
        if L - qe_eff > 0:
            cig.append(((L - qe_eff) << 4) | _S)
        tid, pos = idx.global_to_contig(np.array([ra_eff]))
        tid2, _ = idx.global_to_contig(np.array([re_eff - 1]))
        if tid[0] != tid2[0]:
            continue
        # identity score over the final runs (matches - mismatches -
        # affine gaps): ranks close repeat-copy candidates by how well
        # they actually align, not just by anchors (minimap2 re-ranks
        # by DP score the same way)
        sc_aln = 0
        qi, rj = qa_eff, ra_eff
        for op, ln in merged:
            if op == _M:
                nm = int((codes[qi:qi + ln]
                          == idx.codes[rj:rj + ln]).sum())
                sc_aln += match * nm - mismatch * (ln - nm)
                qi += ln
                rj += ln
            elif op == _I:
                sc_aln -= gapo + gape * ln
                qi += ln
            else:
                sc_aln -= gapo + gape * ln
                rj += ln
        s1, s2 = chain_sc[i]
        if s2 == 0:
            # no overlapping competitor: unique placement (minimap2
            # likewise saturates unique hits at 60)
            mapq = 60 if cq.size >= 10 else min(60, 20 + 4 * int(cq.size))
        else:
            mapq = int(40.0 * (1.0 - s2 / max(s1, 1))
                       * min(1.0, cq.size / 10.0) + 0.499)
        mapq = max(0, min(60, mapq))
        part_recs[i] = dict(ref_id=int(tid[0]), pos=int(pos[0]),
                            strand=strand, mapq=mapq,
                            cigar=np.array(cig, dtype=np.uint32),
                            score=sc_aln)

    # attach SA tags where a read has >1 surviving part; primary = the
    # part with the best identity score (falls back to chain order when
    # scores tie)
    records = [None] * n
    extra = []
    for i in range(n):
        pids = [p for p in read_parts[i] if part_recs[p] is not None]
        if not pids:
            continue
        pids.sort(key=lambda p: -part_recs[p]["score"])
        prim = part_recs[pids[0]]
        records[i] = prim
        if len(pids) == 1:
            continue
        info = [(idx.names[part_recs[p]["ref_id"]], part_recs[p]["pos"],
                 part_recs[p]["strand"], part_recs[p]["cigar"],
                 part_recs[p]["mapq"]) for p in pids]
        prim["tags"] = _sa_aux(info, 0)
        for j, p in enumerate(pids[1:], start=1):
            sup = dict(part_recs[p])
            sup["supplementary"] = True
            sup["tags"] = _sa_aux(info, j)
            extra.append((i, sup))

    out = _finalize(records, idx, seqs, names, None, False)
    for i, sup in extra:
        rec = _finalize([sup], idx, [seqs[i]],
                        [names[i]] if names else [f"read{i}"], None, False)[0]
        rec["flag"] |= bamio.FSUPPLEMENTARY
        out.append(rec)
    return out


def _pick_bucket(gq: int, gr: int):
    for bi, (cap, band) in enumerate(_BUCKETS):
        if gq <= cap and abs(gq - gr) < band // 2 - 4 and gr <= cap + band // 2 - 4:
            return bi
    return None


EXT_CAP = 1000  # longest read-end extension (longer tails are split parts)
EXT_BAND = 64
EXT_PIN = 1 << 20  # start-pin bonus for mode="extend"


def _run_end_extensions(idx: GenomeIndex, chains, skels, match, mismatch,
                        gapo, gape, device=None):
    """Extend every part from its outermost anchors to the read ends
    (the ksw right/left extensions of minimap2's alignment stage; the
    chain alone soft-clips at the anchors).  Returns per-part
    (ops_fwd, q_used, r_used) dicts for heads and tails; ref windows
    clamp to the part's contig so edge reads align clipped at the
    boundary."""
    heads = {}
    tails = {}
    jobs = []  # (part, side, q_codes, ref_lo, ref_hi, reversed)
    for i, sk in enumerate(skels):
        if sk is None:
            continue
        _, qa, qe, ra, re_ = sk
        _, strand, cq, cr, codes = chains[i]
        mid = min(max(ra, 0), idx.codes.size - 1)
        cid, _ = idx.global_to_contig(np.array([mid]))
        g0 = int(idx.starts[int(cid[0])])
        g1 = g0 + int(idx.lengths[int(cid[0])])
        L = codes.size
        if qa > 0:
            n = min(qa, EXT_CAP)
            qh = codes[qa - n:qa][::-1]
            lo = max(ra - (n + EXT_BAND), g0)
            jobs.append((i, 0, qh, lo, min(ra, g1), True))
        if L - qe > 0:
            n = min(L - qe, EXT_CAP)
            qt = codes[qe:qe + n]
            hi = min(re_ + n + EXT_BAND, g1)
            jobs.append((i, 1, qt, max(re_, g0), hi, False))
    if not jobs:
        return heads, tails
    R = max(len(j[2]) for j in jobs)
    W = R + EXT_BAND
    q = np.full((len(jobs), R), 4, dtype=np.uint8)
    t = np.full((len(jobs), W), 4, dtype=np.uint8)
    qlen = np.zeros(len(jobs), dtype=np.int32)
    tlen = np.zeros(len(jobs), dtype=np.int32)
    for b, (i, side, qc, lo, hi, rev) in enumerate(jobs):
        q[b, : len(qc)] = qc
        qlen[b] = len(qc)
        seg = idx.codes[lo:hi]
        if rev:
            seg = seg[::-1]
        t[b, : len(seg)] = seg
        tlen[b] = len(seg)
    ops, sc, i_lo, j_lo, i_hi, j_hi, _ = band_align_ops(
        q, t, qlen, tlen, match=match, mismatch=mismatch, gapo=gapo,
        gape=gape, mode="extend", clip5=EXT_PIN, device=device)
    for b, (i, side, qc, lo, hi, rev) in enumerate(jobs):
        if int(sc[b]) <= 0 or int(i_lo[b]) != 0:
            continue
        row = ops[b]
        o = (row[row > 0] - 1)[::-1]  # start->end of the extension walk
        q_used = int(i_hi[b]) + 1
        r_used = int(j_hi[b]) + 1
        jl = int(j_lo[b])
        runs = []
        if jl > 0:  # leading deletion away from the anchor
            runs.append((_D, jl))
        if o.size:
            change = np.flatnonzero(np.diff(o) != 0)
            bounds = np.concatenate([[-1], change, [o.size - 1]])
            for a2, b2 in zip(bounds[:-1], bounds[1:]):
                runs.append((int(o[a2 + 1]), int(b2 - a2)))
        if side == 0:
            # head: walked on reversed sequences; flip run order so ops
            # read left-to-right in the original orientation
            heads[i] = ([(op, ln) for op, ln in reversed(runs)], q_used,
                        r_used)
        else:
            tails[i] = (runs, q_used, r_used)
    return heads, tails


def _run_segments(idx: GenomeIndex, jobs, chains, match, mismatch, gapo, gape,
                  device=None):
    """Batch global alignments per bucket; returns job_id -> [(op, len)]."""
    out = {}
    by_bucket = {}
    for jid, (ri, qa, gq, ra, gr, b) in enumerate(jobs):
        by_bucket.setdefault(b, []).append(jid)
    for b, jids in by_bucket.items():
        cap, band = _BUCKETS[b]
        off = band // 2
        W = cap + band
        Bt = len(jids)
        q = np.full((Bt, cap), 4, dtype=np.uint8)
        t = np.full((Bt, W), 4, dtype=np.uint8)
        qlen = np.zeros(Bt, dtype=np.int32)
        tlen = np.zeros(Bt, dtype=np.int32)
        for bi, jid in enumerate(jids):
            ri, qa, gq, ra, gr, _ = jobs[jid]
            codes = chains[ri][4]
            q[bi, :gq] = codes[qa : qa + gq]
            # t[x] = ref[ra + x - off]
            lo = max(ra - off, 0)
            hi = min(ra + gr, idx.codes.size)
            t[bi, lo - (ra - off) : hi - (ra - off)] = idx.codes[lo:hi]
            # mask anything beyond the segment as invalid
            t[bi, off + gr :] = 4
            qlen[bi] = gq
            tlen[bi] = gr
        ops, sc, i_lo, j_lo, i_hi, j_hi, lead = band_align_ops(
            q, t, qlen, tlen, match=match, mismatch=mismatch, gapo=gapo,
            gape=gape, mode="global", device=device)
        for bi, jid in enumerate(jids):
            ri, qa, gq, ra, gr, _ = jobs[jid]
            if int(i_lo[bi]) != 0 or int(i_hi[bi]) != gq - 1:
                out[jid] = None
                continue
            row = ops[bi]
            o = row[row > 0] - 1
            o = o[::-1]
            runs = []
            if lead[bi] > 0:
                runs.append((_D, int(lead[bi])))
            if o.size:
                change = np.flatnonzero(np.diff(o) != 0)
                bounds = np.concatenate([[-1], change, [o.size - 1]])
                for a, bnd in zip(bounds[:-1], bounds[1:]):
                    runs.append((int(o[a + 1]), int(bnd - a)))
            out[jid] = runs
    return out
