"""Short-read mapper: minimizer seeding -> diagonal voting -> batched banded
extension -> AlnBatch (the role of `bwa mem` in source/nextPolish:199-206).

Pairing: after single-end placement, mate fields/flags/tlen are filled from
the two mates' primary alignments (`-p` interleaved semantics: reads i and
i+1 are mates when paired=True).
"""
from __future__ import annotations

import numpy as np

from ..io import bam as bamio
from ..io.bam import AlnBatch, BamHeader
from .extend import band_align_ops, runs_to_cigar
from .index import GenomeIndex
from .leftalign import left_align_cigar
from .minimizer import kmer_hashes, seq_codes

_RC = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

NIB_OF_CODE = np.array([1, 2, 4, 8, 15], dtype=np.uint8)  # A C G T N
_SOFT = 4  # BAM CIGAR soft-clip op


def _revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _RC[codes[::-1]]


def seed_read(idx: GenomeIndex, codes: np.ndarray):
    """All minimizer-compatible seed hits: (diag, strand) arrays.

    diag is the implied global ref start of the read under each hit.
    """
    k = idx.k
    h, st = kmer_hashes(codes, k)
    ok = h != np.uint64(0xFFFFFFFFFFFFFFFF)
    qpos = np.flatnonzero(ok)
    if not qpos.size:
        return np.empty(0, np.int64), np.empty(0, np.uint8)
    # subsample query kmers for speed: every 3rd position
    qpos = qpos[::3]
    hq = h[qpos]
    lo, hi = idx.lookup(hq)
    n_hits = hi - lo
    tot = int(n_hits.sum())
    if not tot:
        return np.empty(0, np.int64), np.empty(0, np.uint8)
    rep = np.repeat(np.arange(qpos.size), n_hits)
    flat = np.repeat(lo, n_hits) + (
        np.arange(tot) - np.repeat(np.cumsum(n_hits) - n_hits, n_hits)
    )
    rpos = idx.positions[flat]
    rstrand = idx.strands[flat]
    qstrand = st[qpos][rep]
    qp = qpos[rep]
    same = rstrand == qstrand
    L = codes.size
    diag = np.where(same, rpos - qp, rpos - (L - k - qp))
    strand = (~same).astype(np.uint8)
    return diag, strand


def _tied_clusters(idx: GenomeIndex, codes: np.ndarray, tol: int = 8):
    """All top-tied seed clusters of one read: [(diag, strand, votes)],
    merged-bin counting identical to seed_votes_batch."""
    diag, strand = seed_read(idx, codes)
    if not diag.size:
        return []
    key = (diag // tol) * 2 + strand.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    merged = counts.copy()
    for d in (-2, 2):
        j = np.searchsorted(uniq, uniq + d)
        ok = (j < uniq.size)
        ok &= uniq[np.minimum(j, uniq.size - 1)] == uniq + d
        merged[ok] += counts[j[ok]]
    top = int(merged.max())
    out = []
    taken = set()
    for u in uniq[merged == top]:
        if u - 2 in taken:  # adjacent same-strand bin of a taken cluster
            continue
        taken.add(int(u))
        sel = (key == u) | (key == u - 2) | (key == u + 2)
        out.append((int(np.median(diag[sel])), int(u & 1), top))
    return out


def _pair_disambiguate(placements, idx: GenomeIndex, codes_fwd,
                       window: int = 1200):
    """bwa mem's pairing stage for ambiguous reads (mem_pair role,
    util/bwa/bwamem_pair.c): when a read's best seed clusters tie but its
    mate is confidently placed, pick the tied cluster that forms a proper
    FR pair inside the insert window instead of the pseudo-random tie
    hash.  Repeat-copy ambiguity then resolves the way bwa resolves it —
    by mate evidence — which is what the polishing pileups see."""
    n = len(placements)
    for i in range(n):
        d, s, v1, v2 = placements[i]
        if v1 <= 0 or v2 < v1:  # unambiguous (or unplaced)
            continue
        mate = i + 1 if i % 2 == 0 else i - 1
        if not (0 <= mate < n):
            continue
        md, ms, mv1, mv2 = placements[mate]
        if mv1 <= 0 or mv2 >= mv1:  # mate ambiguous too
            continue
        cands = _tied_clusters(idx, codes_fwd[i])
        if len(cands) < 2:
            continue
        best = None
        for cd, cs, _ in cands:
            if cs == ms:  # FR orientation: mates on opposite strands
                continue
            gap = abs(cd - md)
            if gap <= window and (best is None or gap < best[0]):
                best = (gap, cd, cs)
        if best is not None:
            placements[i] = (best[1], best[2], v1, v2)
    return placements


def _vote(diag: np.ndarray, strand: np.ndarray, tol: int = 8):
    """Pick the best (diag, strand) cluster (adjacent diag bins merged);
    returns (best_diag, best_strand, votes, second_votes)."""
    if not diag.size:
        return 0, 0, 0, 0
    key = (diag // tol) * 2 + strand.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    # merged count of bin + same-strand neighbor bins
    merged = counts.copy()
    for d in (-2, 2):
        j = np.searchsorted(uniq, uniq + d)
        ok = (j < uniq.size)
        ok &= uniq[np.minimum(j, uniq.size - 1)] == uniq + d
        merged[ok] += counts[j[ok]]
    order = np.argsort(-merged, kind="stable")
    bk = int(uniq[order[0]])
    v1 = int(merged[order[0]])
    # second best from a non-adjacent cluster
    v2 = 0
    for o in order[1:]:
        if abs(int(uniq[o]) - bk) > 2 or (int(uniq[o]) & 1) != (bk & 1):
            v2 = int(merged[o])
            break
    sel = (key == bk) | (key == bk - 2) | (key == bk + 2)
    best_diag = int(np.median(diag[sel]))
    return best_diag, int(bk & 1), v1, v2


def seed_votes_batch(idx: GenomeIndex, codes_mat: np.ndarray,
                     lens: np.ndarray, subsample: int = 3, tol: int = 8):
    """Vectorized seeding for a whole batch of (padded) reads.

    Returns per-read (diag, strand, v1, v2) arrays: the winning seed
    cluster's global ref start, orientation, merged vote count, and the
    best competing non-adjacent cluster's count.
    """
    from .minimizer import _mix64

    N, R = codes_mat.shape
    k = idx.k
    nk = R - k + 1
    c = codes_mat.astype(np.uint64)
    valid = codes_mat < 4
    # subsample query positions FIRST: hash only every `subsample`-th k-mer
    cols = np.arange(0, nk, subsample)
    nc = cols.size
    fwd = np.zeros((N, nc), dtype=np.uint64)
    rev = np.zeros((N, nc), dtype=np.uint64)
    okay = np.ones((N, nc), dtype=bool)
    for i in range(k):
        ci = c[:, cols + i]
        fwd = (fwd << np.uint64(2)) | ci
        rev |= (np.uint64(3) - ci) << np.uint64(2 * i)
        okay &= valid[:, cols + i]
    okay &= cols[None, :] + k <= lens[:, None]
    qstrand = (rev < fwd).astype(np.uint8)
    h = _mix64(np.minimum(fwd, rev))
    qpos_mat = np.broadcast_to(cols, h.shape)

    flat_ok = okay.ravel()
    hq = h.ravel()[flat_ok]
    qp = qpos_mat.ravel()[flat_ok]
    qs = qstrand.ravel()[flat_ok]
    rid = np.broadcast_to(np.arange(N)[:, None], h.shape).ravel()[flat_ok]

    lo, hi = idx.lookup(hq)
    nh = hi - lo
    tot = int(nh.sum())
    out = np.zeros((N, 4), dtype=np.int64)
    if not tot:
        return out
    rep = np.repeat(np.arange(hq.size), nh)
    flat = np.repeat(lo, nh) + (
        np.arange(tot) - np.repeat(np.cumsum(nh) - nh, nh)
    )
    rpos = idx.positions[flat]
    same = idx.strands[flat] == qs[rep]
    hr = rid[rep]
    hqp = qp[rep]
    L = lens[hr]
    diag = np.where(same, rpos - hqp, rpos - (L - k - hqp))
    strand = (~same).astype(np.int64)

    bin_ = diag // tol
    key = (hr.astype(np.int64) << 34) | (strand << 33) | (bin_ + (1 << 31))
    ukey, counts = np.unique(key, return_counts=True)
    merged = counts.copy()
    for d in (-1, 1):
        j = np.searchsorted(ukey, ukey + d)
        ok2 = j < ukey.size
        ok2 &= ukey[np.minimum(j, ukey.size - 1)] == ukey + d
        # neighbor must be same read+strand (high bits equal)
        ok2 &= (ukey >> 33) == ((ukey + d) >> 33)
        merged[ok2] += counts[j[ok2]]
    # per-read best by merged count
    krid = (ukey >> 34).astype(np.int64)
    order = np.lexsort((-merged, krid))
    ks, km = ukey[order], merged[order]
    kr = krid[order]
    first = np.ones(kr.size, dtype=bool)
    first[1:] = kr[1:] != kr[:-1]
    best_key = np.zeros(N, dtype=np.int64)
    best_cnt = np.zeros(N, dtype=np.int64)
    fidx0 = np.flatnonzero(first)
    # bwa-like tie handling: among equally-supported placements pick one
    # pseudo-randomly per read (hash of the read id).  A stable first-wins
    # choice sends EVERY ambiguous read to the same copy of a repeat,
    # leaving the other copy with zero coverage; hashing splits them.
    blk = np.cumsum(first) - 1
    tied = km == km[fidx0][blk]
    ntied = np.add.reduceat(tied.astype(np.int64), fidx0)
    rids0 = kr[fidx0]
    h = (rids0.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         ) >> np.uint64(33)
    pick = fidx0 + (h % ntied.astype(np.uint64)).astype(np.int64)
    best_key[rids0] = ks[pick]
    best_cnt[rids0] = km[pick]
    # second best: first (= highest-merged) entry for the read whose bin
    # is not adjacent to the winner or is on the other strand
    second = np.zeros(N, dtype=np.int64)
    fidx = np.flatnonzero(first)
    bk_e = best_key[kr]
    qual = (np.abs(ks - bk_e) > 1) | ((ks >> 33) != (bk_e >> 33))
    pos = np.where(qual, np.arange(kr.size), kr.size)
    first_q = np.minimum.reduceat(pos, fidx)
    hasq = first_q < kr.size
    second[kr[fidx[hasq]]] = km[first_q[hasq]]
    # mean diag over the winning (and adjacent) bins
    hit_best = (key == best_key[hr]) | (key == best_key[hr] - 1) | (
        key == best_key[hr] + 1
    )
    # adjacent keys must share read+strand bits
    hit_best &= (key >> 33) == (best_key[hr] >> 33)
    sums = np.zeros(N, dtype=np.int64)
    cnts = np.zeros(N, dtype=np.int64)
    np.add.at(sums, hr[hit_best], diag[hit_best])
    np.add.at(cnts, hr[hit_best], 1)
    out[:, 0] = sums // np.maximum(cnts, 1)
    out[:, 1] = (best_key >> 33) & 1
    out[:, 2] = best_cnt
    out[:, 3] = second
    return out


def map_short_batch(idx: GenomeIndex, seqs: list, names: list | None = None,
                    quals: list | None = None, paired: bool = False,
                    band: int = 32, min_score: int = 30,
                    batch_size: int = 8192, seed_subsample: int = 1,
                    rescue_window: int = 1000, device=None):
    """Map reads; returns a list of BAM-style record dicts (sorted later).

    seqs: list of bytes (read sequences).  With paired=True, consecutive
    reads are mates (interleaved -p convention).  Seeding hashes every
    query k-mer by default (bwa-level sensitivity); seed_subsample > 1
    trades sensitivity for speed.  Unplaced mates of confidently-placed
    reads get a banded-alignment rescue in the expected insert window
    (bwa mem's mem_matesw role, util/bwa/bwamem_pair.c)."""
    n = len(seqs)
    codes_fwd = [seq_codes(s) for s in seqs]
    R0 = max((len(s) for s in seqs), default=0)
    mat = np.full((n, R0), 4, dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int64)
    for i, cseq in enumerate(codes_fwd):
        mat[i, : cseq.size] = cseq
        lens[i] = cseq.size
    votes = seed_votes_batch(idx, mat, lens, subsample=seed_subsample)
    placements = [tuple(votes[i]) for i in range(n)]
    if paired:
        placements = _pair_disambiguate(placements, idx, codes_fwd)

    records = [None] * n
    # batch the extensions
    todo = [i for i in range(n) if placements[i][2] > 0]
    R = max((len(s) for s in seqs), default=0)
    W = R + band
    for lo in range(0, len(todo), batch_size):
        sub = todo[lo : lo + batch_size]
        Bt = len(sub)
        q = np.full((Bt, R), 4, dtype=np.uint8)
        t = np.full((Bt, W), 4, dtype=np.uint8)
        qlen = np.zeros(Bt, dtype=np.int32)
        tlen = np.full(Bt, W, dtype=np.int32)
        tstart = np.zeros(Bt, dtype=np.int64)
        for b, i in enumerate(sub):
            d, s, _, _ = placements[i]
            c = codes_fwd[i] if s == 0 else _revcomp_codes(codes_fwd[i])
            q[b, : c.size] = c
            qlen[b] = c.size
            ts = d - band // 2
            tstart[b] = ts
            # clamp the window to the placed contig: reads hanging off a
            # contig edge align clipped at the boundary (bwa keeps them;
            # dropping them left a coverage hole at every contig edge)
            mid = min(max(d + c.size // 2, 0), idx.codes.size - 1)
            cid, _ = idx.global_to_contig(np.int64(mid))
            cid = int(cid)
            g0 = int(idx.starts[cid])
            g1 = g0 + int(idx.lengths[cid])
            lo_c = max(ts, g0)
            hi_c = min(ts + W, g1)
            if hi_c > lo_c:
                t[b, lo_c - ts : hi_c - ts] = idx.codes[lo_c:hi_c]
        # bwa mem's soft-clip penalties (opt->pen_clip5/3 = 5,
        # util/bwa/bwamem.c): prefer running through end errors over
        # clipping them unless clipping wins by > 5
        ops, score, i_lo, j_lo, i_hi, j_hi, _ = band_align_ops(
            q, t, qlen, tlen, clip5=5, clip3=5, device=device)
        tid_b, pos_b = idx.global_to_contig(tstart + j_lo)
        tid2_b, _ = idx.global_to_contig(tstart + j_hi)
        # gapless fast path: rows whose op stream is pure M need no
        # run-length pass (the overwhelmingly common case for short reads)
        gapless = ~np.any((ops > 1), axis=1)
        for b, i in enumerate(sub):
            if score[b] < min_score:
                continue
            d, s, v1, v2 = placements[i]
            # reject if the window crossed a contig boundary
            if tid_b[b] != tid2_b[b] or pos_b[b] < 0:
                continue
            il, ih, ql = int(i_lo[b]), int(i_hi[b]), int(qlen[b])
            if gapless[b]:
                cig = []
                if il > 0:
                    cig.append((il << 4) | _SOFT)
                cig.append(((ih - il + 1) << 4) | 0)
                if ql - 1 - ih > 0:
                    cig.append(((ql - 1 - ih) << 4) | _SOFT)
                cig = np.array(cig, dtype=np.uint32)
            else:
                cig = runs_to_cigar(ops[b], il, ih, ql)
                # canonical indel placement in repeats (same rationale
                # as the long-read mapper; see longread.left_align_runs)
                cig = left_align_cigar(cig, q[b], idx.codes, il,
                                       int(tstart[b] + j_lo[b]))
            mapq = _mapq(v1, v2, int(score[b]), ql)
            records[i] = dict(
                ref_id=int(tid_b[b]),
                pos=int(pos_b[b]),
                strand=s,
                mapq=mapq,
                cigar=cig,
                score=int(score[b]),
            )
    if paired:
        _mate_rescue(records, idx, codes_fwd, min_score, rescue_window,
                     batch_size, device)
    return _finalize(records, idx, seqs, names, quals, paired)


def _mate_rescue(records, idx: GenomeIndex, codes_fwd, min_score: int,
                 window: int, batch_size: int, device=None):
    """Place unmapped mates of confidently-mapped reads by banded
    alignment inside the expected insert window (FR orientation)."""
    n = len(records)
    todo = []
    for i in range(n):
        if records[i] is not None:
            continue
        mate = i + 1 if i % 2 == 0 else i - 1
        if not (0 <= mate < n):
            continue
        m = records[mate]
        if m is None or m["mapq"] < 20:
            continue
        todo.append((i, m))
    if not todo:
        return
    R = max(codes_fwd[i].size for i, _ in todo)
    W = window + 2 * R
    for lo in range(0, len(todo), batch_size):
        sub = todo[lo : lo + batch_size]
        Bt = len(sub)
        q = np.full((Bt, R), 4, dtype=np.uint8)
        t = np.full((Bt, W), 4, dtype=np.uint8)
        qlen = np.zeros(Bt, dtype=np.int32)
        tlen = np.full(Bt, W, dtype=np.int32)
        tstart = np.zeros(Bt, dtype=np.int64)
        strands = np.zeros(Bt, dtype=np.uint8)
        for b, (i, m) in enumerate(sub):
            mstart = idx.contig_to_global(m["ref_id"], m["pos"])
            if m["strand"] == 0:
                # mate forward: rescued read lies downstream, reversed
                ts = mstart
                strands[b] = 1
            else:
                ts = mstart + codes_fwd[i ^ 1].size - W
                strands[b] = 0
            c = (codes_fwd[i] if strands[b] == 0
                 else _revcomp_codes(codes_fwd[i]))
            q[b, : c.size] = c
            qlen[b] = c.size
            tstart[b] = ts
            # clamp to the mate's contig (edge reads align clipped)
            g0 = int(idx.starts[m["ref_id"]])
            g1 = g0 + int(idx.lengths[m["ref_id"]])
            lo_c, hi_c = max(ts, g0), min(ts + W, g1)
            if hi_c > lo_c:
                t[b, lo_c - ts : hi_c - ts] = idx.codes[lo_c:hi_c]
        ops, score, i_lo, j_lo, i_hi, j_hi, _ = band_align_ops(
            q, t, qlen, tlen, clip5=5, clip3=5, device=device)
        tid_b, pos_b = idx.global_to_contig(tstart + j_lo)
        tid2_b, _ = idx.global_to_contig(tstart + j_hi)
        for b, (i, m) in enumerate(sub):
            if score[b] < min_score or tid_b[b] != m["ref_id"] \
                    or tid_b[b] != tid2_b[b] or pos_b[b] < 0:
                continue
            il, ih, ql = int(i_lo[b]), int(i_hi[b]), int(qlen[b])
            cig = runs_to_cigar(ops[b], il, ih, ql)
            cig = left_align_cigar(cig, q[b], idx.codes, il,
                                   int(tstart[b] + j_lo[b]))
            records[i] = dict(
                ref_id=int(tid_b[b]), pos=int(pos_b[b]),
                strand=int(strands[b]),
                mapq=min(int(m["mapq"]), 40),  # mate-evidence placement
                cigar=cig, score=int(score[b]),
            )


def _mapq(v1: int, v2: int, score: int, qlen: int) -> int:
    """bwa-flavored mapq: margin between best and second seed cluster.
    A uniquely placed read keeps mapq 60 even with a few base errors
    (bwa behavior — the engines' vote weights and mapq-60 caps depend on
    it, lib/kmercount.c:199,227,286); identity only demotes clearly
    erroneous alignments."""
    if v1 <= 0:
        return 0
    frac = 1.0 - (v2 / v1)
    q = 60.0 * frac
    ident = max(min(score / max(qlen, 1), 1.0), 0.0)
    if ident < 0.8:
        q *= ident
    return max(0, min(int(q + 0.499), 60))


def _finalize(records, idx, seqs, names, quals, paired):
    """Fill flags/mate/tlen and build BAM record dicts."""
    n = len(seqs)
    out = []
    for i in range(n):
        rec = records[i]
        name = names[i] if names else f"read{i}"
        if paired:
            mate = i + 1 if i % 2 == 0 else i - 1
            mrec = records[mate] if 0 <= mate < n else None
            name = name.rsplit("/", 1)[0]
        else:
            mrec = None
        flag = 0
        if paired:
            flag |= bamio.FPAIRED | (bamio.FREAD1 if i % 2 == 0 else bamio.FREAD2)
        codes = seq_codes(seqs[i])
        if rec is None:
            flag |= bamio.FUNMAP
            out.append(dict(name=name, flag=flag, tid=-1, pos=-1, mapq=0,
                            cigar=np.empty(0, np.uint32),
                            seq_nib=NIB_OF_CODE[codes],
                            qual=_qual(quals, i, codes.size),
                            mtid=-1, mpos=-1, tlen=0))
            continue
        if rec["strand"]:
            flag |= bamio.FREVERSE
            codes = _revcomp_codes(codes)
            qual = _qual(quals, i, codes.size)[::-1].copy()
        else:
            qual = _qual(quals, i, codes.size)
        mtid, mpos, tlen = -1, -1, 0
        if paired:
            if mrec is None:
                flag |= bamio.FMUNMAP
            else:
                mtid, mpos = mrec["ref_id"], mrec["pos"]
                if mrec["strand"]:
                    flag |= bamio.FMREVERSE
                if mtid == rec["ref_id"] and mrec["strand"] != rec["strand"]:
                    span_l = min(rec["pos"], mpos)
                    ref_len = int(
                        ((rec["cigar"] >> 4)
                         * bamio.CONSUMES_R[rec["cigar"] & 0xF]).sum()
                    )
                    mref_len = int(
                        ((mrec["cigar"] >> 4)
                         * bamio.CONSUMES_R[mrec["cigar"] & 0xF]).sum()
                    )
                    span_r = max(rec["pos"] + ref_len, mpos + mref_len)
                    t = span_r - span_l
                    if t < 2000:
                        flag |= bamio.FPROPER
                        tlen = t if rec["pos"] <= mpos else -t
        out.append(dict(name=name, flag=flag, tid=rec["ref_id"],
                        pos=rec["pos"], mapq=rec["mapq"], cigar=rec["cigar"],
                        seq_nib=NIB_OF_CODE[codes], qual=qual,
                        mtid=mtid, mpos=mpos, tlen=tlen,
                        tags=rec.get("tags", b"")))
    return out


def _qual(quals, i, n):
    if quals and quals[i] is not None:
        q = np.frombuffer(quals[i], dtype=np.uint8)
        if q.size == n:
            return (q - 33).astype(np.uint8)
    return np.full(n, 30, np.uint8)


def records_to_batch(records, idx: GenomeIndex) -> AlnBatch:
    """Sort records by (tid, pos) and materialize an AlnBatch (the in-memory
    analog of `samtools sort` + read_bam)."""
    header = BamHeader("", list(idx.names), [int(x) for x in idx.lengths])
    mapped = sorted(
        (r for r in records if r["tid"] >= 0),
        key=lambda r: (r["tid"], r["pos"]),
    )
    n = len(mapped)
    tid = np.array([r["tid"] for r in mapped], dtype=np.int32)
    pos = np.array([r["pos"] for r in mapped], dtype=np.int32)
    mapq = np.array([r["mapq"] for r in mapped], dtype=np.uint8)
    flag = np.array([r["flag"] for r in mapped], dtype=np.uint16)
    tlen = np.array([r["tlen"] for r in mapped], dtype=np.int32)
    lqseq = np.array([len(r["seq_nib"]) for r in mapped], dtype=np.int32)
    cigar = (np.concatenate([r["cigar"] for r in mapped])
             if n else np.empty(0, np.uint32))
    cigar_len = np.array([len(r["cigar"]) for r in mapped], dtype=np.int32)
    cigar_off = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(cigar_len[:-1], out=cigar_off[1:])
    seq = (np.concatenate([r["seq_nib"] for r in mapped])
           if n else np.empty(0, np.uint8))
    seq_off = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(lqseq[:-1].astype(np.int64), out=seq_off[1:])
    qual = (np.concatenate([r["qual"] for r in mapped])
            if n else np.empty(0, np.uint8))
    batch = AlnBatch(
        header=header, tid=tid, pos=pos, mapq=mapq, flag=flag, tlen=tlen,
        lqseq=lqseq, cigar=cigar, cigar_off=cigar_off, cigar_len=cigar_len,
        seq=seq, seq_off=seq_off, qual=qual, qual_off=seq_off.copy(),
        names=[r["name"] for r in mapped],
        mtid=np.array([r["mtid"] for r in mapped], dtype=np.int32),
        mpos=np.array([r["mpos"] for r in mapped], dtype=np.int32),
    )
    if any(r.get("tags") for r in mapped):
        tags_len = np.array([len(r.get("tags", b"")) for r in mapped],
                            dtype=np.int32)
        tags_off = np.zeros(n, dtype=np.int64)
        np.cumsum(tags_len[:-1].astype(np.int64), out=tags_off[1:])
        batch.tags = np.frombuffer(
            b"".join(bytes(r.get("tags", b"")) for r in mapped), dtype=np.uint8
        )
        batch.tags_off = tags_off
        batch.tags_len = tags_len
    return batch
