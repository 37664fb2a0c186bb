"""Low-quality region repair — exact mirror of the reference flow.

This implements, line-faithfully, the post-DP repair pipeline of
lib/ctg_cns.c for the non-fast paths:

  get_l_del_regions (:1562) / get_lqseqs_from_gap (:1630)  — region finding
  generate_lqseqs_from_tags (:822) / _kmer (:636)          — candidates+seed
  count_kmers/count_kscore (:405)                          — 8-mer ranking
  poa_to_consensus (lib/dag.c:658)                         — POA seeding
  align (lib/align.c:39)                                   — Myers O(ND)
  generate_consensus_trimed (:1287) + mini link DP (:999)  — refinement
  iterate_generate_consensus_trimed (:1425)                — 2 iterations
  update_consensus_trimed (:1165)                          — splice

The regions are tiny (tens of bases x <= 60 candidates x a handful of
windows), so this runs as exact host code; the heavy per-window DP stays in
dp.py.  Everything here preserves the C's insertion orders, integer
divisions and tie rules — verified byte-for-byte against the reference
engine by tools/ref_parity2.py.
"""
from __future__ import annotations

import numpy as np

from npbench.ref.cns.dp import Consensus

# --- constants (lib/ctg_cns.h:3-38) ---
LQSEQ_MAX_COUNT = 30
LQSEQ_MAX_REV_LEN = 2000
KMER_RANGE = 40
KMER_MAX_SEQ = 10
KMER_LEN = 8
GAP_FLANK_LEN = 10
GAP_BETWEEN_LEN = 30
GAP_MIN_RATIO2 = 0.1
GAP_MIN_RATIO3 = 0.6
DEL_MIN_LEN = 20
DEL_MIN_DEPTH_RATIO = 0.3
LQSEQ_MIN_LEN = 0
HQSEQ_MIN_LEN = 4
HQ_MIN_QV = 60
LQSEQ_MAX_CAN_COUNT = 60

INT_TO_BASE = b"ATGC-NM"
INT_TO_BASE_ARR = np.frombuffer(INT_TO_BASE, dtype=np.uint8).copy()
# base_to_int (lib/ctg_cns.c:58-67): note lowercase n/m map to 4
BASE_TO_INT = np.full(256, 4, dtype=np.uint8)
for _c, _v in zip(b"ACGMNT", (0, 3, 2, 6, 5, 1)):
    BASE_TO_INT[_c] = _v
for _c, _v in zip(b"acgt", (0, 3, 2, 1)):
    BASE_TO_INT[_c] = _v

GAP_MIN_RATIO1 = {"ont": 0.01, "clr": 0.3, "rs": 0.3, "hifi": 0.3}


class LqSeq:
    __slots__ = ("start", "end", "l", "seqs", "len", "lqcount",
                 "sudoseed", "sudoseed_len", "indexs", "indexe")

    def __init__(self, start, end, l):
        self.start = start
        self.end = end
        self.l = l
        self.seqs = []  # list of [seq(bytes), order(int), kscore(int)]
        self.len = 0
        self.lqcount = 0
        self.sudoseed = b""
        self.sudoseed_len = 0
        self.indexs = 0
        self.indexe = 0


# ---------------------------------------------------------------------------
# region finding
# ---------------------------------------------------------------------------

def _cal_del_pos(coverage, l_del, s, e):
    """l_del > cov*0.6 positions in [s, e] (cal_del_pos :1556)."""
    v = 0
    for i in range(s, e + 1):
        if l_del[i] > coverage[i] * 0.6:
            v += 1
    return v


def get_l_del_regions(coverage, l_ins, l_del, cns: Consensus, read_type):
    """Deletion-pressure regions, ascending (get_l_del_regions :1562)."""
    pos, base, qv = cns.pos, cns.base, cns.qv
    n = len(pos)
    dels = []  # [s, e, l]
    ps = pe = 0
    # vector prefilter of the per-base skip test (exact same predicate)
    posv = pos.astype(np.int64)
    keep = (l_del[pos] >= coverage[pos] * DEL_MIN_DEPTH_RATIO)
    keep[1:] |= posv[1:] >= posv[:-1] + DEL_MIN_LEN
    cand_i = np.flatnonzero(keep)
    cand_i = cand_i[cand_i >= 1]
    for i in cand_i:
        i = int(i)
        if ps <= i <= pe:
            continue
        s = i - 1
        while s > 0 and l_del[pos[s]] > coverage[pos[s]] * DEL_MIN_DEPTH_RATIO:
            s -= 1
        e = i + 1
        while (e < n - 1
               and l_del[pos[e]] > coverage[pos[e]] * DEL_MIN_DEPTH_RATIO):
            e += 1
        if pos[e] - pos[s] < 10:
            continue
        p = _cal_del_pos(coverage, l_del, int(pos[s]), int(pos[e]))
        ll = int(pos[e]) - int(pos[s]) + 1
        if read_type in ("clr", "rs") and p < ll * 0.05:
            continue
        l = 2 if p > ll // 3 else 3
        ps, pe = s, e

        p = 0
        s = i - LQSEQ_MIN_LEN // 2
        while s > 0:
            if (qv[s] >= HQ_MIN_QV and l_del[pos[s]] <
                    coverage[pos[s]] * DEL_MIN_DEPTH_RATIO):
                p += 1
            else:
                p = 0
            if (p >= HQSEQ_MIN_LEN
                    and BASE_TO_INT[base[s]] != BASE_TO_INT[base[s - 1]]
                    and l_ins[pos[s]] <= 0):
                break
            s -= 1
        p = 0
        e = i + LQSEQ_MIN_LEN // 2
        while e < n - 1:
            if (qv[e] >= HQ_MIN_QV and l_del[pos[e]] <
                    coverage[pos[e]] * DEL_MIN_DEPTH_RATIO):
                p += 1
            else:
                p = 0
            if (p >= HQSEQ_MIN_LEN
                    and BASE_TO_INT[base[e]] != BASE_TO_INT[base[e + 1]]
                    and l_ins[pos[e]] <= 0):
                break
            e += 1
        sp = int(pos[s]) if s >= 0 else int(pos[0])
        ep = int(pos[e]) if e < n - 1 else int(pos[n - 1])
        if ep - sp < DEL_MIN_LEN:
            continue
        if not dels or sp > dels[-1][1]:
            dels.append([sp, ep, l])
        else:
            dels[-1][1] = ep
    return dels


def _lqseqs_merge_del(d, lqseqs):
    """get_lqseqs_from_dels (:1539): merge a del region into the
    (descending) lqseqs list; may absorb and truncate lower regions."""
    ds, de, dl = d
    index = len(lqseqs) - 1
    if index >= 0:
        s = min(ds, lqseqs[index].start)
        while index > 0 and lqseqs[index].start <= de and not lqseqs[index].l:
            index -= 1
        if lqseqs[index].start > de:
            index += 1
            if index >= len(lqseqs):
                lqseqs.append(LqSeq(0, 0, 0))
            lqseqs[index].end = 0
        elif lqseqs[index].l:
            del lqseqs[index + 1:]
            return
        lqseqs[index].start = s
        lqseqs[index].end = max(de, lqseqs[index].end)
        lqseqs[index].l = dl
        del lqseqs[index + 1:]
    else:
        lqseqs.append(LqSeq(ds, de, dl))


def _lqseqs_merge_cluster(clu, lqseqs):
    """get_lqseqs_from_cluster (:1518): merge a gap cluster's range into
    the (descending) lqseqs list with l=1."""
    if not clu.i_m:
        return
    index = len(lqseqs) - 1
    if index >= 0:
        while index > 0 and lqseqs[index].start <= clu.r_e:
            index -= 1
        if lqseqs[index].start > clu.r_e:
            index += 1
            if index >= len(lqseqs):
                lqseqs.append(LqSeq(0, 0, 0))
        lqseqs[index].start = clu.r_s
        lqseqs[index].end = clu.r_e
        lqseqs[index].l = 1
        del lqseqs[index + 1:]
    else:
        lqseqs.append(LqSeq(clu.r_s, clu.r_e, 1))


def get_lqseqs_from_gap(coverage, l_ins, l_del, cns: Consensus,
                        read_type, clusters=()) -> list[LqSeq]:
    """LQ regions in build (descending-coordinate) order
    (get_lqseqs_from_gap :1630)."""
    pos, base, qv = cns.pos, cns.base, cns.qv
    n = len(pos)
    lqseqs: list[LqSeq] = []
    if not n:
        return lqseqs
    ratio1 = GAP_MIN_RATIO1[read_type]
    dels = get_l_del_regions(coverage, l_ins, l_del, cns, read_type)
    dels_i = len(dels)
    clusters_i = len(clusters)

    # vector prefilter: the walk only acts where l_ins >= cov * ratio1
    cand_i = np.flatnonzero(l_ins[pos] >= coverage[pos] * ratio1)[::-1]
    for i in cand_i:
        i = int(i)
        pi = pos[i]
        if l_ins[pi] < coverage[pi] * GAP_MIN_RATIO2:
            s = int(pi) - GAP_FLANK_LEN
            e = int(pi) + GAP_FLANK_LEN
            tot = int(l_ins[pi])
            p = i - 1
            while p >= 0 and pos[p] >= s:
                if pos[p] != pos[p + 1]:
                    tot += int(l_ins[pos[p]])
                p -= 1
            p = i + 1
            while p < n and pos[p] <= e:
                if pos[p] != pos[p - 1]:
                    tot += int(l_ins[pos[p]])
                p += 1
            if tot < coverage[pi] * GAP_MIN_RATIO3:
                continue

        p = 0
        s = i - LQSEQ_MIN_LEN // 2
        while s > 0:
            p = p + 1 if qv[s] >= HQ_MIN_QV else 0
            if (p >= HQSEQ_MIN_LEN
                    and BASE_TO_INT[base[s]] != BASE_TO_INT[base[s - 1]]
                    and l_ins[pos[s]] <= 0):
                break
            s -= 1
        p = 0
        e = i + LQSEQ_MIN_LEN // 2
        while e < n - 1:
            p = p + 1 if qv[e] >= HQ_MIN_QV else 0
            if (p >= HQSEQ_MIN_LEN
                    and BASE_TO_INT[base[e]] != BASE_TO_INT[base[e + 1]]
                    and l_ins[pos[e]] <= 0):
                break
            e += 1
        sp = int(pos[s]) if s >= 0 else int(pos[0])
        ep = int(pos[e]) if e < n - 1 else int(pos[n - 1])
        if not lqseqs or ep + GAP_BETWEEN_LEN < lqseqs[-1].start:
            while dels_i and ep < dels[dels_i - 1][0]:
                _lqseqs_merge_del(dels[dels_i - 1], lqseqs)
                dels_i -= 1
            while clusters_i > 0 and ep < clusters[clusters_i - 1].r_s:
                _lqseqs_merge_cluster(clusters[clusters_i - 1], lqseqs)
                clusters_i -= 1
                while clusters_i > 0 and not clusters[clusters_i - 1].i_m:
                    clusters_i -= 1
            lqseqs.append(LqSeq(sp, ep, 0))
        else:
            lqseqs[-1].start = sp
    return lqseqs


# ---------------------------------------------------------------------------
# candidate extraction + seed selection
# ---------------------------------------------------------------------------

def _count_kmers(seqs, n_len, c, from_tail):
    """count_kmers (:405): 8-mer counts over the first (or last) KMER_RANGE
    bases of the first min(n_len, c) candidates."""
    kmers = {}
    for j in range(min(n_len, c)):
        seq = seqs[j][0]
        if len(seq) < KMER_LEN:
            continue
        s = len(seq) - KMER_RANGE if from_tail and len(seq) > KMER_RANGE else 0
        lim = min(len(seq), KMER_RANGE) - KMER_LEN
        kmer = 0
        for k in range(lim):
            if k:
                kmer = ((kmer << 2) | int(BASE_TO_INT[seq[s + k + KMER_LEN - 1]])) & 0xFFFF
            else:
                kmer = 0
                for idx in range(KMER_LEN):
                    kmer = ((kmer << 2) | int(BASE_TO_INT[seq[s + k + idx]])) & 0xFFFF
            kmers[kmer] = kmers.get(kmer, 0) + 1
    return kmers


def _count_kscore(seqs, n_len, kmers, from_tail):
    """count_kscore (:428)."""
    for j in range(n_len):
        seqs[j][2] = 0
        seq = seqs[j][0]
        if len(seq) < KMER_LEN:
            continue
        s = len(seq) - KMER_RANGE if from_tail and len(seq) > KMER_RANGE else 0
        lim = min(len(seq), KMER_RANGE) - KMER_LEN
        kmer = 0
        for k in range(lim):
            if k:
                kmer = ((kmer << 2)
                        | int(BASE_TO_INT[seq[s + k + KMER_LEN - 1]])) & 0xFFFF
            else:
                kmer = 0
                for idx in range(KMER_LEN):
                    kmer = ((kmer << 2)
                            | int(BASE_TO_INT[seq[s + k + idx]])) & 0xFFFF
            seqs[j][2] += kmers.get(kmer, 0)


def _remove_short_lqseq(lq: LqSeq):
    """remove_short_lqseq (:620): trim short outliers from the tail of a
    descending-by-length sort, then restore ascending order."""
    lq.seqs[: lq.len] = sorted(lq.seqs[: lq.len],
                               key=lambda s: -len(s[0]))
    k = lq.len // 4
    while lq.len > k and (
        len(lq.seqs[lq.len - 1][0]) < len(lq.seqs[k][0]) // 2
        or len(lq.seqs[lq.len - 1][0]) * 1.4 < len(lq.seqs[lq.len - 2][0])
    ):
        lq.len -= 1
    if k == lq.len:
        lq.len = 0
    if lq.len > LQSEQ_MAX_COUNT:
        lq.len = LQSEQ_MAX_COUNT
    lq.seqs[: lq.len] = lq.seqs[: lq.len][::-1]


def _seed_select(lq: LqSeq, kmer_variant: bool) -> int:
    """Shared tail of generate_lqseqs_from_tags[_kmer] (:873-963): length
    filters, 8-mer kscore ranking, POA seed.  Returns the region's
    contribution to max_aln_length (0 if the region was dropped)."""
    from npbench.ref.cns.poadag import poa_to_consensus

    seqs = lq.seqs
    # the plain variant reaches here only with len > 4; the kmer variant
    # applies the length trims conditionally (:736 `if (lqseq->len > 4)`)
    if lq.len > 4:
        seqs[: lq.len] = sorted(seqs[: lq.len], key=lambda s: len(s[0]))
        k = lq.len // 2
        while lq.len > k and (
            len(seqs[lq.len - 1][0]) > 2 * len(seqs[k][0])
            or len(seqs[lq.len - 1][0]) >= 1.4 * len(seqs[lq.len - 2][0])
        ):
            lq.len -= 1
        if k == lq.len:
            lq.len = 0
            return 0
        k = lq.len // 2
        if len(seqs[0][0]) < len(seqs[k][0]) // 2:
            seqs[: lq.len] = seqs[: lq.len][::-1]
            while len(seqs[lq.len - 1][0]) < len(seqs[k][0]) // 2:
                lq.len -= 1
            if k == lq.len:
                lq.len = 0
                return 0

    kmers = _count_kmers(seqs, lq.len, LQSEQ_MAX_CAN_COUNT, False)
    _count_kscore(seqs, lq.len, kmers, False)
    kmaxlen = len(seqs[0][0])
    if kmaxlen > 100:
        saved = {s[1]: s[2] for s in seqs[: lq.len]}
        kmers = _count_kmers(seqs, lq.len, LQSEQ_MAX_CAN_COUNT, True)
        _count_kscore(seqs, lq.len, kmers, True)
        for s in seqs[: lq.len]:
            s[2] += saved[s[1]]

    seqs[: lq.len] = sorted(seqs[: lq.len], key=lambda s: -s[2])
    kmaxlen = len(seqs[0][0])
    klast = kmax = seqs[0][2]
    k = 0
    j = 0
    while j < lq.len:
        if (seqs[j][2] * 10 < kmax or j >= LQSEQ_MAX_COUNT
                or seqs[j][2] * 2 < klast):
            break
        klast = seqs[j][2]
        if (j < KMER_MAX_SEQ and seqs[j][2] > kmax * 0.8
                and len(seqs[j][0]) > kmaxlen):
            kmaxlen = len(seqs[j][0])
            k = j
        j += 1

    lq.indexs = 0
    lq.indexe = 5 if (kmaxlen > LQSEQ_MAX_REV_LEN and j > 6) else j - 1
    limit = 1 if kmer_variant else 3
    if (lq.indexe - lq.indexs <= limit
            or (len(seqs[0][0]) > 20000
                and lq.len < LQSEQ_MAX_CAN_COUNT // 3)):
        lq.len = 0
        return 0

    if len(seqs[0][0]) < 3000:
        j0 = lq.indexs
        k = 6 if j0 + 6 < lq.indexe else lq.indexe - j0 + 1
    else:
        j0 = lq.indexs
        k = 2 if j0 + 2 < lq.indexe else lq.indexe - j0 + 1
    if len(seqs[0][0]) < 20000:
        cand = [s[0] for s in seqs[j0 : j0 + k]]
        lq.sudoseed = poa_to_consensus(cand)
    else:
        lq.sudoseed = seqs[0][0]
    lq.sudoseed_len = len(lq.sudoseed)
    return lq.lqcount + lq.sudoseed_len


def generate_lqseqs_from_tags(lqseqs: list[LqSeq], cols, kmer_variant: bool,
                              clusters=()) -> int:
    """Candidate collection + seed construction
    (generate_lqseqs_from_tags :822 / _kmer :636).  cols = the window's
    merged TagColumns (row 0 = reference).  Returns max_aln_length."""
    n_rows = cols.n_rows()
    count = len(lqseqs)
    s = count - 1
    for i in range(1, n_rows):
        t_s = int(cols.aln_t_s[i])
        t_e = int(cols.aln_t_e[i])
        while s >= 0 and (lqseqs[s].start < t_s
                          or lqseqs[s].len >= LQSEQ_MAX_CAN_COUNT):
            s -= 1
        j = s
        while j >= 0 and lqseqs[j].end <= t_e:
            j -= 1
        if j == s:
            continue
        t, d, q = cols.row(i)
        for k in range(s, j, -1):
            lq = lqseqs[k]
            if lq.len >= LQSEQ_MAX_CAN_COUNT:
                continue
            # the C scans from column index start - aln_t_s (insertions
            # only delay t_pos, so t[p0] <= start) until t_pos > end;
            # t is non-decreasing, so this is the [p0, hi) slice
            p0 = lq.start - t_s
            hi = int(np.searchsorted(t, lq.end, side="right"))
            tv = t[p0:hi]
            qv_ = q[p0:hi]
            sel = qv_[(tv >= lq.start) & (qv_ != 4)]
            chars = INT_TO_BASE_ARR[sel]
            index = len(chars)
            if kmer_variant:
                accept = index > 0
            else:
                accept = (lq.l and index) or index > lq.end - lq.start + 1
            if accept:
                seq = chars.tobytes()
                lq.seqs.append([seq, lq.len, 0])
                if index > lq.lqcount:
                    lq.lqcount = index
                lq.len += 1
            else:
                lq.sudoseed_len += 1

    max_aln_length = 0
    clusters_i = len(clusters) - 1
    for lq in lqseqs:
        if lq.l == 1:
            while clusters_i >= 0 and not clusters[clusters_i].i_m:
                clusters_i -= 1
            if clusters_i >= 0:
                _inject_cluster_seqs(lq, clusters[clusters_i])
                clusters_i -= 1
        elif not kmer_variant and lq.l > 1 and lq.len > 4:
            _remove_short_lqseq(lq)
        if kmer_variant:
            if not lq.len:
                continue
            # exact-duplicate majority vote (:707-733)
            sbest = 0
            used = [0] * lq.len
            for j in range(lq.len):
                lq.seqs[j][2] = 1
                if used[j]:
                    continue
                for k in range(j + 1, lq.len):
                    if lq.seqs[j][0] == lq.seqs[k][0]:
                        used[k] = 1
                        lq.seqs[j][2] += 1
                if (lq.seqs[j][2] > lq.seqs[sbest][2]
                        or (lq.seqs[j][2] == lq.seqs[sbest][2]
                            and len(lq.seqs[j][0]) > len(lq.seqs[sbest][0]))):
                    sbest = j
            if ((lq.seqs[sbest][2] > lq.len // 3
                 or len(lq.seqs[sbest][0]) < 10 or lq.len <= 4)
                    and (lq.seqs[sbest][2] != 1
                         or (lq.len != 3 and lq.len != 4))):
                lq.len = -2
                lq.l = 4
                lq.sudoseed = lq.seqs[sbest][0]
                lq.sudoseed_len = len(lq.sudoseed)
                m = lq.lqcount + lq.sudoseed_len
            else:
                m = _seed_select(lq, True)
            if m > max_aln_length:
                max_aln_length = m
        else:
            if lq.len <= 4 or lq.len < lq.sudoseed_len * 0.5:
                lq.len = 0
                continue
            m = _seed_select(lq, False)
            if m > max_aln_length:
                max_aln_length = m
    return max_aln_length


# ---------------------------------------------------------------------------
# Myers O(ND) alignment (lib/align.c:39-177)
# ---------------------------------------------------------------------------

def myers_align(query: bytes, target: bytes):
    """Returns (t_str, q_str, q_consumed, t_consumed) or None when the
    alignment failed (banding ran out or a gap exceeded 250)."""
    q_len, t_len = len(query), len(target)
    max_d = int(0.4 * (q_len + t_len))
    band_factor = 0.1 if q_len + t_len > 5000 else 1.0
    band_size = int(band_factor * (q_len + t_len))
    k_offset = max_d
    V = [0] * (2 * max_d + 2)
    D = []
    min_k = max_k = 0
    best_m = -1
    aligned = False
    d_final = k_final = kk_final = x_final = 0
    d = 0
    while d < max_d and max_k - min_k <= band_size:
        D.append({})
        x = y = 0
        k = min_k
        while k <= max_k:
            kk = -k - 1 if k < 0 else k
            if k == min_k or (k != max_k
                              and V[k - 1 + k_offset] < V[k + 1 + k_offset]):
                x = V[k + 1 + k_offset]
                D[d][kk] = 0
            else:
                x = V[k - 1 + k_offset] + 1
                D[d][kk] = 1
            y = x - k
            while x < q_len and y < t_len and query[x] == target[y]:
                x += 1
                y += 1
            V[k + k_offset] = x
            if x + y > best_m:
                best_m = x + y
            if x >= q_len and y >= t_len:
                aligned = True
                break
            k += 2
        new_min_k = max_k
        new_max_k = min_k
        k2 = min_k
        while k2 < new_min_k:
            if V[k2 + k_offset] * 2 - k2 >= best_m - 150:
                new_min_k = k2
            k2 += 2
        k2 = max_k
        while k2 > new_max_k:
            if V[k2 + k_offset] * 2 - k2 >= best_m - 150:
                new_max_k = k2
            k2 -= 2
        max_k = new_max_k + 1
        min_k = new_min_k - 1
        if aligned:
            d_final, k_final, x_final = d, k, x
            kk_final = -k - 1 if k < 0 else k
            break
        d += 1
    if not aligned:
        return None

    x = x_final - 1
    k = k_final
    kk = kk_final
    d = d_final
    y_cons = x_final - k_final  # t consumed
    q_cons = x_final
    t_out = bytearray()
    q_out = bytearray()
    gap = 0
    while True:
        while x >= 0 and x >= k and query[x] == target[x - k]:
            t_out.append(query[x])
            q_out.append(query[x])
            x -= 1
            gap = 0
        pre_d = d - 1
        if x < 0 and x - k < 0:
            break
        if D[d][kk]:
            pre_k = k - 1
            pre_x = x - 1
        else:
            pre_k = k + 1
            pre_x = x
        pre_y = pre_x - pre_k
        pre_kk = -pre_k - 1 if pre_k < 0 else pre_k
        if pre_x == x and pre_y != x - k:  # advance in y
            if x - k < 0:
                gap = 260
            else:
                q_out.append(ord("-"))
                t_out.append(target[x - k])
        else:  # advance in x
            if x < 0:
                gap = 260
            else:
                q_out.append(query[x])
                t_out.append(ord("-"))
        gap += 1
        if gap > 250:
            return None  # C: aln_pos = 2 -> treated as failed downstream
        d = pre_d
        k = pre_k
        kk = pre_kk
        x = pre_x
    t_out.reverse()
    q_out.reverse()
    if len(t_out) <= 2:
        return None
    return bytes(t_out), bytes(q_out), q_cons, y_cons


# ---------------------------------------------------------------------------
# refinement: linked mini-MSA + mini link DP (:999-1163, :1287-1473)
# ---------------------------------------------------------------------------

INT64_MIN = -(2 ** 63)


def _mini_consensus(rows, read_type):
    """get_align_tags over linked rows + get_lqseqs_from_align_tags
    (:999-1163).  rows = [(t_str, q_str)] bytes; returns the BACKWARD
    consensus string (as the C does, no final reverse)."""
    # tags per row: (t_pos, delta, q_base) with q_base 0..6; coverage track
    tag_rows = []
    max_tpos = -1
    for t_str, q_str in rows:
        t_pos = -1
        delta = 0
        cols = []
        for tc, qc in zip(t_str, q_str):
            b = int(BASE_TO_INT[qc])
            if tc == 0x2D:  # '-'
                delta += 1
            else:
                t_pos += 1
                delta = 0
            cols.append((t_pos, delta, b))
        tag_rows.append(cols)
        if t_pos > max_tpos:
            max_tpos = t_pos
    length = max_tpos + 1
    coverage = [0] * (length + 1)
    for cols in tag_rows:
        for (tp, dl, b) in cols:
            if dl == 0 and b != 6:
                coverage[tp] += 1

    # update_msa with insertion-order link lists
    msa = {}
    order = {}
    for cols in tag_rows:
        pp = ppp = (-1, 0, 0)
        for cur in cols:
            if cur[2] == 6 or pp[2] == 6:
                ppp = pp
                pp = cur
                continue
            cell = msa.get(cur)
            if cell is None:
                cell = msa[cur] = []
            for e in cell:
                if e[0] == pp and e[1] == ppp:
                    e[2] += 1
                    break
            else:
                cell.append([pp, ppp, 1, 0])  # pp, ppp, link, score
            ppp = pp
            pp = cur
    # DP in (p, d, b) order
    coef = 4 if read_type == "hifi" else 2
    keys_by_pos = [[] for _ in range(length)]
    for key in msa:
        keys_by_pos[key[0]].append(key)
    best_idx = {}
    for p in range(length):
        keys_by_pos[p].sort()
        covp = coverage[p]
        for key in keys_by_pos[p]:
            cell = msa[key]
            bi = 0
            p_pp = INT64_MIN
            raiser = INT64_MIN
            b = key[2]
            for mi, m in enumerate(cell):
                if m[0][0] == -1:
                    m[3] = 10 * m[2] - coef * covp
                else:
                    pp_cell = msa[m[0]]
                    for n in pp_cell:
                        if n[0] == m[1]:
                            cand = n[3] + 10 * m[2] - coef * covp
                            if cand > m[3]:
                                m[3] = cand
                                raiser = n[3]
                            if read_type == "hifi":
                                if n[3] > p_pp or (n[3] == p_pp
                                                   and m[0][2] != 4):
                                    bi = mi
                                    p_pp = n[3]
                            else:
                                if (m[2] > cell[bi][2] // 2 and n[3] > p_pp
                                        and (m[0][2] == 4 or m[0][2] == b
                                             or m[1][2] == b
                                             or m[0][2] == m[1][2])):
                                    bi = mi
                                    p_pp = n[3]
                if m[3] > cell[bi][3] or (m[3] == cell[bi][3]
                                          and m[0][2] != 4):
                    bi = mi
                    p_pp = raiser
            best_idx[key] = bi

    # global best = last visited cell (len-1, max delta, b=5): the final N
    last_keys = keys_by_pos[length - 1]
    if not last_keys:
        return b""
    cur = last_keys[-1]
    out = bytearray()
    while True:
        cell = msa.get(cur)
        if cell is None:
            break
        e = cell[best_idx[cur]]
        if cur[2] != 4:
            link = e[2]
            ch = INT_TO_BASE[cur[2]]
            if link * 5 > coverage[cur[0]] or ch == 0x4E:  # 'N'
                out.append(ch)
            else:
                out.append(ch + 32)
        if e[0][0] == -1:
            break
        cur = e[0]
    return bytes(out)  # BACKWARD string, like the C


def _build_linked_rows(lqseqs: list[LqSeq], count):
    """generate_consensus_trimed's row construction (:1319-1412)."""
    rows = []
    for lq in lqseqs:
        lq.lqcount = 0
    for i in range(LQSEQ_MAX_COUNT):
        t_parts = bytearray()
        q_parts = bytearray()
        for j in range(count - 1, -1, -1):
            lq = lqseqs[j]
            if lq.len <= 0:
                continue
            seed = lq.sudoseed
            seed_len = lq.sudoseed_len
            t_parts.append(0x4E)  # 'N'
            q_parts.append(0x4E)
            if i + lq.indexs > lq.indexe:
                query = None
                query_len = seed_len
            else:
                query = lq.seqs[i + lq.indexs][0]
                query_len = len(query)
            if i + lq.indexs > lq.indexe:
                lq.lqcount = 0
            if (i + lq.indexs > lq.indexe
                    or (i and (query_len < seed_len * 0.5
                               or query_len > seed_len * 1.3))):
                if lq.lqcount < lq.indexe - lq.indexs:
                    lq.lqcount += 1
                    t_parts += b"M" * seed_len
                    q_parts += b"M" * seed_len
                else:
                    lq.lqcount += 1
                    _fill_with_lqseq(t_parts, q_parts, seed,
                                     lq.seqs[lq.indexs][0])
            else:
                res = myers_align(query, seed)
                if res is not None:
                    t_str, q_str, q_cons, t_cons = res
                    t_parts += t_str
                    q_parts += q_str
                    # unaligned seed tail
                    while t_cons < seed_len:
                        t_parts.append(seed[t_cons])
                        q_parts.append(0x2D)
                        t_cons += 1
                    # unaligned query tail (max 250)
                    delta = 0
                    while q_cons < query_len and delta < 250:
                        delta += 1
                        q_parts.append(query[q_cons])
                        t_parts.append(0x2D)
                        q_cons += 1
                else:
                    if lq.lqcount < lq.indexe - lq.indexs:
                        lq.lqcount += 1
                        t_parts += b"M" * seed_len
                        q_parts += b"M" * seed_len
                    else:
                        lq.lqcount += 1
                        _fill_with_lqseq(t_parts, q_parts, seed,
                                         lq.seqs[lq.indexs][0])
        t_parts.append(0x4E)
        q_parts.append(0x4E)
        rows.append((bytes(t_parts), bytes(q_parts)))
    return rows


def _fill_with_lqseq(t_parts, q_parts, seed, lqseq):
    """fill_aln_with_lqseq (:1268-1285)."""
    if len(lqseq) > len(seed):
        t_parts += seed + b"-" * (len(lqseq) - len(seed))
        q_parts += lqseq
    else:
        t_parts += seed
        q_parts += lqseq + b"-" * (len(seed) - len(lqseq))


def iterate_refine(lqseqs: list[LqSeq], read_type, iterations=2):
    """iterate_generate_consensus_trimed (:1425-1473): rebuild every
    region's sudoseed from the mini consensus, twice; reject regions whose
    new seed shrank or is mostly low-quality."""
    count = len(lqseqs)
    for _ in range(iterations):
        rows = _build_linked_rows(lqseqs, count)
        cons = _mini_consensus(rows, read_type)
        j = count
        sudoseed = bytearray()
        for k in range(len(cons) - 1, -1, -1):
            ch = cons[k]
            if ch != 0x4E:  # not 'N'
                if ch < 0x61:  # uppercase
                    sudoseed.append(ch)
                else:
                    sudoseed.append(ch - 32)
                    lqseqs[j].lqcount += 1
            else:
                if j != count:
                    lq = lqseqs[j]
                    lq.sudoseed = bytes(sudoseed)
                    lq.sudoseed_len = len(lq.sudoseed)
                    if not lq.l:
                        reject = (lq.sudoseed_len <= lq.end - lq.start + 1
                                  or lq.lqcount > lq.sudoseed_len * 4 // 5)
                    else:
                        reject = lq.sudoseed_len * 1.3 < min(
                            len(s[0]) for s in lq.seqs[: lq.len])
                    if reject:
                        lq.len = -1
                j -= 1
                while j >= 0 and lqseqs[j].len <= 0:
                    j -= 1
                if j < 0:
                    continue
                lqseqs[j].sudoseed_len = 0
                lqseqs[j].lqcount = 0
                sudoseed = bytearray()


def update_consensus_trimed(lqseqs: list[LqSeq], cns: Consensus) -> Consensus:
    """Splice accepted sudoseeds over their regions (:1165-1211).

    Semantics are the C's per-base loop (ONE lq-cursor step per
    consensus base); runs of bases under a stable cursor state are
    copied as numpy slices (searchsorted segment bounds), and only the
    cursor-transition bases replay one at a time — byte-identical to
    the per-base walk, ~50x less python."""
    pos, base, qv = cns.pos, cns.base, cns.qv
    out_pos: list = []
    out_base: list = []
    out_qv: list = []
    lqi = len(lqseqs) - 1
    update = True
    n = len(pos)

    def step_one(i):
        """The original loop body for exactly one base."""
        nonlocal lqi, update
        p = int(pos[i])
        if lqi >= 0 and ((lqseqs[lqi].len <= 0 and lqseqs[lqi].len != -2)
                         or p > lqseqs[lqi].end):
            lqi -= 1
            update = True
        if (lqi >= 0
                and (lqseqs[lqi].len > 0 or lqseqs[lqi].len == -2)
                and lqseqs[lqi].start <= p <= lqseqs[lqi].end):
            if update:
                seed = np.frombuffer(bytes(lqseqs[lqi].sudoseed),
                                     dtype=np.uint8)
                out_pos.append(np.full(len(seed), lqseqs[lqi].start,
                                       np.int32))
                out_base.append(seed)
                out_qv.append(np.zeros(len(seed), np.int32))
                update = False
        else:
            out_pos.append(pos[i:i + 1].astype(np.int32))
            out_base.append(base[i:i + 1].astype(np.uint8))
            out_qv.append(qv[i:i + 1].astype(np.int32))
            update = True

    i = 0
    while i < n:
        if lqi < 0:
            # cursor exhausted: every remaining base copies verbatim
            out_pos.append(pos[i:].astype(np.int32))
            out_base.append(base[i:].astype(np.uint8))
            out_qv.append(qv[i:].astype(np.int32))
            break
        lq = lqseqs[lqi]
        dead = lq.len <= 0 and lq.len != -2
        p = int(pos[i])
        if dead or p > lq.end:
            # cursor transition (decrements at most once per base):
            # replay this single base exactly
            step_one(i)
            i += 1
            continue
        # stable state: top region alive and p <= lq.end.  Bases below
        # lq.start copy; bases inside [start, end] splice the sudoseed
        # once (then emit nothing until the region passes)
        j_end = int(np.searchsorted(pos[i:], lq.end, side="right")) + i
        j_start = min(int(np.searchsorted(pos[i:], lq.start,
                                          side="left")) + i, j_end)
        if j_start > i:
            out_pos.append(pos[i:j_start].astype(np.int32))
            out_base.append(base[i:j_start].astype(np.uint8))
            out_qv.append(qv[i:j_start].astype(np.int32))
            update = True
        if j_start < j_end:
            if update:
                seed = np.frombuffer(bytes(lq.sudoseed), dtype=np.uint8)
                out_pos.append(np.full(len(seed), lq.start, np.int32))
                out_base.append(seed)
                out_qv.append(np.zeros(len(seed), np.int32))
                update = False
        i = j_end
    if not out_pos:
        return Consensus(np.zeros(0, np.int32), np.zeros(0, np.uint8),
                         np.zeros(0, np.int32))
    return Consensus(np.concatenate(out_pos),
                     np.concatenate(out_base),
                     np.concatenate(out_qv))


def _inject_cluster_seqs(lq: LqSeq, clu):
    """generate_lqseqs_from_cluster (:592)."""
    from npbench.ref.cns.structural import cluster_candidate_seqs

    seqs, max_len = cluster_candidate_seqs(
        clu, LQSEQ_MAX_CAN_COUNT - lq.len)
    for seq in seqs:
        lq.seqs.append([seq, lq.len, 0])
        lq.len += 1
    if max_len > lq.lqcount:
        lq.lqcount = max_len
    assert lq.start == clu.r_s


def repair(cns: Consensus, cols, coverage, l_ins, l_del,
           read_type: str, clusters=()) -> Consensus:
    """ONT/CLR/RS repair path (generate_cns_from_best_score :1828-1874)."""
    lqseqs = get_lqseqs_from_gap(coverage, l_ins, l_del, cns, read_type,
                                 clusters)
    if not lqseqs:
        return cns
    generate_lqseqs_from_tags(lqseqs, cols, kmer_variant=False,
                              clusters=clusters)
    iterate_refine(lqseqs, read_type, 2)
    return update_consensus_trimed(lqseqs, cns)


def hifi_lq_regions(cns: Consensus, coverage, clusters=()) -> list[LqSeq]:
    """HIFI LQ detection: qv-run scan in traceback (reverse) order
    (generate_cns_from_best_score_lq :1751-1793), DAG_MIN_QV = 80."""
    n = len(cns.pos)
    rpos = cns.pos[::-1]
    rqv = cns.qv[::-1]
    lq_min_length = 2
    lqseqs: list[LqSeq] = []
    clusters_i = len(clusters)
    lq = 0
    lq_s = -1
    lq_e = -1
    for p in range(n):
        if coverage[rpos[p]] < 4:
            lq = 0
            lq_s = -1
        elif rqv[p] < 80:
            if lq_s == -1:
                lq_s = p
            lq_e = p
            lq = 1
        elif (lq and p - lq_e > 2 * lq_min_length
              and rpos[p] != rpos[p - 1]):
            e_i = p - lq_min_length - 1
            s_i = lq_s - lq_min_length if lq_s > lq_min_length else 1
            if lqseqs and rpos[s_i] >= lqseqs[-1].start:
                lqseqs[-1].start = int(rpos[e_i])
            else:
                while (clusters_i > 0
                       and rpos[s_i] < clusters[clusters_i - 1].r_s):
                    _lqseqs_merge_cluster(clusters[clusters_i - 1], lqseqs)
                    clusters_i -= 1
                    while (clusters_i > 0
                           and not clusters[clusters_i - 1].i_m):
                        clusters_i -= 1
                lqseqs.append(LqSeq(int(rpos[e_i]), int(rpos[s_i]), 4))
            lq = 0
            lq_s = -1
    return lqseqs


def repair_hifi(cns: Consensus, cols, coverage, clusters=()) -> Consensus:
    """HIFI repair path (generate_cns_from_best_score_lq :1727-1826)."""
    lqseqs = hifi_lq_regions(cns, coverage, clusters)
    if not lqseqs:
        return cns
    generate_lqseqs_from_tags(lqseqs, cols, kmer_variant=True,
                              clusters=clusters)
    iterate_refine(lqseqs, "hifi", 2)
    return update_consensus_trimed(lqseqs, cns)
