"""Structural-variant layer of the consensus engine (SURVEY component #17).

Exact ports from lib/ctg_cns.c of:
  SA-tag parsing + split-read indel candidates  set_satags :2158,
                                                check_indel :2463
  random-read depth track                       cal_rreads_w :3225,
                                                update_ref_d{,s} :3315,
                                                cal_ref_d{,_ave} :3276
  low-depth regions                             update_ld_regs :2696
  round-2 ref-qv hints                          set_ref_qv :2233,
                                                cal_ref_ide :3269,
                                                update_ld_regs_with_refqv :2753
  gap clustering                                update_gap_cluster :2552,
                                                cal_gap_cluster_median :2509
  supplementary realignment                     update_align_tags :2839
  cluster candidate extraction                  generate_gapseqs :2898
  contig split points                           update_split_p :2999

The layer activates per window when the contig is longer than
INS_MIN_CHECK_LEN (100 kb) and enough reads / split reads exist
(ctg_cns_core :3449,:3559).  Split-read gap candidates additionally let
clipped reads bypass the clip-ratio filter for contigs of any size.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# constants (lib/ctg_cns.h:29-40, lib/ctg_cns.c:2458-2460)
INS_MIN_CHECK_LEN = 100_000
INS_RADOM_COUNT = 50_000
INS_RADOM_LEN = 15_000_000
INS_WIN_STEP = 10
INS_WIN_DIV = 20
INS_MIN_DEPTH_RATIO = 0.1
INS_MIN_DEPTH_RATIO_REFQV = 0.3
INS_WIN_MIN_SIZE = 500
INS_CLUSTER_SIZE = 1000
CLUSTER_MIN_DEPTH_RATIO = 0.2
TEM_CLIP_RATIO = 0.1
MAX_GAP_LEN = 30_000
LQSEQ_MAX_CAN_COUNT = 60


# ---------------------------------------------------------------------------
# BAM aux / SA tags
# ---------------------------------------------------------------------------

_AUX_SIZE = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
             ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}


def find_sa_tag(tags: bytes) -> str | None:
    """Walk raw BAM aux data for SA:Z (bam_aux_get role)."""
    i = 0
    n = len(tags)
    while i + 3 <= n:
        key = tags[i : i + 2]
        typ = tags[i + 2]
        i += 3
        if typ == ord("Z") or typ == ord("H"):
            j = tags.find(b"\x00", i)
            if j < 0:
                return None
            if key == b"SA":
                return tags[i:j].decode()
            i = j + 1
        elif typ == ord("B"):
            if i + 5 > n:
                return None
            sub = tags[i]
            cnt = int.from_bytes(tags[i + 1 : i + 5], "little")
            i += 5 + _AUX_SIZE.get(sub, 1) * cnt
        else:
            i += _AUX_SIZE.get(typ, 1)
    return None


def parse_sa(sa: str):
    """SA:Z entries -> [(rname, pos0, strand, cigar_str)]."""
    out = []
    for ent in sa.split(";"):
        if not ent:
            continue
        f = ent.split(",")
        if len(f) < 4:
            continue
        out.append((f[0], int(f[1]) - 1, 0 if f[2] == "+" else 1, f[3]))
    return out


def cigarstr2ul(c: str, end: int) -> int:
    """Leading/trailing clip length of a cigar string (:2368)."""
    import re

    ops = re.findall(r"(\d+)([MIDNSHP=X])", c)
    if not ops:
        return 0
    ln, op = ops[-1] if end else ops[0]
    return int(ln) if op in "SH" else 0


def cigarstr2rlen(c: str) -> int:
    """Reference span of a cigar string (:2388)."""
    import re

    return sum(int(ln) for ln, op in re.findall(r"(\d+)([MIDNSHP=X])", c)
               if op in "MDN=X")


@dataclass
class GapCand:
    """The per-read best split candidate (the C `gap g`)."""

    score: int = 0
    gap_s: int = 0
    gap_e: int = 0
    fs: int = 0  # chosen supplementary's ref start
    ds: int = 0  # chosen supplementary's read start


def check_indel(g: GapCand, rlen: int, rfp1, rdp1, rfp2, rdp2):
    """Split-read indel candidate (:2463).  rfp/rdp = (s, e) tuples."""
    l = 0
    mclen = rlen * TEM_CLIP_RATIO
    if rfp1[0] > rfp2[0]:
        l = 1
        rfp1, rfp2 = rfp2, rfp1
        rdp1, rdp2 = rdp2, rdp1
    if (rfp2[1] > rfp1[1] and rdp2[1] > rdp1[1]
            and rdp1[0] < mclen and rdp2[1] > rlen - mclen
            and abs(rfp2[0] - rfp1[1]) < MAX_GAP_LEN
            and abs(rdp2[0] - rdp1[1]) < MAX_GAP_LEN
            and rfp1[0] != rfp2[0]):
        score = (rdp1[0] + rlen - rdp2[1] + abs(rfp2[0] - rfp1[1])
                 + abs(rdp2[0] - rdp1[1]))
        if score < g.score or not g.score:
            g.score = score
            g.ds = rdp1[0] if l else rdp2[0]
            g.fs = rfp1[0] if l else rfp2[0]
            if rfp1[1] < rfp2[0]:
                g.gap_s = rfp1[1]
                g.gap_e = rfp2[0]
            else:
                g.gap_s = rfp2[0]
                g.gap_e = rfp1[1]


def read_gap_candidate(batch, r: int, contig_name: str) -> GapCand:
    """SA-tag walk for one read (ctg_cns_core :3487-3508)."""
    g = GapCand()
    tags = batch.rec_tags(r)
    if not tags:
        return g
    sa = find_sa_tag(tags)
    if sa is None:
        return g
    cig = batch.rec_cigar(r)
    l_qseq = int(batch.lqseq[r])
    if l_qseq == 0:
        ops, lens = cig & 0xF, cig >> 4
        l_qseq = int(lens[np.isin(ops, (0, 1, 4, 5, 7, 8))].sum())

    def clip(end):
        if not len(cig):
            return 0
        c = cig[-1] if end else cig[0]
        return int(c >> 4) if (c & 0xF) in (4, 5) else 0

    rfp1 = (int(batch.pos[r]), int(_endpos(batch, r)))
    rdp1 = (clip(0), l_qseq - clip(1))
    strand = 1 if batch.flag[r] & 16 else 0
    for rname, pos0, sstrand, cstr in parse_sa(sa):
        if rname == contig_name and sstrand == strand:
            rfp2 = (pos0, pos0 + cigarstr2rlen(cstr))
            rdp2 = (cigarstr2ul(cstr, 0), l_qseq - cigarstr2ul(cstr, 1))
            check_indel(g, l_qseq, rfp1, rdp1, rfp2, rdp2)
    return g


def _endpos(batch, r: int) -> int:
    cig = batch.rec_cigar(r)
    ops, lens = cig & 0xF, cig >> 4
    return int(batch.pos[r]) + int(lens[np.isin(ops, (0, 2, 3, 7, 8))].sum())


# ---------------------------------------------------------------------------
# depth track
# ---------------------------------------------------------------------------

def cal_rreads_w(lens: np.ndarray) -> int:
    """Median read span / 20, min 500 (:3225)."""
    k = len(lens) // 2
    pivot = int(np.partition(lens, k)[k])
    w = (pivot + 1) // INS_WIN_DIV
    return w if w > INS_WIN_MIN_SIZE else INS_WIN_MIN_SIZE


def cal_ref_d_ave(r: np.ndarray, l: int, clip: int) -> int:
    """Iterative trimmed depth mean (:3290)."""
    j, t, h = 1, 150, 0
    while j and t // j > h // 3:
        h = t // j * 3
        sel = r[clip : l - clip : 10]
        m = (sel > 0) & (sel < h)
        t = int(sel[m].sum())
        j = int(m.sum())
    return t // j if j else 0


def cal_ref_d(r: np.ndarray, l: int) -> int:
    """Median depth over the track (:3298)."""
    ignore5 = 10000 if l > 20000 else (100 if l > 200 else 20)
    ignore3 = 0
    while not r[ignore5]:
        ignore5 += 1
    ignore5 += 1
    while not r[l - 1 - ignore3]:
        ignore3 += 1
    ignore3 += 1
    t = r[ignore5 : l - ignore3].astype(np.int64)
    j = len(t)
    if not j:
        return 0
    e = int((t < 4).sum())
    if l > 50000 and e / j > 0.2:
        return cal_ref_d_ave(r, l, ignore5)
    return int(np.partition(t, j // 2)[j // 2])


class DepthTrack:
    """rreads sample + per-window binned depth (ctg_cns_core state)."""

    def __init__(self, max_len: int):
        self.rreads: list[tuple[int, int]] = []
        self.rreads_w = 0
        self.ref_d = 0
        self._cap = max_len // INS_WIN_STEP + 200_000
        self.ref_ds = np.zeros(self._cap, dtype=np.int32)

    def reset_window(self, win_len: int):
        self.ref_ds[: win_len // INS_WIN_STEP + 1] = 0

    def add_read(self, rf_s: int, rf_e: int, win_s: int):
        if not self.rreads_w:
            self.rreads.append((rf_s, rf_e))
            if len(self.rreads) >= INS_RADOM_COUNT:
                self._init_w(win_s)
        else:
            self._update(rf_s, rf_e, win_s)

    def add_reads(self, rf_s: np.ndarray, rf_e: np.ndarray, win_s: int):
        """add_read over each (rf_s[i], rf_e[i]) in order: the first reads
        fill the sample until it holds INS_RADOM_COUNT, which sets
        rreads_w; the rest go to the binned depth."""
        rf_s = np.asarray(rf_s, dtype=np.int64)
        rf_e = np.asarray(rf_e, dtype=np.int64)
        n = 0
        if not self.rreads_w:
            n = min(len(rf_s), INS_RADOM_COUNT - len(self.rreads))
            self.rreads += zip(rf_s[:n].tolist(), rf_e[:n].tolist())
            if len(self.rreads) < INS_RADOM_COUNT:
                return
            self._init_w(win_s)
        self._update_many(rf_s[n:], rf_e[n:], win_s)

    def _init_w(self, win_s: int):
        se = np.array(self.rreads, dtype=np.int64).reshape(-1, 2)
        self.rreads_w = cal_rreads_w(se[:, 1] - se[:, 0])
        self._update_many(se[:, 0], se[:, 1], win_s)

    def _update_many(self, rf_s: np.ndarray, rf_e: np.ndarray, win_s: int):
        """_update over every read, as one difference array."""
        w = self.rreads_w
        s_ = np.where(rf_s > win_s, rf_s - win_s, 0)
        e_ = rf_e - win_s
        long_ = e_ - s_ + 1 >= w * 3
        lo = (s_[long_] + w) // INS_WIN_STEP
        hi = np.minimum((e_[long_] - 2 * w) // INS_WIN_STEP + 1, self._cap)
        ok = lo < hi  # _update's e_ >= s_, and a slice the cap leaves
        if not ok.any():
            return
        d = (np.bincount(lo[ok], minlength=self._cap + 1)
             - np.bincount(hi[ok], minlength=self._cap + 1))
        self.ref_ds += np.cumsum(d[:self._cap]).astype(np.int32)

    def finish_reads(self, win_s: int):
        if not self.rreads_w and self.rreads:
            self._init_w(win_s)

    def _update(self, rf_s: int, rf_e: int, win_s: int):
        w = self.rreads_w
        s_ = rf_s - win_s if rf_s > win_s else 0
        e_ = rf_e - win_s
        if e_ - s_ + 1 >= w * 3:
            s_ = (s_ + w) // INS_WIN_STEP
            e_ = (e_ - 2 * w) // INS_WIN_STEP
            if e_ >= s_:
                self.ref_ds[s_ : min(e_ + 1, self._cap)] += 1


# ---------------------------------------------------------------------------
# low-depth regions
# ---------------------------------------------------------------------------

def _find_low_depth_edge(r, s, l, d, lable):
    md = int(d * INS_MIN_DEPTH_RATIO * 2)
    if lable:
        while s > 1 and r[s] <= md:
            s -= 1
    else:
        while s < l and r[s] <= md:
            s += 1
    return s


def update_ld_regs(r: np.ndarray, l: int, w: int, d: int) -> list[list[int]]:
    """Low-depth [s, e] regions in window-local coords (:2696)."""
    regs: list[list[int]] = []
    init_data = 0
    md = d * INS_MIN_DEPTH_RATIO
    i = 0
    while i < l:
        if r[i] <= md:
            if not init_data:
                t = _find_low_depth_edge(r, i, l, d, 1)
                s0 = t * INS_WIN_STEP if t > 1 else 0
                t = _find_low_depth_edge(r, i, l, d, 0)
                e0 = (t - 1) * INS_WIN_STEP + w
                regs.append([s0, e0])
                i = t
                init_data = 1
            else:
                t = _find_low_depth_edge(r, i, l, d, 1)
                t0 = t * INS_WIN_STEP
                if t0 > regs[-1][1] + INS_WIN_DIV // 2 * w:
                    regs.append([t0, 0])
                t = _find_low_depth_edge(r, i, l, d, 0)
                regs[-1][1] = (t - 1) * INS_WIN_STEP + w
                i = t
            if regs[-1][0] > regs[-1][1]:
                regs[-1][0], regs[-1][1] = regs[-1][1], regs[-1][0]
        i += 1
    return regs


# ---------------------------------------------------------------------------
# round-2 ref-qv hints (FASTA header comments `node:<n> ... qv:<hex:...>`)
# ---------------------------------------------------------------------------

def parse_ref_qv(desc: str | None):
    """set_ref_qv (:2233): -> [(p, ide, ort, irt)] or []."""
    if not desc:
        return []
    qv_l = 0
    qv = None
    for token in desc.split(" "):
        if token.startswith("node"):
            try:
                qv_l = int(token[7:])
            except ValueError:
                qv_l = 0
        if token.startswith("qv"):
            qv = token[5:]
    if not (qv_l and qv):
        return []
    out = []
    for token in qv.split(":"):
        if not token:
            continue
        t = int(token, 16)
        out.append((t >> 32, (t >> 20) & 0x3FF, (t >> 10) & 0x3FF,
                    t & 0x3FF))
    return out


def cal_ref_ide(qv) -> int:
    if not qv:
        return 0
    t = np.array([q[1] for q in qv], dtype=np.int64)
    return int(np.partition(t, len(t) // 2)[len(t) // 2])


def update_ld_regs_with_refqv(regs, r, qv, w, s_t, e_t, d_t, ide_t, ort_t,
                              irt_t):
    """Append low-qv hint regions and merge (:2753)."""
    t = 0
    for p, ide, ort, irt in qv:
        if p >= e_t:
            break
        if p < s_t:
            continue
        if ide < ide_t and ort < ort_t and irt < irt_t:
            s = (p - w * 2 - s_t) // INS_WIN_STEP if p > w * 2 + s_t else 0
            e = ((p + w * 2 - s_t) // INS_WIN_STEP if p + w * 2 < e_t
                 else (e_t - s_t) // INS_WIN_STEP)
            if np.any(r[s : e + 1] <= d_t):
                t += 1
                regs.append([p - s_t, p + 1 - s_t])
    if t:
        regs.sort(key=lambda x: (x[0], x[1]))
        for i in range(1, len(regs)):
            if regs[i][0] < regs[i - 1][1] + INS_WIN_DIV // 2 * w:
                regs[i][0] = regs[i - 1][0]
                if regs[i][1] < regs[i - 1][1]:
                    regs[i][1] = regs[i - 1][1]
                regs[i - 1][0] = regs[i - 1][1] = 0
    return regs


# ---------------------------------------------------------------------------
# gap clustering
# ---------------------------------------------------------------------------

@dataclass
class GapInfo:
    """A stored split-read gap (the C gap_)."""

    gap_s: int
    gap_e: int
    p_id: int  # primary row id in the window tag rows
    p_s: int  # primary aln_q_s (after shift)
    s_id: int  # supplementary fs; becomes its row id after realignment
    s_s: int  # supplementary ds; becomes its aln_q_s after realignment
    l: int
    dseq: np.ndarray  # read sequence nibbles (full read)


@dataclass
class GapCluster:
    gaps: list = field(default_factory=list)
    median: int = 0
    r_s: int = 0
    r_e: int = 0

    @property
    def i_m(self):
        return len(self.gaps)


def cal_gap_cluster_median(clu: GapCluster):
    """Robust cluster median (:2509)."""
    gaps = clu.gaps
    n = len(gaps)
    medians = [(g.gap_s + g.gap_e) // 2 for g in gaps]
    offset = 10
    while offset <= 100:
        clu.median = 0
        count_m = 0
        count_mc = 0
        count_m_diff = 0
        for i in range(n):
            median = medians[i]
            if median == clu.median:
                continue
            s = median - offset if median > offset else 0
            e = median + offset
            count_t = 0
            count_t_diff = 0
            j = i - 1
            while j >= 0:
                if medians[j] >= s:
                    count_t += 1
                    count_t_diff += abs(medians[j] - median)
                else:
                    break
                j -= 1
            j = i + 1
            while j < n:
                if medians[j] <= e:
                    count_t += 1
                    count_t_diff += abs(medians[j] - median)
                else:
                    break
                j += 1
            if count_t > count_m or (count_t == count_m
                                     and count_m_diff > count_t_diff):
                count_m = count_t
                count_mc = median
                count_m_diff = count_t_diff
        if count_m >= max(3, n // 6):
            clu.median = count_mc
            break
        offset += 10
    if offset > 100:
        clu.median = (gaps[n // 2].gap_s + gaps[n // 2].gap_e) // 2


def update_gap_cluster(gaps: list[GapInfo], ref_ds: np.ndarray, w: int,
                       d: int, ref_s: int) -> list[GapCluster]:
    """Cluster split-read gaps over low-depth spots (:2552)."""
    if d < 10:
        return []
    md = int(d * CLUSTER_MIN_DEPTH_RATIO)
    gaps.sort(key=lambda g: (g.gap_s, g.gap_e))
    clusters: list[GapCluster] = []
    n = len(gaps)
    i = 0
    while i < n - md:
        p = (gaps[i].gap_s + gaps[i].gap_e) // 2 - ref_s
        if p < w or ref_ds[p // INS_WIN_STEP] >= d // 2:
            i += 1
            continue
        e = gaps[i].gap_e
        clu = GapCluster()
        t = 1
        j = i + 1
        while j < n and gaps[j].gap_s <= e:
            pj = (gaps[j].gap_s + gaps[j].gap_e) // 2 - ref_s
            if ref_ds[pj // INS_WIN_STEP] >= d // 2:
                j += 1
                continue
            t += 1
            if gaps[j].gap_e > e:
                e = gaps[j].gap_e
            if len(clu.gaps) < LQSEQ_MAX_CAN_COUNT << 1:
                clu.gaps.append(gaps[j])
            j += 1
        i = j - 1
        if len(clu.gaps) > md and ref_ds[p // INS_WIN_STEP] < t:
            clusters.append(clu)
        i += 1
    for clu in clusters:
        clu.gaps.sort(key=lambda g: g.gap_s + g.gap_e)
        cal_gap_cluster_median(clu)
    return clusters


def cal_valid_gap(clu: GapCluster) -> int:
    return sum(1 for g in clu.gaps if g.l)


# ---------------------------------------------------------------------------
# split points
# ---------------------------------------------------------------------------

def update_split_p(split_ps: list[list[int]], clusters: list[GapCluster],
                   ld_regs: list[list[int]], s: int, l: int, ref_qv):
    """Contig split-point selection (:2999)."""
    ENDING_FLANK = 1000
    j = 0
    for reg in ld_regs:
        if reg[0] < ENDING_FLANK or reg[1] + ENDING_FLANK > l:
            continue
        j = j - 1 if j > 1 else 0
        split = 1
        while j < len(clusters) and split:
            clu = clusters[j]
            if clu.r_s > reg[1]:
                break
            if ((reg[0] <= clu.r_s <= reg[1])
                    or (reg[0] <= clu.r_e <= reg[1])
                    or (clu.r_s <= reg[0] <= clu.r_e)
                    or (clu.r_s <= reg[1] <= clu.r_e)):
                split = 0
            j += 1
        if split:
            if not split_ps or reg[0] + s > split_ps[-1][1] + 10000:
                split_ps.append([reg[0] + s, reg[1] + s])
            else:
                split_ps[-1][1] = reg[1] + s
    for reg in split_ps:
        sco = 0
        p = 0
        for qi, (qp, ide, ort, irt) in enumerate(ref_qv):
            if qp > reg[1]:
                break
            if qp >= reg[0]:
                if sco == 0 or ide + ort + irt < sco:
                    sco = ide + ort + irt
                    p = qi
        if sco and sco < 2900:
            reg[0] = reg[1] = ref_qv[p][0]
    return split_ps


# ---------------------------------------------------------------------------
# supplementary realignment + cluster candidate extraction
# ---------------------------------------------------------------------------

NIB_TO_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8).copy()


@dataclass
class SupAln:
    fs: int
    ds: int
    cigar: np.ndarray


def find_sup_aln(sup_alns: list[SupAln], fs: int, ds: int) -> SupAln:
    for a in sup_alns:
        if a.fs == fs and a.ds == ds:
            return a
    raise AssertionError("supplementary alignment not found")


def realign_cluster_sups(clusters, sup_alns, accum, ref_cns, ref_s, ref_e,
                         add_row):
    """update_align_tags (:2839): realign each cluster's supplementary
    segments into the window MSA as extra rows.  `add_row(tpos, qbase,
    is_ins, qidx, clip_needed)` performs trim+track+append and returns
    (row_id, aln_q_s) or None when filtered."""
    from .tags import NIB_TO_CNS

    for clu in clusters:
        lqseq_count = 0
        offset = 20
        while (lqseq_count < LQSEQ_MAX_CAN_COUNT
               and lqseq_count < clu.i_m * 0.8 and offset < 300):
            s = clu.median - offset if clu.median > offset else 0
            e = clu.median + offset
            for g in clu.gaps:
                if g.l:
                    continue
                median = (g.gap_s + g.gap_e) // 2
                if median < s or median > e:
                    continue
                sup = find_sup_aln(sup_alns, g.s_id, g.s_s)
                res = add_row(sup.fs, sup.cigar, g.dseq)
                if res is None:
                    continue
                row_id, q_s = res
                g.l = offset // 20
                g.s_id = row_id
                g.s_s = q_s
                lqseq_count += 1
            offset += 20


def generate_gapseqs(clusters, accum, win_s: int):
    """generate_gapseqs (:2898): choose each cluster's reference range and
    per-gap read-coordinate candidate spans.  accum provides per-row
    (t, d, q) arrays (window-local t) plus aln_t_s/aln_t_e."""
    for clu in clusters:
        offset = 10
        lqseq_rmcount = 0
        clu.r_s = clu.r_e = 0
        while True:
            lqseq_pcount = lqseq_count = 0
            while (offset < 30000
                   and lqseq_pcount < clu.i_m - lqseq_rmcount
                   and (lqseq_count >= lqseq_pcount
                        or lqseq_pcount < clu.i_m // 2)):
                s = clu.median - offset - win_s if clu.median > offset else 0
                e = clu.median + offset - win_s
                lqseq_pcount = lqseq_count
                lqseq_rmcount = lqseq_count = 0
                for g in clu.gaps:
                    if not g.l:
                        lqseq_rmcount += 1
                        continue
                    f_s, f_e = accum.row_span(g.p_id)
                    l_s, l_e = accum.row_span(g.s_id)
                    if f_s > l_s:
                        g.p_id, g.s_id = g.s_id, g.p_id
                        g.p_s, g.s_s = g.s_s, g.p_s
                        f_s, f_e, l_s, l_e = l_s, l_e, f_s, f_e
                    if (f_s < s and f_e > s and l_s < e and l_e > e
                            and s < l_s and e > f_e):
                        lqseq_count += 1
                if lqseq_count > lqseq_pcount:
                    clu.r_s = s
                    clu.r_e = e
                offset += 10
            offset_step = 1 << 62
            lqseq_count = 0
            for g in clu.gaps:
                if not g.l:
                    continue
                f_s, f_e = accum.row_span(g.p_id)
                l_s, l_e = accum.row_span(g.s_id)
                if (f_s > clu.r_s or f_e < clu.r_s or l_s > clu.r_e
                        or l_e < clu.r_e):
                    g.l = 1
                    continue
                t, d, q = accum.row(g.p_id)
                hit = np.searchsorted(t, clu.r_s, side="left")
                if hit < len(t) and t[hit] == clu.r_s:
                    nq = int((q[: hit + 1] != 4).sum())
                else:
                    nq = int((q != 4).sum())
                g.gap_s = g.p_s - 1 + nq
                t, d, q = accum.row(g.s_id)
                hit = np.searchsorted(t, clu.r_e + 1, side="left")
                if hit < len(t) and t[hit] == clu.r_e + 1:
                    nq = int((q[:hit] != 4).sum())
                else:
                    nq = int((q != 4).sum())
                g.gap_e = g.s_s + nq
                if g.gap_e > g.gap_s + 10:
                    lqseq_count += 1
                    g.l = 2
                else:
                    g.l = 1
                if abs(g.gap_s - g.gap_e) < offset_step:
                    offset_step = abs(g.gap_s - g.gap_e)
            if lqseq_count >= lqseq_pcount // 2 or lqseq_count >= 10:
                break
            offset += offset_step // 2 + 20

    for i, clu in enumerate(clusters):
        if not clu.i_m:
            continue
        if (i < len(clusters) - 1
                and clu.r_e + 500 >= clusters[i + 1].r_s):
            if cal_valid_gap(clusters[i + 1]) > cal_valid_gap(clu):
                clu.gaps = []
                continue
            clusters[i + 1].gaps = []


def cluster_candidate_seqs(clu: GapCluster, limit: int):
    """generate_lqseqs_from_cluster (:592): decode l==2 gap spans from the
    stored read nibbles; returns (seqs, max_len)."""
    seqs = []
    max_len = 0
    for g in clu.gaps:
        if len(seqs) >= limit:
            break
        if g.l != 2:
            continue
        nib = g.dseq[g.gap_s : g.gap_e]
        seq = NIB_TO_ASCII[nib].tobytes()
        seqs.append(seq)
        if len(seq) > max_len:
            max_len = len(seq)
    return seqs, max_len
