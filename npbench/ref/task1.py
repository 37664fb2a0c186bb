"""Plain reference of task 1 (`worker1 -t 1`, NextPolish's score_chain,
lib/scorechain.c:3-15) for the benchmark's check of the polished bytes.

One contig at a time, from the draft and the read records that the
benchmark's generator made (npbench/simgen.py), never from anything the
program wrote:

  read filter (contig_read_fliter1: every primary mapped read)
  -> insertion slots over the cell chain (contig_create_insert)
  -> the 3-mer pileup of the reads and of the contig read as a read, with
     each cell's first-observation order (contig_parse_read)
  -> the chain DP over the dense [cells, 512] pileup in plain PyTorch ops
     (the (max,+) scan as an associative scan, the pointers, the
     traceback as a scan over the reversed relations)
  -> FLAG_ZERO / FLAG_COVERAGE and the FASTA emission with flagged bases
     lowercased (contig_get_contig).

A frozen copy of the port's plain path as of commit 6e13449: the numpy
pileup of nextpolish_tpu_torch/ops/pileup.py (`build_cell_index`'s
numpy branch, `expand_reads`, `ref_stream`, `event_ranks`), the dense
chain DP of ops/chain.py (`emission`, `build_transition`, `pointers`,
`chain_correct_batch` with `forward_states_plain` and
`traceback_batch_plain`), and the flags and emission of
models/contig_state.py and models/score_chain.py (`_apply_choice`).  The
program runs the native slot walker, a packed planes buffer and the
CUDA scan kernels instead; none of that is here.  It imports numpy and
torch only.

`dtype` sets the precision of the DP's scores: float32 as the
configuration states, or a lower one for the control
(npbench/control.py), which has to come out as not correct.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

S = 8
K3 = S * S * S
PAD, A, C, DEL, G, T, N, OTHER = range(8)
NIB_TO_SYM = np.array([PAD, A, C, DEL, G, OTHER, OTHER, OTHER, T, OTHER,
                       OTHER, OTHER, OTHER, OTHER, OTHER, N], dtype=np.uint8)
SYM_TO_ASCII = np.frombuffer(b"=ACMGTNN", dtype=np.uint8).copy()
ASCII_TO_NIB = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    ASCII_TO_NIB[_c] = _i
    ASCII_TO_NIB[_c + 32] = _i

CMATCH, CINS, CDEL, CSOFT_CLIP, CHARD_CLIP = 0, 1, 2, 4, 5
CONSUMES_R = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                      dtype=np.int64)
_QCON = np.zeros(16, dtype=np.int64)
_QCON[[CMATCH, CINS, CSOFT_CLIP, CHARD_CLIP]] = 1
_RCON = np.zeros(16, dtype=np.int64)
_RCON[[CMATCH, CDEL]] = 1

FLAG_ZERO, FLAG_COVERAGE = 1, 2
NEG = -1e9
CHUNK = 128
RANK_BIG = 1 << 20
RANK_NONE = 0xFFFF
TRIM_LEN_EDGE = 2           # worker1's -trim_len_edge default
INDEL_BALANCE_SGS = 0.5     # -indel_balance_factor_sgs
MIN_COUNT_RATIO_SKIP = 0.8  # -min_count_ratio_skip


@dataclass
class Reads:
    """One contig's alignment records as flat columns."""

    pos: np.ndarray
    flag: np.ndarray
    lqseq: np.ndarray
    cigar: np.ndarray
    cigar_off: np.ndarray
    cigar_len: np.ndarray
    seq: np.ndarray
    seq_off: np.ndarray

    @classmethod
    def of(cls, records: list) -> "Reads":
        cig = [np.asarray(r["cigar"], dtype=np.uint32) for r in records]
        seq = [np.asarray(r["seq_nib"], dtype=np.uint8) for r in records]
        clen = np.fromiter(map(len, cig), np.int64, len(cig))
        slen = np.fromiter(map(len, seq), np.int64, len(seq))
        return cls(
            pos=np.array([r["pos"] for r in records], dtype=np.int64),
            flag=np.array([r.get("flag", 0) for r in records],
                          dtype=np.int64),
            lqseq=slen,
            cigar=(np.concatenate(cig) if len(cig)
                   else np.zeros(0, np.uint32)),
            cigar_off=np.cumsum(clen) - clen,
            cigar_len=clen,
            seq=np.concatenate(seq) if len(seq) else np.zeros(0, np.uint8),
            seq_off=np.cumsum(slen) - slen)

    def ref_span(self) -> np.ndarray:
        contrib = (self.cigar >> 4).astype(np.int64) * CONSUMES_R[
            self.cigar & 0xF]
        cum = np.concatenate([[0], np.cumsum(contrib)])
        return cum[self.cigar_off + self.cigar_len] - cum[self.cigar_off]


# ---------------------------------------------------------------------------
# the pileup (numpy)
# ---------------------------------------------------------------------------

def _flat_ops(rd: Reads, ridx: np.ndarray):
    """Every CIGAR op of the selected reads with its read, type, length
    and query / reference start."""
    lens = rd.cigar_len[ridx].astype(np.int64)
    n_ops = int(lens.sum())
    op_read = np.repeat(np.arange(len(ridx)), lens)
    seg0 = np.cumsum(lens) - lens
    idx = np.repeat(rd.cigar_off[ridx] - seg0, lens) + np.arange(n_ops)
    words = rd.cigar[idx]
    op_type = (words & 0xF).astype(np.int64)
    op_len = (words >> 4).astype(np.int64)

    def excl_cumsum(x):
        c = np.cumsum(x) - x
        return c - np.repeat(c[seg0[lens > 0]], lens[lens > 0])

    qs = excl_cumsum(op_len * _QCON[op_type])
    rs = excl_cumsum(op_len * _RCON[op_type]) + rd.pos[ridx][op_read]
    return op_read, op_type, op_len, qs, rs


def _read_trims(rd: Reads, ridx, op_read, op_type, op_len, rs):
    """qstart / qend per read: the trimmed edges, extended over
    homopolymers, and shifted past insertions at position 0
    (contig_cut_read)."""
    n = len(ridx)
    first = rd.cigar[rd.cigar_off[ridx]]
    last = rd.cigar[rd.cigar_off[ridx] + np.maximum(rd.cigar_len[ridx], 1)
                    - 1]
    lsoft = np.where((first & 0xF) == CSOFT_CLIP, first >> 4, 0)
    rsoft = np.where((last & 0xF) == CSOFT_CLIP, last >> 4, 0)
    qstart = TRIM_LEN_EDGE + lsoft.astype(np.int64)
    qend = rd.lqseq[ridx] - TRIM_LEN_EDGE - rsoft.astype(np.int64) - 1
    for r in range(n):
        o, ln = rd.seq_off[ridx[r]], rd.lqseq[ridx[r]]
        seq = rd.seq[o:o + ln]
        a = qstart[r]
        while 0 < a < ln and seq[a] == seq[a - 1]:
            a += 1
        qstart[r] = a
        b = qend[r]
        while 0 <= b < ln - 1 and seq[b] == seq[b + 1]:
            b -= 1
        qend[r] = b
    at0 = (op_type == CINS) & (rs == 0)
    if at0.any():
        qstart = qstart + np.bincount(op_read[at0], weights=op_len[at0],
                                      minlength=n).astype(np.int64)
    return qstart, qend


def cell_index(rd: Reads, ridx: np.ndarray, L: int):
    """ins_len[p], the longest insertion after position p, and cell_of[p],
    the cell of position p on the chain; n_cells, n_dp."""
    ins_len = np.zeros(L, dtype=np.int64)
    if len(ridx):
        _, op_type, op_len, _, rs = _flat_ops(rd, ridx)
        ins = (op_type == CINS) & (rs > 0) & (rs <= L - 1)
        np.maximum.at(ins_len, rs[ins] - 1, op_len[ins])
    cell_of = np.zeros(L, dtype=np.int64)
    if L > 1:
        np.cumsum(1 + ins_len[:-1], out=cell_of[1:])
    return ins_len, cell_of, int(cell_of[-1] + 1 + ins_len[-1]), \
        int(cell_of[-1] + 1)


def expand_reads(rd: Reads, ridx, ins_len, cell_of, L):
    """Each read's emissions over the cell chain, one symbol a cell:
    (cells, symbols, row offsets, row lengths) in read order."""
    end = L - 1
    op_read, op_type, op_len, qs, rs = _flat_ops(rd, ridx)
    qstart, qend = _read_trims(rd, ridx, op_read, op_type, op_len, rs)
    qs_o, qe_o = qstart[op_read], qend[op_read]
    ins_of = np.zeros(L + 1, dtype=np.int64)
    ins_of[:L] = ins_len
    cand_c, cand_q, cand_r = [], [], []

    def runs(sel):
        rep = np.repeat(sel, op_len[sel])
        j = np.arange(len(rep)) - np.repeat(np.cumsum(op_len[sel])
                                            - op_len[sel], op_len[sel])
        return rep, j

    m = np.flatnonzero(op_type == CMATCH)
    if len(m):
        rep, j = runs(m)
        pos, qpos = rs[rep] + j, qs[rep] + j
        g = (pos >= 0) & (pos <= end) & (qpos >= qs_o[rep]) \
            & (qpos <= qe_o[rep])
        cand_c.append(cell_of[pos[g]])
        cand_q.append(qpos[g])
        cand_r.append(op_read[rep[g]])
    d = np.flatnonzero(op_type == CDEL)
    if len(d):
        rep, j = runs(d)
        pos, qpos = rs[rep] + j, qs[rep]
        g = (pos >= 0) & (pos <= end) & (qpos >= qs_o[rep]) \
            & (qpos <= qe_o[rep])
        cand_c.append(cell_of[pos[g]])
        cand_q.append(np.full(int(g.sum()), -1, dtype=np.int64))
        cand_r.append(op_read[rep[g]])
    iops = np.flatnonzero((op_type == CINS) & (rs > 0) & (rs <= end))
    if len(iops):
        rep, j = runs(iops)
        qpos = qs[rep] + j
        anchor = rs[rep] - 1
        g = (qpos >= qs_o[rep]) & (qpos <= qe_o[rep]) & (j < ins_of[anchor])
        cand_c.append(cell_of[anchor[g]] + 1 + j[g])
        cand_q.append(qpos[g])
        cand_r.append(op_read[rep[g]])
        anc = rs[iops] - 1
        padn = np.maximum(ins_of[anc] - op_len[iops], 0)
        qafter = qs[iops] + op_len[iops]
        pg = (qafter > qstart[op_read[iops]]) \
            & (qafter <= qend[op_read[iops]] + 1)
        padn = np.where(pg, padn, 0)
        if padn.sum():
            rep = np.repeat(np.arange(len(iops)), padn)
            j = np.arange(len(rep)) - np.repeat(np.cumsum(padn) - padn,
                                                padn)
            cand_c.append(cell_of[anc[rep]] + 1 + op_len[iops][rep] + j)
            cand_q.append(np.full(len(rep), -1, dtype=np.int64))
            cand_r.append(op_read[iops[rep]])
    cells = np.concatenate(cand_c) if cand_c else np.zeros(0, np.int64)
    qv = np.concatenate(cand_q) if cand_q else np.zeros(0, np.int64)
    rr = np.concatenate(cand_r) if cand_r else np.zeros(0, np.int64)
    nsel = len(ridx)
    c0 = np.full(nsel, np.iinfo(np.int64).max, dtype=np.int64)
    c1 = np.full(nsel, -1, dtype=np.int64)
    np.minimum.at(c0, rr, cells)
    np.maximum.at(c1, rr, cells)
    used = c1 >= 0
    c0 = np.where(used, c0, 0)
    row_len = np.where(used, c1 - c0 + 1, 0)
    row_off = np.concatenate([[0], np.cumsum(row_len)])
    total = int(row_off[-1])
    syms = np.full(total, DEL, dtype=np.uint8)
    hasq = qv >= 0
    if hasq.any():
        r = rr[hasq]
        slot = row_off[r] + (cells[hasq] - c0[r])
        syms[slot] = NIB_TO_SYM[rd.seq[rd.seq_off[ridx][r] + qv[hasq]]]
    rows = np.flatnonzero(used)
    within = np.arange(total) - np.repeat(row_off[rows], row_len[rows])
    out_cells = np.repeat(c0[rows], row_len[rows]) + within
    return out_cells, syms, row_off, row_len


def row_kmers(syms, row_off, row_len) -> np.ndarray:
    """Rolling 3-mers along each read's row, PAD before its first
    symbol."""
    n = len(syms)
    p1 = np.empty(n, dtype=np.uint8)
    p2 = np.empty(n, dtype=np.uint8)
    p1[1:] = syms[:-1]
    p2[2:] = syms[:-2]
    live = row_len > 0
    firsts = row_off[:-1][live]
    p1[firsts] = PAD
    p2[firsts] = PAD
    second = firsts + 1
    ok = second < firsts + row_len[live]
    p2[second[ok]] = PAD
    return p2.astype(np.int64) * (S * S) + p1.astype(np.int64) * S \
        + syms.astype(np.int64)


def event_ranks(cells, kmers, n) -> np.ndarray:
    """Dense [n, 512] first-observation rank of each kmer in its cell,
    from events in observation order; RANK_NONE where unobserved."""
    rank = np.full((n, K3), RANK_NONE, dtype=np.uint16)
    if not len(cells):
        return rank
    uniq, first_idx = np.unique(cells * K3 + kmers, return_index=True)
    ucell = uniq // K3
    order = np.lexsort((first_idx, ucell))
    oc = ucell[order]
    change = np.ones(len(order), dtype=bool)
    change[1:] = oc[1:] != oc[:-1]
    first = np.flatnonzero(change)
    pos_in = np.arange(len(order)) - first[np.cumsum(change) - 1]
    rank.reshape(-1)[uniq[order]] = np.minimum(pos_in, 0xFFFE)
    return rank


def pileup(draft: bytes, rd: Reads):
    """The dense pileup of one contig: counts and ranks [n_dp, 512],
    refkmer and total [n_dp], and the cell index."""
    L = len(draft)
    overlap = (rd.pos + rd.ref_span() > 0) & (rd.pos <= L - 1)
    level1 = (rd.flag & 0xC04) == 0
    ridx_ins = np.flatnonzero(level1 & overlap & (rd.cigar_len > 0))
    ins_len, cell_of, n_cells, n_dp = cell_index(rd, ridx_ins, L)
    ridx = np.flatnonzero(level1 & overlap & (rd.cigar_len > 0)
                          & (rd.lqseq > 0))
    cells, syms, row_off, row_len = expand_reads(rd, ridx, ins_len, cell_of,
                                                 L)
    kmers = row_kmers(syms, row_off, row_len)
    # the contig read as a read: draft bases at position cells, DEL at
    # insertion cells, rolling 3-mers from PAD (contig_as_read)
    ref_sym = np.full(n_cells, DEL, dtype=np.uint8)
    ref_sym[cell_of] = NIB_TO_SYM[ASCII_TO_NIB[np.frombuffer(draft,
                                                             np.uint8)]]
    rs = ref_sym[:n_dp]
    p1 = np.concatenate([[PAD], rs[:-1]]).astype(np.int64)
    p2 = np.concatenate([[PAD, PAD], rs[:-2]])[:n_dp].astype(np.int64)
    refkmer = p2 * (S * S) + p1 * S + rs.astype(np.int64)
    # observation order: the contig first, then the reads in file order
    keep = cells < n_dp
    ocells = np.concatenate([np.arange(n_dp), cells[keep]])
    okmers = np.concatenate([refkmer, kmers[keep]])
    rank = event_ranks(ocells, okmers, n_dp)
    counts = np.zeros((n_dp, K3), dtype=np.int32)
    keys, cnt = np.unique(ocells * K3 + okmers, return_counts=True)
    counts.reshape(-1)[keys] = np.minimum(cnt, 0xFFFF)
    total = np.bincount(cells[keep], minlength=n_dp).astype(np.int64) + 1
    return counts, rank, refkmer, total, (ins_len, cell_of, n_cells, n_dp)


# ---------------------------------------------------------------------------
# the chain DP (plain PyTorch)
# ---------------------------------------------------------------------------

def _eye(device, dtype):
    e = torch.full((S, S), NEG, dtype=dtype, device=device)
    return e.fill_diagonal_(0.0)


def _compose(a, b):
    """(max,+) product over the last two axes."""
    return (a[..., :, :, None] + b[..., None, :, :]).amax(dim=-2)


def _scan(x):
    """Inclusive (max,+) scan over axis -3: pairs, the pairs' scan, then
    each odd result with the next even element."""
    n = x.shape[-3]
    if n < 2:
        return x
    odd = _scan(_compose(x[..., 0:n - 1:2, :, :], x[..., 1::2, :, :]))
    if n % 2 == 0:
        even = _compose(odd[..., :-1, :, :], x[..., 2::2, :, :])
    else:
        even = _compose(odd, x[..., 2::2, :, :])
    even = torch.cat([x[..., :1, :, :], even], dim=-3)
    out = torch.empty_like(x)
    out[..., 0::2, :, :] = even
    out[..., 1::2, :, :] = odd
    return out


def forward_states(A, s0):
    """f [B, L, 8]: the state after each cell, from A [B, L, 8, 8] and
    s0 [B, 8]; 128-cell chunks, each renormalised, scanned, replayed."""
    B, L = A.shape[0], A.shape[1]
    nch = L // CHUNK
    Ach = A.reshape(B, nch, CHUNK, S, S)
    eye = _eye(A.device, A.dtype).expand(B, nch, S, S)
    P = eye
    for t in range(CHUNK):
        P = _compose(P, Ach[:, :, t])
        P = P - P.amax(dim=(-2, -1), keepdim=True)
    Pinc = _scan(P)
    Pexc = torch.cat([eye[:, :1], Pinc[:, :-1]], dim=1)
    st = (s0[:, None, :, None] + Pexc).amax(dim=-2)
    s = st - st.amax(dim=-1, keepdim=True)
    f = torch.empty((B, nch, CHUNK, S), dtype=A.dtype, device=A.device)
    for t in range(CHUNK):
        s = (s[..., :, None] + Ach[:, :, t]).amax(dim=-2)
        f[:, :, t] = s
    return f.reshape(B, L, S)


def traceback(P, b_end, dtype):
    """choice [B, L] int8: the pointers P [B, L, 8] walked back from
    b_end, as a scan over the reversed 0/NEG relation matrices."""
    B, L, _ = P.shape
    dev = P.device
    onehot = torch.nn.functional.one_hot(P.long(), S) > 0
    Mt = torch.where(onehot, torch.tensor(0.0, dtype=dtype, device=dev),
                     torch.tensor(NEG, dtype=dtype, device=dev))
    eye = _eye(dev, dtype).expand(B, 1, S, S)
    Mrev = torch.cat([torch.flip(Mt[:, 1:], dims=[1]), eye], dim=1)
    u = torch.where(torch.arange(S, device=dev)[None, :]
                    == b_end[:, None].long(), 0.0, NEG).to(dtype)
    frev = forward_states(Mrev, u)
    bvals = torch.argmax(frev, dim=2).to(torch.int8)
    return torch.cat([torch.flip(bvals[:, :L - 1], dims=[1]),
                      b_end.to(torch.int8)[:, None]], dim=1)


def chain_choice(counts, rank, refkmer, total, valid, s0, dtype):
    """The chain DP over one padded row: emission, transitions, forward
    scan, pointers, traceback.  counts/rank [1, L, 512] int32,
    refkmer/total [1, L], valid [1, L] bool, s0 [1, 8]."""
    dev = counts.device
    cnt = counts.to(dtype)
    dec = (total > 1).to(dtype)
    adj = cnt.scatter_add(2, refkmer.long()[..., None], -dec[..., None])
    del cnt
    tot1 = torch.where(total > 1, total - 1, total).to(dtype)
    rate = torch.tensor(np.float32(INDEL_BALANCE_SGS)).to(dtype)
    em = torch.where(counts > 0, adj - tot1[..., None] * rate,
                     torch.tensor(NEG, dtype=dtype, device=dev))
    del adj
    B, L = em.shape[:2]
    M = em.reshape(B, L, S, S, S).amax(dim=2)
    M[..., 0] = M.amax(dim=3)
    M = torch.where(valid[..., None, None], M, _eye(dev, dtype))
    f = forward_states(M.contiguous(), s0)
    del M
    fprev = torch.cat([s0[:, None], f[:, :-1]], dim=1)
    del f
    # pointers: the winning kmer per (cell, base), ties to the earliest
    # observed; base_max_score's pick, ties to the earliest inserted
    emr = em.reshape(B, L, S * S, S)
    obsr = emr > NEG * 0.5
    gath = fprev[:, :, torch.arange(S * S, device=dev) % S]
    sc = torch.where(obsr, gath[..., None] + emr,
                     torch.tensor(NEG, dtype=dtype, device=dev))
    del em, emr, gath
    V = sc.amax(dim=2)
    rkr = torch.where(obsr, rank.reshape(B, L, S * S, S), RANK_BIG)
    winner = (sc == V[:, :, None, :]) & obsr
    del sc
    wp = torch.argmin(torch.where(winner, rkr, RANK_BIG), dim=2)
    del winner
    wb2 = (wp % S).to(torch.int32)
    Rm = rkr.amin(dim=2)
    del rkr
    lane_obs = obsr.any(dim=2)
    del obsr
    Vmax = torch.where(lane_obs, V, torch.tensor(NEG, dtype=dtype,
                                                 device=dev)).amax(dim=2)
    cand = (V == Vmax[..., None]) & lane_obs
    msel = torch.argmin(torch.where(cand, Rm, RANK_BIG), dim=2).to(
        torch.int32)
    msel_prev = torch.cat([torch.zeros((B, 1), dtype=torch.int32,
                                       device=dev), msel[:, :-1]], dim=1)
    P = torch.where(wb2 != 0, wb2, msel_prev[..., None])
    P = torch.where(valid[..., None], P,
                    torch.arange(S, dtype=torch.int32, device=dev))
    last = torch.clamp_min(valid.sum(dim=1) - 1, 0)
    b_end = torch.gather(msel, 1, last[:, None])[:, 0]
    return traceback(P.contiguous(), b_end, dtype)


def _padded(n: int) -> int:
    """n rounded up to a power-of-two number of 128-cell chunks."""
    nch = max(-(-n // CHUNK), 1)
    return (1 << (nch - 1).bit_length()) * CHUNK


def polish_contig(draft: bytes, records: list, device="cpu",
                  dtype=torch.float32) -> bytes:
    """The polished sequence of one contig from its draft and its read
    records (the generator's dicts, in file order)."""
    counts, rank, refkmer, total, (ins_len, cell_of, n_cells, n_dp) = \
        pileup(draft, Reads.of(records))
    L = _padded(n_dp)
    dev = torch.device(device)
    s0 = torch.full((1, S), NEG, dtype=dtype)
    s0[0, 0] = 0.0
    s0[0, np.flatnonzero(counts[0].reshape(S, S, S).sum(axis=(0, 2)))] = 0.0

    def pad(a, fill, dt):
        t = torch.full((1, L) + a.shape[1:], fill, dtype=dt, device=dev)
        t[0, :n_dp] = torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
        return t

    valid = torch.zeros((1, L), dtype=torch.bool)
    valid[0, :n_dp] = True
    with torch.no_grad():
        choice = chain_choice(
            pad(counts, 0, torch.int32),
            pad(rank.astype(np.int32), RANK_NONE, torch.int32),
            pad(refkmer, 0, torch.int32), pad(total, 0, torch.int32),
            valid.to(dev), s0.to(dev), dtype)
    choice = choice[0, :n_dp].cpu().numpy().astype(np.int64)
    # flags: no real coverage (the contig alone), or the chosen base's
    # support under min_count_ratio_skip of the cell's total
    cov = counts.reshape(n_dp, S * S, S)[np.arange(n_dp), :, choice].sum(
        axis=1)
    del counts, rank
    flag = np.where(total == 1, FLAG_ZERO, 0) | np.where(
        cov < MIN_COUNT_RATIO_SKIP * np.maximum(total, 1), FLAG_COVERAGE, 0)
    # emission: deleted cells dropped, flagged bases lowercased, and a
    # flagged deleted cell lowercases the next emitted base
    emit = choice != DEL
    flagged = flag != 0
    pos = np.flatnonzero(emit)
    if not len(pos):
        return b""
    cum = np.cumsum((~emit) & flagged)
    prev = np.concatenate([[0], cum[pos[:-1]]])
    lower = flagged[pos] | ((cum[pos] - prev) > 0)
    chars = SYM_TO_ASCII[choice[pos]]
    return np.where(lower, chars + 32, chars).astype(np.uint8).tobytes()
