"""Read kind `long_sv`: long reads over a haploid genome whose draft has
structural errors, written as minimap2 -ax map-ont writes them (without
-Y): a read that spans a structural error, and a chimeric read, is a
primary record plus supplementary ones, with reciprocal SA tags.

Per block, from one numpy `default_rng(seed)` in this order: every
chromosome's segment lengths (`sv.segment_len`), the truth tail that the
misjoin moves; then per chromosome its truth (random bases, the
contig's length less its segments), the draft (simgen's substitutions,
then its single-base indels), the segments' truth positions, and the
segments' bases; then per chromosome its reads.

- Segments: `sv.segments` draft-only segments a chromosome (expanded
  repeats the truth lacks), inserted before truth positions in the
  chromosome's head, apart from each other, from its ends and from the
  misjoin by the longest read and 1 kb: no read spans two of them.
- The misjoin: the chromosomes swap their truth tails of one length
  (contig k is chromosome k's head, then chromosome k+1's tail; a block
  of one contig is its chromosome rotated), so each contig joins two
  truth pieces that do not adjoin.
- Reads: at the configuration's depth, lengths and error rates as
  simgen.simulate_case draws them (a read over a segment or over the
  misjoin's truth adjacency spans it); `sv.chimera_frac` of them
  chimeras of two random truth pieces, each on a strand of its own and
  spanning no segment or misjoin.

A read's piece is aligned to its chromosome's draft by composing its
alignment against the truth with the truth-to-draft edit map
(simgen._compose, as `long` does), then cut where it crosses a segment
(its long deletion is dropped) or the misjoin.  Each part is trimmed to
its first and last matched base; a part of fewer than `sv.min_part`
query bases is left unaligned (soft-clipped).  The part with the most
query bases is the primary record: its SEQ is the whole read and its
clips are soft.  The others are supplementary (flag 0x800): hard clips,
SEQ only their aligned bases.  Every record has MAPQ 60 and an NM tag;
a read of several parts carries SA:Z on each record, listing its other
parts (the primary first) as minimap2 writes them:
`contig,pos,strand,<clip>S<n>M<n>I|D<clip>S,mapq,NM;`.

No two supplementary records of one contig share their position and
leading clip: NextPolish finds a split read's supplementary by that pair
(lib/ctg_cns.c, find_sup_aln), and where two share it the port, as the
JAX package and the reference, reads one read's CIGAR over another's
bases (an IndexError where the other's part is longer).  A read whose
supplementary would repeat one is drawn and then dropped.

Records are sorted by (tid, pos).  The record dicts hold what
npbench/bamwrite.py writes and a BAM reader returns: flag, CIGAR (H
kept), stored SEQ and the raw tag bytes.
"""
from __future__ import annotations

import struct

import numpy as np

from npbench import bamwrite, simgen

OP_M, OP_I, OP_D, OP_S, OP_H = 0, 1, 2, 4, 5
MAPQ = 60
_COMP = np.zeros(256, dtype=np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def _rc(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def _int_tag(key: bytes, v: int) -> bytes:
    """An integer aux field in the smallest unsigned type, as samtools
    stores minimap2's `NM:i` (a part's NM, under its length, fits 16
    bits)."""
    return key + (b"C" + struct.pack("<B", v) if v <= 0xFF
                  else b"S" + struct.pack("<H", v))


def _rle(ops: np.ndarray) -> np.ndarray:
    """BAM CIGAR words of a run of per-column ops."""
    cut = np.concatenate([[0], np.flatnonzero(np.diff(ops)) + 1])
    lens = np.diff(np.concatenate([cut, [len(ops)]]))
    return (lens.astype(np.uint32) << 4) | ops[cut].astype(np.uint32)


class _Chrom:
    """One truth chromosome, its draft and where the draft's bases lie
    in the block's contigs."""

    def __init__(self, rng, n: int, segs: np.ndarray, tail: int,
                 config: dict, spacing: int):
        self.truth = rng.choice(simgen.BASES, n)
        draft = simgen._mutate(rng, self.truth, config["draft_sub"])
        draft, dmap = simgen.draft_indels(rng, draft,
                                          config.get("draft_ins", 0.0),
                                          config.get("draft_del", 0.0))
        self.misjoin = n - tail  # the truth adjacency the draft breaks
        k = len(segs)
        lo, hi = spacing, self.misjoin - spacing
        room = hi - lo - (k - 1) * spacing
        if room < 0:
            raise ValueError(f"a truth of {n} bases holds no {k} segments "
                             f"{spacing} bases apart")
        at = lo + np.sort(rng.integers(0, room + 1, k)) \
            + spacing * np.arange(k)
        self.junctions = np.sort(np.append(at, self.misjoin))
        dins = dmap.dins.copy()
        for j, s in sorted(zip(at.tolist(), segs.tolist()), reverse=True):
            p = int(dmap.dend[j])
            draft = np.concatenate([draft[:p], rng.choice(simgen.BASES, s),
                                    draft[p:]])
            dins[j] += s
        dend = np.concatenate([[0], np.cumsum(dins + dmap.keep)])
        self.dmap = simgen.DraftMap(dmap.keep, dins, dend[:-1] + dins, dend)
        self.draft = draft
        self.cut = int(dend[self.misjoin])  # head draft[:cut], tail after
        self.place = None  # ((tid, offset) of the head, of the tail)

    def locate(self, x: int) -> tuple:
        """(tid, position) of draft base x in the block's contigs."""
        tid, off = self.place[x >= self.cut]
        return tid, x + off

    def crosses(self, s: int, ln: int) -> bool:
        """Whether truth [s, s + ln) spans a segment or the misjoin."""
        j = self.junctions
        return bool(((j > s) & (j < s + ln)).any())


def _layout(chroms: list) -> list:
    """The contigs' drafts: contig k is chromosome k's head then
    chromosome k+1's tail (one chromosome: its tail, then its head);
    sets each chromosome's `place`."""
    n = len(chroms)
    if n == 1:
        (c,) = chroms
        c.place = ((0, len(c.draft) - c.cut), (0, -c.cut))
        return [np.concatenate([c.draft[c.cut:], c.draft[:c.cut]])]
    for k, c in enumerate(chroms):
        c.place = ((k, 0), ((k - 1) % n, chroms[k - 1].cut - c.cut))
    return [np.concatenate([c.draft[:c.cut], nxt.draft[nxt.cut:]])
            for c, nxt in zip(chroms, chroms[1:] + chroms[:1])]


def _parts(chrom: _Chrom, seq, is_del, is_ins, s: int, seg_min: int):
    """A read piece's alignment against its chromosome's draft, cut at
    segments and the misjoin: [(draft x, core CIGAR, query start, query
    end (in seq), NM)], each part from its first to its last M."""
    dm = chrom.dmap
    (cig,), shift = simgen._compose(is_del[None], is_ins[None],
                                    dm.keep[None, s:s + len(is_del)],
                                    dm.dins[None, s:s + len(is_del)])
    ops, lens = (cig & 0xF).astype(np.int64), (cig >> 4).astype(np.int64)
    lead = int(lens[0]) if ops[0] == OP_S else 0
    core = ops != OP_S
    ops, lens = ops[core], lens[core]
    col = np.repeat(ops, lens)
    rc, qc = col != OP_I, col != OP_D
    x = int(dm.dbefore[s] + shift[0]) + np.cumsum(rc) - rc
    q = lead + np.cumsum(qc) - qc
    seg = np.repeat((ops == OP_D) & (lens >= seg_min), lens)
    label = np.cumsum(np.diff(np.concatenate([[0], seg.astype(np.int8)]))
                      > 0) + (x >= chrom.cut)
    out = []
    for g in np.unique(label[~seg]).tolist():
        idx = np.flatnonzero((label == g) & ~seg)
        m = idx[col[idx] == OP_M]
        if not len(m):
            continue
        idx = idx[(idx >= m[0]) & (idx <= m[-1])]
        c = col[idx]
        nm = int((c != OP_M).sum() + (chrom.draft[x[m]] != seq[q[m]]).sum())
        out.append((int(x[m[0]]), _rle(c), int(q[m[0]]), int(q[m[-1]]) + 1,
                    nm))
    return out


def _sa_entry(name: str, pos: int, rev: bool, u: int, v: int, rlen: int,
              span: int, nm: int) -> str:
    """One SA:Z entry as minimap2 writes it (format.c, the SA tag): the
    clips soft, the aligned part as one M and one I or D."""
    lq = v - u
    body = (f"{lq}M{span - lq}D" if lq < span else
            f"{span}M{lq - span}I" if lq > span else f"{lq}M")
    clip = (f"{u}S" if u else "") + body + (f"{rlen - v}S" if rlen - v
                                              else "")
    return f"{name},{pos + 1},{'-' if rev else '+'},{clip},{MAPQ},{nm};"


def _records(name: str, pieces: list, chroms: list, names: list,
             min_part: int, seg_min: int, seen: list) -> list:
    """A read's records.  `pieces`: [(chromosome, truth start, seq,
    is_del, is_ins, reverse)] in the read's order, 5' to 3'; `seen`: the
    (pos, leading clip) of each contig's supplementary records so far."""
    rlen = sum(len(p[2]) for p in pieces)
    fwd = np.concatenate([_rc(p[2]) if p[5] else p[2] for p in pieces])
    parts, off = [], 0
    for c, s, seq, is_del, is_ins, rev in pieces:
        # where the piece's seq sits in the SEQ of a record on its strand
        base = rlen - off - len(seq) if rev else off
        off += len(seq)
        for x, core, u, v, nm in _parts(chroms[c], seq, is_del, is_ins, s,
                                        seg_min):
            if v - u >= min_part:
                tid, pos = chroms[c].locate(x)
                parts.append((tid, pos, core, rev, base + u, base + v, nm))
    if not parts:
        return []
    parts.sort(key=lambda p: p[5] - p[4], reverse=True)
    if any((p[1], p[4]) in seen[p[0]] for p in parts[1:]):
        return []
    span = [int(((p[2] >> 4) * np.isin(p[2] & 0xF, (OP_M, OP_D))).sum())
            for p in parts]
    sa = [_sa_entry(names[p[0]], p[1], p[3], p[4], p[5], rlen, sp, p[6])
          for p, sp in zip(parts, span)]
    out = []
    for k, (tid, pos, core, rev, u, v, nm) in enumerate(parts):
        seq = _rc(fwd) if rev else fwd
        clip = OP_H if k else OP_S
        cig = np.array(([u << 4 | clip] if u else []) + core.tolist()
                       + ([(rlen - v) << 4 | clip] if rlen - v else []),
                       dtype=np.uint32)
        tags = _int_tag(b"NM", nm)
        if len(parts) > 1:
            tags += b"SAZ" + "".join(e for j, e in enumerate(sa)
                                     if j != k).encode() + b"\x00"
        if k:
            seen[tid].add((pos, u))
        out.append(dict(
            name=name, tid=tid, pos=pos, mapq=MAPQ,
            flag=(0x10 if rev else 0) | (0x800 if k else 0), cigar=cig,
            seq_nib=bamwrite.seq_to_nib((seq if not k else seq[u:v])
                                        .tobytes()),
            tags=tags))
    return out


def simulate(seed: int, lens: list, config: dict) -> simgen.SimCase:
    r, sv = config["reads"], config["sv"]
    lo_len, hi_len = r["read_len"]
    sub, ins, dele = r["sub"], r["ins"], r["del"]
    seg_min = sv["segment_len"][0]
    spacing = hi_len + 1000
    rng = np.random.default_rng(seed)
    segs = [rng.integers(sv["segment_len"][0], sv["segment_len"][1] + 1,
                         sv["segments"]) for _ in lens]
    truth_lens = [int(n) - int(s.sum()) for n, s in zip(lens, segs)]
    short = min(truth_lens)
    tail = int(rng.integers(int(0.3 * short), int(0.5 * short) + 1))
    chroms = [_Chrom(rng, n, s, tail, config, spacing)
              for n, s in zip(truth_lens, segs)]
    drafts = _layout(chroms)
    names = [f"ctg{k}" for k in range(len(lens))]
    weights = np.array(truth_lens, dtype=np.float64) / sum(truth_lens)
    seen = [set() for _ in lens]
    records = []

    def draw(c: int, s: int, ln: int):
        seq, _, is_del, is_ins = simgen._read_draws(
            rng, chroms[c].truth, s, ln, sub, ins, dele)
        return (c, s, seq, is_del, is_ins, bool(rng.random() < r["rev_frac"]))

    def free_piece(ln: int):
        """A chimera's piece: a random chromosome and start, spanning no
        segment or misjoin."""
        c = int(rng.choice(len(chroms), p=weights))
        ln = min(ln, truth_lens[c])
        while True:
            s = int(rng.integers(0, truth_lens[c] - ln + 1))
            if not chroms[c].crosses(s, ln):
                return draw(c, s, ln)

    for c, n in enumerate(truth_lens):
        mean_len = min((lo_len + hi_len) / 2, n)
        for k in range(int(round(r["depth"] * n / mean_len))):
            ln = min(int(rng.integers(lo_len, hi_len + 1)), n)
            if rng.random() < sv["chimera_frac"]:
                l1 = int(rng.integers(ln // 5, ln - ln // 5 + 1))
                name, pieces = f"x{c}_{k}", [free_piece(l1),
                                             free_piece(ln - l1)]
            else:
                s = int(rng.integers(0, n - ln + 1))
                name, pieces = f"r{c}_{k}", [draw(c, s, ln)]
            records += _records(name, pieces, chroms, names,
                                sv["min_part"], seg_min, seen)
    records.sort(key=lambda rec: (rec["tid"], rec["pos"]))
    return simgen.SimCase(names, [c.truth.tobytes() for c in chroms],
                          [d.tobytes() for d in drafts], records)
