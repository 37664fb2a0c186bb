"""The benchmark's generator of polishing inputs with alignments known
by construction: long reads (`simulate_case`, error profiles per read
type in `PROFILES`) and paired-end short reads (`simulate_short_case`),
written as a draft FASTA and a sorted, indexed BAM (`write_case`).

A frozen copy of the port's nextpolish_tpu_torch/sim.py (those
functions, as of commit 6e13449), writing through the benchmark's own
BAM writer (npbench/bamwrite.py), so that the inputs do not move when a
later change edits the port; the draft's indels (`draft_indels`,
`_compose`) are the benchmark's own, and without them the output is the
copy's, byte for byte.  Nothing here imports the port.

A random `truth` genome is drawn; the `draft` is the truth with
substitutions and, where asked for (`draft_ins`, `draft_del`; the
frozen copy had substitutions only), single-base insertions and
deletions.  Reads are sampled from the truth with independent
substitution, insertion and deletion rates per truth base; a read's
alignment against the draft is its alignment against the truth composed
with the truth-to-draft edit map (`DraftMap`, `_compose`), so it is
known by construction and no mapper is needed.  Long reads are flagged reverse strand
half the time; short reads come in pairs, the first mate forward and the
second reverse.  Everything is drawn from one numpy `default_rng(seed)`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from npbench import bamwrite as bamio

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4

# long-read error profiles per read type (per truth base: substitution,
# insertion and deletion rates) with their read lengths, as keyword
# arguments of simulate_case and long_reads: ONT as both draw by default;
# HiFi near-exact and long; CLR and RS indel-heavy, as those chemistries
# are
PROFILES = {
    "ont": dict(sub=0.03, ins=0.03, dele=0.03, read_len=(3000, 12000)),
    "hifi": dict(sub=0.002, ins=0.002, dele=0.002, read_len=(10000, 20000)),
    "clr": dict(sub=0.02, ins=0.08, dele=0.04, read_len=(3000, 12000)),
    "rs": dict(sub=0.02, ins=0.08, dele=0.04, read_len=(3000, 12000)),
}


@dataclass
class DraftMap:
    """Where each truth base of one contig lies in its draft: `keep[t]`,
    whether the draft holds truth base t; `dins[t]`, the draft-only
    bases just before it; `dbefore[t]`, the draft bases before truth
    base t's slot (its draft position where it is kept); `dend[t]`, the
    draft bases before truth base t's draft-only insertions (t = 0..n)."""

    keep: np.ndarray
    dins: np.ndarray
    dbefore: np.ndarray
    dend: np.ndarray


def draft_indels(rng, draft: np.ndarray, ins: float,
                 dele: float) -> tuple:
    """(draft with indels, DraftMap): each base of a substituted draft
    deleted with probability `dele`, or given one random draft-only base
    before it with probability `ins` (never before the first)."""
    n = len(draft)
    u = rng.random(n)
    is_del = u < dele
    is_ins = (u >= dele) & (u < dele + ins)
    is_ins[0] = False
    extra = rng.choice(BASES, int(is_ins.sum()))
    keep = ~is_del
    dins = is_ins.astype(np.int64)
    slots = np.stack([np.zeros(n, np.uint8), draft], axis=1)
    slots[is_ins, 0] = extra
    has = np.stack([is_ins, keep], axis=1)
    step = dins + keep
    dend = np.concatenate([[0], np.cumsum(step)])
    return slots[has], DraftMap(keep, dins, dend[:-1] + dins, dend)


def _compose(is_del: np.ndarray, is_ins: np.ndarray, keep: np.ndarray,
             dins: np.ndarray) -> tuple:
    """Reads' alignments against the draft from their alignments against
    the truth: per read (rows) and truth base of its span (columns), the
    read's deletion and insertion (before the base) flags, and the
    draft's `keep` / `dins` over the same bases.  Before each base but
    the first come the draft-only bases (D), then the read's inserted
    base (I), then the base itself: M, or D where the read lacks it, I
    where the draft lacks it, nothing where both do.  A leading or
    trailing I becomes a soft clip and a leading or trailing D is
    dropped.  Returns (cigars, shift): BAM CIGAR words per read and the
    draft bases its start moves by."""
    m, n = is_del.shape
    cd = dins.astype(np.int64)
    cd[:, 0] = 0
    top = np.where(keep, np.where(is_del, OP_D, OP_M), OP_I)
    counts = np.stack([cd, is_ins.astype(np.int64),
                       (keep | ~is_del).astype(np.int64)], axis=2)
    kinds = np.stack([np.full((m, n), OP_D), np.full((m, n), OP_I), top],
                     axis=2)
    op = np.repeat(kinds.ravel(), counts.ravel())
    rid = np.repeat(np.arange(m), counts.sum(axis=(1, 2)))
    run = np.concatenate([[0], np.flatnonzero(
        (op[1:] != op[:-1]) | (rid[1:] != rid[:-1])) + 1])
    lens = np.diff(np.concatenate([run, [len(op)]]))
    cig = (lens.astype(np.uint32) << 4) | op[run].astype(np.uint32)
    cigars = _split(cig, np.bincount(rid[run], minlength=m))
    shift = np.zeros(m, dtype=np.int64)
    for k, c in enumerate(cigars):
        if (c[0] & 0xF) != OP_M or (c[-1] & 0xF) != OP_M:
            cigars[k], shift[k] = _clip_edges(c)
    return cigars, shift


def _clip_edges(cig: np.ndarray) -> tuple:
    """A composed CIGAR with its leading and trailing I and D runs
    turned into soft clips and dropped: (cigar, leading D bases)."""
    ops, lens = (cig & 0xF).tolist(), (cig >> 4).tolist()
    i, j = 0, len(ops) - 1
    lead = shift = tail = 0
    while ops[i] != OP_M:
        lead += lens[i] if ops[i] == OP_I else 0
        shift += lens[i] if ops[i] == OP_D else 0
        i += 1
    while ops[j] != OP_M:
        tail += lens[j] if ops[j] == OP_I else 0
        j -= 1
    out = ([lead << 4 | OP_S] if lead else []) + cig[i:j + 1].tolist() \
        + ([tail << 4 | OP_S] if tail else [])
    return np.array(out, dtype=np.uint32), shift


@dataclass
class SimCase:
    names: list
    truths: list  # bytes
    drafts: list  # bytes
    records: list  # BAM record dicts, sorted by (tid, pos)


def simulate_read(rng, truth: np.ndarray, start: int, length: int,
                  sub: float, ins: float, dele: float, r=None):
    """One read over truth[start:start+length].  Returns (seq uint8 ASCII,
    cigar uint32 BAM words).  The first and last truth bases always
    match, so the CIGAR starts and ends with M.  `r`, one uniform draw
    per truth base, is drawn here unless given."""
    return _read_draws(rng, truth, start, length, sub, ins, dele, r)[:2]


def _read_draws(rng, truth, start, length, sub, ins, dele, r=None):
    """simulate_read's (seq, cigar), with its per-base deletion and
    insertion flags."""
    seg = truth[start:start + length]
    n = len(seg)
    r = rng.random(n) if r is None else r.copy()
    r[0] = r[-1] = 1.0
    is_del = r < dele
    is_ins = (r >= dele) & (r < dele + ins)
    is_sub = (r >= dele + ins) & (r < dele + ins + sub)
    code = np.searchsorted(BASES, seg)
    code = np.where(is_sub, (code + rng.integers(1, 4, n)) % 4, code)
    # one slot per truth base, two (I then M) at an insertion
    nslot = np.where(is_ins, 2, 1)
    first = np.cumsum(nslot) - nslot
    ops = np.repeat(np.where(is_del, OP_D, OP_M), nslot)
    ops[first[is_ins]] = OP_I
    qcode = np.repeat(code, nslot)
    qcode[first[is_ins]] = rng.integers(0, 4, int(is_ins.sum()))
    seq = BASES[qcode[ops != OP_D]]
    change = np.flatnonzero(np.diff(ops)) + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [len(ops)]]))
    cigar = (lens.astype(np.uint32) << 4) | ops[starts].astype(np.uint32)
    return seq, cigar, is_del, is_ins


def simulate_case(seed: int, n_contigs: int, contig_len, depth: float,
                  read_len=(3000, 12000), sub=0.03, ins=0.03, dele=0.03,
                  draft_sub=0.005, rev_frac=0.5, hotspot=None,
                  draft_ins=0.0, draft_del=0.0) -> SimCase:
    """`n_contigs` contigs of `contig_len` bases (an int, or one length
    per contig), reads at `depth`x with lengths uniform in `read_len`
    (cut to the contig); a draft with substitutions at `draft_sub` and
    indels at `draft_ins` / `draft_del` per base.  `hotspot` =
    (position, max_len, fixed) gives every read over that truth position
    an extra insertion of 1..max_len bases there: prefixes of one motif
    when `fixed`, random bases otherwise."""
    rng = np.random.default_rng(seed)
    names, truths, drafts, records = [], [], [], []
    lens = np.broadcast_to(np.asarray(contig_len), (n_contigs,))
    indels = bool(draft_ins or draft_del)
    if indels and hotspot:
        raise ValueError("a hotspot needs a draft without indels")
    for tid in range(n_contigs):
        contig_len = int(lens[tid])
        mean_len = min((read_len[0] + read_len[1]) / 2, contig_len)
        truth = rng.choice(BASES, contig_len)
        motif = rng.choice(BASES, hotspot[1]) if hotspot else None
        draft = truth.copy()
        hit = rng.random(contig_len) < draft_sub
        code = np.searchsorted(BASES, truth[hit])
        draft[hit] = BASES[(code + rng.integers(1, 4, len(code))) % 4]
        dmap = None
        if indels:
            draft, dmap = draft_indels(rng, draft, draft_ins, draft_del)
        names.append(f"ctg{tid}")
        truths.append(truth.tobytes())
        drafts.append(draft.tobytes())
        n_reads = int(round(depth * contig_len / mean_len))
        for k in range(n_reads):
            ln = min(int(rng.integers(read_len[0], read_len[1] + 1)),
                     contig_len)
            s = int(rng.integers(0, contig_len - ln + 1))
            if hotspot and s < hotspot[0] < s + ln - 1:
                # an insertion of 1..max_len bases before truth base
                # hotspot[0]: a prefix of one motif (many reads ending at
                # many insertion depths: ring slots) or random bases (many
                # predecessor contexts per cell: entry slots)
                p, ilen = hotspot[0], int(rng.integers(1, hotspot[1] + 1))
                s1, c1 = simulate_read(rng, truth, s, p - s, sub, ins, dele)
                s2, c2 = simulate_read(rng, truth, p, s + ln - p, sub, ins,
                                       dele)
                extra = (motif[:ilen] if hotspot[2]
                         else rng.choice(BASES, ilen))
                seq = np.concatenate([s1, extra, s2])
                cigar = np.concatenate(
                    [c1, [np.uint32(ilen << 4 | OP_I)], c2]
                ).astype(np.uint32)
            elif dmap is not None:
                seq, _, is_del, is_ins = _read_draws(rng, truth, s, ln, sub,
                                                     ins, dele)
                (cigar,), shift = _compose(
                    is_del[None], is_ins[None], dmap.keep[None, s:s + ln],
                    dmap.dins[None, s:s + ln])
                s = int(dmap.dbefore[s] + shift[0])
            else:
                seq, cigar = simulate_read(rng, truth, s, ln, sub, ins, dele)
            records.append(dict(
                name=f"r{tid}_{k}", tid=tid, pos=s, mapq=60,
                flag=16 if rng.random() < rev_frac else 0, cigar=cigar,
                seq_nib=bamio.seq_to_nib(seq.tobytes())))
    records.sort(key=lambda rec: (rec["tid"], rec["pos"]))
    return SimCase(names, truths, drafts, records)


def long_reads(seed: int, truths: list, depth: float,
               read_len=(3000, 12000), sub=0.03, ins=0.03, dele=0.03,
               rev_frac=0.5) -> list:
    """Long reads at `depth`x over given truth contigs (bytes), as
    simulate_case draws them (lengths uniform in `read_len`, cut to the
    contig; per-base error rates; reverse strand with probability
    `rev_frac`): BAM record dicts named l<tid>_<k>, for write_reads."""
    rng = np.random.default_rng(seed)
    records = []
    for tid, tb in enumerate(truths):
        truth = np.frombuffer(tb, dtype=np.uint8)
        L = len(truth)
        mean_len = min((read_len[0] + read_len[1]) / 2, L)
        for k in range(int(round(depth * L / mean_len))):
            ln = min(int(rng.integers(read_len[0], read_len[1] + 1)), L)
            s = int(rng.integers(0, L - ln + 1))
            seq, cigar = simulate_read(rng, truth, s, ln, sub, ins, dele)
            records.append(dict(
                name=f"l{tid}_{k}", tid=tid, pos=s, mapq=60,
                flag=16 if rng.random() < rev_frac else 0, cigar=cigar,
                seq_nib=bamio.seq_to_nib(seq.tobytes())))
    return records


def _mutate(rng, truth: np.ndarray, rate: float) -> np.ndarray:
    """truth with a substitution at each base with probability `rate`."""
    out = truth.copy()
    hit = rng.random(len(truth)) < rate
    code = np.searchsorted(BASES, truth[hit])
    out[hit] = BASES[(code + rng.integers(1, 4, len(code))) % 4]
    return out


def simulate_short_case(seed: int, contig_lens, depth: float,
                        read_len: int = 150, insert=(350, 35),
                        sub=0.01, ins=0.002, dele=0.002,
                        draft_sub=0.005, draft_ins=0.0,
                        draft_del=0.0) -> SimCase:
    """Paired-end short reads at `depth`x over contigs of `contig_lens`
    bases.  Fragment lengths are normal (`insert` = mean, sd; cut to
    [read_len, 2 * mean]); mate 1 reads the fragment's start forward,
    mate 2 its end reverse, with flags 0x1|0x2|0x40|0x20 and
    0x1|0x2|0x80|0x10 and tlen +/- the fragment length.  Per truth base a
    read carries `sub` substitutions and `ins` / `dele` insertions /
    deletions; reads drawn without an indel (most of them) are built in
    bulk, the rest as simulate_read builds them from the same per-base
    draws (_indel_reads, also in bulk).  With `draft_ins` or `draft_del`
    the draft carries indels too, and the reads' alignments are composed
    with its edit map (simulate_case)."""
    rng = np.random.default_rng(seed)
    names, truths, drafts, records = [], [], [], []
    for tid, L in enumerate(np.atleast_1d(contig_lens)):
        truth = rng.choice(BASES, int(L))
        names.append(f"ctg{tid}")
        truths.append(truth.tobytes())
        draft, dmap = _mutate(rng, truth, draft_sub), None
        if draft_ins or draft_del:
            draft, dmap = draft_indels(rng, draft, draft_ins, draft_del)
        drafts.append(draft.tobytes())
        records += _pair_records(rng, truth, tid, depth, read_len, insert,
                                 sub, ins, dele, f"p{tid}_", dmap=dmap)
    records.sort(key=lambda rec: (rec["tid"], rec["pos"]))
    return SimCase(names, truths, drafts, records)


def _pair_records(rng, truth: np.ndarray, tid: int, depth: float,
                  read_len: int, insert, sub: float, ins: float,
                  dele: float, prefix: str, holes=(), dmap=None) -> list:
    """simulate_short_case's read pairs over one truth contig, fragments
    named prefix + index; a fragment with a mate starting inside one of
    the (start, end) `holes` is drawn and then dropped.  With a DraftMap
    the reads over a draft edit or with an indel of their own are
    aligned to the draft by _compose, and positions and template lengths
    are the draft's."""
    L = len(truth)
    p_indel = ins + dele
    n_frag = int(round(depth * L / (2 * read_len)))
    flen = np.clip(np.rint(rng.normal(insert[0], insert[1], n_frag)),
                   read_len, min(2 * insert[0], L)).astype(np.int64)
    fstart = rng.integers(0, L - flen + 1)
    # mate 1 at the fragment's start, mate 2 at its end
    starts = np.concatenate([fstart, fstart + flen - read_len])
    mate = np.repeat([0, 1], n_frag)
    frag = np.tile(np.arange(n_frag), 2)
    r = rng.random((2 * n_frag, read_len))
    r[:, 0] = r[:, -1] = 1.0
    gapless = ~np.any(r < p_indel, axis=1)
    codes = np.searchsorted(BASES, truth)[
        starts[:, None] + np.arange(read_len)]
    is_sub = (r >= p_indel) & (r < p_indel + sub)
    codes = np.where(is_sub, (codes + rng.integers(1, 4, codes.shape))
                     % 4, codes)
    nib_g = bamio.ASCII_TO_NIB[BASES[codes]]
    cig_g = np.array([read_len << 4 | OP_M], dtype=np.uint32)
    # reads with an indel: simulate_read's draws, read by read in
    # order, then the reads themselves in bulk
    gap = np.flatnonzero(~gapless)
    nib_i, cig_i = _indel_reads(rng, truth, starts[gap], r[gap], sub,
                                ins, dele)
    nibs, cigars = list(nib_g), [cig_g] * (2 * n_frag)
    for i, k in enumerate(gap.tolist()):
        nibs[k], cigars[k] = nib_i[i], cig_i[i]
    pos, tlen = starts, np.concatenate([flen, -flen])
    if dmap is not None:
        pos = dmap.dbefore[starts]
        # reads whose span holds a draft edit (a draft-only base before
        # any of its bases but the first, or a truth base the draft
        # lacks), or an indel of their own
        gaps = np.concatenate([[0], np.cumsum(~dmap.keep)])
        dcum = np.concatenate([[0], np.cumsum(dmap.dins)])
        edit = (gaps[starts + read_len] > gaps[starts]) | (
            dcum[starts + read_len] > dcum[starts + 1])
        sel = np.flatnonzero(edit | ~gapless)
        cols = np.arange(read_len)
        for lo in range(0, len(sel), 16384):
            k = sel[lo:lo + 16384]
            span = starts[k, None] + cols
            cig, shift = _compose(r[k] < dele, (r[k] >= dele)
                                  & (r[k] < dele + ins), dmap.keep[span],
                                  dmap.dins[span])
            for i, kk in enumerate(k.tolist()):
                cigars[kk] = cig[i]
            pos[k] += shift
        fl = dmap.dend[fstart + flen] - dmap.dbefore[fstart]
        tlen = np.concatenate([fl, -fl])
    frag_names = [f"{prefix}{f}" for f in range(n_frag)]
    keep = np.ones(n_frag, dtype=bool)
    for h0, h1 in holes:
        inside = (starts >= h0) & (starts < h1)
        keep &= ~(inside[:n_frag] | inside[n_frag:])
    # each mate's mpos is the other mate's start: starts rolled by a
    # half
    return [
        dict(name=frag_names[f], tid=tid, pos=pos, mapq=60,
             flag=0x3 | (0x60 if m == 0 else 0x90), cigar=cigar,
             seq_nib=nib, mtid=tid, mpos=mpos, tlen=tlen)
        for m, f, pos, mpos, tlen, nib, cigar in zip(
            mate.tolist(), frag.tolist(), pos.tolist(),
            np.roll(pos, n_frag).tolist(), tlen.tolist(), nibs, cigars)
        if keep[f]]


def _indel_reads(rng, truth: np.ndarray, starts: np.ndarray, r: np.ndarray,
                 sub: float, ins: float, dele: float, batch: int = 16384):
    """simulate_read(rng, truth, starts[i], len(r[i]), ..., r=r[i]) for each
    i in order, as (seq_nib, cigar) lists: the same draws in the same order
    (each read's substitution bases, then its inserted bases), the reads
    built from them `batch` at a time in bulk."""
    m, n = r.shape
    r = r.copy()
    r[:, 0] = r[:, -1] = 1.0
    is_del = r < dele
    is_ins = (r >= dele) & (r < dele + ins)
    is_sub = (r >= dele + ins) & (r < dele + ins + sub)
    n_ins = is_ins.sum(axis=1)
    sub_draw = np.empty((m, n), dtype=np.int64)
    ins_draw = []
    for i in range(m):
        sub_draw[i] = rng.integers(1, 4, n)
        ins_draw.append(rng.integers(0, 4, int(n_ins[i])))
    tcode = np.searchsorted(BASES, truth)
    nibs, cigars = [], []
    for lo in range(0, m, batch):
        hi = min(lo + batch, m)
        ii, dd = is_ins[lo:hi], is_del[lo:hi]
        code = tcode[starts[lo:hi, None] + np.arange(n)]
        code = np.where(is_sub[lo:hi], (code + sub_draw[lo:hi]) % 4, code)
        # two slots a truth base: (the inserted base, then the base) at an
        # insertion, (the base or a deletion, nothing) elsewhere
        first = code.copy()
        if ii.any():
            first[ii] = np.concatenate(ins_draw[lo:hi])
        slots = np.stack([first, code], axis=2)
        has_base = np.stack([~dd, ii], axis=2)
        ops = np.stack([np.where(ii, OP_I, np.where(dd, OP_D, OP_M)),
                        np.full(ii.shape, OP_M)], axis=2)
        has_op = np.stack([np.ones_like(ii), ii], axis=2)
        nib = bamio.ASCII_TO_NIB[BASES[slots[has_base]]]
        nibs += _split(nib, has_base.sum(axis=(1, 2)))
        op = ops[has_op]
        rid = np.repeat(np.arange(hi - lo), has_op.sum(axis=(1, 2)))
        run = np.concatenate([[0], np.flatnonzero(
            (op[1:] != op[:-1]) | (rid[1:] != rid[:-1])) + 1])
        lens = np.diff(np.concatenate([run, [len(op)]]))
        cig = (lens.astype(np.uint32) << 4) | op[run].astype(np.uint32)
        cigars += _split(cig, np.bincount(rid[run], minlength=hi - lo))
    return nibs, cigars


def _split(a: np.ndarray, lens: np.ndarray) -> list:
    """a cut into consecutive pieces of the given lengths (views)."""
    ends = np.cumsum(lens).tolist()
    return [a[s:e] for s, e in zip([0] + ends[:-1], ends)]


def write_case(case: SimCase, outdir: str) -> tuple[str, str]:
    """Write genome.fa and the sorted, indexed reads.sort.bam; returns
    (fasta path, bam path)."""
    os.makedirs(outdir, exist_ok=True)
    fa = os.path.join(outdir, "genome.fa")
    with open(fa, "wb") as fh:
        for name, seq in zip(case.names, case.drafts):
            fh.write(b">" + name.encode() + b"\n" + seq + b"\n")
    bam = os.path.join(outdir, "reads.sort.bam")
    hdr = bamio.BamHeader("", list(case.names),
                          [len(d) for d in case.drafts])
    bamio.write_bam(bam, hdr, case.records, index=True)
    return fa, bam
