"""Polishing cases with alignments known by construction: long reads
(`simulate_case`), paired-end short reads (`simulate_short_case`) and a
diploid genome with both (`simulate_diploid_case`), as a
BAM (`write_case`) or as the read files of a run.cfg project
(`write_reads`); random sparse pileups for the chain DP alone
(`random_pileup`); inputs of the mappers' banded DP alone
(`band_case`); and the benchmark workloads of the repo's bench.py
(`make_task1_case`, an AlnBatch in memory; `make_task5_case`, long reads
through the built-in mapper), which the dryrun and the stage profiler
run.

A random `truth` genome is drawn; the `draft` is the truth with
substitutions only, so a read's exact alignment against the truth is also
a valid alignment against the draft and no mapper is needed.  Reads are
sampled from the truth with independent substitution, insertion and
deletion rates per truth base.  Long reads are flagged reverse strand
half the time; short reads come in pairs, the first mate forward and the
second reverse (the BAM stores every read in reference orientation, so
the flag is the only trace of the strand).  Everything is drawn from one
numpy `default_rng(seed)`.
"""
from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

from .io import bam as bamio

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
OP_M, OP_I, OP_D = 0, 1, 2


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
    return seq, cigar


def simulate_case(seed: int, n_contigs: int, contig_len, depth: float,
                  read_len=(3000, 12000), sub=0.03, ins=0.03, dele=0.03,
                  draft_sub=0.005, rev_frac=0.5, hotspot=None) -> SimCase:
    """`n_contigs` contigs of `contig_len` bases (an int, or one length
    per contig), reads at `depth`x with lengths uniform in `read_len`
    (cut to the contig).  `hotspot` =
    (position, max_len, fixed) gives every read over that truth position
    an extra insertion of 1..max_len bases there: prefixes of one motif
    when `fixed`, random bases otherwise."""
    rng = np.random.default_rng(seed)
    names, truths, drafts, records = [], [], [], []
    lens = np.broadcast_to(np.asarray(contig_len), (n_contigs,))
    for tid in range(n_contigs):
        contig_len = int(lens[tid])
        mean_len = min((read_len[0] + read_len[1]) / 2, contig_len)
        truth = rng.choice(BASES, contig_len)
        motif = rng.choice(BASES, hotspot[1]) if hotspot else None
        draft = truth.copy()
        hit = rng.random(contig_len) < draft_sub
        code = np.searchsorted(BASES, truth[hit])
        draft[hit] = BASES[(code + rng.integers(1, 4, len(code))) % 4]
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
                        draft_sub=0.005) -> SimCase:
    """Paired-end short reads at `depth`x over contigs of `contig_lens`
    bases.  Fragment lengths are normal (`insert` = mean, sd; cut to
    [read_len, 2 * mean]); mate 1 reads the fragment's start forward,
    mate 2 its end reverse, with flags 0x1|0x2|0x40|0x20 and
    0x1|0x2|0x80|0x10 and tlen +/- the fragment length.  Per truth base a
    read carries `sub` substitutions and `ins` / `dele` insertions /
    deletions; reads drawn without an indel (most of them) are built in
    bulk, the rest as simulate_read builds them from the same per-base
    draws (_indel_reads, also in bulk)."""
    rng = np.random.default_rng(seed)
    names, truths, drafts, records = [], [], [], []
    for tid, L in enumerate(np.atleast_1d(contig_lens)):
        truth = rng.choice(BASES, int(L))
        names.append(f"ctg{tid}")
        truths.append(truth.tobytes())
        drafts.append(_mutate(rng, truth, draft_sub).tobytes())
        records += _pair_records(rng, truth, tid, depth, read_len, insert,
                                 sub, ins, dele, f"p{tid}_")
    records.sort(key=lambda rec: (rec["tid"], rec["pos"]))
    return SimCase(names, truths, drafts, records)


def _pair_records(rng, truth: np.ndarray, tid: int, depth: float,
                  read_len: int, insert, sub: float, ins: float,
                  dele: float, prefix: str, holes=()) -> list:
    """simulate_short_case's read pairs over one truth contig, fragments
    named prefix + index; a fragment with a mate starting inside one of
    the (start, end) `holes` is drawn and then dropped."""
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
    nib_g = bamio._ASCII_TO_NIB[BASES[codes]]
    cig_g = np.array([read_len << 4 | OP_M], dtype=np.uint32)
    # reads with an indel: simulate_read's draws, read by read in
    # order, then the reads themselves in bulk
    gap = np.flatnonzero(~gapless)
    nib_i, cig_i = _indel_reads(rng, truth, starts[gap], r[gap], sub,
                                ins, dele)
    nibs, cigars = list(nib_g), [cig_g] * (2 * n_frag)
    for i, k in enumerate(gap.tolist()):
        nibs[k], cigars[k] = nib_i[i], cig_i[i]
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
            mate.tolist(), frag.tolist(), starts.tolist(),
            np.roll(starts, n_frag).tolist(),
            np.concatenate([flen, -flen]).tolist(), nibs, cigars)
        if keep[f]]


@dataclass
class DiploidCase(SimCase):
    hap2s: list  # bytes: the second haplotype of each contig
    holes: list  # per contig, (start, end) stretches without read starts
    long_records: list  # long-read BAM record dicts, or [] without them


def simulate_diploid_case(seed: int, contig_lens, depth: float,
                          het_rate: float, holes: int, hole_len: int,
                          long_depth: float | None = None) -> DiploidCase:
    """A diploid genome for tasks 3 and 4: per contig, hap1 is random and
    hap2 is hap1 with a substitution at each base with probability
    `het_rate` (the heterozygous SNPs); `truths` holds hap1 and the draft
    is hap1 with 0.5% substitutions.  PE150 read pairs are drawn
    from each haplotype at depth / 2 with simulate_short_case's error
    model, fragments of hap1 named a<tid>_<k>, of hap2 b<tid>_<k>.  Each
    contig has `holes` stretches of `hole_len` bases, one in each of
    `holes` equal slices at a random offset, where no read starts, so
    that their far part has no short-read coverage.  With `long_depth`,
    long reads of 3-12 kb come from each haplotype at
    long_depth / 2 with simulate_case's error model (3% each of
    substitutions, insertions and deletions), named l<tid>_<hap>_<k>."""
    rng = np.random.default_rng(seed)
    names, truths, drafts, hap2s, all_holes = [], [], [], [], []
    records, long_records = [], []
    for tid, L in enumerate(np.atleast_1d(contig_lens)):
        L = int(L)
        hap1 = rng.choice(BASES, L)
        hap2 = _mutate(rng, hap1, het_rate)
        names.append(f"ctg{tid}")
        truths.append(hap1.tobytes())
        hap2s.append(hap2.tobytes())
        drafts.append(_mutate(rng, hap1, 0.005).tobytes())
        seg = L // max(holes, 1)
        starts = [k * seg + int(rng.integers(0, seg - hole_len))
                  for k in range(holes)]
        hs = [(h, h + hole_len) for h in starts]
        all_holes.append(hs)
        for hap, pre in ((hap1, "a"), (hap2, "b")):
            records += _pair_records(rng, hap, tid, depth / 2, 150,
                                     (350, 35), 0.01, 0.002, 0.002,
                                     f"{pre}{tid}_", hs)
        if long_depth:
            mean_len = min(7500, L)
            for h, hap in enumerate((hap1, hap2)):
                for k in range(int(round(long_depth / 2 * L / mean_len))):
                    ln = min(int(rng.integers(3000, 12001)), L)
                    s = int(rng.integers(0, L - ln + 1))
                    seq, cigar = simulate_read(rng, hap, s, ln, 0.03, 0.03,
                                               0.03)
                    long_records.append(dict(
                        name=f"l{tid}_{h + 1}_{k}", tid=tid, pos=s,
                        mapq=60, flag=16 if rng.random() < 0.5 else 0,
                        cigar=cigar,
                        seq_nib=bamio.seq_to_nib(seq.tobytes())))
    records.sort(key=lambda rec: (rec["tid"], rec["pos"]))
    long_records.sort(key=lambda rec: (rec["tid"], rec["pos"]))
    return DiploidCase(names, truths, drafts, records, hap2s, all_holes,
                       long_records)


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
        nib = bamio._ASCII_TO_NIB[BASES[slots[has_base]]]
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


_NIB_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def write_reads(records: list, paths: list, fastq: bool = True) -> None:
    """Reads (BAM record dicts, as a case holds them) as sequenced: a
    reverse-strand read reverse complemented back, gzipped, in one
    FASTA/FASTQ file, or for paired-end reads in two files, mate 1 and
    mate 2 of each fragment at the same index (quality 'I' throughout).
    The inputs of a run.cfg project."""
    if len(paths) == 2:
        mates = {}
        for r in records:
            mates.setdefault(r["name"], [None, None])[
                0 if r["flag"] & 0x40 else 1] = r
        groups = [[m[0] for m in mates.values()],
                  [m[1] for m in mates.values()]]
    else:
        groups = [records]
    for path, recs in zip(paths, groups):
        with gzip.open(path, "wb", compresslevel=1) as fh:
            for r in recs:
                seq = _NIB_ASCII[r["seq_nib"]].tobytes()
                if r["flag"] & 16:
                    seq = seq.translate(_COMP)[::-1]
                if fastq:
                    fh.write(b"@" + r["name"].encode() + b"\n" + seq
                             + b"\n+\n" + b"I" * len(seq) + b"\n")
                else:
                    fh.write(b">" + r["name"].encode() + b"\n" + seq
                             + b"\n")


def write_project(outdir: str, names: list, drafts: list, task: str,
                  sgs: list | None = None, lgs: list | None = None) -> str:
    """A run.cfg project in `outdir`: draft.fa, the paired short reads
    `sgs` as r1/r2.fq.gz and the long reads `lgs` as lgs.fa.gz (record
    dicts, see write_reads) with their fofns, and run.cfg with `task`
    and workdir ./work.  Returns the path of run.cfg."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "draft.fa"), "wb") as fh:
        for name, seq in zip(names, drafts):
            fh.write(b">" + name.encode() + b"\n" + seq + b"\n")
    cfg = [f"task = {task}", "genome = ./draft.fa", "workdir = ./work"]
    if sgs is not None:
        write_reads(sgs, [os.path.join(outdir, "r1.fq.gz"),
                          os.path.join(outdir, "r2.fq.gz")])
        with open(os.path.join(outdir, "sgs.fofn"), "w") as fh:
            fh.write("r1.fq.gz\nr2.fq.gz\n")
        cfg.append("sgs_fofn = ./sgs.fofn")
    if lgs is not None:
        write_reads(lgs, [os.path.join(outdir, "lgs.fa.gz")], fastq=False)
        with open(os.path.join(outdir, "lgs.fofn"), "w") as fh:
            fh.write("lgs.fa.gz\n")
        cfg.append("lgs_fofn = ./lgs.fofn")
    path = os.path.join(outdir, "run.cfg")
    with open(path, "w") as fh:
        fh.write("\n".join(cfg) + "\n")
    return path


def random_pileup(seed: int, n_dp: int, per: int, heavy_cells: int = 0,
                  big_counts: bool = False, rolling: bool = False):
    """A random sparse pileup for ops/chain.py: sorted cell*512+kmer keys
    with `per` draws per cell, counts 1..49, per-cell first-observation
    ranks in kmer order, totals 2..89.  `heavy_cells` cells get 24 more
    draws (more distinct kmers than the planes hold: overflow entries),
    `big_counts` pushes 60 counts past the 7-bit plane cap and every
    total past 255 (escaped totals), `rolling` makes refkmer the rolling
    3-mer stream of a random draft (observed first in its cell, as the
    contig-as-read makes it) instead of the cell's first observed kmer.
    Returns (uk int64, cn int64, rk uint16, refkmer int32, total int32),
    the inputs of chain.pack_chain_planes."""
    K3 = 512
    rng = np.random.default_rng(seed)
    cells = np.repeat(np.arange(n_dp, dtype=np.int64), per)
    kmers = rng.integers(0, K3, per * n_dp)
    if heavy_cells:
        hv = rng.choice(n_dp, heavy_cells, replace=False)
        cells = np.concatenate([cells, np.repeat(hv, 24)])
        kmers = np.concatenate([kmers, rng.integers(0, K3, 24 * heavy_cells)])
    if rolling:
        sym = rng.integers(1, 6, n_dp)
        prev1 = np.concatenate([[0], sym[:-1]])
        prev2 = np.concatenate([[0, 0], sym[:-2]])
        refkmer = ((prev2 << 6) | (prev1 << 3) | sym).astype(np.int32)
        cells = np.concatenate([cells, np.arange(n_dp)])
        kmers = np.concatenate([kmers, refkmer])
    uk = np.unique(cells * K3 + kmers)
    cn = rng.integers(1, 50, len(uk)).astype(np.int64)
    ucell = uk // K3
    first = np.searchsorted(ucell, ucell)  # each cell's first key
    rk = np.arange(len(uk)) - first
    if rolling:  # the draft kmer moves to rank 0
        r_ref = rk[(uk % K3) == refkmer[ucell]][ucell]
        rk = np.where(rk == r_ref, 0, rk + (rk < r_ref))
    else:
        refkmer = (uk[first[np.searchsorted(ucell, np.arange(n_dp))]]
                   % K3).astype(np.int32)
    total = rng.integers(2, 90, n_dp).astype(np.int32)
    if big_counts:
        cn[rng.choice(len(cn), 60, replace=False)] += 500
        total = total + 600
    return uk, cn, rk.astype(np.uint16), refkmer, total


# the main path's scoring per mode of align/extend.py: short reads and
# mate rescue (align/mapper.py), long-read segments and end extensions
# (align/longread.py)
BAND_SCORES = {
    "local": dict(match=1, mismatch=4, gapo=6, gape=1, clip5=5, clip3=5),
    "global": dict(match=2, mismatch=4, gapo=4, gape=2),
    "extend": dict(match=2, mismatch=4, gapo=4, gape=2, clip5=1 << 20),
}


def band_case(seed: int, Bt: int, R: int, B: int, mode: str,
              err: float = 0.06):
    """Inputs of align/extend.py's banded DP laid out as the mappers lay
    them out: (q [Bt, R] uint8 codes, 4 = pad; t [Bt, R+B]; qlen, tlen
    [Bt] int32).  Each read is a piece of its reference with substitutions
    and indels at `err` (a fifth of them indel runs of 1-4 bases); qlen
    runs from R/2 to R, so rows past qlen occur.  Every third reference is
    a tandem repeat of a short motif and every fifth read carries a
    repeat-unit indel, so equal-score paths tie; every seventh read is
    unrelated to its reference.  local: the read lies anywhere inside the
    window; extend: it starts at the window's corner; global: the segment
    t[x] = ref[x - B//2] of length tlen = qlen +- a few, within the band.
    """
    rng = np.random.default_rng(seed)
    off = B // 2 if mode == "global" else 0
    q = np.full((Bt, R), 4, dtype=np.uint8)
    t = np.full((Bt, R + B), 4, dtype=np.uint8)
    qlen = np.zeros(Bt, dtype=np.int32)
    tlen = np.zeros(Bt, dtype=np.int32)
    for b in range(Bt):
        n = R + B + 8
        if b % 3 == 0:
            unit = rng.integers(0, 4, int(rng.integers(1, 5)))
            ref = np.resize(unit, n).astype(np.uint8)
        else:
            ref = rng.integers(0, 4, n).astype(np.uint8)
        ql = int(rng.integers(max(R // 2, 1), R + 1))
        start = 0 if mode == "extend" else (
            off if mode == "global" else int(rng.integers(0, max(B // 4, 1))))
        src = ref[start:]
        read = []
        j = 0
        while len(read) < ql and j < len(src):
            r = rng.random()
            if r < err * 0.8:
                read.append(int(rng.integers(0, 4)))
                j += 1
            elif r < err * 0.9:
                j += int(rng.integers(1, 5))  # deletion run
            elif r < err:
                read.extend(rng.integers(0, 4, int(rng.integers(1, 5))))
            else:
                read.append(int(src[j]))
                j += 1
        read = np.array(read[:ql], dtype=np.uint8)
        if b % 5 == 0 and ql > 12:
            read = np.delete(read, range(6, 8))  # a repeat-unit deletion
        if b % 7 == 0:
            read = rng.integers(0, 4, len(read)).astype(np.uint8)
        ql = len(read)
        q[b, :ql] = read
        qlen[b] = ql
        if mode == "global":
            tl = min(max(1, ql + int(rng.integers(-3, 4))), R + B - off)
            t[b, off:off + tl] = ref[off:off + tl]
            tlen[b] = tl
        else:
            t[b] = ref[:R + B]
            tlen[b] = R + B
    return q, t, qlen, tlen


def band_indel_case(seed: int, Bt: int, R: int, B: int, mode: str):
    """band_case's layout with one long indel a read: even reads lose a
    run of B/8 to B/2 - 1 reference bases halfway along, odd reads
    gain a random run of that length there, so the traceback's walk moves
    across many band columns (deletions to the left, insertions to the
    right).  Reads are otherwise exact copies; qlen runs from 3R/4 to R."""
    rng = np.random.default_rng(seed)
    off = B // 2 if mode == "global" else 0
    q = np.full((Bt, R), 4, dtype=np.uint8)
    t = np.full((Bt, R + B), 4, dtype=np.uint8)
    qlen = np.zeros(Bt, dtype=np.int32)
    tlen = np.zeros(Bt, dtype=np.int32)
    for b in range(Bt):
        ref = rng.integers(0, 4, R + B + 8).astype(np.uint8)
        ql = int(rng.integers(max(3 * R // 4, 1), R + 1))
        n = int(rng.integers(max(B // 8, 1), max(B // 2, 2)))
        start = off if mode == "global" else (
            0 if mode == "extend" else int(rng.integers(0, max(B // 4, 1))))
        a = ql // 2
        src = ref[start:]
        if b % 2 == 0:
            read = np.concatenate([src[:a], src[a + n:]])
            used = ql + n
        else:
            read = np.concatenate([src[:a], rng.integers(0, 4, n), src[a:]])
            used = max(ql - n, 1)
        read = read[:ql].astype(np.uint8)
        q[b, :ql] = read
        qlen[b] = ql
        if mode == "global":
            tl = min(used, R + B - off)
            t[b, off:off + tl] = ref[off:off + tl]
            tlen[b] = tl
        else:
            t[b] = ref[:R + B]
            tlen[b] = R + B
    return q, t, qlen, tlen


# ---------------------------------------------------------------------------
# the benchmark workloads' fixtures (bench.py's _sim_read, make_task1_case
# and make_task5_case, copied with the imports changed; make_task5_case
# maps on the host): the dryrun's and the stage profiler's inputs, the
# same arrays and bytes for the same rng
# ---------------------------------------------------------------------------

def _sim_read(rng, true, s, ref_span, bases, p_ins=0.002, p_del=0.002,
              p_sub=0.01):
    """Noisy copy of true[s:s+ref_span] with its exact CIGAR, fully
    vectorized.  Single-base ins/del/sub events; returns
    (seq_bytes, [(op, len)]) with op 0=M 1=I 2=D."""
    seg = true[s:s + ref_span]
    n = len(seg)
    ins = rng.random(n) < p_ins  # insert one base before position i
    dele = rng.random(n) < p_del
    sub = (rng.random(n) < p_sub) & ~dele
    out = seg.copy()
    nsub = int(sub.sum())
    if nsub:
        out[sub] = rng.choice(bases, nsub)
    # per position: optional I slot (random base), then an M/D slot
    n_out = ins.astype(np.int64) + 1
    off = np.cumsum(n_out) - n_out
    total = int(n_out.sum())
    seq = np.empty(total, dtype=np.uint8)
    seq[off[ins]] = rng.choice(bases, int(ins.sum()))
    seq[off + ins] = np.where(dele, 0, out)
    ops = np.empty(total, dtype=np.uint8)
    ops[off[ins]] = 1
    ops[off + ins] = np.where(dele, 2, 0)
    # deletions consume no query: drop their seq slots
    qmask = np.ones(total, dtype=bool)
    qmask[(off + ins)[dele]] = False
    seq = seq[qmask]
    # run-length encode ops
    brk = np.flatnonzero(np.diff(ops.astype(np.int8)) != 0)
    starts_r = np.concatenate([[0], brk + 1])
    ends_r = np.concatenate([brk + 1, [len(ops)]])
    cig = [(int(ops[a]), int(b - a)) for a, b in zip(starts_r, ends_r)]
    return seq.tobytes(), cig


def make_task1_case(rng, L=100_000, depth=40, read_len=150, n_contigs=12,
                    clip_frac=0.02, p_indel=0.002, p_sub=0.01):
    from .io.bam import AlnBatch, BamHeader
    from .io.fasta import ASCII_TO_NIB

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    names = [f"ctg{i}" for i in range(n_contigs)]
    header = BamHeader("", names, [L] * n_contigs)
    trues = []
    rows = []  # (tid, pos, seq, cigar)
    per = depth * L // read_len
    for i in range(n_contigs):
        true = rng.choice(bases, L)
        trues.append(true.tobytes())
        starts = np.sort(rng.integers(0, L - read_len - 10, per))
        # most reads are gapless (vectorized); a Poisson-sampled subset
        # carries explicit insertion/deletion events so the engine's
        # insert cells and mixed-CIGAR paths see real work
        n_ev = rng.poisson(2 * p_indel * read_len, per)
        gapless = n_ev == 0
        seqs = true[starts[:, None] + np.arange(read_len)[None, :]].copy()
        n_err = int(p_sub * seqs.size)
        er = rng.integers(0, per, n_err)
        ec = rng.integers(0, read_len, n_err)
        seqs[er, ec] = rng.choice(bases, n_err)
        base_cig = [(0, read_len)]
        for j in range(per):  # emitted in sorted-position order
            if gapless[j]:
                rows.append((i, int(starts[j]), seqs[j].tobytes(),
                             base_cig))
                continue
            seq, cig = _sim_read(rng, true, int(starts[j]), read_len,
                                 bases, p_ins=p_indel, p_del=p_indel,
                                 p_sub=p_sub)
            if rng.random() < clip_frac:
                extra = rng.choice(bases, 10).tobytes()
                if rng.random() < 0.5:
                    seq = extra + seq
                    cig = [(4, 10)] + cig
                else:
                    seq = seq + extra
                    cig = cig + [(4, 10)]
            rows.append((i, int(starts[j]), seq, cig))
    n = len(rows)
    lq = np.array([len(r[2]) for r in rows], dtype=np.int32)
    seq_off = np.concatenate([[0], np.cumsum(lq[:-1])]).astype(np.int64)
    cig_arr = []
    cig_off = []
    off = 0
    for _, _, _, cig in rows:
        cig_off.append(off)
        for op, ln in cig:
            cig_arr.append((ln << 4) | op)
        off += len(cig)
    seqcat = np.frombuffer(b"".join(r[2] for r in rows), dtype=np.uint8)
    batch = AlnBatch(
        header=header,
        tid=np.array([r[0] for r in rows], np.int32),
        pos=np.array([r[1] for r in rows], np.int32),
        mapq=np.full(n, 60, np.uint8),
        flag=np.zeros(n, np.uint16),
        tlen=np.where(np.arange(n) % 2 == 0, 300, -300).astype(np.int32),
        lqseq=lq,
        cigar=np.array(cig_arr, dtype=np.uint32),
        cigar_off=np.array(cig_off, dtype=np.int64),
        cigar_len=np.array([len(r[3]) for r in rows], np.int32),
        seq=ASCII_TO_NIB[seqcat],
        seq_off=seq_off,
        qual=np.full(int(lq.sum()), 35, np.uint8),
        qual_off=seq_off.copy(),
        mtid=np.full(n, -1, np.int32),
        mpos=np.full(n, -1, np.int32),
    )
    return names, trues, batch, n


def make_task5_case(rng, L=50_000, n_contigs=8, depth=30, err=0.03):
    from .align.index import GenomeIndex
    from .align.longread import map_long_batch
    from .align.mapper import records_to_batch

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    names, drafts, reads_all = [], [], []
    for i in range(n_contigs):
        true = rng.choice(bases, L)
        # draft = lightly corrupted truth
        d, _ = _sim_read(rng, true, 0, L, bases, 0.003, 0.003, 0.006)
        names.append(f"ctg{i}")
        drafts.append(d)
        n_reads = depth * L // 3000
        for _ in range(n_reads):
            a = int(rng.integers(0, max(L - 4000, 1)))
            b = min(a + int(rng.integers(2500, 4000)), L)
            r, _ = _sim_read(rng, true, a, b - a, bases, err, err, err)
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
            reads_all.append((i, r))
    idx = GenomeIndex.build(list(zip(names, drafts)), k=15, w=10)
    # the fixture maps on the host: its caller's device work is the polish
    recs = map_long_batch(idx, [r for _, r in reads_all], device="cpu")
    batch = records_to_batch(recs, idx)
    return names, drafts, batch
