"""Long-read polishing cases with alignments known by construction.

A random `truth` genome is drawn; the `draft` is the truth with
substitutions only, so a read's exact alignment against the truth is also
a valid alignment against the draft and no mapper is needed.  Reads are
sampled from the truth with independent substitution, insertion and
deletion rates per truth base; half of them are flagged as reverse
strand (the BAM stores every read in reference orientation, so the flag
is the only trace of the strand).  Everything is drawn from one numpy
`default_rng(seed)`.
"""
from __future__ import annotations

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
                  sub: float, ins: float, dele: float):
    """One read over truth[start:start+length].  Returns (seq uint8 ASCII,
    cigar uint32 BAM words).  The first and last truth bases always
    match, so the CIGAR starts and ends with M."""
    seg = truth[start:start + length]
    n = len(seg)
    r = rng.random(n)
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
