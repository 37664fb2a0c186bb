"""seq_split CLI (util/seq_split.c parity): split a read FOFN into n
balanced gzip chunks with length filtering, N-read removal (pairs dropped
together; >10% N-reads aborts, util/seq_split.c:345-349), and a total-base
cap.

Usage: python -m nextpolish_tpu_torch.seq_split [options] input.fofn
"""
from __future__ import annotations

import argparse
import gzip
import os
import sys

from .io.fasta import read_fastx
from .kit import parse_num_unit


def _files_of(fofn: str) -> list[str]:
    base = os.path.dirname(os.path.abspath(fofn))
    out = []
    for line in open(fofn):
        line = line.strip()
        if not line:
            continue
        out.append(line if os.path.isabs(line) else os.path.join(base, line))
    return out


def _units(files: list[str], interleave: bool):
    """Yield read groups: [rec] or an interleaved PE pair [r1, r2]."""
    if interleave and len(files) >= 2:
        it1, it2 = read_fastx(files[0]), read_fastx(files[1])
        for r1 in it1:
            r2 = next(it2, None)
            if r2 is None:
                break
            yield [r1, r2]
        for f in files[2:]:
            for r in read_fastx(f):
                yield [r]
    else:
        for f in files:
            for r in read_fastx(f):
                yield [r]


def split_reads(files: list[str], n: int, outdir: str, prefix: str,
                min_len: int = 50, max_len: int = 0, max_base: int = 0,
                interleave: bool = True, rm_nread: bool = True) -> list[str]:
    """split_data (util/seq_split.c:256-360): write `n` balanced gzip
    chunks named {prefix}.{i:03d}.fasta.gz; returns the chunk paths."""
    os.makedirs(outdir, exist_ok=True)
    paths = [os.path.join(outdir, f"{prefix}.{i + 1:03d}.fasta.gz")
             for i in range(n)]
    outs = [gzip.open(p, "wb", compresslevel=4) for p in paths]
    loads = [0] * n
    total = kept = n_reads = 0
    done = False
    for grp in _units(files, interleave):
        if done:
            break
        n_reads += len(grp)
        if rm_nread and any(b"N" in r.seq.upper() for r in grp):
            continue
        if any(len(r.seq) < min_len for r in grp):
            continue
        if max_len and any(len(r.seq) > max_len for r in grp):
            continue
        kept += len(grp)
        i = loads.index(min(loads))
        for r in grp:
            outs[i].write(b">" + r.name.encode() + b"\n" + r.seq + b"\n")
            loads[i] += len(r.seq)
            total += len(r.seq)
        if max_base and total >= max_base:
            done = True
    for o in outs:
        o.close()
    if rm_nread and n_reads and (n_reads - kept) > 0.1 * n_reads:
        sys.stderr.write(
            "Error! Too many reads (>10%) contain N bases — check the "
            "input, or rerun with -N to keep them.\n")
        raise SystemExit(1)
    sys.stderr.write(f"used reads: {kept}, used bases: {total}\n")
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="seq_split",
        description="split a FOFN into balanced gzip chunks "
                    "(util/seq_split.c:93-108 flags)")
    ap.add_argument("-t", dest="threads", type=int, default=8,
                    help="threads (accepted for compatibility) [8]")
    ap.add_argument("-m", dest="max_mem", default="500M",
                    help="max memory per thread (compatibility) [500M]")
    ap.add_argument("-i", dest="interleave", type=int, default=1,
                    help="interleave paired-end files [1]")
    ap.add_argument("-f", dest="min_len", default="50",
                    help="minimum read length [50]")
    ap.add_argument("-l", dest="max_len", default="0",
                    help="maximum read length [inf]")
    ap.add_argument("-s", dest="max_base", default="0",
                    help="total base number to output [inf]")
    ap.add_argument("-n", dest="subfile", type=int, default=10,
                    help="subfile number [10]")
    ap.add_argument("-N", dest="keep_n", action="store_true",
                    help="don't discard reads containing N bases")
    ap.add_argument("-p", dest="prefix", default="input.part",
                    help="prefix of subfiles [input.part]")
    ap.add_argument("-d", dest="outdir", default=os.getcwd(),
                    help="output directory [$CWD]")
    ap.add_argument("fofn", help="input fofn")
    args = ap.parse_args(argv)
    files = _files_of(args.fofn)
    for f in files:
        if not os.path.exists(f):
            sys.stderr.write(f"Error! {f} does not exist!\n")
            return 1
    paths = split_reads(
        files, args.subfile, args.outdir, args.prefix,
        min_len=int(parse_num_unit(args.min_len)),
        max_len=int(parse_num_unit(args.max_len)),
        max_base=int(parse_num_unit(args.max_base)),
        interleave=bool(args.interleave), rm_nread=not args.keep_n)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
