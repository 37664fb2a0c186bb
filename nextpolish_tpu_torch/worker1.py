"""Standalone short-read polishing worker (lib/nextpolish1.py parity), port
of nextpolish_tpu/worker1.py.

Bring-your-own-BAM workflow (doc/TUTORIAL.rst:50-82):

    python -m nextpolish_tpu_torch.worker1 -g genome.fa -s sgs.sort.bam \
        -t 1 -o genome.polishtemp.fa [--device cuda|cpu]
    # then re-map against the temp output and run -t 2

Tasks: 1=score_chain, 2=kmer_count, 3=snp_phase, 4=snp_valid, 5=legacy
lgspolish (the long-read chain engine; it reads -l, or -s in its place).
--device picks where the chain DPs run (default cuda; cuda without a
usable card raises): -t 1 sends its contigs round-robin over every
visible card (CUDA_VISIBLE_DEVICES restricts them), the other tasks run
on the first.  Output records are `>name len\\nseq` like the reference worker;
resume skips contigs already present in -o.  The flags are the JAX
worker's.
"""
from __future__ import annotations

import argparse
import os
import sys

from .device import resolve_devices
from .io.bam import read_bam
from .io.fasta import FastaIndex
from .kit import plog
from .models.kmer_count import kmer_count_contig
from .models.lgs_polish import lgspolish_contig
from .models.score_chain import (
    AlgoConfig,
    estimate_read_tlen,
    score_chain_pipeline,
)
from .models.snp_phase import snp_phase_contig
from .models.snp_valid import snp_valid_contig
from .pipeline import read_polished_names

log = plog()


def build_argparser():
    p = argparse.ArgumentParser(
        prog="nextpolish_tpu_torch.worker1",
        description="Polish a genome with short reads (tasks 1-4; "
                    "5 is the legacy long-read chain).",
    )
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-s", "--bam_sgs", help="sorted BAM of short reads")
    p.add_argument("-l", "--bam_lgs", help="sorted BAM of long reads "
                                           "(tasks 3/4)")
    p.add_argument("-t", "--task", type=int, required=True,
                   choices=[1, 2, 3, 4, 5])
    p.add_argument("-o", "--out", default="stdout")
    p.add_argument("-u", "--uppercase", action="store_true")
    p.add_argument("-debug", action="store_true",
                   help="output details of polished bases to stderr "
                        "(lib/nextpolish1.py -debug)")
    p.add_argument("-p", "--process", type=int, default=1,
                   help="accepted for CLI parity; device batching replaces "
                        "process pools")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the chain DPs (default: cuda)")
    # algorithm thresholds (same flags as the reference worker)
    a = p.add_argument_group("algorithm")
    a.add_argument("-min_map_quality", type=int, default=0)
    a.add_argument("-max_ins_len_sgs", type=int, default=10000)
    a.add_argument("-max_ins_fold_sgs", type=int, default=5)
    a.add_argument("-max_clip_ratio_sgs", type=float, default=0.15)
    a.add_argument("-max_clip_ratio_lgs", type=float, default=0.4)
    a.add_argument("-trim_len_edge", type=int, default=2)
    a.add_argument("-ext_len_edge", type=int, default=2)
    a.add_argument("-indel_balance_factor_sgs", type=float, default=0.5)
    a.add_argument("-min_count_ratio_skip", type=float, default=0.8)
    a.add_argument("-min_len_ldr", type=int, default=3)
    a.add_argument("-max_len_kmer", type=int, default=50)
    a.add_argument("-min_len_inter_kmer", type=int, default=5)
    a.add_argument("-max_count_kmer", type=int, default=50)
    a.add_argument("-ploidy", type=int, default=2)
    a.add_argument("-indel_balance_factor_lgs", type=float, default=0.33)
    a.add_argument("-min_depth_snp", type=int, default=3)
    a.add_argument("-min_count_snp", type=int, default=5)
    a.add_argument("-min_count_snp_link", type=int, default=5)
    a.add_argument("-max_indel_factor_lgs", type=float, default=0.21)
    a.add_argument("-max_snp_factor_lgs", type=float, default=0.53)
    a.add_argument("-min_snp_factor_sgs", type=float, default=0.34)
    return p


def open_contig_source(path):
    """Per-contig streaming when a .bai exists: peak RAM is a few contigs'
    reads, not the whole BAM (htslib bam_itr_queryi role,
    lib/contig.c:1010-1043)."""
    if path and os.path.exists(path + ".bai"):
        from .io.bamregion import IndexedBam

        return IndexedBam(path)
    return read_bam(path) if path else None


def per_contig(src, name, seqlen):
    """Resolve a BAM source to this contig's AlnBatch.  IndexedBam
    streams per region (htslib bam_itr_queryi role); an in-memory
    AlnBatch passes through — tasks 2-5 expect column arrays
    (batch.flag/tlen/mapq), not a streaming handle."""
    if src is not None and hasattr(src, "fetch"):
        return src.fetch(src.header.name2id(name), 0, max(seqlen - 1, 0))
    return src


def main(argv=None):
    args, _ = build_argparser().parse_known_args(argv)
    devices = resolve_devices(args.device)
    device = devices[0]
    cfg = AlgoConfig(
        trim_len_edge=args.trim_len_edge,
        ext_len_edge=args.ext_len_edge,
        min_map_quality=args.min_map_quality,
        indel_balance_factor_sgs=args.indel_balance_factor_sgs,
        min_count_ratio_skip=args.min_count_ratio_skip,
        min_len_ldr=args.min_len_ldr,
        min_len_inter_kmer=args.min_len_inter_kmer,
        max_len_kmer=args.max_len_kmer,
        max_count_kmer=args.max_count_kmer,
        indel_balance_factor_lgs=args.indel_balance_factor_lgs,
        max_clip_ratio_sgs=args.max_clip_ratio_sgs,
        max_clip_ratio_lgs=args.max_clip_ratio_lgs,
        max_ins_len_sgs=args.max_ins_len_sgs,
        max_ins_fold_sgs=args.max_ins_fold_sgs,
        min_depth_snp=args.min_depth_snp,
        min_count_snp=args.min_count_snp,
        min_count_snp_link=args.min_count_snp_link,
        ploidy=args.ploidy,
        max_indel_factor_lgs=args.max_indel_factor_lgs,
        max_snp_factor_lgs=args.max_snp_factor_lgs,
        min_snp_factor_sgs=args.min_snp_factor_sgs,
    )
    if args.debug:
        cfg.trace_sink = []
    genome = FastaIndex(args.genome)
    if args.task == 5:
        # legacy lgspolish: only the long-read BAM is required
        lgs = open_contig_source(args.bam_lgs or args.bam_sgs)
        sgs = None
    else:
        if not args.bam_sgs:
            log.critical("-s/--bam_sgs is required for tasks 1-4")
        sgs = open_contig_source(args.bam_sgs)
        head = sgs.fetch_head(10_000) if hasattr(sgs, "fetch_head") else sgs
        cfg.read_tlen = estimate_read_tlen(head, cfg)
        lgs = open_contig_source(args.bam_lgs) if args.bam_lgs else None

    def engine(n, s):
        """Tasks 2-5: one contig's polished bytes."""
        if args.task == 2:
            return kmer_count_contig(n, s, per_contig(sgs, n, len(s)), cfg,
                                     device)
        if args.task == 3:
            return snp_phase_contig(n, s, per_contig(sgs, n, len(s)),
                                    per_contig(lgs, n, len(s)), cfg,
                                    device)
        if args.task == 4:
            return snp_valid_contig(n, s, per_contig(sgs, n, len(s)),
                                    per_contig(lgs, n, len(s)), cfg)
        return lgspolish_contig(n, s, per_contig(lgs, n, len(s)), cfg)

    done = set()
    if args.out != "stdout":
        done = read_polished_names(args.out)
        out = open(args.out, "ab" if done else "wb")
    else:
        out = sys.stdout.buffer
    todo = []
    for name in genome.names:
        if name in done:
            log.warning("Skip polished seq: %s", name)
            continue
        todo.append(name)
    if args.task == 1:
        results = score_chain_pipeline(
            ((n, genome.fetch(n).seq) for n in todo), sgs, cfg,
            devices=devices)
    else:
        results = ((n, engine(n, genome.fetch(n).seq)) for n in todo)
    for name, seq in results:
        if args.uppercase:
            seq = seq.upper()
        out.write(b">" + name.encode() + b" " + str(len(seq)).encode()
                  + b"\n" + seq + b"\n")
        out.flush()
        if cfg.trace_sink:
            # `seq pos index curbase draftbase` per changed base
            # (lib/nextpolish1.py:230-231)
            for pname, pos, j, cur, old in cfg.trace_sink:
                print(f"{pname} {pos} {j} {cur} {old}", file=sys.stderr)
            cfg.trace_sink.clear()
    if args.out != "stdout":
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
