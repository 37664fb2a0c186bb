"""Standalone long-read/HiFi consensus worker (lib/nextpolish2.py parity).

Bring-your-own-BAM workflow (doc/TUTORIAL.rst:128-150):

    python -m nextpolish_tpu_torch.worker2 -g genome.fa -l lgs.sort.bam.list \
        -r ont -o genome.polished.fa [--device cuda|cpu]

-l takes a file-of-filenames of sorted BAMs (merged in memory) or a single
BAM path.  -r in {ont, clr, hifi, rs}.  --device picks where the level
scan runs (default cuda: the first visible card, as the JAX package's
batcher launches on its first chip; cuda without a usable card raises).
NPT_CNS_ENGINE=device|native|numpy overrides the engine choice.
"""
from __future__ import annotations

import argparse
import os
import sys

from .device import resolve_devices
from .io.bam import AlnBatch, read_bam
from .io.fasta import FastaIndex
from .kit import parse_num_unit, plog
from .models.ctg_cns import ctg_cns_contig
from .pipeline import read_polished_names
from .runtime import trace

log = plog()


def merge_batches(paths: list[str]) -> AlnBatch:
    """In-memory k-way merge of sorted BAMs in the reference heap's
    emission order (bam_merge_iter role, lib/bsort.c:1202-1463)."""
    from .io.bamregion import merge_region_batches

    return merge_region_batches([read_bam(p) for p in paths])


def open_bam_source(paths: list[str]):
    """Streaming region fetcher when every BAM has a .bai; otherwise the
    whole-file in-memory merge (bounded-RAM data plane, SURVEY §7)."""
    if all(os.path.exists(p + ".bai") for p in paths):
        from .io.bamregion import RegionFetcher

        return RegionFetcher(paths)
    return merge_batches(paths)


def main(argv=None):
    """The worker's command line, all of it inside the `worker2` span."""
    with trace.timed("worker2"):
        return _main(argv)


def _main(argv):
    p = argparse.ArgumentParser(
        prog="nextpolish_tpu_torch.worker2",
        description="Polish a genome with long reads (tasks 5/6).",
    )
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-l", "--bam_list", required=True,
                   help="file of sorted-BAM paths, or a single BAM")
    p.add_argument("-r", "--read_type", required=True,
                   choices=["ont", "clr", "hifi", "rs"])
    p.add_argument("-o", "--out", default="stdout")
    # reference semantics (lib/nextpolish2.py:242-250): splitting is ON
    # by default in standalone mode; -sp turns it OFF
    p.add_argument("-sp", "--split", action="store_false", default=True,
                   help="do not split corrected contigs at structural "
                        "break points")
    p.add_argument("-w", "--window", type=str, default="5M")
    p.add_argument("-u", "--uppercase", action="store_true")
    p.add_argument("-p", "--process", type=int, default=1)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the level scan (default: cuda)")
    args, _ = p.parse_known_args(argv)
    device = resolve_devices(args.device)[0]

    if args.bam_list.endswith(".bam"):
        paths = [args.bam_list]
    else:
        d = os.path.dirname(os.path.abspath(args.bam_list))
        paths = []
        for line in open(args.bam_list):
            line = line.strip()
            if line:
                paths.append(line if line.startswith("/")
                             else os.path.join(d, line))
    batch = open_bam_source(paths)
    genome = FastaIndex(args.genome)
    from .runtime.budget import cns_window_len

    window, ram_clamped = cns_window_len(
        args.read_type, requested=parse_num_unit(args.window))
    if ram_clamped:
        log.warning("window clamped to %d by available memory", window)

    done = set()
    if args.out != "stdout":
        done = read_polished_names(args.out)
        out = open(args.out, "ab" if done else "wb")
    else:
        out = sys.stdout.buffer
    from .models.cns.window import default_engine
    from .runtime.overlap import pipelined_map

    # the device engine batches B windows per launch ACROSS contigs, so
    # the contig pipeline runs deep enough to keep its batches full (the
    # window loop is the reference's process axis, lib/nextpolish2.py:192)
    batcher = None
    depth = 2
    if default_engine(device) == "device":
        from .models.cns.batcher import CnsBatcher

        batcher = CnsBatcher(args.read_type, device=device)
        depth = max(2, batcher.B)

    def polish_one(name):
        rec = genome.fetch(name)
        return ctg_cns_contig(name, rec.seq, batch,
                              args.read_type, split=1 if args.split else 0,
                              window=window,
                              qv_desc=rec.comment or None, batcher=batcher,
                              device=device)

    todo = [n for n in genome.names if n not in done]
    for name in done & set(genome.names):
        log.warning("Skip polished seq: %s", name)
    for name, parts in zip(todo, pipelined_map(polish_one, todo,
                                               depth=depth)):
        for pname, seq in parts:
            if len(seq) <= 10:
                log.critical("polished seq %s is too short (%d bp)",
                             pname, len(seq))
            if args.uppercase:
                seq = seq.upper()
            out.write(b">" + pname.encode() + b" " + str(len(seq)).encode()
                      + b"\n" + seq + b"\n")
        out.flush()
    if args.out != "stdout":
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
