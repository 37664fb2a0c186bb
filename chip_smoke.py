#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nextpolish_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 1] [--contigs 4] [--phases 1,2,...,11]

Phases (any failed check exits non-zero; nothing is caught):
  1. build   the engine-2 level-scan kernels (nvcc, sm_90a: the chain and
             the winners), task 1's chain-DP kernels (the forward scan and
             the traceback), the aligner's kernels (the banded DP and its
             traceback) and the native host library, all from the
             sources in this checkout, in parallel; each kernel's
             registers, shared memory and spills as ptxas reports them;
             the native library must hold the task-1 pileup walker;
  2. check   both kernels against their plain PyTorch versions on the
             card, byte for byte (the chain's per-entry scores, then the
             winners), for the ont/clr/rs/hifi rules: a batch of eight
             10-17 kb windows, and windows with E > 20, with Vb > 8 and
             with a 300-level insertion chain;
  3. main    the engine calibration's pick on this card and both probe
             rates (models/cns/calib.py), then worker2 -r ont --device cuda
             with NPT_CNS_ENGINE=device on a simulated bacterial-scale
             draft (--contigs x 600 kb, 30x ONT-like reads of 3-12 kb with
             3% each of substitutions, insertions and deletions); both
             kernels must have been launched, and the FASTA must be
             byte-equal to the port's own run with NPT_CNS_ENGINE=native
             (the copied C++ host engine).  Each engine then polishes the
             first contig alone, for a per-stage breakdown (trace spans).
             The main path's first launch group is re-run alone for each
             kernel's full-size time (ms per launch, us per level per
             window) beside its bounds: bytes/operations, and for the
             chain the latency bound (longest window's levels x one
             dependent shared-memory load -> store step, measured here,
             / the SM clock read during the run).  The group's shortest
             window, cut to its first 100,000 levels, is scanned by the
             plain versions, which must equal, byte for byte, both kernels
             on that prefix alone and the full-size launch's winners over
             it; and the group
             cut to its first 4,096 levels per window times each kernel
             beside its plain version on the same inputs;
  4. check   task 1's chain DP on the card, kernels against their plain
             versions (f bit for bit, the result bytes equal) on random
             pileup buffers: overflow entries, escaped totals, counts over
             the planes' cap, FMT 0 and 1, B = 4 rows of different n_dp in
             one launch, one- and two-chunk rows; and a 20 kb chain's
             result bytes equal to the f64 oracle slow_chain at rate 0.5;
  5. main    worker1 -t 1 --device cuda on a simulated bacterial genome
             (a 4,600,000 bp chromosome and plasmids of 100,000 and 50,000
             bp, paired-end 150 bp reads at 40x with 1% substitutions and
             0.2% each of insertions and deletions; draft = truth + 0.5%
             substitutions): both chain kernels must have been launched,
             every contig must have gone through the native walker, and
             every launch's buffer, recorded on the way, must give the same
             result bytes through the plain versions on the card, and every
             launch of each chain kernel the same f and choices as its
             plain version on the same card tensors; then the
             differences to the truth before and after polishing, and each
             kernel's time on the largest launch (CUDA events, and its
             device time as the aligner's kernels take it) beside its
             plain version and its bounds; the largest launch's whole DP
             (both kernels
             and the torch ops) re-run twice under torch.profiler, its
             summed kernel time printed as task1.dp_device_ms (the two
             readings must agree within 5%), then once more through the
             stage profiler (profile_chain.py): each chain.* stage's
             device time and share printed, and the line `task1.stages
             {json}`; the stages and `other` split that run's device
             events, so they add up to its whole by construction: the
             whole must lie within 5% of task1.dp_device_ms (a run of
             its own), `other` must hold under 5% of it, every fwd_*
             kernel must fall in chain.forward and every
             tb_* kernel in chain.traceback, and the profiled run's result
             bytes must equal the launch's; with phase 7, the reads of
             phase 7's genome written as r1/r2.fq.gz;
  6. main    on phase 5's BAM and output (it writes no BAM): (a) the
             chromosome alone through task 1's window route, forced
             in-process by lowering the single-launch cap to 2^20 cells
             (2^19-cell windows, about 9): its FASTA byte-equal to phase
             5's single launch, every window's scans equal to their plain
             versions, the windows, their device time, the host walk time
             and the peak device memory; (b) worker1 -t 2 --device cuda on
             phase 5's polished FASTA, as task=default chains the two
             tasks: every planes launch and every no-depth rescue batch,
             recorded on the way, equal to its plain re-run on the card
             (random rescue problems, R = 64 and Lb up to 1,024, stand in
             when the run has no rescue batch, and the phase says so), and
             every chain-kernel launch equal to its plain version (their
             (B, L) printed); the
             no-depth regions, the launches, the wall, bases/s, and the
             differences to the truth after task 2 beside those after
             task 1;
  7. main    the aligner and the run.cfg pipeline: (a) both aligner
             kernels against their plain versions on the card, byte for
             byte, in local, global and extend modes at the shapes of
             bench_band.SHAPES, the main path's (R, B) = (150, 32) with
             8,192 reads, (150, 1,150)
             (mate rescue), (4,096, 512) (the largest long-read segment
             bucket) and (1,000, 64) (end extensions), and at (150, 512)
             with 256 reads and (150, 544) (band_align's widest warp-route
             band, at the read count from which bands over 256 take that
             route, and the first band always on its block route), reads
             built to tie,
             and in each shape's main-path mode reads with one long indel
             (walks across many band columns); each shape timed (device
             time, launches queued behind a spin kernel; plain CUDA
             events around the launches beside) beside its plain version,
             its bytes/operations bound and its dependency
             bound (band_align: R rows of a neighbour exchange and a
             log2(B/K)-round shuffle scan; band_traceback: the longest
             walk, a dependent shared-memory load a step; cycles measured
             by extend.step_cycles, at the SM clock read beside it);
             (b) `python -m nextpolish_tpu_torch run.cfg --device cuda`
             with task = default (5, 1, 2) on phase 5's genome with the
             chromosome cut to its first 1,000,000 bp: phase 5's PE150
             reads of it (written by phase 5, not simulated again) and
             30x long reads of 3-12 kb with 3% each of substitutions,
             insertions and deletions (phase 3's error model), as
             FASTA.gz; the built-in mapper runs on the card every round.
             Printed: the stage walls (mapping and polish per task), the
             kernel launches of every kernel on the path, the aligner
             kernels' times (as in (a)) at the short-read shape and the
             largest long-read bucket, calib's pick with both rates,
             max_memory_allocated, and the differences to the truth after
             every round; every chain-kernel launch equals its plain
             version on the same card tensors; the aligner launches,
             recorded on the way, are
             re-run through the plain versions on the card (the first 20,
             one of every (mode, R, B) shape, then more while a time
             budget lasts; the count is printed) and must be equal;
  8. main    tasks 3, 4 and legacy 5 on a simulated diploid contig
             (sim.simulate_diploid_case: 600,000 bp, a heterozygous
             SNP a kb, PE150 at 40x in total from both haplotypes with
             phase 5's error model, 10 stretches of 400 bp without read
             starts, 30x long reads of 3-12 kb from both haplotypes with
             phase 3's error model; draft = hap1 + 0.5% substitutions),
             chained as users run them, all --device cuda: worker1 -t 1
             on the draft, -t 3 -l on its output, -t 4 -l on task 3's,
             -t 5 -l on the draft, and models.score_chain.
             td_score_chain_contig on the draft with the long reads (one
             launch over the contig at the lgs rate 0.33).  Each run of
             the last four is byte-equal to the same call with --device
             cpu in this process; every chain-kernel launch equals its
             plain version on the same card tensors; task 3 must launch
             the chain kernels (the holes' low-depth rescue) and its
             output must hold lowercase bases (task 4's input).  Printed:
             wall and bases/s, kernel and chain launches, cells and
             (B, L) per run, the het sites task 3 changed, lowercase
             before and after task 4, differences to hap1 and hap2;
  9. main    several processes: one run.cfg (task = 5,1, engine 2 on the
             card through NPT_CNS_ENGINE=device) on three contigs cut from
             phase 7(b)'s chromosome (105,000, 50,000 and 45,000 bp, so
             blc_genome gives rank 0 the first and rank 1 the others),
             phase 5's PE150 reads of them and 30x long reads (phase 7(b)'s
             depths), run as one process in this one (`python -m
             nextpolish_tpu_torch run.cfg --device cuda`, as 7(b) runs it)
             and as two ranks on this card (`python -m
             nextpolish_tpu_torch.launch --nprocs 2 run.cfg --device
             cuda`): the final FASTA and .stat byte-equal, both ranks'
             part files of both rounds non-empty, each rank's log naming
             this card, each rank's launches of level_chain, chain_forward
             and band_align above 0; task 1's chain launches of the ranks
             add up to the one process's, each rank's aligner launches
             equal the one process's (every rank maps every read, as the
             JAX package's ranks do) and the ranks' engine-2 windows add
             up to the one process's (a launch groups the windows in
             flight, so launches need not).  Every launch of the one
             process, recorded on the way, is held against its plain
             version on the card: each engine-2 window's first 16,384
             levels (both kernels on that prefix, and the launch's
             winners over it), every chain-kernel launch (f bit for bit,
             the choices byte for byte) and every aligner launch.
             Printed: both walls, every stage wall of each run, the
             launches of each rank and the differences to the truth;
 10. main    several cards in one process, as a device list that names
             this card twice (the machine has one card): (a) the task-1
             router score_chain_pipeline_multichip over [cuda:0, cuda:0]
             on phase 5's genome and BAM (fetched per contig), with its
             sharding threshold lowered in-process to 1,000,000 bp, so
             that the chromosome runs the reads-sharded route (two reads
             shards walked in two threads, merged per 2^19-cell window)
             and the plasmids go round-robin to the list's two entries:
             the FASTA byte-equal to phase 5's, one launch of each chain
             kernel a window and a plasmid, every launch held against
             its plain version; printed: the wall, each shard's walk, the
             per-window merge (CUDA events around the reduction), peak
             device memory and the launches; (b) engine 2's _run_batch
             over [cuda:0, cuda:0] on 17 of phase 2's simulated windows
             (groups of 8, 8 and 1 on entries 0, 1, 0), byte-equal to the
             same call over [cuda:0], each group's winners equal to the
             plain versions on its inputs;
 11. main    the port's dry run (dryrun.py), needing no earlier phase:
             entry("cuda")'s choices (the dense chain DP at L = 512) equal
             to the same call with plain=True, then dryrun_multichip(2,
             "cuda") over [cuda:0, cuda:0] (task 1's router with
             shard_min=0 against score_chain_contig on one entry, engine
             2's _run_batch on two 6 kb windows against one entry); each
             of the four kernels it reaches (chain_forward,
             chain_traceback, level_chain, level_winners) must have been
             launched, and every launch is held against its plain
             version; printed: the wall and the launches, which the
             kernels line lists under the path `phase 11: dryrun`.

Cuts, all of scale, none of shape: phase 3's number of contigs
(--contigs, 4 by default: 8 before the aligner's phase); phase 3's
plain check of a whole window became its first 100,000 levels, phase
9's of each window its first 16,384 (the plain chain takes about 0.2 ms
a level on the H100); phase 9's genome is cut from 400,000 to 200,000
bp (the script passed 1,050 s on a slow host); phase 7(b)'s
chromosome is cut to 1,000,000 bp (the host half of the mapper, about
0.2 ms a short read, would need about 500 s for the whole genome's two
short-read rounds).  Not a cut but time given back: phase 5's simulation
and BAM writing build their reads and records in bulk (sim.py's
_indel_reads, io/bam.py's _encode_records, BGZF blocks compressed on
several threads), the same bytes as the per-read build and per-record
writer before them (tests/test_torch_sim.py); phase 5 prints both
times.  Depth, read lengths and error rates are not cut;
phases 5 and 6 are not cut (phase 6(a) lowers the launch cap, not the
contig: a contig past the real cap needs about 10 M reads, which this
script's time limit cannot simulate); phase 8's heterozygous chromosome
is cut to 600,000 bp (1,000,000 took the phase 193.6 s, past the 150 s
it may take; its het rate, holes and depths are not cut).
--phases runs a subset (the build always runs; 6, 7, 9 and 10 need 5).

The last three lines are the kernels' JSON record (the level scan's two
kernels, one port of the TPU kernel; task 1's two chain kernels, whose
launches include phase 8's runs; the aligner's two kernels; with their
launches on each path, phase 9's process and ranks among them; each entry's
`timer` says what its `ms` is: CUDA events around the wrapper calls, or,
for the aligner's kernels, the device time), the card's name and power
limit, and
{"ok": true, "device": {...}}.  The script imports nothing of JAX or of
the JAX package, and exits non-zero without a result when no CUDA device
is usable.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT_OPS_PER_S = 67e12  # non-tensor fp32 rate; int32 ALU work rated so
CONTIG_LEN = 600_000  # bacterial scale: 8 x 600 kb = 4.8 Mb
DEPTH = 30
TRUNC_LEVELS = 4096  # levels per window of the kernel-vs-plain timing
KERNELS = ("level_chain", "level_winners")
TPU_KERNEL = "nextpolish_tpu/models/cns/pallas_scan.py:82"
SOURCE = "nextpolish_tpu_torch/csrc/level_scan.cu"
CHAIN_KERNELS = {  # name -> the JAX function it replaces (XLA, not Pallas)
    "chain_forward": "nextpolish_tpu/ops/tropical.py:104",
    "chain_traceback": "nextpolish_tpu/ops/tropical.py:191",
}
CHAIN_SOURCE = "nextpolish_tpu_torch/csrc/chain_scan.cu"
BAND_KERNELS = {  # name -> the JAX function it replaces (XLA, not Pallas)
    "band_align": "nextpolish_tpu/align/extend.py:30",
    "band_traceback": "nextpolish_tpu/align/extend.py:164",
}
BAND_SOURCE = "nextpolish_tpu_torch/csrc/band_align.cu"
# what the `ms` of a kernels-line entry is (its `timer`): CUDA events
# around the wrapper calls, or the aligner kernels' device time
# (bench_band.device_ms), which leaves out the wrapper's host time that
# events around a 10-40 us launch hold; the chain kernels carry both
EVENTS = "CUDA events around the wrapper calls"
DEVICE = "device time: launches queued behind a spin kernel"
PIPE_CHROM_BASES = 1_000_000  # phase 7(b)'s cut of the chromosome
PIPE_LONG_DEPTH = 30
REPLAY_BUDGET_S = 90.0  # phase 7(b)'s plain re-runs past the required ones
WINDOW_LEVELS = 100_000  # phase 3's plain check of one window's prefix
# task 1's main path: a chromosome and two plasmids, PE150 at 40x
TASK1_CONTIGS = (4_600_000, 100_000, 50_000)
TASK1_DEPTH = 40
# worst kernel-vs-plain difference seen, per kernel, over every check
ERR = dict.fromkeys(KERNELS + tuple(CHAIN_KERNELS) + tuple(BAND_KERNELS), 0)

RT_ERRORS = {  # (sub, ins, del) per read type of the kernel checks
    "ont": (0.03, 0.03, 0.03),
    "clr": (0.02, 0.05, 0.03),
    "rs": (0.02, 0.05, 0.03),
    "hifi": (0.002, 0.002, 0.002),
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def build_all():
    from nextpolish_tpu_torch import native
    from nextpolish_tpu_torch.align import extend as text
    from nextpolish_tpu_torch.models.cns import level_scan as ls
    from nextpolish_tpu_torch.ops import chain as tch

    out, errs = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            out[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:  # reported below, then the run fails
            errs.append(f"{name}: {e!r}")

    threads = [threading.Thread(target=run, args=("level_scan", ls.build)),
               threading.Thread(target=run, args=("chain_scan", tch.build)),
               threading.Thread(target=run, args=("band_align", text.build)),
               threading.Thread(target=run, args=("native", native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errs, "build failed: " + "; ".join(errs))
    check(native.available(), "native library did not load")
    check(hasattr(native._load(), "npt_pileup_planes"),
          "the native library has no npt_pileup_planes")
    check(hasattr(native._load(), "npt_chain_dp"),
          "the native library has no npt_chain_dp (the mapper's chaining)")
    for lib in ("level_scan", "chain_scan", "band_align"):
        info, secs = out[lib]
        log(f"build: {lib} nvcc {info['seconds']:.1f} s (wall {secs:.1f} s)")
        for name, props in ptxas_by_kernel(info["ptxas"]).items():
            log(f"  ptxas: {name}: {props}")
    log(f"build: native {out['native'][1]:.1f} s "
        f"({os.path.basename(out['native'][0])})")
    log(f"  level_chain dynamic shared memory {ls.chain_smem_bytes()} B "
        "per block")
    log('build: ' + json.dumps({"kernels": list(KERNELS)
                                + list(CHAIN_KERNELS)
                                + list(BAND_KERNELS)}))


def ptxas_by_kernel(text: str) -> dict:
    """ptxas -v output -> {kernel<template argument>: "Used N registers,
    ...; N bytes stack frame, N bytes spill stores, ..."}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(level_chain_kernel|level_winners_kernel|"
                          r"smem_step_probe|fwd_scan|"
                          r"tb_maps|tb_walk|tb_replay|"
                          r"band_align_kernel|band_traceback_kernel|"
                          r"band_step_probe)"
                          r"(?:I((?:L[bi]\d+E)+)E)?", m.group(1))
            args = (",".join(re.findall(r"L[bi](\d+)E", k.group(2)))
                    if k and k.group(2) else "")
            cur = (k.group(1) + (f"<{args}>" if args else "")
                   if k else m.group(1))
            out[cur] = []
        elif cur and ("spill" in line or "registers" in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain on the card
# ---------------------------------------------------------------------------

def sim_windows(tmp, rt, seed, lengths, depth, errors, read_len,
                hotspot=None):
    """Simulated windows (one per contig, whole contig) -> DenseWindows."""
    import numpy as np

    from nextpolish_tpu_torch import sim
    from nextpolish_tpu_torch.io.bam import read_bam
    from nextpolish_tpu_torch.models.cns.device_dp import prepare_window
    from nextpolish_tpu_torch.models.cns.window import window_prep

    sub, ins, dele = errors
    case = sim.simulate_case(seed, len(lengths), lengths, depth, read_len,
                             sub=sub, ins=ins, dele=dele, hotspot=hotspot)
    d = os.path.join(tmp, f"win_{rt}_{seed}")
    _, bam = sim.write_case(case, d)
    batch = read_bam(bam)
    dws = []
    for tid, draft in enumerate(case.drafts):
        ca = np.frombuffer(draft, dtype=np.uint8)
        work = window_prep(batch, tid, ca, 0, len(draft), rt, None,
                           case.names[tid])
        _, dw = prepare_window(work.merged, work.coverage, work.L)
        check(dw is not None, f"sim window {rt}/{seed}/{tid} refused")
        dws.append(dw)
    return dws


def max_err(pairs) -> int:
    return max((int((a.long() - b.long()).abs().max()) if a.numel() else 0)
               for a, b in pairs)


def compare(dws, rt, dev, label):
    """Both kernels vs their plain versions on the same device tensors:
    the chain's per-entry results, then the winners; byte-equal or
    fail."""
    import torch

    from nextpolish_tpu_torch.models.cns import level_scan as ls
    from nextpolish_tpu_torch.models.cns.device_dp import (
        READ_TYPE_ID,
        pack_batch,
    )
    from nextpolish_tpu_torch.models.cns.dp import COV_COEF

    b = pack_batch(dws).to(dev)
    rt_id, c = READ_TYPE_ID[rt], COV_COEF[rt]
    ki = ls.level_chain(b, rt_id, c)
    kb, ks = ls.level_winners(b, ki, rt_id)
    pi = ls.level_chain_plain(b, rt_id, c)
    pb, ps = ls.level_winners_plain(b, pi, rt_id)
    torch.cuda.synchronize(dev)
    e_chain = max_err([(ki, pi)])
    e_win = max_err([(kb, pb), (ks, ps)])
    ERR["level_chain"] = max(ERR["level_chain"], e_chain)
    ERR["level_winners"] = max(ERR["level_winners"], e_win)
    log(f"check {rt:4s} {label}: B={len(dws)} E={[dw.E for dw in dws]} "
        f"Vb={[dw.Vb for dw in dws]} levels={b.meta.numel()} "
        f"max_abs_err chain {e_chain} winners {e_win}")
    check(e_chain == 0 and torch.equal(ki, pi),
          f"level_chain kernel != plain for {rt} {label}")
    check(e_win == 0 and torch.equal(kb, pb) and torch.equal(ks, ps),
          f"level_winners kernel != plain for {rt} {label}")


def kernel_checks(tmp, dev, seed):
    special = [
        # E > 20: many predecessor contexts at a one-base insertion hotspot
        sim_windows(tmp, "ont", 0, [3000], 110, (0.05, 0.05, 0.05),
                    (1000, 3000), hotspot=(1500, 1, False)),
        # Vb > 8: reads ending at 1..12 insertion depths of one motif
        sim_windows(tmp, "ont", 1, [3000], 30, (0.03, 0.03, 0.03),
                    (1000, 3000), hotspot=(1500, 12, True)),
        # a deep insertion chain (up to 300 levels at one position)
        sim_windows(tmp, "ont", 2, [3000], 8, (0.03, 0.03, 0.03),
                    (1000, 3000), hotspot=(1500, 300, True)),
    ]
    special = [dw for dws in special for dw in dws]
    check(special[0].E > 20, f"E>20 window has E={special[0].E}")
    check(special[1].Vb > 8, f"Vb>8 window has Vb={special[1].Vb}")
    for k, rt in enumerate(RT_ERRORS):
        dws = sim_windows(tmp, rt, seed + 10 + k,
                          [10_000 + 1_000 * i for i in range(8)], 30,
                          RT_ERRORS[rt], (3000, 8000))
        compare(dws, rt, dev, "B=8 batch, 10-17 kb")
        compare(special, rt, dev, "E>20 / Vb>8 / deep chain")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def truncate(dw, n):
    """The window's first n levels (a prefix of the level scan is the scan
    of the prefix)."""
    n = min(n, dw.n_levels)
    keep = dw.ent_lvl < n
    return dataclasses.replace(
        dw, ent_lvl=dw.ent_lvl[keep], ent_b=dw.ent_b[keep],
        ent_slot=dw.ent_slot[keep], ent_A=dw.ent_A[keep],
        ent_M=dw.ent_M[keep], ent_same=dw.ent_same[keep],
        eorder=dw.eorder[keep], meta=dw.meta[:n],
        level_pos=dw.level_pos[:n], n_levels=n)


def bounds(batch, rows):
    """Least time of each kernel's work on an H100: bytes moved (each
    input read once, each output written once) over HBM bandwidth, and
    int32 operations over the non-tensor rate; the larger bounds it.
    `rows` is the chain's per-entry result rows (3 for ONT, else 2).
    Chain: per entry 12 operations (decode, weight, score, two carry
    writes) plus 3 per set match bit (gather, compare, max).  Winners: per
    entry 13 (the rule walk), per level and cell 4 (start and stores).
    Returns {kernel: (ms, "bytes" | "operations", bytes, ops)}."""
    import numpy as np

    ent_M = batch.ent_M.cpu().numpy().astype(np.uint32)
    pop = int(np.unpackbits(ent_M.view(np.uint8)).sum())
    Et, Lt = batch.ent_A.numel(), batch.meta.numel()
    lvl = (Lt + 1) * 4 + Lt * 4 + batch.win_host.size * 4
    work = {
        "level_chain": (Et * 10 + lvl + rows * Et * 4, Et * 12 + 3 * pop),
        "level_winners": (Et * 6 + rows * Et * 4 + lvl + Lt * 6
                          + batch.n_sc_rows * 6 * 4, Et * 13 + Lt * 6 * 4),
    }
    out = {}
    for k, (nbytes, ops) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_INT_OPS_PER_S * 1e3
        out[k] = (max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)
    return out


def sm_clock_mhz() -> float:
    """The SM clock now, as nvidia-smi reads it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return float(r.stdout.strip().splitlines()[0])


def calib_pick(dev) -> dict:
    """The engine calibration on this card (models/cns/calib.py, cached
    in NPT_CNS_CALIB for the rest of the run): its pick and both probe
    rates."""
    from nextpolish_tpu_torch.models.cns import calib

    t0 = time.perf_counter()
    eng = calib.choose_engine("ont", dev)
    secs = time.perf_counter() - t0
    rec = json.load(open(os.environ["NPT_CNS_CALIB"]))[
        calib._cache_key("ont", dev)]
    check(rec["engine"] == eng, "calib's cache disagrees with its pick")
    log(f"calib: picked the {eng} engine: probe rates device "
        f"{rec['device_bases_per_s']} bases/s, native "
        f"{rec['native_bases_per_s']} bases/s ({secs:.1f} s, "
        f"{calib._cache_key('ont', dev)})")
    return rec


def main_path(tmp, dev, args):
    import torch

    from nextpolish_tpu_torch import sim, worker2
    from nextpolish_tpu_torch.bench_band import time_ms
    from nextpolish_tpu_torch.models.cns import batcher as batcher_mod
    from nextpolish_tpu_torch.models.cns.device_dp import (
        READ_TYPE_ID,
        pack_batch,
    )
    from nextpolish_tpu_torch.models.cns import level_scan as ls
    from nextpolish_tpu_torch.models.cns.dp import COV_COEF
    from nextpolish_tpu_torch.runtime import trace

    t0 = time.perf_counter()
    case = sim.simulate_case(args.seed, args.contigs, CONTIG_LEN, DEPTH)
    fa, bam = sim.write_case(case, os.path.join(tmp, "main"))
    n_bases = sum(len(d) for d in case.drafts)
    log(f"main: simulated {args.contigs} x {CONTIG_LEN} bp = {n_bases} bp, "
        f"{len(case.records)} reads, BAM {os.path.getsize(bam)} B "
        f"({time.perf_counter() - t0:.1f} s)")

    # keep the first launch group's windows for the kernel timings below
    groups = []
    dispatch = batcher_mod.dispatch_group

    def recording_dispatch(dws, *a, **k):
        if not groups:
            groups.append(list(dws))
        return dispatch(dws, *a, **k)

    batcher_mod.dispatch_group = recording_dispatch
    pick = calib_pick(dev)
    out_dev = os.path.join(tmp, "main", "device.fa")
    os.environ["NPT_CNS_ENGINE"] = "device"
    trace.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    ls.level_chain.launches = 0
    ls.level_winners.launches = 0
    t0 = time.perf_counter()
    rc = worker2.main(["-g", fa, "-l", bam, "-r", "ont", "-o", out_dev,
                       "--device", "cuda"])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k: getattr(ls, k).launches for k in KERNELS}
    snap = trace.snapshot("cns")
    peak = torch.cuda.max_memory_allocated(dev)
    batcher_mod.dispatch_group = dispatch
    os.environ.pop("NPT_CNS_ENGINE")
    check(rc == 0, f"worker2 --device cuda returned {rc}")
    for k in KERNELS:
        check(launches[k] > 0, f"the main path launched {k} no time")

    def got(key):
        return snap.get(key, {}).get("s", 0)

    polished = sum(len(l) for l in open(out_dev, "rb").read().split(b"\n")
                   if l and not l.startswith(b">"))
    log(f"main: device engine wall {wall:.2f} s, {polished} polished bases,"
        f" {polished / wall:.0f} bases/s; kernel launches {launches}, "
        f"windows to the kernel {int(got('cns.windows'))}, windows densify "
        f"refused {int(got('cns.windows_host'))}, levels "
        f"{int(got('cns.levels'))}")
    log(f"main: kernel time (summed CUDA events, both kernels) "
        f"{got('cns.kernel') * 1e3:.1f} ms, host prep (cns.host) "
        f"{got('cns.host'):.2f} s, waits on the DP (cns.dp) "
        f"{got('cns.dp'):.2f} s, max_memory_allocated {peak} B")
    log("main: thread-summed spans: " + ", ".join(
        f"{k} {got(k):.2f} s" for k in ("cns.fetch", "cns.prep",
                                        "cns.densify", "cns.dp",
                                        "cns.finish")))
    check(got("cns.windows") > 0, "no window reached the kernel")

    out_nat = os.path.join(tmp, "main", "native.fa")
    os.environ["NPT_CNS_ENGINE"] = "native"
    t0 = time.perf_counter()
    rc = worker2.main(["-g", fa, "-l", bam, "-r", "ont", "-o", out_nat,
                       "--device", "cuda"])
    nat_wall = time.perf_counter() - t0
    os.environ.pop("NPT_CNS_ENGINE")
    check(rc == 0, f"worker2 (native engine) returned {rc}")
    a, b = open(out_dev, "rb").read(), open(out_nat, "rb").read()
    log(f"main: native engine wall {nat_wall:.2f} s; FASTA "
        f"{'byte-equal' if a == b else 'DIFFERENT'} ({len(a)} B)")
    faster = "device" if wall < nat_wall else "native"
    log(f"main: calib picked {pick['engine']} (probe: device "
        f"{pick['device_bases_per_s']}, native {pick['native_bases_per_s']}"
        f" bases/s); this phase measured the {faster} engine faster "
        f"(device {wall:.2f} s, native {nat_wall:.2f} s): "
        f"{'agrees' if faster == pick['engine'] else 'DISAGREES'}")
    check(a == b, "device-engine FASTA differs from the native engine's")
    truth_len = sum(len(t) for t in case.truths)
    log(f"main: polished length {polished} vs truth {truth_len}")

    # ---- one contig alone, both engines: where a window's time goes ------
    one_fa = os.path.join(tmp, "main", "one.fa")
    with open(one_fa, "wb") as fh:
        fh.write(b">" + case.names[0].encode() + b"\n" + case.drafts[0]
                 + b"\n")
    outs = []
    for eng in ("device", "native"):
        os.environ["NPT_CNS_ENGINE"] = eng
        outs.append(os.path.join(tmp, "main", f"one_{eng}.fa"))
        trace.reset()
        t0 = time.perf_counter()
        rc = worker2.main(["-g", one_fa, "-l", bam, "-r", "ont", "-o",
                           outs[-1], "--device", "cuda"])
        torch.cuda.synchronize(dev)
        one_wall = time.perf_counter() - t0
        check(rc == 0, f"worker2 on one contig ({eng}) returned {rc}")
        snap = trace.snapshot("cns")
        log(f"main: one {CONTIG_LEN} bp contig alone, {eng} engine: wall "
            f"{one_wall:.2f} s; " + ", ".join(
                f"{k} {got(k):.3f} s" for k in (
                    "cns.fetch", "cns.prep", "cns.densify", "cns.dp",
                    "cns.kernel", "cns.finish", "cns.host")))
    os.environ.pop("NPT_CNS_ENGINE")
    check(open(outs[0], "rb").read() == open(outs[1], "rb").read(),
          "one-contig device and native FASTA differ")

    # ---- the kernels at the main path's shapes ---------------------------
    check(groups, "no launch group recorded")
    dws = groups[0]
    rt_id, c = READ_TYPE_ID["ont"], COV_COEF["ont"]
    rows = ls.inter_rows(rt_id)
    full = pack_batch(dws, sc_tail=True).to(dev)
    lv = full.meta.numel()
    longest = max(dw.n_levels for dw in dws)
    res = {}
    ls.level_chain(full, rt_id, c)  # warm-up
    # three chains in flight while nvidia-smi reads the SM clock
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        res["inter"] = ls.level_chain(full, rt_id, c)
    t1.record()
    mhz = sm_clock_mhz()
    torch.cuda.synchronize(dev)
    full_ms = {"level_chain": t0.elapsed_time(t1) / 3}
    full_ms["level_winners"] = time_ms(
        lambda: res.update(full=ls.level_winners(full, res["inter"], rt_id)),
        dev, 3)
    step = ls.smem_step_cycles(dev)
    chain_bound_ms = longest * step / (mhz * 1e6) * 1e3
    fb = bounds(full, rows)
    log(f"main: the main path's first group (B={len(dws)}, "
        f"E={[dw.E for dw in dws]}, Vb={[dw.Vb for dw in dws]}, {lv} "
        f"levels, longest window {longest}, {full.ent_A.numel()} entries); "
        f"SM clock {mhz:.0f} MHz during the chain, one dependent "
        f"shared-memory load -> store step {step} cycles")
    for k in KERNELS:
        log(f"main: {k}: {full_ms[k]:.3f} ms per launch, "
            f"{full_ms[k] * 1e3 * len(dws) / lv:.4f} us per level per "
            f"window, {full_ms[k] * 1e3 / longest:.4f} us per level of the "
            f"longest window; bound {fb[k][0]:.4f} ms ({fb[k][1]})"
            + (f", chain bound {chain_bound_ms:.3f} ms ({longest} levels x "
               f"{step} cycles / {mhz:.0f} MHz)" if k == "level_chain"
               else ""))

    # the group's shortest window, its first WINDOW_LEVELS levels, against
    # the plain versions (a prefix of the level scan is the scan of the
    # prefix)
    i = min(range(len(dws)), key=lambda j: dws[j].n_levels)
    cut = truncate(dws[i], WINDOW_LEVELS)
    one = pack_batch([cut]).to(dev)  # every level's scores kept
    ki1 = ls.level_chain(one, rt_id, c)
    kb1, ks1 = ls.level_winners(one, ki1, rt_id)
    t0 = time.perf_counter()
    pi1 = ls.level_chain_plain(one, rt_id, c)
    pb1, ps1 = ls.level_winners_plain(one, pi1, rt_id)
    torch.cuda.synchronize(dev)
    cut_plain_s = time.perf_counter() - t0
    fb_ = res["full"][0]
    lb = int(full.win_host[i, 0])
    nl = cut.n_levels
    win_pairs = [(kb1, pb1), (ks1, ps1), (fb_[lb:lb + nl], pb1)]
    e_chain, e_win = max_err([(ki1, pi1)]), max_err(win_pairs)
    log(f"main: window {i} of that group, its first {nl} of "
        f"{dws[i].n_levels} levels (E={dws[i].E}, Vb={dws[i].Vb}): plain "
        f"{cut_plain_s:.1f} s; kernels alone and the full-size launch's "
        f"winners vs plain: max_abs_err chain {e_chain}, winners {e_win}")
    check(e_chain == 0 and torch.equal(ki1, pi1),
          "level_chain kernel != plain on a main-path window prefix")
    check(e_win == 0 and all(torch.equal(a, b) for a, b in win_pairs),
          "level_winners kernel != plain on a main-path window prefix")
    ERR["level_chain"] = max(ERR["level_chain"], e_chain)
    ERR["level_winners"] = max(ERR["level_winners"], e_win)
    del one, ki1, kb1, ks1, pi1, pb1, ps1, win_pairs

    # the group cut to its first TRUNC_LEVELS levels: kernels vs plain
    trunc = pack_batch([truncate(dw, TRUNC_LEVELS) for dw in dws]).to(dev)
    ki = ls.level_chain(trunc, rt_id, c)  # warm-up
    ls.level_winners(trunc, ki, rt_id)
    ms = {"level_chain": time_ms(lambda: ls.level_chain(trunc, rt_id, c),
                                 dev, 3),
          "level_winners": time_ms(lambda: ls.level_winners(trunc, ki, rt_id),
                                   dev, 3)}
    plain_ms = {
        "level_chain": time_ms(lambda: res.update(
            pi=ls.level_chain_plain(trunc, rt_id, c)), dev, 1),
        "level_winners": time_ms(lambda: res.update(
            pw=ls.level_winners_plain(trunc, res["pi"], rt_id)), dev, 1)}
    kb, ks = ls.level_winners(trunc, ki, rt_id)
    torch.cuda.synchronize(dev)
    e_chain = max_err([(ki, res["pi"])])
    e_win = max_err([(kb, res["pw"][0]), (ks, res["pw"][1])])
    check(e_chain == 0 and e_win == 0,
          "kernels != plain on the main path's windows")
    tb = bounds(trunc, rows)
    for k in KERNELS:
        log(f"main: first {TRUNC_LEVELS} levels of each window "
            f"({trunc.meta.numel()} levels): {k} {ms[k]:.3f} ms, plain "
            f"{plain_ms[k]:.1f} ms, bound {tb[k][0]:.5f} ms ({tb[k][1]}: "
            f"{tb[k][2]} B, {tb[k][3]} ops)")
    recs = []
    for k in KERNELS:
        rec = dict(name=k, route="cuda", source=SOURCE, replaces=TPU_KERNEL,
                   launches=launches[k], max_abs_err=ERR[k], ms=ms[k],
                   plain_ms=plain_ms[k], bound_ms=tb[k][0],
                   bound_by=tb[k][1], library_ms=None, timer=EVENTS,
                   full_group_ms=full_ms[k],
                   full_group_bound_ms=fb[k][0])
        if k == "level_chain":
            rec["full_group_chain_bound_ms"] = chain_bound_ms
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# phase 4: task 1's chain kernels vs plain on the card
# ---------------------------------------------------------------------------

class capture_scans:
    """While active, ops.chain's two scan wrappers record their inputs on
    the way to the kernels, every call.  `.orig` holds the wrappers.  A
    wrapper counts its launches on the module's name for it, so while the
    recorders stand in for the wrappers the counts live on the recorders
    and go back to the wrappers on exit."""

    def __init__(self):
        from nextpolish_tpu_torch.ops import chain as tch

        self.tch = tch
        self.orig = (tch.forward_states, tch.traceback_batch)
        self.fwd, self.tb = [], []

    def __enter__(self):
        fwd, tb = self.orig

        def rec_fwd(A, s0, chunk=128):
            self.fwd.append((A, s0))
            return fwd(A, s0, chunk)

        def rec_tb(P, b_end, chunk=128):
            self.tb.append((P, b_end))
            return tb(P, b_end, chunk)

        rec_fwd.launches, rec_tb.launches = fwd.launches, tb.launches
        self.tch.forward_states, self.tch.traceback_batch = rec_fwd, rec_tb
        return self

    def __exit__(self, *exc):
        fwd, tb = self.orig
        fwd.launches = self.tch.forward_states.launches
        tb.launches = self.tch.traceback_batch.launches
        self.tch.forward_states, self.tch.traceback_batch = self.orig


def hold_scans(cap, dev, label):
    """Each captured scan's kernel against its plain version on the same
    card tensors: f bit for bit, the choices byte for byte."""
    import torch

    tch = cap.tch
    fwd, tb = cap.orig
    for A, s0 in cap.fwd:
        fk, fp = fwd(A, s0), tch.forward_states_plain(A, s0)
        torch.cuda.synchronize(dev)
        err = float((fk.double() - fp.double()).abs().max())
        ERR["chain_forward"] = max(ERR["chain_forward"], err)
        check(torch.equal(fk.view(torch.int32), fp.view(torch.int32)),
              f"chain_forward kernel != plain ({label}, A "
              f"{tuple(A.shape)}, max_abs_err {err})")
    for P, b_end in cap.tb:
        ck, cp = tb(P, b_end), tch.traceback_batch_plain(P, b_end)
        torch.cuda.synchronize(dev)
        err = int((ck.int() - cp.int()).abs().max())
        ERR["chain_traceback"] = max(ERR["chain_traceback"], err)
        check(torch.equal(ck, cp), f"chain_traceback kernel != plain "
              f"({label}, P {tuple(P.shape)})")


def chain_case(dev, label, bufs, key):
    """One launch of the DP on the card, kernels against plain: the
    result bytes, and each scan's f / choices."""
    import numpy as np
    import torch

    from nextpolish_tpu_torch.ops import chain as tch

    dbuf = torch.from_numpy(np.stack(bufs).view(np.int16)).to(dev)
    with capture_scans() as cap:
        got = tch.chain_correct_planes_batch(dbuf, *key)
    want = tch.chain_correct_planes_batch(dbuf, *key, plain=True)
    torch.cuda.synchronize(dev)
    check(len(cap.fwd) == 1 and len(cap.tb) == 1,
          f"{label}: expected one launch of each chain kernel")
    hold_scans(cap, dev, label)
    L, Emax, EOV, ET, FMT, TH, PS = key
    log(f"check task1 {label}: B={len(bufs)} L={L} Emax={Emax} EOV={EOV} "
        f"ET={ET} FMT={FMT}: result bytes "
        f"{'equal' if torch.equal(got, want) else 'DIFFERENT'}")
    check(torch.equal(got, want), f"chain DP kernels != plain ({label})")
    return got.cpu().numpy()


def chain_checks(dev, seed):
    import numpy as np
    import torch

    from nextpolish_tpu_torch import sim
    from nextpolish_tpu_torch.ops import chain as tch

    def packed(n_dp, per, heavy=0, big=False, rolling=False, s=0, t0=None):
        uk, cn, rk, refkmer, total = sim.random_pileup(
            seed + s, n_dp, per, heavy, big, rolling)
        if t0 is not None:
            total[0] = t0  # one TH bucket across rows
        buf, *key = tch.pack_chain_planes(uk, cn, rk, refkmer, total, n_dp,
                                          0.5)
        return buf, tuple(key)

    cases = {
        "overflow entries (EOV > 0), FMT 1": packed(1500, 4, heavy=40),
        "escaped totals (ET > 0), counts over CNT_CAP": packed(
            1500, 2, big=True, s=1),
        "FMT 0 (rolling draft kmers)": packed(3000, 3, rolling=True, s=2),
        "one chunk (n_dp 100)": packed(100, 3, rolling=True, s=3),
        "two chunks (n_dp 200)": packed(200, 3, s=4),
    }
    for label, (buf, key) in cases.items():
        chain_case(dev, label, [buf], key)
    L, Emax, EOV, ET, FMT, TH, PS = cases[
        "overflow entries (EOV > 0), FMT 1"][1]
    check(EOV > 0, "no overflow case")
    check(cases["escaped totals (ET > 0), counts over CNT_CAP"][1][3] > 0,
          "no escaped-total case")
    check(cases["FMT 0 (rolling draft kmers)"][1][4] == 0, "no FMT 0 case")
    check(cases["one chunk (n_dp 100)"][1][0] == 128
          and cases["two chunks (n_dp 200)"][1][0] == 256,
          "no one- and two-chunk cases")
    rows = [packed(1100 - 8 * b, 4, heavy=10, s=10 + b, t0=97)
            for b in range(4)]
    check(len({k for _, k in rows}) == 1, "B=4 rows span shape buckets")
    chain_case(dev, "B=4 rows, n_dp 1100..1076", [b for b, _ in rows],
               rows[0][1])

    # a 20 kb chain-connected pileup (the draft kmer chain at depth plus
    # noise kmers, the draft kmer first) against the f64 oracle
    rng = np.random.default_rng(seed)
    n_dp = 20_000
    sym = rng.integers(1, 6, n_dp)
    refkmer = ((np.concatenate([[0, 0], sym[:-2]]) << 6)
               | (np.concatenate([[0], sym[:-1]]) << 3) | sym)
    counts = np.zeros((n_dp, 512), dtype=np.int64)
    counts[np.arange(n_dp), refkmer] = rng.integers(5, 30, n_dp)
    for c in range(n_dp):
        for _ in range(int(rng.integers(0, 3))):
            k = ((int(refkmer[c]) & ~7) | int(rng.integers(1, 6))
                 if rng.random() < 0.5 else int(rng.integers(0, 512)))
            counts[c, k] += int(rng.integers(1, 12))
    total = counts.sum(axis=1).astype(np.int32)
    uk = np.flatnonzero(counts.reshape(-1)).astype(np.int64)
    ucell = uk // 512
    rk = np.arange(len(uk)) - np.searchsorted(ucell, ucell)
    r_ref = rk[(uk % 512) == refkmer[ucell]][ucell]
    rk = np.where(rk == r_ref, 0, rk + (rk < r_ref))
    rank = np.full((n_dp, 512), 0xFFFF, dtype=np.uint16)
    rank.reshape(-1)[uk] = rk
    t0 = time.perf_counter()
    want = tch.slow_chain(counts, refkmer.astype(np.int32), total, 0.5,
                          rank=rank)
    slow_s = time.perf_counter() - t0
    buf, *key = tch.pack_chain_planes(uk, counts.reshape(-1)[uk],
                                      rk.astype(np.uint16),
                                      refkmer.astype(np.int32), total, n_dp,
                                      0.5)
    got = chain_case(dev, "20 kb chain", [buf], tuple(key))[0][:n_dp] & 7
    diff = int(np.count_nonzero(got != want))
    log(f"check task1 20 kb chain vs slow_chain (f64, {slow_s:.1f} s): "
        f"{diff} cells differ of {n_dp}")
    check(diff == 0, "chain DP on the card != slow_chain at rate 0.5")


# ---------------------------------------------------------------------------
# phase 5: task 1's main path
# ---------------------------------------------------------------------------

def edit_distance(a: bytes, b: bytes) -> int:
    """Levenshtein distance, one numpy row per base of a."""
    import numpy as np

    a = np.frombuffer(a, dtype=np.uint8)
    b = np.frombuffer(b, dtype=np.uint8)
    idx = np.arange(len(b) + 1)
    prev = idx.copy()
    for i in range(1, len(a) + 1):
        x = np.empty(len(b) + 1, dtype=np.int64)
        x[0] = i
        x[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        prev = np.minimum.accumulate(x - idx) + idx
    return int(prev[-1])


def differences(truth: bytes, seq: bytes, step: int = 2000) -> int:
    """Edit distance of seq to truth for near-identical, colinear
    sequences: exact 32-base anchors of the truth every `step` bases are
    found near their expected place in seq, and the segments between
    anchors are compared (equal lengths with few mismatches by Hamming
    distance, others by edit distance)."""
    import numpy as np

    seq = seq.upper()
    anchors = [(0, 0)]
    off = 0
    for p in range(step, len(truth) - 32, step):
        q = seq.find(truth[p:p + 32], max(0, p + off - 500), p + off + 532)
        if q >= 0:
            anchors.append((p, q))
            off = q - p
    anchors.append((len(truth), len(seq)))
    total = 0
    for (p0, q0), (p1, q1) in zip(anchors[:-1], anchors[1:]):
        a, b = truth[p0:p1], seq[q0:q1]
        if len(a) == len(b):
            d = int(np.count_nonzero(np.frombuffer(a, np.uint8)
                                     != np.frombuffer(b, np.uint8)))
            if d <= 20:
                total += d
                continue
        total += edit_distance(a, b)
    return total


def profiled_device_ms(fn, dev):
    """One call of fn under torch.profiler (CPU and CUDA activity): the
    summed device time of every kernel it ran (ms) and that time per
    kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nextpolish_tpu_torch.profile_chain import device_events

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    per = {}
    # kernels, memsets and copies: not the GPU-side copies of ops/chain.py's
    # chain.* ranges, which span kernels already counted
    for e in device_events(prof):
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    check(per, "torch.profiler recorded no device time")
    return sum(per.values()), per


def chain_bounds(B: int, L: int, step_cycles: int, mhz: float) -> dict:
    """Least time of each chain kernel's work on an H100: bytes moved (each
    input read once, each output written once) over HBM bandwidth, and
    operations over the non-tensor fp32 rate (the traceback's integer
    work rated so); the larger bounds it.  Forward: per cell one 8x8
    (max,+) product (512 adds, 448 maxes) and its renormalisation (63
    maxes, 64 subtractions) in phase 1, 64 adds and 56 maxes in the
    replay, and two products per chunk in the tree.  Traceback: per cell
    about 100 integer operations (pack a row, compose eight 3-bit fields,
    one replay step).  Also the dependency bound: 128 + 2 log2(chunks) +
    128 dependent steps, each one dependent shared-memory load -> store
    (measured here) at the SM clock.  Returns {kernel: (ms, bound_by,
    bytes, ops)} and the dependency bound in ms."""
    nch = L // 128
    prod = 512 + 448
    work = {
        "chain_forward": (B * (L * 256 + 32 + L * 32),
                          B * (L * (prod + 127 + 120) + 2 * nch * prod)),
        "chain_traceback": (B * (L * 32 + 4 + L), B * L * 100),
    }
    out = {}
    for k, (nbytes, ops) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_INT_OPS_PER_S * 1e3
        out[k] = (max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)
    depth = 256 + 2 * (nch.bit_length() - 1)
    return out, depth * step_cycles / (mhz * 1e6) * 1e3


def stage_split(big, dev, dp_ms):
    """The largest launch's DP (`big`: its buffers, key and launch) once
    more through the stage profiler: each chain.* stage's device time and
    share, the line `task1.stages {json}`, and the checks.  The stages and
    `other` split the run's device events, so they add up to its whole
    by construction; the checks are that whole within 5% of
    task1.dp_device_ms (an earlier run of the same buffer), `other` under
    5% of it, every fwd_* kernel in chain.forward and every tb_* kernel
    in chain.traceback, the result bytes equal to the launch's."""
    import numpy as np

    from nextpolish_tpu_torch import profile_chain as pc

    t0 = time.perf_counter()
    report, result = pc.profile_stages(big[0], big[1], dev)
    stages, whole = report["stages"], report["whole_ms"]
    for line in pc.format_report(report):
        log(f"task1 stages: {line}")
    log(f"task1 stages: the profiled whole {whole:.3f} ms; "
        f"task1.dp_device_ms {dp_ms:.3f} "
        f"ms; each stage's share of it: " + ", ".join(
            f"{s} {v['ms'] / dp_ms * 100:.1f}%" for s, v in stages.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    log("task1.stages " + json.dumps({
        "B": report["B"], "L": report["L"], "whole_ms": whole,
        "dp_device_ms": dp_ms,
        "stages": {s: {"ms": v["ms"], "share": v["share"], "top": v["top"]}
                   for s, v in stages.items()}}))
    check(abs(whole - dp_ms) <= 0.05 * dp_ms,
          f"the profiled whole {whole} ms is not within 5% of "
          f"task1.dp_device_ms {dp_ms} ms: the profiler lost kernels")
    check(stages[pc.OTHER]["share"] < 0.05,
          f"{stages[pc.OTHER]['share'] * 100:.1f}% of the DP's device time "
          f"is in no stage: {stages[pc.OTHER]['top']}")
    for stage, tag in (("chain.forward", "fwd_"),
                       ("chain.traceback", "tb_")):
        where = {s for s, v in stages.items()
                 for n in v["kernels"] if tag in n}
        check(where == {stage}, f"{tag}* kernels in {sorted(where)}, not "
              f"in {stage} alone")
    same = np.array_equal(result, big[2].wait())
    log(f"task1 stages: the profiled run's result bytes "
        f"{'equal' if same else 'DIFFERENT'} to the launch's")
    check(same, "the profiled DP's result differs from the launch's")
    return report


def task1_main_path(tmp, dev, args, ctx):
    import numpy as np
    import torch

    from nextpolish_tpu_torch import sim, worker1
    from nextpolish_tpu_torch.bench_band import device_ms, time_ms
    from nextpolish_tpu_torch.models import score_chain as sc
    from nextpolish_tpu_torch.models.cns import level_scan as ls
    from nextpolish_tpu_torch.ops import chain as tch
    from nextpolish_tpu_torch.runtime import trace

    t0 = time.perf_counter()
    case = sim.simulate_short_case(args.seed, TASK1_CONTIGS, TASK1_DEPTH)
    t1 = time.perf_counter()
    fa, bam = sim.write_case(case, os.path.join(tmp, "task1"))
    n_reads = len(case.records)
    if 7 in args.phase_set:
        # phase 7's genome: the chromosome's first PIPE_CHROM_BASES bases
        # and the plasmids, with the fragments that lie inside them
        ctx["pipe_sgs"] = [r for r in case.records if r["tid"] != 0 or max(
            r["pos"], r["mpos"]) + 200 <= PIPE_CHROM_BASES]
    if 9 in args.phase_set:
        # phase 9's contigs: pieces of the chromosome, with the fragments
        # that lie inside one of them
        ctx["multi_sgs"] = [r for r in case.records if r["tid"] == 0 and any(
            a <= min(r["pos"], r["mpos"]) and max(r["pos"], r["mpos"]) + 200
            <= b for a, b in MULTI_PIECES)]
    case.records = None  # the BAM holds them now
    log(f"task1: simulated {len(TASK1_CONTIGS)} contigs, "
        f"{sum(TASK1_CONTIGS)} bp, {n_reads} PE150 reads at {TASK1_DEPTH}x "
        f"({t1 - t0:.1f} s), BAM {os.path.getsize(bam)} B "
        f"({time.perf_counter() - t1:.1f} s)")

    # every launch's buffer and result, recorded on the way
    launches_rec = []
    dispatch = sc.dispatch_chain_group

    def recording_dispatch(handles, device=None):
        bufs = np.stack([h.buf for h in handles])
        dispatch(handles, device)
        launches_rec.append((bufs, handles[0].key, handles[0].launch,
                             [h.name for h in handles]))

    out = os.path.join(tmp, "task1", "polished.fa")
    sc.dispatch_chain_group = recording_dispatch
    try:
        with capture_scans() as cap:
            trace.reset("task1")
            torch.cuda.reset_peak_memory_stats(dev)
            zero_chain_launches()
            t0 = time.perf_counter()
            rc = worker1.main(["-g", fa, "-s", bam, "-t", "1", "-o", out,
                               "--device", "cuda"])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = chain_launches()
            snap = trace.snapshot("task1")
            peak = torch.cuda.max_memory_allocated(dev)
    finally:
        sc.dispatch_chain_group = dispatch
    check(rc == 0, f"worker1 -t 1 --device cuda returned {rc}")
    for k, n in launches.items():
        check(n > 0, f"the task-1 main path launched {k} no time")

    def got(key):
        return snap.get(key, {}).get("s", 0)

    walks = int(got("task1.native_walks"))
    log(f"task1: native walks {walks} of {len(TASK1_CONTIGS)} contigs")
    check(walks == len(TASK1_CONTIGS),
          "a contig of the main path missed the native walker")
    fasta = open(out, "rb").read().split(b"\n")
    polished = dict(zip((h[1:].split(b" ")[0].decode() for h in fasta[0::2]),
                        fasta[1::2]))
    n_pol = sum(len(s) for s in polished.values())
    log(f"task1: worker1 wall {wall:.2f} s, {n_pol} polished bases, "
        f"{n_pol / wall:.0f} bases/s; kernel launches {launches}; chain "
        f"launches {int(got('task1.chain_launches'))}, cells "
        f"{int(got('task1.chain_cells'))}; device DP (task1.kernel, summed "
        f"CUDA events) {got('task1.kernel') * 1e3:.1f} ms; "
        f"max_memory_allocated {peak} B")
    cells_max = max(h[1][0] * len(h[0]) for h in launches_rec)
    log(f"task1: max_memory_allocated {peak / cells_max:.1f} B a cell of "
        f"the largest launch ({cells_max} cells; the routing budget "
        f"LAUNCH_BYTES_PER_CELL is {sc.LAUNCH_BYTES_PER_CELL})")
    check(peak <= cells_max * sc.LAUNCH_BYTES_PER_CELL,
          "task 1's peak device memory passed LAUNCH_BYTES_PER_CELL a cell")
    log("task1: spans (s, thread-summed): " + ", ".join(
        f"{k} {got(k):.3f}" for k in (
            "task1.host", "task1.fetch", "task1.walk", "task1.pack",
            "task1.dispatch", "task1.wait")))
    ctx.update(fa=fa, bam=bam, out=out, polished=polished, case=case,
               launches=launches, diffs={}, seed=args.seed)
    for name, truth, draft in zip(case.names, case.truths, case.drafts):
        check(name in polished, f"{name} missing from the output")
        before = differences(truth, draft)
        after = differences(truth, polished[name])
        ctx["diffs"][name] = after
        log(f"task1: {name} ({len(truth)} bp): differences to the truth "
            f"{before} in the draft, {after} after polishing "
            f"(lowercase {sum(1 for c in polished[name] if c >= 97)})")

    # every launch again through the plain versions on the card
    for bufs, key, launch, names in launches_rec:
        dbuf = torch.from_numpy(bufs.view(np.int16)).to(dev)
        plain = tch.chain_correct_planes_batch(dbuf, *key, plain=True)
        same = np.array_equal(plain.cpu().numpy(), launch.wait())
        log(f"task1: launch {names} (L={key[0]}): result bytes "
            f"{'equal' if same else 'DIFFERENT'} through the plain versions")
        check(same, f"task-1 launch {names} differs from the plain versions")
        del dbuf, plain
    # every launch's scans: kernel vs plain, bit for bit; the largest timed
    hold_scans(cap, dev, "main path")
    log(f"task1: {len(cap.tb)} chain_traceback launches (B, L) "
        f"{[tuple(P.shape[:2]) for P, _ in cap.tb]} equal to "
        "traceback_batch_plain")
    fwd, tb = cap.orig
    (A, s0), (P, b_end) = (max(x, key=lambda a: a[0].shape[:2].numel())
                           for x in (cap.fwd, cap.tb))
    del cap
    B, L = A.shape[0], A.shape[1]
    fwd(A, s0), tb(P, b_end)  # warm-up
    ms = {"chain_forward": time_ms(lambda: fwd(A, s0), dev, 5),
          "chain_traceback": time_ms(lambda: tb(P, b_end), dev, 5)}
    # on the aligner kernels' timer too, so all four compare on one
    dev_ms = {"chain_forward": device_ms(lambda: fwd(A, s0), dev, 5),
              "chain_traceback": device_ms(lambda: tb(P, b_end), dev, 5)}
    plain_ms = {
        "chain_forward": time_ms(lambda: tch.forward_states_plain(A, s0),
                                 dev, 1),
        "chain_traceback": time_ms(
            lambda: tch.traceback_batch_plain(P, b_end), dev, 1)}
    mhz = sm_clock_mhz()
    step = ls.smem_step_cycles(dev)
    bnd, dep_ms = chain_bounds(B, L, step, mhz)
    # the largest launch's whole DP (both kernels and the torch ops), its
    # device time from the profiler, twice
    big = max(launches_rec, key=lambda r: r[1][0] * len(r[0]))
    dbuf = torch.from_numpy(big[0].view(np.int16)).to(dev)
    readings = []
    for _ in range(2):
        total, per = profiled_device_ms(
            lambda: tch.chain_correct_planes_batch(dbuf, *big[1]), dev)
        readings.append(total)
        log(f"task1.dp_device_ms {total:.3f} (the largest launch's DP, "
            f"B={len(big[0])}, L={big[1][0]}: {len(per)} kernels, "
            f"torch.profiler)")
    check(any("fwd_" in n for n in per) and any("tb_" in n for n in per),
          f"the profiler saw no chain kernel: {sorted(per)[:20]}")
    hand = sum(v for n, v in per.items() if "fwd_" in n or "tb_" in n)
    log("task1: the DP's kernels by device time (ms): " + ", ".join(
        f"{n[:60]} {v:.3f}" for n, v in sorted(per.items(),
                                                key=lambda kv: -kv[1])[:8]))
    log(f"task1: the two hand kernels {hand:.3f} ms of "
        f"{readings[-1]:.3f} ms ({hand / readings[-1] * 100:.1f}%), the "
        f"torch ops the rest")
    check(abs(readings[0] - readings[1]) <= 0.05 * max(readings),
          f"task1.dp_device_ms readings {readings} differ by more than 5%")
    del dbuf
    stage_split(big, dev, readings[-1])
    recs = []
    for k in CHAIN_KERNELS:
        log(f"task1: {k} on the largest launch (B={B}, L={L}): "
            f"{ms[k]:.3f} ms per launch (CUDA events; device time "
            f"{dev_ms[k]:.4f} ms), plain {plain_ms[k]:.1f} ms; bound "
            f"{bnd[k][0]:.4f} ms ({bnd[k][1]}: {bnd[k][2]} B, {bnd[k][3]} "
            f"ops); dependency bound {dep_ms:.4f} ms ({step} cycles a step "
            f"at {mhz:.0f} MHz)")
        recs.append(dict(name=k, route="cuda", source=CHAIN_SOURCE,
                         replaces=CHAIN_KERNELS[k], launches=launches[k],
                         max_abs_err=ERR[k], ms=ms[k], plain_ms=plain_ms[k],
                         bound_ms=bnd[k][0], bound_by=bnd[k][1],
                         library_ms=None, timer=EVENTS,
                         device_ms=dev_ms[k], dependency_bound_ms=dep_ms,
                         cells=B * L))
    return recs


# ---------------------------------------------------------------------------
# phase 6: task 1's window route and task 2, on phase 5's BAM and output
# ---------------------------------------------------------------------------

WINDOW_CAP_CELLS = 1 << 20  # phase 6(a)'s lowered single-launch cap


def chain_launches():
    from nextpolish_tpu_torch.ops import chain as tch

    return {"chain_forward": tch.forward_states.launches,
            "chain_traceback": tch.traceback_batch.launches}


def zero_chain_launches():
    from nextpolish_tpu_torch.ops import chain as tch

    tch.forward_states.launches = 0
    tch.traceback_batch.launches = 0


def task1_windowed(tmp, dev, ctx):
    """Phase 6(a): the chromosome alone through the window route; returns
    the kernel launches of that run."""
    import torch

    from nextpolish_tpu_torch import worker1
    from nextpolish_tpu_torch.models import score_chain as sc
    from nextpolish_tpu_torch.runtime import trace

    case = ctx["case"]
    name, draft = case.names[0], case.drafts[0]
    one_fa = os.path.join(tmp, "task1", "chrom.fa")
    with open(one_fa, "wb") as fh:
        fh.write(b">" + name.encode() + b"\n" + draft + b"\n")
    out = os.path.join(tmp, "task1", "windowed.fa")
    cap = sc.MAX_LAUNCH_CELLS
    sc.MAX_LAUNCH_CELLS = WINDOW_CAP_CELLS
    try:
        with capture_scans() as cap_scans:
            trace.reset("task1")
            torch.cuda.reset_peak_memory_stats(dev)
            zero_chain_launches()
            t0 = time.perf_counter()
            rc = worker1.main(["-g", one_fa, "-s", ctx["bam"], "-t", "1",
                               "-o", out, "--device", "cuda"])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = chain_launches()
            snap = trace.snapshot("task1")
            peak = torch.cuda.max_memory_allocated(dev)
    finally:
        sc.MAX_LAUNCH_CELLS = cap
    check(rc == 0, f"worker1 -t 1 (window route) returned {rc}")
    for k, n in launches.items():
        check(n > 0, f"the window route launched {k} no time")

    def got(key, field="s"):
        return snap.get(key, {}).get(field, 0)

    n_win = int(got("task1.windows"))
    check(n_win >= 3, f"the chromosome ran in {n_win} windows, not >= 3")
    check(launches == {"chain_forward": n_win, "chain_traceback": n_win},
          f"window route launches {launches} for {n_win} windows")
    seq = open(out, "rb").read().split(b"\n")[1]
    same = seq == ctx["polished"][name]
    log(f"task1 windowed: {name} ({len(draft)} bp) in {n_win} windows of "
        f"{sc.SHARD_WINDOW_CELLS} cells (single-launch cap lowered to "
        f"{WINDOW_CAP_CELLS} cells): FASTA "
        f"{'byte-equal' if same else 'DIFFERENT'} to phase 5's single "
        f"launch")
    check(same, "the window route's FASTA differs from the single launch's")
    win_s = got("task1.window_kernel")
    log(f"task1 windowed: wall {wall:.2f} s, {len(seq) / wall:.0f} bases/s; "
        f"kernel launches {launches}; device time per window (CUDA events "
        f"around its forward and traceback halves) {win_s / n_win * 1e3:.2f}"
        f" ms, {win_s * 1e3:.1f} ms over {n_win} windows; host walk "
        f"(task1.walk: cell index + sparse native walk) "
        f"{got('task1.walk'):.3f} s, region fetch {got('task1.fetch'):.3f} "
        f"s; max_memory_allocated {peak} B")
    hold_scans(cap_scans, dev, "window route")
    log(f"task1 windowed: {len(cap_scans.fwd)} forward and "
        f"{len(cap_scans.tb)} traceback scans equal to their plain versions")
    return launches


def task2_main_path(tmp, dev, ctx):
    """Phase 6(b): worker1 -t 2 --device cuda on phase 5's polished FASTA;
    returns the kernel launches of that run."""
    import numpy as np
    import torch

    from nextpolish_tpu_torch import worker1
    from nextpolish_tpu_torch.models import score_chain as sc
    from nextpolish_tpu_torch.ops import chain as tch
    from nextpolish_tpu_torch.runtime import trace

    case = ctx["case"]
    planes, rescues = [], []
    planes_fn, rescue_fn = tch.chain_correct_planes_batch, sc.run_chain_batch

    def rec_planes(bufs, *key, **kw):
        out = planes_fn(bufs, *key, **kw)
        planes.append((bufs, key, out))
        return out

    def rec_rescue(problems, rate, *a, **kw):
        out = rescue_fn(problems, rate, *a, **kw)
        if problems:
            rescues.append((problems, rate, out))
        return out

    out = os.path.join(tmp, "task1", "task2.fa")
    tch.chain_correct_planes_batch = rec_planes
    sc.run_chain_batch = rec_rescue
    try:
        with capture_scans() as cap_scans:
            trace.reset("task1")
            zero_chain_launches()
            t0 = time.perf_counter()
            rc = worker1.main(["-g", ctx["out"], "-s", ctx["bam"], "-t",
                               "2", "-o", out, "--device", "cuda"])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = chain_launches()
    finally:
        tch.chain_correct_planes_batch = planes_fn
        sc.run_chain_batch = rescue_fn
    check(rc == 0, f"worker1 -t 2 --device cuda returned {rc}")
    hold_scans(cap_scans, dev, "task 2")
    log(f"task2: {len(cap_scans.tb)} chain_traceback launches (B, L) "
        f"{[tuple(P.shape[:2]) for P, _ in cap_scans.tb]} equal to "
        "traceback_batch_plain")
    del cap_scans
    fasta = open(out, "rb").read().split(b"\n")
    polished = dict(zip((h[1:].split(b" ")[0].decode() for h in fasta[0::2]),
                        fasta[1::2]))
    n_pol = sum(len(v) for v in polished.values())
    shapes = [(len(p), max(c.shape[0] for c, *_ in p)) for p, _, _ in
              rescues]
    log(f"task2: worker1 -t 2 wall {wall:.2f} s, {n_pol} bases, "
        f"{n_pol / wall:.0f} bases/s; no-depth regions (one planes launch "
        f"each) {len(planes)}, rescue batches {len(rescues)} (regions, "
        f"longest) {shapes}; kernel launches {launches}")
    check(len(planes) > 0, "task 2 made no planes launch (no no-depth "
          "region in phase 5's output)")
    for k, n in launches.items():
        check(n > 0, f"the task-2 main path launched {k} no time")
    for name, truth in zip(case.names, case.truths):
        check(name in polished, f"{name} missing from task 2's output")
        after2 = differences(truth, polished[name])
        log(f"task2: {name} ({len(truth)} bp): differences to the truth "
            f"{ctx['diffs'][name]} after task 1, {after2} after task 2 "
            f"(lowercase {sum(1 for c in polished[name] if c >= 97)})")

    # every launch again through the plain versions on the card
    for bufs, key, got in planes:
        want = tch.chain_correct_planes_batch(bufs, *key, plain=True)
        check(torch.equal(want, got),
              f"task-2 planes launch (L={key[0]}) differs from the plain "
              "versions")
    log(f"task2: {len(planes)} planes launches byte-equal through the "
        "plain versions")
    if not rescues:
        rng = np.random.default_rng(ctx["seed"])
        probs = []
        for n in rng.integers(1, 1025, 64):
            counts = np.zeros((n, 512), dtype=np.uint16)
            refk = rng.integers(0, 512, n).astype(np.int32)
            counts[np.arange(n), refk] = rng.integers(1, 40, n)
            extra = rng.integers(0, 512, (n, 2))
            counts[np.arange(n)[:, None], extra] += rng.integers(
                0, 5, (n, 2)).astype(np.uint16)
            total = counts.astype(np.int64).sum(axis=1).astype(np.int32)
            probs.append((counts, refk, total, None))
        rescues.append((probs, 0.5,
                        tch.run_chain_batch(probs, 0.5, device=dev)))
        log("task2: the run made no rescue batch; random rescue problems "
            f"(R = 64, Lb up to {max(p[0].shape[0] for p in probs)}) stand "
            "in for the check")
    for problems, rate, got in rescues:
        want = tch.run_chain_batch(problems, rate, device=dev, plain=True)
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"a rescue batch of {len(problems)} regions differs from the "
              "plain versions")
    log(f"task2: {len(rescues)} rescue batches byte-equal through the "
        "plain versions")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the aligner's kernels and the run.cfg pipeline
# ---------------------------------------------------------------------------

def band_launches():
    from nextpolish_tpu_torch.align import extend as text

    return {"band_align": text.band_align_core.launches,
            "band_traceback": text.band_traceback.launches}


def band_bounds(q, t, ops, R: int, B: int, cycles, mhz: float) -> dict:
    """Least time of each aligner kernel's work on an H100: bytes moved
    (each input read once, each output written once) over HBM bandwidth,
    and int32 operations over the non-tensor rate; the larger is bound_ms.
    band_align: q, t, qlen, tlen in; tb (a byte a cell), best and the end
    cell out; about 30 operations a cell (the substitution score, E, the
    diagonal, the floor, the decay, one max of the scan, F, the open bits,
    H, the source and the byte, the row maximum, Hfin).  band_traceback:
    the cells this run's walks visit (the ops emitted, plus the end step)
    read once, the end cells in, the packed ops and final cells out;
    about 10 operations a step.  Beside them the dependency bound, from
    `cycles` = (shuffle-scan round, walk step) as extend.step_cycles
    measures them at `mhz`: band_align's R dependent rows, each one
    neighbour exchange and a log2(B/K)-round shuffle scan (K cells a
    lane as the launch's route has them: the smallest power of two with
    32K >= B on the warp route, 4 on the block route), one round each;
    band_traceback's
    longest walk of this launch (its nonzero ops plus the end step), one
    dependent shared-memory load and state update a step.  Returns
    {kernel: (ms, bound_by, bytes, ops, dependency ms)}, ms the larger of
    bytes and operations."""
    import numpy as np

    Bt = q.shape[0]
    fields = (ops[:, :, None] >> (2 * np.arange(4, dtype=np.uint8))) & 3
    per_read = (fields > 0).reshape(Bt, -1).sum(axis=1)
    steps = int(per_read.sum()) + Bt
    warp = B <= 256 or (B <= 512 and Bt >= 256)  # band_align.cu's routes
    K = 1 << (-(-B // 32) - 1).bit_length() if warp else 4
    rounds = 1 + max(0, (-(-B // K) - 1).bit_length())
    dep = {"band_align": R * rounds * cycles[0],
           "band_traceback": (int(per_read.max()) + 1) * cycles[1]}
    work = {
        "band_align": (Bt * (R + (R + B) + 8) + Bt * R * B + Bt * 12,
                       Bt * R * B * 30),
        "band_traceback": (steps + Bt * 8 + ops.size + Bt * 8, steps * 10),
    }
    out = {}
    for k, (nbytes, nops) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = nops / H100_INT_OPS_PER_S * 1e3
        out[k] = (max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations", nbytes,
                  nops, dep[k] / (mhz * 1e6) * 1e3)
    return out


def band_cycles(dev):
    """(scan-round cycles, walk-step cycles) from the probe, and the SM
    clock read beside it."""
    from nextpolish_tpu_torch.align import extend as text

    cycles = text.step_cycles(dev)
    return cycles, sm_clock_mhz()


def band_times(align, walk, dev, reps=20):
    """Each aligner kernel's time per launch: its device time (bench_band.
    device_ms: `reps` launches queued behind a spin kernel, so the
    wrapper's host time between them stays out), and plain CUDA events
    around `reps` launches (which hold that host time)."""
    from nextpolish_tpu_torch.bench_band import device_ms, time_ms

    fns = {"band_align": align, "band_traceback": walk}
    return ({k: device_ms(fn, dev, reps) for k, fn in fns.items()},
            {k: time_ms(fn, dev, reps) for k, fn in fns.items()})


def log_band_time(prefix, ms, ev_ms, plain_ms, bnd, cycles, mhz):
    for k in BAND_KERNELS:
        log(f"{prefix} {k}: {ms[k]:.4f} ms (device time; CUDA events "
            f"{ev_ms[k]:.4f} ms), plain {plain_ms[k]:.1f} ms, "
            f"bound {bnd[k][0]:.4f} ms ({bnd[k][1]}: {bnd[k][2]} B, "
            f"{bnd[k][3]} ops), dependency bound {bnd[k][4]:.4f} ms "
            f"({cycles[k == 'band_traceback']} cycles a "
            f"{'step' if k == 'band_traceback' else 'round'} at {mhz:.0f} "
            f"MHz); largest of the three "
            f"{max(bnd[k][0], bnd[k][4]):.4f} ms")


def hold_band(dev, q, t, qlen, tlen, kw, label, want=None):
    """Both aligner kernels against their plain versions on the same card
    tensors (tb, best, end cell; ops, final cell), byte for byte; `want`
    holds outputs recorded earlier (compared too).  Returns the kernel
    outputs."""
    import torch

    from nextpolish_tpu_torch.align import extend as text

    core = text.band_align_core(q, t, qlen, tlen, **kw)
    walk = text.band_traceback(core[0], core[2], core[3])
    pcore = text.band_align_plain(q, t, qlen, tlen, **kw)
    pwalk = text.band_traceback_plain(pcore[0], pcore[2], pcore[3])
    torch.cuda.synchronize(dev)
    pairs = list(zip(core + walk, pcore + pwalk))
    errs = [int((a.long() - b.long()).abs().max()) if a.numel() else 0
            for a, b in pairs]
    ERR["band_align"] = max(ERR["band_align"], *errs[:4])
    ERR["band_traceback"] = max(ERR["band_traceback"], *errs[4:])
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    if want is not None:
        same = same and all(torch.equal(a.cpu(), b) for a, b in
                            zip(core[1:] + walk, want))
    check(same, f"aligner kernels != plain ({label}, max_abs_err "
          f"{max(errs)})")
    return core, walk


def band_checks(dev, seed):
    """Phase 7(a): both aligner kernels against their plain versions at
    the main path's shapes, every mode, and on reads with one long indel
    (sim.band_indel_case) in each shape's main-path mode; each shape's
    main-path mode timed."""
    import torch

    from nextpolish_tpu_torch import sim
    from nextpolish_tpu_torch.align import extend as text
    from nextpolish_tpu_torch.bench_band import SHAPES, time_ms

    cycles, mhz = band_cycles(dev)
    timings = {}
    for R, B, Bt, main_mode in SHAPES:
        for mode in ("local", "global", "extend"):
            kw = dict(mode=mode, **sim.BAND_SCORES[mode])
            cases = [("band_case", sim.band_case)]
            if mode == main_mode:
                cases.append(("band_indel_case", sim.band_indel_case))
            for name, make in cases:
                q, t, qlen, tlen = (torch.from_numpy(x).to(dev) for x in
                                    make(seed + R + B, Bt, R, B, mode))
                t0 = time.perf_counter()
                core, walk = hold_band(dev, q, t, qlen, tlen, kw,
                                       f"{mode}, R={R}, B={B}, {Bt} reads, "
                                       f"{name}")
                log(f"check aligner {mode:6s} R={R:4d} B={B:4d} "
                    f"reads={Bt:4d} {name}: both kernels equal to plain "
                    f"({time.perf_counter() - t0:.1f} s)")
            if mode != main_mode:
                continue
            # timed on band_case's inputs
            q, t, qlen, tlen = (torch.from_numpy(x).to(dev) for x in
                                sim.band_case(seed + R + B, Bt, R, B, mode))
            core = text.band_align_core(q, t, qlen, tlen, **kw)
            walk = text.band_traceback(core[0], core[2], core[3])
            ms, ev_ms = band_times(
                lambda: text.band_align_core(q, t, qlen, tlen, **kw),
                lambda: text.band_traceback(core[0], core[2], core[3]), dev)
            plain_ms = {
                "band_align": time_ms(
                    lambda: text.band_align_plain(q, t, qlen, tlen, **kw),
                    dev, 1),
                "band_traceback": time_ms(
                    lambda: text.band_traceback_plain(core[0], core[2],
                                                      core[3]), dev, 1)}
            bnd = band_bounds(q, t, walk[0].cpu().numpy(), R, B, cycles,
                              mhz)
            log_band_time(f"check aligner at ({R}, {B}) x {Bt} {mode}:", ms,
                          ev_ms, plain_ms, bnd, cycles, mhz)
            timings[(R, B)] = dict(reads=Bt, mode=mode, ms=ms, event_ms=ev_ms,
                                   plain_ms=plain_ms, bound=bnd)
    return timings


class capture_band:
    """While active, align/extend.py's two kernel wrappers record every
    call on the way: the inputs and outputs, on the host (the traceback
    tensor for the first `keep_tb` calls only).  The counts move to the
    recorders and back, as in capture_scans."""

    def __init__(self, keep_tb=20):
        from nextpolish_tpu_torch.align import extend as text

        self.text = text
        self.keep_tb = keep_tb
        self.orig = (text.band_align_core, text.band_traceback)
        self.calls = []

    def __enter__(self):
        core_fn, walk_fn = self.orig

        def rec_core(q, t, qlen, tlen, **kw):
            out = core_fn(q, t, qlen, tlen, **kw)
            self.calls.append(dict(
                inputs=[x.cpu() for x in (q, t, qlen, tlen)], kw=kw,
                core=[x.cpu() for x in out[1:]],
                tb=out[0].cpu() if len(self.calls) < self.keep_tb else None))
            return out

        def rec_walk(tb, end_i, end_c):
            out = walk_fn(tb, end_i, end_c)
            self.calls[-1]["walk"] = [x.cpu() for x in out]
            return out

        rec_core.launches = core_fn.launches
        rec_walk.launches = walk_fn.launches
        self.text.band_align_core = rec_core
        self.text.band_traceback = rec_walk
        return self

    def __exit__(self, *exc):
        core_fn, walk_fn = self.orig
        core_fn.launches = self.text.band_align_core.launches
        walk_fn.launches = self.text.band_traceback.launches
        self.text.band_align_core, self.text.band_traceback = self.orig


def replay_band(cap, dev):
    """Re-run recorded aligner calls through the plain versions on the
    card: the first 20, the first of every (mode, R, B) shape, then more
    in order while REPLAY_BUDGET_S lasts.  Returns (re-run, of)."""
    import torch

    from nextpolish_tpu_torch.align import extend as text

    seen, todo = set(), []
    for n, c in enumerate(cap.calls):
        shape = (c["kw"]["mode"], c["inputs"][0].shape[1],
                 c["inputs"][1].shape[1] - c["inputs"][0].shape[1])
        if n < 20 or shape not in seen:
            todo.append(n)
        seen.add(shape)
    t0 = time.perf_counter()
    done = set()
    for n in todo + [n for n in range(len(cap.calls)) if n not in todo]:
        if n not in todo and time.perf_counter() - t0 > REPLAY_BUDGET_S:
            break
        c = cap.calls[n]
        q, t, qlen, tlen = (x.to(dev) for x in c["inputs"])
        pcore = text.band_align_plain(q, t, qlen, tlen, **c["kw"])
        pwalk = text.band_traceback_plain(pcore[0], pcore[2], pcore[3])
        got = c["core"] + c["walk"]
        same = all(torch.equal(a.cpu(), b) for a, b in
                   zip(pcore[1:] + pwalk, got))
        if c["tb"] is not None:
            same = same and torch.equal(pcore[0].cpu(), c["tb"])
        check(same, f"aligner launch {n} ({c['kw']['mode']}, q "
              f"{tuple(c['inputs'][0].shape)}, t "
              f"{tuple(c['inputs'][1].shape)}) != its plain re-run")
        done.add(n)
    return len(done), len(cap.calls), len(seen)


def read_fasta(path) -> dict:
    out, name = {}, None
    for line in open(path, "rb").read().split(b"\n"):
        if line.startswith(b">"):
            name = line[1:].split(b" ")[0].decode()
            out[name] = []
        elif name is not None and line:
            out[name].append(line)
    return {k: b"".join(v) for k, v in out.items()}


def pipeline_main_path(tmp, dev, args, ctx):
    """Phase 7(b): python -m nextpolish_tpu_torch run.cfg --device cuda,
    task = default, on phase 5's genome with the chromosome cut."""
    import torch

    from nextpolish_tpu_torch import __main__ as cli
    from nextpolish_tpu_torch import pipeline as tpipe
    from nextpolish_tpu_torch import sim
    from nextpolish_tpu_torch.align import extend as text
    from nextpolish_tpu_torch.bench_band import time_ms
    from nextpolish_tpu_torch.models.cns import level_scan as ls

    case = ctx["case"]
    names = case.names
    truths = [case.truths[0][:PIPE_CHROM_BASES]] + case.truths[1:]
    drafts = [case.drafts[0][:PIPE_CHROM_BASES]] + case.drafts[1:]
    t0 = time.perf_counter()
    lgs = sim.long_reads(args.seed + 7, truths, PIPE_LONG_DEPTH)
    proj = os.path.join(tmp, "pipeline")
    cfg = sim.write_project(proj, names, drafts, "default",
                            sgs=ctx.pop("pipe_sgs"), lgs=lgs)
    log(f"pipeline: {sum(map(len, drafts))} bp ({names[0]} cut to "
        f"{PIPE_CHROM_BASES} bp, {names[1]}, {names[2]}), phase 5's PE150 "
        f"reads of it as r1/r2.fq.gz, {len(lgs)} long reads "
        f"({sum(len(r['seq_nib']) for r in lgs)} bases, "
        f"{PIPE_LONG_DEPTH}x) as lgs.fa.gz "
        f"({time.perf_counter() - t0:.1f} s)")
    del lgs

    walls = {}
    maps = {"map_sgs": tpipe.Pipeline.map_sgs,
            "map_long": tpipe.Pipeline.map_long}

    def timed(fn):
        def run(self, *a, **k):
            t1 = time.perf_counter()
            out = fn(self, *a, **k)
            walls.setdefault("mapping", []).append(time.perf_counter() - t1)
            return out
        return run

    for k, fn in maps.items():
        setattr(tpipe.Pipeline, k, timed(fn))
    stages = []
    stage_fn = tpipe.StageRunner.stage

    def timed_stage(self, name, fn, subdir=None):
        t1 = time.perf_counter()
        out = stage_fn(self, name, fn, subdir)
        stages.append((name, time.perf_counter() - t1))
        return out

    tpipe.StageRunner.stage = timed_stage
    zero_chain_launches()
    ls.level_chain.launches = 0
    ls.level_winners.launches = 0
    text.band_align_core.launches = 0
    text.band_traceback.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with capture_band() as cap, capture_scans() as cap_scans:
            t0 = time.perf_counter()
            rc = cli.main([cfg, "--device", "cuda"])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    finally:
        for k, fn in maps.items():
            setattr(tpipe.Pipeline, k, fn)
        tpipe.StageRunner.stage = stage_fn
    peak = torch.cuda.max_memory_allocated(dev)
    launches = cli.kernel_launches()
    check(rc == 0, f"python -m nextpolish_tpu_torch returned {rc}")
    pick = json.load(open(os.environ["NPT_CNS_CALIB"]))
    pick = next(v for k, v in pick.items() if k.endswith("/ont"))
    log(f"pipeline: wall {wall:.2f} s; calib's pick {pick['engine']} "
        f"(probe: device {pick['device_bases_per_s']}, native "
        f"{pick['native_bases_per_s']} bases/s); kernel launches "
        f"{launches}; max_memory_allocated {peak} B")
    for (name, secs), mwall in zip(stages, walls["mapping"]):
        log(f"pipeline: stage {name}: {secs:.2f} s, mapping {mwall:.2f} s, "
            f"polish {secs - mwall:.2f} s")
    need = list(BAND_KERNELS) + list(CHAIN_KERNELS)
    if pick["engine"] == "device":
        need += list(KERNELS)
    for k in need:
        check(launches[k] > 0, f"the pipeline launched {k} no time")
    check(launches["band_align"] == len(cap.calls),
          "aligner launches and recorded calls differ")

    work = os.path.join(proj, "work")
    asm = read_fasta(os.path.join(work, "genome.nextpolish.fasta"))
    check(os.path.exists(os.path.join(work,
                                      "genome.nextpolish.fasta.stat")),
          "no genome.nextpolish.fasta.stat")
    rounds = [("draft", dict(zip(names, drafts)))]
    for step, stage in enumerate(("lgs_polish", "score_chain",
                                  "kmer_count"), 1):
        rounds.append((stage, read_fasta(os.path.join(
            work, f"{step:02d}.{stage}", "genome.nextpolish.part.fasta"))))
    check(asm == rounds[-1][1], "the assembly differs from the last round")
    for name, truth in zip(names, truths):
        diffs = []
        for stage, seqs in rounds:
            check(name in seqs, f"{name} missing after {stage}")
            diffs.append(f"{stage} {differences(truth, seqs[name])}")
        log(f"pipeline: {name} ({len(truth)} bp): differences to the truth "
            + ", ".join(diffs))

    # the chain scans and the aligner's launches again through the plain
    # versions
    hold_scans(cap_scans, dev, "pipeline")
    log(f"pipeline: {len(cap_scans.fwd)} chain_forward and "
        f"{len(cap_scans.tb)} chain_traceback launches equal to their plain "
        "versions")
    del cap_scans
    t0 = time.perf_counter()
    n_done, n_all, n_shapes = replay_band(cap, dev)
    log(f"pipeline: {n_done} of {n_all} aligner launches ({n_shapes} "
        f"(mode, R, B) shapes) re-run through the plain versions on the "
        f"card: equal ({time.perf_counter() - t0:.1f} s)")

    # both kernels timed at the short-read shape and the largest bucket
    def shape_of(c):
        return (c["kw"]["mode"], c["inputs"][0].shape[1],
                c["inputs"][1].shape[1] - c["inputs"][0].shape[1],
                c["inputs"][0].shape[0])

    short = max((c for c in cap.calls if shape_of(c)[0] == "local"
                 and shape_of(c)[2] == 32),
                key=lambda c: shape_of(c)[3], default=None)
    longest = max((c for c in cap.calls if c["kw"]["mode"] == "global"),
                  key=lambda c: shape_of(c)[1] * shape_of(c)[2],
                  default=None)
    check(short is not None and longest is not None,
          "no short-read or segment launch recorded")
    timed_shapes = {}
    cycles, mhz = band_cycles(dev)
    for label, c in (("short reads", short), ("largest segment bucket",
                                              longest)):
        mode, R, B, Bt = shape_of(c)
        q, t, qlen, tlen = (x.to(dev) for x in c["inputs"])
        core, walk = hold_band(dev, q, t, qlen, tlen, c["kw"], label,
                               want=c["core"] + c["walk"])
        ms, ev_ms = band_times(
            lambda: text.band_align_core(q, t, qlen, tlen, **c["kw"]),
            lambda: text.band_traceback(core[0], core[2], core[3]), dev)
        plain_ms = {
            "band_align": time_ms(
                lambda: text.band_align_plain(q, t, qlen, tlen, **c["kw"]),
                dev, 1),
            "band_traceback": time_ms(
                lambda: text.band_traceback_plain(core[0], core[2], core[3]),
                dev, 1)}
        bnd = band_bounds(q, t, walk[0].cpu().numpy(), R, B, cycles, mhz)
        log_band_time(f"pipeline: on a {label} launch ({mode}, R={R}, "
                      f"B={B}, {Bt} reads):", ms, ev_ms, plain_ms, bnd,
                      cycles, mhz)
        timed_shapes[label] = dict(shape=[mode, R, B, Bt], ms=ms,
                                   event_ms=ev_ms, plain_ms=plain_ms,
                                   bound=bnd)
    return launches, timed_shapes


# ---------------------------------------------------------------------------
# phase 8: tasks 3, 4 and legacy 5, and the long-read chain variant
# ---------------------------------------------------------------------------

# a heterozygous chromosome, cut to 600 kb: at 1 Mb phase 8 took 193.6 s
# on the H100 machine, past the 150 s it may take (half of it the
# --device cpu reruns)
DIPLOID_BASES = 600_000
DIPLOID_DEPTH = 40  # PE150 in total, 20x a haplotype
HET_RATE = 0.001  # one heterozygous SNP a kb
HOLES, HOLE_LEN = 10, 400  # stretches without read starts
DIPLOID_LONG_DEPTH = 30


def lowercase(seq: bytes) -> int:
    return sum(1 for c in seq if c >= 97)


def bases_at(truth: bytes, seq: bytes, sites, flank: int = 12) -> list:
    """The base of seq at each truth position of `sites` (ascending), found
    after the truth's `flank` bases before it near where the previous
    site's offset puts it; None where that context is not found."""
    out, off = [], 0
    for p in sites.tolist():
        q = seq.find(truth[p - flank:p], max(0, p + off - 200),
                     p + off + 200)
        if p < flank or q < 0 or q + flank >= len(seq):
            out.append(None)
            continue
        off = q - (p - flank)
        out.append(seq[q + flank])
    return out


def snp_main_path(tmp, dev, args):
    """Phase 8: worker1 -t 1, -t 3 -l on its output, -t 4 -l on task 3's,
    -t 5 -l on the draft, and td_score_chain_contig on the draft with
    the long reads, all on the card, on a simulated diploid contig; each
    of the last four byte-equal to its --device cpu run in this process,
    and every chain-kernel launch of the card runs equal to its plain
    version.  Returns the chain-kernel launches of each card run."""
    import numpy as np
    import torch

    from nextpolish_tpu_torch import sim, worker1
    from nextpolish_tpu_torch.io import bam as bamio
    from nextpolish_tpu_torch.models import score_chain as sc
    from nextpolish_tpu_torch.runtime import trace

    d = os.path.join(tmp, "diploid")
    t0 = time.perf_counter()
    case = sim.simulate_diploid_case(
        args.seed + 11, [DIPLOID_BASES], DIPLOID_DEPTH, HET_RATE, HOLES,
        HOLE_LEN, long_depth=DIPLOID_LONG_DEPTH)
    t1 = time.perf_counter()
    fa, bam = sim.write_case(case, d)
    lbam = os.path.join(d, "long.sort.bam")
    hdr = bamio.BamHeader("", list(case.names),
                          [len(x) for x in case.drafts])
    bamio.write_bam(lbam, hdr, case.long_records, index=True)
    name, hap1, hap2 = case.names[0], case.truths[0], case.hap2s[0]
    het = np.flatnonzero(np.frombuffer(hap1, np.uint8)
                         != np.frombuffer(hap2, np.uint8))
    log(f"snp: simulated {name} ({DIPLOID_BASES} bp, {len(het)} het SNPs, "
        f"{HOLES} holes of {HOLE_LEN} bp without read starts), "
        f"{len(case.records)} PE150 reads at {DIPLOID_DEPTH}x and "
        f"{len(case.long_records)} long reads at {DIPLOID_LONG_DEPTH}x from "
        f"both haplotypes ({t1 - t0:.1f} s), BAMs "
        f"({time.perf_counter() - t1:.1f} s)")
    n_long = len(case.long_records)
    case.records = case.long_records = None  # the BAMs hold them now

    def card_run(label, fn):
        """fn on the card: its wall, launches, chain cells and launches
        (the trace counters), every scan held to its plain version."""
        with capture_scans() as cap:
            trace.reset("task1")
            zero_chain_launches()
            t = time.perf_counter()
            out = fn("cuda")
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t
            launches = chain_launches()
            snap = trace.snapshot("task1")
        hold_scans(cap, dev, label)
        shapes = sorted({tuple(P.shape[:2]) for P, _ in cap.tb})
        return out, wall, launches, snap, shapes

    def worker(task, genome, reads, out):
        def fn(device):
            path = f"{out}.{device}.fa"
            rc = worker1.main(["-g", genome, *reads, "-t", task, "-o",
                               path, "--device", device])
            check(rc == 0, f"worker1 -t {task} --device {device} "
                  f"returned {rc}")
            return open(path, "rb").read()
        return fn

    def td(device):
        batch = bamio.read_bam(lbam)
        return sc.td_score_chain_contig(name, case.drafts[0], batch,
                                        sc.AlgoConfig(), device=device)

    sgs_lgs = ["-s", bam, "-l", lbam]
    t1_fa = os.path.join(d, "t1.cuda.fa")
    runs = [
        ("worker1 -t 1", worker("1", fa, ["-s", bam],
                                os.path.join(d, "t1"))),
        ("worker1 -t 3", worker("3", t1_fa, sgs_lgs, os.path.join(d, "t3"))),
        ("worker1 -t 4", worker("4", os.path.join(d, "t3.cuda.fa"),
                                sgs_lgs, os.path.join(d, "t4"))),
        ("worker1 -t 5", worker("5", fa, ["-l", lbam],
                                os.path.join(d, "t5"))),
        ("td_score_chain_contig", td),
    ]
    by_path, seqs = {}, {}
    for label, fn in runs:
        out, wall, launches, snap, shapes = card_run(label, fn)
        seq = out if label == "td_score_chain_contig" else \
            out.split(b"\n")[1]
        seqs[label] = seq
        by_path[label] = launches
        cells = int(snap.get("task1.chain_cells", {}).get("s", 0))
        n_chain = int(snap.get("task1.chain_launches", {}).get("n", 0))
        same = None
        if label != "worker1 -t 1":
            t = time.perf_counter()
            cpu = fn("cpu")
            cpu_s = time.perf_counter() - t
            same = cpu == out
        log(f"snp: {label}: wall {wall:.2f} s, {len(seq)} bases, "
            f"{len(seq) / wall:.0f} bases/s; kernel launches {launches}, "
            f"chain launches {n_chain}, cells {cells}, (B, L) {shapes}; "
            f"lowercase {lowercase(seq)}; differences to hap1 "
            f"{differences(hap1, seq)}, to hap2 {differences(hap2, seq)}"
            + ("" if same is None else
               f"; --device cpu ({cpu_s:.2f} s) "
               f"{'byte-equal' if same else 'DIFFERENT'}"))
        check(same is not False, f"{label}: --device cuda differs from "
              "--device cpu")
        if label not in ("worker1 -t 4", "worker1 -t 5"):  # host only
            for k, n in launches.items():
                check(n > 0, f"{label} launched {k} no time")
    from nextpolish_tpu_torch.io.bamregion import IndexedBam

    fetch_s = {}
    for kind, path in (("short", bam), ("long", lbam)):
        t = time.perf_counter()
        src = IndexedBam(path)
        n_rec = len(src.fetch(0, 0, DIPLOID_BASES - 1))
        fetch_s[kind] = (time.perf_counter() - t, n_rec)
    log("snp: one region fetch of the contig (IndexedBam, as each worker1 "
        "run makes per BAM): " + ", ".join(
            f"{k} reads {v[0]:.2f} s ({v[1]} records)"
            for k, v in fetch_s.items()))
    log(f"snp: the draft: differences to hap1 "
        f"{differences(hap1, case.drafts[0])}, to hap2 "
        f"{differences(hap2, case.drafts[0])}; {n_long} long reads")
    a1 = bases_at(hap1, seqs["worker1 -t 1"].upper(), het)
    a3 = bases_at(hap1, seqs["worker1 -t 3"].upper(), het)
    both = [(x, y, hap2[p]) for x, y, p in zip(a1, a3, het.tolist())
            if x is not None and y is not None]
    log(f"snp: task 3 changed {sum(x != y for x, y, _ in both)} of the "
        f"{len(both)} het sites found in both outputs (of {len(het)}); "
        f"{sum(y == b for _, y, b in both)} carry hap2's base after it, "
        f"{sum(x == b for x, _, b in both)} before")
    low = lowercase(seqs["worker1 -t 3"])
    log(f"snp: lowercase before task 4 (task 3's output) {low}, after "
        f"{lowercase(seqs['worker1 -t 4'])}")
    check(low > 0, "task 4's input (task 3's output) holds no lowercase")
    return by_path


# ---------------------------------------------------------------------------
# phase 9: several processes (launch.py, parallel/hosts.py), two ranks
# ---------------------------------------------------------------------------

# three contigs cut from phase 7(b)'s chromosome (its first 200,000 bp),
# sized so that blc_genome gives rank 0 the first and rank 1 the others
MULTI_PIECES = ((0, 105_000), (105_000, 155_000), (155_000, 200_000))
HOLD_LEVELS = 16_384  # phase 9's plain check of each engine-2 window
TIME_LINE = re.compile(r"TIME (\S+) wall=([\d.]+)s")


class capture_levels:
    """While active, the engine-2 launches of `module` (the batcher's by
    default; models/cns/device_dp for _run_batch's) are recorded: each
    group's windows, read type and coverage coefficient, and its Pending,
    whose host results stay alive with the record."""

    def __init__(self, module=None):
        if module is None:
            from nextpolish_tpu_torch.models.cns import batcher as module

        self.mod = module
        self.orig = module.dispatch_group
        self.groups = []

    def __enter__(self):
        def rec(dws, read_type, device=None, cov_coef=None, sc_tail=False):
            pend = self.orig(dws, read_type, device, cov_coef, sc_tail)
            self.groups.append((list(dws), read_type, cov_coef, pend))
            return pend

        self.mod.dispatch_group = rec
        return self

    def __exit__(self, *exc):
        self.mod.dispatch_group = self.orig


def hold_levels(cap, dev, label):
    """Each recorded launch's windows, cut to their first HOLD_LEVELS
    levels (a prefix of the level scan is the scan of the prefix), through
    the plain versions on the card: equal to both kernels on the prefix
    alone and to the recorded launch's winners over it.  Returns the
    levels held."""
    import torch

    from nextpolish_tpu_torch.models.cns import level_scan as ls
    from nextpolish_tpu_torch.models.cns.device_dp import (
        READ_TYPE_ID,
        pack_batch,
    )
    from nextpolish_tpu_torch.models.cns.dp import COV_COEF

    held = 0
    for g, (dws, rt, cov, pend) in enumerate(cap.groups):
        rt_id = READ_TYPE_ID[rt]
        c = COV_COEF[rt] if cov is None else cov
        pend.done.synchronize()
        for i, dw in enumerate(dws):
            cut = truncate(dw, HOLD_LEVELS)
            one = pack_batch([cut]).to(dev)  # every level's scores kept
            ki = ls.level_chain(one, rt_id, c)
            kb, ks = ls.level_winners(one, ki, rt_id)
            pi = ls.level_chain_plain(one, rt_id, c)
            pb, ps = ls.level_winners_plain(one, pi, rt_id)
            lb, nl = int(pend.win[i, 0]), cut.n_levels
            launched = pend.best[lb:lb + nl].to(dev)
            torch.cuda.synchronize(dev)
            win_pairs = [(kb, pb), (ks, ps), (launched, pb)]
            e_chain, e_win = max_err([(ki, pi)]), max_err(win_pairs)
            ERR["level_chain"] = max(ERR["level_chain"], e_chain)
            ERR["level_winners"] = max(ERR["level_winners"], e_win)
            check(e_chain == 0 and torch.equal(ki, pi),
                  f"level_chain kernel != plain ({label}, launch {g}, "
                  f"window {i})")
            check(e_win == 0 and all(torch.equal(a, b)
                                     for a, b in win_pairs),
                  f"level_winners kernel != plain ({label}, launch {g}, "
                  f"window {i})")
            held += nl
    return held


def hold_groups(cap, dev, label):
    """Each recorded launch, whole, through the plain versions on the
    card: the launch's winners and scores equal to theirs."""
    import torch

    from nextpolish_tpu_torch.models.cns import level_scan as ls
    from nextpolish_tpu_torch.models.cns.device_dp import (
        READ_TYPE_ID,
        pack_batch,
    )
    from nextpolish_tpu_torch.models.cns.dp import COV_COEF

    for gi, (dws, rt, cov, pend) in enumerate(cap.groups):
        b = pack_batch(dws).to(dev)
        rt_id = READ_TYPE_ID[rt]
        c = COV_COEF[rt] if cov is None else cov
        pb, ps = ls.level_winners_plain(b, ls.level_chain_plain(b, rt_id, c),
                                        rt_id)
        pairs = [(pend.best, pb.cpu()), (pend.sc, ps.cpu())]
        err = max_err(pairs)
        ERR["level_winners"] = max(ERR["level_winners"], err)
        check(err == 0 and all(torch.equal(x, y) for x, y in pairs),
              f"{label} engine-2 group {gi}: kernels != plain")


def run_logged(cmd, env, cwd, label):
    """One CLI run as a child process: (wall, its log)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *cmd], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"phase 9 {label} returned {r.returncode}: "
          + r.stderr[-3000:])
    return wall, r.stderr


def rank_records(text: str, nproc: int, card: str) -> list:
    """Each rank's (launches, engine-2 windows) from its last log line;
    the line must name this card."""
    from nextpolish_tpu_torch.__main__ import rank_lines

    got = rank_lines(text)
    check(sorted(got) == list(range(nproc)),
          f"rank lines {sorted(got)} of {nproc} processes")
    for r, (n, dev, name, _, _) in got.items():
        check(n == nproc, f"rank {r} logged {n} processes, not {nproc}")
        check(dev.startswith("cuda") and name == card,
              f"rank {r} ran on {dev} ({name}), not on {card}")
    return [got[r][3:] for r in range(nproc)]


def multiproc_main_path(tmp, dev, args, ctx):
    """Phase 9: the same run.cfg (task = 5,1, engine 2 on the card) as one
    process, in this one with every launch held against its plain
    version, and as two ranks through the launcher, both --device
    cuda."""
    import logging

    import torch

    from nextpolish_tpu_torch import __main__ as cli
    from nextpolish_tpu_torch import sim
    from nextpolish_tpu_torch.align import extend as text
    from nextpolish_tpu_torch.kit import plog
    from nextpolish_tpu_torch.models.cns import level_scan as ls
    from nextpolish_tpu_torch.parallel.hosts import blc_genome
    from nextpolish_tpu_torch.runtime import trace

    case = ctx["case"]
    names = [f"{case.names[0]}_{a}" for a, _ in MULTI_PIECES]
    truths = [case.truths[0][a:b] for a, b in MULTI_PIECES]
    drafts = [case.drafts[0][a:b] for a, b in MULTI_PIECES]
    t0 = time.perf_counter()
    lgs = sim.long_reads(args.seed + 9, truths, PIPE_LONG_DEPTH)
    proj = os.path.join(tmp, "multiproc")
    sgs = ctx.pop("multi_sgs")
    cfg = sim.write_project(proj, names, drafts, "5,1", sgs=sgs, lgs=lgs)
    blocks = blc_genome(dict(zip(names, map(len, drafts))), 2)
    check(sorted(set(blocks.values())) == [0, 1],
          f"blc_genome gives the ranks {blocks}")
    log(f"multiproc: {sum(map(len, drafts))} bp ({', '.join(names)}: "
        f"pieces of {case.names[0]}), {len(sgs)} PE150 reads of phase 5 "
        f"and {len(lgs)} long reads ({PIPE_LONG_DEPTH}x), task = 5,1, "
        f"blocks {blocks} ({time.perf_counter() - t0:.1f} s)")
    del sgs, lgs
    card = torch.cuda.get_device_name(dev)
    work = os.path.join(proj, "work")

    # one process, here, as phase 7(b) runs it; its log read as the ranks'
    zero_chain_launches()
    for fn in (ls.level_chain, ls.level_winners, text.band_align_core,
               text.band_traceback):
        fn.launches = 0
    trace.reset()
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    handler.setFormatter(logging.Formatter("%(message)s"))
    plog().addHandler(handler)
    os.environ["NPT_CNS_ENGINE"] = "device"
    try:
        with capture_levels() as cap_lv, capture_band() as cap, \
                capture_scans() as cap_scans:
            t0 = time.perf_counter()
            rc = cli.main([cfg, "--device", "cuda"])
            torch.cuda.synchronize(dev)
            wall1 = time.perf_counter() - t0
    finally:
        os.environ.pop("NPT_CNS_ENGINE")
        plog().removeHandler(handler)
    check(rc == 0, f"phase 9 one process returned {rc}")
    text1 = buf.getvalue()
    (one, win1), = rank_records(text1, 1, card)
    check(one == cli.kernel_launches(), "the rank line's launches differ "
          "from the counters")
    check(len(cap_lv.groups) == one["level_chain"]
          and sum(len(g[0]) for g in cap_lv.groups) == win1,
          "engine-2 launches and recorded groups differ")
    check(len(cap_scans.fwd) == one["chain_forward"]
          and len(cap_scans.tb) == one["chain_traceback"],
          "chain launches and recorded scans differ")
    check(len(cap.calls) == one["band_align"],
          "aligner launches and recorded calls differ")
    os.rename(work, work + ".one")
    torch.cuda.empty_cache()  # the ranks' memory, not this process's cache

    # two ranks through the launcher, on this card
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NPT_COORDINATOR", "NPT_NUM_PROCS",
                                "NPT_PROC_ID", "SLURM_"))}
    env.update(NPT_CNS_ENGINE="device", PYTHONPATH=os.pathsep.join(
        [HERE, os.environ.get("PYTHONPATH", "")]))
    wall2, text2 = run_logged(
        ["-m", "nextpolish_tpu_torch.launch", "--nprocs", "2", cfg,
         "--device", "cuda"], env, proj, "two_ranks")
    ranks = rank_records(text2, 2, card)

    for f in ("genome.nextpolish.fasta", "genome.nextpolish.fasta.stat"):
        a = open(os.path.join(work + ".one", f), "rb").read()
        b = open(os.path.join(work, f), "rb").read()
        check(len(a) > 0 and a == b,
              f"{f} differs between one process and two ranks")
    for step in ("01.lgs_polish", "02.score_chain"):
        for r in range(2):
            part = os.path.join(work, step,
                                f"genome.nextpolish.part.fasta.rank{r}")
            check(os.path.exists(part) and os.path.getsize(part) > 0,
                  f"rank {r} wrote no {step} part")
    for r, (n, _) in enumerate(ranks):
        for k in ("level_chain", "chain_forward", "band_align"):
            check(n[k] > 0, f"rank {r} launched {k} no time")
    # task 1 launches once a contig, so the ranks' launches add up to the
    # one process's; every rank maps every read (as the JAX package's
    # ranks do), so each rank's aligner launches equal the one process's;
    # engine 2's launches group the windows in flight, so its windows add
    # up, not its launches
    for k in ("chain_forward", "chain_traceback"):
        check(sum(n[k] for n, _ in ranks) == one[k],
              f"{k}: ranks {[n[k] for n, _ in ranks]}, one process {one[k]}")
    for k in ("band_align", "band_traceback"):
        check(all(n[k] == one[k] for n, _ in ranks),
              f"{k}: ranks {[n[k] for n, _ in ranks]}, one process {one[k]}")
    check(sum(w for _, w in ranks) == win1,
          f"engine-2 windows: ranks {[w for _, w in ranks]}, one process "
          f"{win1}")

    asm = read_fasta(os.path.join(work, "genome.nextpolish.fasta"))
    diffs = ", ".join(f"{n} {differences(t, asm[n])}"
                      for n, t in zip(names, truths))
    log(f"multiproc: one process {wall1:.2f} s (in this process), two "
        f"ranks {wall2:.2f} s (launcher to exit, both ranks on one card); "
        f"FASTA and .stat byte-equal; differences to the truth after task "
        f"1: {diffs}")
    for label, txt in (("one process", text1), ("two ranks", text2)):
        stages = ", ".join(f"{m[1]} {float(m[2]):.2f} s"
                           for m in TIME_LINE.finditer(txt))
        log(f"multiproc: {label} stage walls: {stages}")
    log(f"multiproc: launches, one process {one} ({win1} engine-2 "
        f"windows); " + "; ".join(f"rank {r} {n} ({w} windows)"
                                  for r, (n, w) in enumerate(ranks)))

    # the one process's launches again through the plain versions
    t0 = time.perf_counter()
    held = hold_levels(cap_lv, dev, "multiproc")
    log(f"multiproc: {one['level_chain']} engine-2 launches ("
        f"{[len(g[0]) for g in cap_lv.groups]} windows), each window's "
        f"first {HOLD_LEVELS} levels ({held} in all) equal to the plain "
        f"versions, both kernels and the launch's winners "
        f"({time.perf_counter() - t0:.1f} s)")
    del cap_lv
    t0 = time.perf_counter()
    hold_scans(cap_scans, dev, "multiproc")
    log(f"multiproc: {len(cap_scans.fwd)} chain_forward and "
        f"{len(cap_scans.tb)} chain_traceback launches ("
        f"{[tuple(A.shape) for A, _ in cap_scans.fwd]}) equal to their "
        f"plain versions ({time.perf_counter() - t0:.1f} s)")
    del cap_scans
    t0 = time.perf_counter()
    n_done, n_all, n_shapes = replay_band(cap, dev)
    check(n_done == n_all, f"only {n_done} of {n_all} aligner launches "
          "re-run")
    log(f"multiproc: {n_done} of {n_all} aligner launches ({n_shapes} "
        f"(mode, R, B) shapes) re-run through the plain versions on the "
        f"card: equal ({time.perf_counter() - t0:.1f} s)")
    return {"phase 9: one process": one,
            **{f"phase 9: rank {r} of 2": n for r, (n, _) in
               enumerate(ranks)}}


# ---------------------------------------------------------------------------
# phase 10: several cards in one process, a list naming this card twice
# ---------------------------------------------------------------------------

SHARD_MIN_CUT = 1_000_000  # phase 10(a)'s lowered sharding threshold


def groups_by_entry(snap, prefix, n) -> list:
    """The round-robin's groups sent to each of the n entries of a device
    list (its trace counters `prefix`.entry{k}); the entries name one
    card here, so the counters, not the devices, tell them apart."""
    return [int(snap.get(f"{prefix}.entry{k}", {}).get("s", 0))
            for k in range(n)]


def multicard_router(tmp, dev, ctx):
    """Phase 10(a): the task-1 router over two entries naming this card,
    on phase 5's genome and BAM with the sharding threshold lowered: the
    chromosome through the reads-sharded route, the plasmids round-robin.
    Returns the kernel launches of that run."""
    import torch

    from nextpolish_tpu_torch.models import score_chain as sc
    from nextpolish_tpu_torch.runtime import trace
    from nextpolish_tpu_torch.worker1 import open_contig_source

    case = ctx["case"]
    devs = [dev, dev]
    src = open_contig_source(ctx["bam"])
    cfg = sc.AlgoConfig()
    cfg.read_tlen = sc.estimate_read_tlen(src.fetch_head(10_000), cfg)
    groups = []
    dispatch = sc.dispatch_chain_group

    def recording_dispatch(handles, device=None):
        groups.append([h.name for h in handles])
        dispatch(handles, device)

    sc.dispatch_chain_group = recording_dispatch
    try:
        with capture_scans() as cap:
            trace.reset("task1")
            torch.cuda.reset_peak_memory_stats(dev)
            zero_chain_launches()
            t0 = time.perf_counter()
            out = list(sc.score_chain_pipeline_multichip(
                zip(case.names, case.drafts), src, cfg, devices=devs,
                shard_min=SHARD_MIN_CUT))
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = chain_launches()
            snap = trace.snapshot("task1")
            peak = torch.cuda.max_memory_allocated(dev)
    finally:
        sc.dispatch_chain_group = dispatch

    def got(key, field="s"):
        return snap.get(key, {}).get(field, 0)

    check([n for n, _ in out] == list(case.names),
          f"the router's output order {[n for n, _ in out]}")
    for name, seq in out:
        same = seq == ctx["polished"][name]
        log(f"multicard: {name}: FASTA "
            f"{'byte-equal' if same else 'DIFFERENT'} to phase 5's")
        check(same, f"phase 10(a)'s {name} differs from phase 5's")
    big = [n for n, d in zip(case.names, case.drafts)
           if len(d) >= SHARD_MIN_CUT]
    small = [n for n in case.names if n not in big]
    n_win = int(got("task1.windows"))
    check(n_win >= 3, f"the sharded route ran {n_win} windows")
    want = n_win + len(small)
    check(launches == {"chain_forward": want, "chain_traceback": want},
          f"phase 10(a) launches {launches}, not {n_win} windows + "
          f"{len(small)} contigs")
    per_entry = groups_by_entry(snap, "task1.groups", len(devs))
    check(sorted(groups) == sorted([n] for n in small)
          and per_entry == [1, 1],
          f"the round-robin's launches {groups} went to the entries "
          f"{per_entry}")
    check(int(got("task1.window_merge", "n")) == n_win,
          "a window of the sharded route ran no timed merge")
    walks = ", ".join(f"shard {r} {got(f'task1.shard{r}.walk'):.3f} s"
                      for r in range(len(devs)))
    merge_s = got("task1.window_merge")
    win_s = got("task1.window_kernel")
    log(f"multicard: router over {len(devs)} entries of {dev} "
        f"(shard_min {SHARD_MIN_CUT} bp): {big} sharded in {n_win} windows "
        f"of {sc.SHARD_WINDOW_CELLS} cells, {small} round-robin, "
        f"{per_entry} groups to entries 0 and 1; wall {wall:.2f} s; walks "
        f"{walks} (two "
        f"threads; task1.walk {got('task1.walk'):.3f} s with the cell "
        f"index); region fetch {got('task1.fetch'):.3f} s; per-window "
        f"merge (CUDA events around the reduction over the entries) "
        f"{merge_s / n_win * 1e3:.3f} ms, {merge_s * 1e3:.2f} ms over "
        f"{n_win} windows; per-window forward and traceback (CUDA events) "
        f"{win_s / n_win * 1e3:.2f} ms; max_memory_allocated {peak} B; "
        f"kernel launches {launches}")
    t0 = time.perf_counter()
    hold_scans(cap, dev, "phase 10(a)")
    log(f"multicard: {len(cap.fwd)} chain_forward and {len(cap.tb)} "
        f"chain_traceback launches equal to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches


def multicard_engine2(tmp, dev, args):
    """Phase 10(b): engine 2's _run_batch over two entries naming this
    card on 17 of phase 2's simulated windows (groups of 8, 8 and 1),
    against the same call over one entry and, each group's launch, the
    plain versions on the same inputs.  Returns the level kernels'
    launches of the two-entry call."""
    from nextpolish_tpu_torch.models.cns import device_dp as dd
    from nextpolish_tpu_torch.models.cns import level_scan as ls
    from nextpolish_tpu_torch.runtime import trace

    lengths = [10_000 + 1_000 * i for i in range(8)]
    # phase 2's ont batch, its clr batch's reads (prepared for ont) and
    # its E > 20 window
    dws = (sim_windows(tmp, "ont", args.seed + 10, lengths, 30,
                       RT_ERRORS["ont"], (3000, 8000))
           + sim_windows(tmp, "ont", args.seed + 11, lengths, 30,
                         RT_ERRORS["clr"], (3000, 8000))
           + sim_windows(tmp, "ont", 0, [3000], 110, (0.05, 0.05, 0.05),
                         (1000, 3000), hotspot=(1500, 1, False)))
    devs = [dev, dev]
    with capture_levels(dd) as cap:
        trace.reset("cns.groups")
        ls.level_chain.launches = ls.level_winners.launches = 0
        t0 = time.perf_counter()
        two = dd._run_batch(dws, "ont", devices=devs)
        wall = time.perf_counter() - t0
        launches = {"level_chain": ls.level_chain.launches,
                    "level_winners": ls.level_winners.launches}
    sizes = [len(g[0]) for g in cap.groups]
    per_entry = groups_by_entry(trace.snapshot("cns.groups"), "cns.groups",
                                len(devs))
    check(sizes == [8, 8, 1] and per_entry == [2, 1],
          f"engine-2 groups of {sizes} windows, {per_entry} to the entries")
    check(launches == {"level_chain": 3, "level_winners": 3},
          f"phase 10(b) launches {launches}")
    one = dd._run_batch(dws, "ont", devices=[dev])
    same = len(one) == len(two) == len(dws) and all(
        (a[0] == b[0]).all() and (a[1] == b[1]).all()
        for a, b in zip(two, one))
    check(same, "engine 2 over two entries differs from one entry")
    t0 = time.perf_counter()
    hold_groups(cap, dev, "phase 10(b)")
    log(f"multicard: engine 2 over {len(devs)} entries of {dev}: "
        f"{len(dws)} windows in groups of {sizes}, {per_entry} to entries "
        f"0 and 1, wall {wall:.2f} s; "
        f"byte-equal to one entry, and each group's winners to the plain "
        f"versions ({time.perf_counter() - t0:.1f} s); launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the port's dry run (dryrun.py) over [cuda:0, cuda:0]
# ---------------------------------------------------------------------------

def dryrun_main_path(dev):
    """Phase 11: dryrun.entry on the card against its plain versions, then
    dryrun.dryrun_multichip(2, "cuda"); the four kernels it reaches must
    launch, and every launch is held against its plain version.  Returns
    the launches."""
    import torch

    from nextpolish_tpu_torch import dryrun
    from nextpolish_tpu_torch.models.cns import device_dp as dd
    from nextpolish_tpu_torch.models.cns import level_scan as ls

    with capture_scans() as cap, capture_levels(dd) as lcap:
        zero_chain_launches()
        ls.level_chain.launches = ls.level_winners.launches = 0
        t0 = time.perf_counter()
        fn, args = dryrun.entry("cuda")
        got = fn(*args)
        res = dryrun.dryrun_multichip(2, "cuda")
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = dict(chain_launches(),
                        level_chain=ls.level_chain.launches,
                        level_winners=ls.level_winners.launches)
    for k, n in launches.items():
        check(n > 0, f"the dry run launched {k} no time")
    t1 = time.perf_counter()
    same = torch.equal(got, fn(*args, plain=True))
    log(f"dryrun: entry's choices {tuple(got.shape)} "
        f"{'equal' if same else 'DIFFERENT'} to the plain versions'")
    check(same, "dryrun.entry's kernels differ from the plain versions")
    hold_scans(cap, dev, "phase 11")
    hold_groups(lcap, dev, "phase 11")
    log(f"dryrun: over [{dev}, {dev}]: task 1's router byte-equal to one "
        f"entry on {res['bases']} bases, engine 2's {res['windows']} "
        f"windows equal to one entry; wall {wall:.2f} s (dryrun_multichip "
        f"{res['wall_s']:.2f} s); launches {launches}; {len(cap.fwd)} "
        f"chain_forward, {len(cap.tb)} chain_traceback and "
        f"{len(lcap.groups)} engine-2 launches equal to their plain "
        f"versions ({time.perf_counter() - t1:.1f} s)")
    return launches


def band_records(launches, timed_shapes, checks):
    """The aligner kernels' entries of the kernels line: the times of the
    main path's short-read launch, the other shapes beside them."""
    recs = []
    main = timed_shapes["short reads"]
    for k in BAND_KERNELS:
        rec = dict(name=k, route="cuda", source=BAND_SOURCE,
                   replaces=BAND_KERNELS[k], launches=launches[k],
                   max_abs_err=ERR[k], ms=main["ms"][k],
                   plain_ms=main["plain_ms"][k],
                   bound_ms=main["bound"][k][0],
                   bound_by=main["bound"][k][1], library_ms=None,
                   timer=DEVICE, dependency_bound_ms=main["bound"][k][4],
                   shape=main["shape"],
                   largest_segment_bucket=dict(
                       shape=timed_shapes["largest segment bucket"]["shape"],
                       ms=timed_shapes["largest segment bucket"]["ms"][k],
                       bound_ms=timed_shapes["largest segment bucket"][
                           "bound"][k][0],
                       dependency_bound_ms=timed_shapes[
                           "largest segment bucket"]["bound"][k][4]),
                   event_ms=main["event_ms"][k],
                   check_shapes={f"{R}x{B}": dict(
                       reads=v["reads"], mode=v["mode"], ms=v["ms"][k],
                       event_ms=v["event_ms"][k],
                       plain_ms=v["plain_ms"][k], bound_ms=v["bound"][k][0],
                       dependency_bound_ms=v["bound"][k][4])
                       for (R, B), v in checks.items()})
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--contigs", type=int, default=4)
    p.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11",
                   help="phases to run (the build always runs; 6, 7, 9 "
                        "and 10 need 5)")
    args = p.parse_args(argv)
    phases = args.phase_set = {int(x) for x in args.phases.split(",")}
    if phases & {6, 7, 9, 10} and 5 not in phases:
        fail("phases 6, 7, 9 and 10 run on phase 5's simulation: add 5 to "
             "--phases")

    # the port must run with JAX and the JAX package out of reach
    sys.modules["jax"] = None
    sys.modules["nextpolish_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    sys.path.insert(0, HERE)
    try:
        import nextpolish_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"nextpolish_tpu_torch is not importable here ({e})")
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    build_all()
    recs = []
    with tempfile.TemporaryDirectory(prefix="npt_smoke_") as tmp:
        # the engine calibration's cache lives and dies with this run
        os.environ["NPT_CNS_CALIB"] = os.path.join(tmp, "calib.json")
        if 2 in phases:
            t0 = time.perf_counter()
            kernel_checks(tmp, dev, args.seed)
            log(f"check: all byte-equal ({time.perf_counter() - t0:.1f} s)")
        if 3 in phases:
            recs += main_path(tmp, dev, args)
        if 4 in phases:
            t0 = time.perf_counter()
            chain_checks(dev, args.seed)
            log(f"check task1: all equal ({time.perf_counter() - t0:.1f} s)")
        if 5 in phases:
            t0 = time.perf_counter()
            ctx = {}
            chain_recs = task1_main_path(tmp, dev, args, ctx)
            recs += chain_recs
            log(f"task1: phase 5 took {time.perf_counter() - t0:.1f} s")
        if 6 in phases:
            t0 = time.perf_counter()
            by_path = {"worker1 -t 1": ctx["launches"],
                       "worker1 -t 1, window route": task1_windowed(
                           tmp, dev, ctx),
                       "worker1 -t 2": task2_main_path(tmp, dev, ctx)}
            for rec in chain_recs:
                k = rec["name"]
                rec["launches_by_path"] = {p: n[k] for p, n in
                                           by_path.items()}
                rec["launches"] = sum(n[k] for n in by_path.values())
            log(f"phase 6 took {time.perf_counter() - t0:.1f} s")
        if 7 in phases:
            t0 = time.perf_counter()
            checks = band_checks(dev, args.seed)
            log(f"check aligner: all equal ({time.perf_counter() - t0:.1f} "
                "s)")
            t1 = time.perf_counter()
            if 3 not in phases:
                calib_pick(dev)
            launches, timed_shapes = pipeline_main_path(tmp, dev, args, ctx)
            path = "python -m nextpolish_tpu_torch run.cfg (task default)"
            for rec in recs:
                k = rec["name"]
                by = rec.setdefault("launches_by_path",
                                    {"main": rec["launches"]})
                by[path] = launches[k]
                rec["launches"] += launches[k]
            recs += band_records(launches, timed_shapes, checks)
            log(f"phase 7 took {time.perf_counter() - t0:.1f} s (the "
                f"pipeline {time.perf_counter() - t1:.1f} s)")
        if 8 in phases:
            t0 = time.perf_counter()
            by_path = snp_main_path(tmp, dev, args)
            for rec in recs:
                k = rec["name"]
                if k not in CHAIN_KERNELS:
                    continue
                by = rec.setdefault("launches_by_path",
                                    {"main": rec["launches"]})
                for path, n in by_path.items():
                    by[f"phase 8: {path}"] = n[k]
                    rec["launches"] += n[k]
            log(f"phase 8 took {time.perf_counter() - t0:.1f} s")
        if 9 in phases:
            t0 = time.perf_counter()
            by_path = multiproc_main_path(tmp, dev, args, ctx)
            for rec in recs:
                k = rec["name"]
                by = rec.setdefault("launches_by_path",
                                    {"main": rec["launches"]})
                for path, n in by_path.items():
                    by[path] = n[k]
                    rec["launches"] += n[k]
            log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
        if 10 in phases:
            t0 = time.perf_counter()
            by_path = {"phase 10(a): router over [cuda:0, cuda:0]":
                       multicard_router(tmp, dev, ctx),
                       "phase 10(b): _run_batch over [cuda:0, cuda:0]":
                       multicard_engine2(tmp, dev, args)}
            for rec in recs:
                k = rec["name"]
                by = rec.setdefault("launches_by_path",
                                    {"main": rec["launches"]})
                for path, n in by_path.items():
                    by[path] = n.get(k, 0)
                    rec["launches"] += n.get(k, 0)
            log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
        if 11 in phases:
            t0 = time.perf_counter()
            launches = dryrun_main_path(dev)
            for rec in recs:
                k = rec["name"]
                by = rec.setdefault("launches_by_path",
                                    {"main": rec["launches"]})
                by["phase 11: dryrun"] = launches.get(k, 0)
                rec["launches"] += launches.get(k, 0)
            log(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": recs}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
