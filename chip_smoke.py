#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nextpolish_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 1] [--contigs 8]

Phases (any failed check exits non-zero; nothing is caught):
  1. build   the level-scan kernels (nvcc, sm_90a: the chain and the
             winners) and the native host library, both from the sources
             in this checkout, in parallel; each kernel's registers,
             shared memory and spills as ptxas reports them;
  2. check   both kernels against their plain PyTorch versions on the
             card, byte for byte (the chain's per-entry scores, then the
             winners), for the ont/clr/rs/hifi rules: a batch of eight
             10-17 kb windows, and windows with E > 20, with Vb > 8 and
             with a 300-level insertion chain;
  3. main    worker2 -r ont --device cuda on a simulated bacterial-scale
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
             window is scanned whole by the plain versions, which must
             equal, byte for byte, both kernels on that window alone and
             the full-size launch (winners and score tail); and the group
             cut to its first 4,096 levels per window times each kernel
             beside its plain version on the same inputs.

The number of contigs is the only cut: contig length, depth and error
rates are fixed.

The last three lines are the kernels' JSON record (both kernels, one
port of the TPU kernel), the card's name and power limit, and
{"ok": true, "device": {...}}.  The script imports
nothing of JAX or of the JAX package, and exits non-zero without a result
when no CUDA device is usable.
"""
from __future__ import annotations

import argparse
import dataclasses
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
# worst kernel-vs-plain difference seen, per kernel, over every check
ERR = dict.fromkeys(KERNELS, 0)

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
    from nextpolish_tpu_torch.models.cns import level_scan as ls

    out, errs = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            out[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:  # reported below, then the run fails
            errs.append(f"{name}: {e!r}")

    threads = [threading.Thread(target=run, args=("level_scan", ls.build)),
               threading.Thread(target=run, args=("native", native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errs, "build failed: " + "; ".join(errs))
    check(native.available(), "native library did not load")
    info, secs = out["level_scan"]
    log(f"build: level_scan nvcc {info['seconds']:.1f} s "
        f"(wall {secs:.1f} s), native {out['native'][1]:.1f} s")
    for name, props in ptxas_by_kernel(info["ptxas"]).items():
        log(f"  ptxas: {name}: {props}")
    log(f"  level_chain dynamic shared memory {ls.chain_smem_bytes()} B "
        "per block")
    log('build: ' + json.dumps({"kernels": list(KERNELS)}))


def ptxas_by_kernel(text: str) -> dict:
    """ptxas -v output -> {kernel<template argument>: "Used N registers,
    ...; N bytes stack frame, N bytes spill stores, ..."}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(level_chain_kernel|level_winners_kernel|"
                          r"smem_step_probe)(?:IL[bi](\d)E)?", m.group(1))
            cur = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
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


def time_ms(fn, dev, reps):
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / reps


def main_path(tmp, dev, args):
    import torch

    from nextpolish_tpu_torch import sim, worker2
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
    out_dev = os.path.join(tmp, "main", "device.fa")
    os.environ.pop("NPT_CNS_ENGINE", None)
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

    # the group's shortest window, whole, against the plain versions
    i = min(range(len(dws)), key=lambda j: dws[j].n_levels)
    one = pack_batch([dws[i]]).to(dev)  # every level's scores kept
    ki1 = ls.level_chain(one, rt_id, c)
    kb1, ks1 = ls.level_winners(one, ki1, rt_id)
    t0 = time.perf_counter()
    pi1 = ls.level_chain_plain(one, rt_id, c)
    pb1, ps1 = ls.level_winners_plain(one, pi1, rt_id)
    torch.cuda.synchronize(dev)
    whole_plain_s = time.perf_counter() - t0
    fb_, fs = res["full"]
    lb, nl, _, _, sc_from, sc_base = (int(x) for x in full.win_host[i, :6])
    win_pairs = [(kb1, pb1), (ks1, ps1), (fb_[lb:lb + nl], pb1),
                 (fs[sc_base:sc_base + nl - sc_from], ps1[sc_from:])]
    e_chain, e_win = max_err([(ki1, pi1)]), max_err(win_pairs)
    log(f"main: window {i} of that group whole ({nl} levels, E={dws[i].E}, "
        f"Vb={dws[i].Vb}): plain {whole_plain_s:.1f} s; kernels alone and "
        f"the full-size launch vs plain: max_abs_err chain {e_chain}, "
        f"winners {e_win}")
    check(e_chain == 0 and torch.equal(ki1, pi1),
          "level_chain kernel != plain on a whole main-path window")
    check(e_win == 0 and all(torch.equal(a, b) for a, b in win_pairs),
          "level_winners kernel != plain on a whole main-path window")
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
                   bound_by=tb[k][1], library_ms=None,
                   full_group_ms=full_ms[k],
                   full_group_bound_ms=fb[k][0])
        if k == "level_chain":
            rec["full_group_chain_bound_ms"] = chain_bound_ms
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--contigs", type=int, default=8)
    args = p.parse_args(argv)

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
    with tempfile.TemporaryDirectory(prefix="npt_smoke_") as tmp:
        t0 = time.perf_counter()
        kernel_checks(tmp, dev, args.seed)
        log(f"check: all byte-equal ({time.perf_counter() - t0:.1f} s)")
        recs = main_path(tmp, dev, args)
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
