"""One run of one cell of the port's benchmark (npbench/run.py is the
command).

A cell (`workloads` in BENCHMARK.json) names a configuration and a
traffic mix.  Everything that belongs to one of them sits in files of its
own, found by name:

  npbench/configs/<config>.json   the deployment: reads, draft, job kind
                                  (BENCHMARK.json's `file`)
  npbench/cells/<cell>.json       the traffic: the pool of blocks (contig
                                  lengths), the contigs a check compares
  npbench/gens/<reads.kind>.py    one generator a read kind:
                                  simulate(seed, lens, config) ->
                                  simgen.SimCase
  npbench/jobs/<kind>.py          how one job runs the program, and its
                                  plain reference
  npbench/metrics/<metric>.py     one reader a metric: read(ctx) -> number
                                  or None

A run:
  1. makes its inputs from --seed with the configuration's read
     generator (npbench/gens/, on the benchmark's own npbench/simgen.py)
     into a directory under TMPDIR: per block of the cell's pool a draft
     FASTA and a sorted, indexed BAM;
  2. runs one warm job on the pool's first block, which loads the
     program's kernels (built into the checkout's
     nextpolish_tpu_torch/_build/ on a checkout's first run) and warms
     every shape the window uses; set-up (setup_s) ends there;
  3. runs jobs back to back, one client in a closed loop, the pool's
     blocks in an order drawn from the seed, until --seconds have passed;
     a job started before then runs to its end (with --trace 1 under
     torch.profiler);
  4. checks the polished FASTA that the window's jobs wrote: every job's
     records against its block's contigs, and the cell's
     `check_contigs` contigs (one where it gives none) drawn from the
     seed, in every job that polished them, against the plain reference;
  5. prints the check lines last on standard error and one JSON line last
     on standard output.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that may not be loaded in a run (compared whole:
# the port's own name, nextpolish_tpu_torch, begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "nextpolish_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------

def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def cell_spec(workload: str, root: str = ROOT) -> dict:
    """The cell's manifest entry, configuration, traffic and metrics."""
    man = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in reported]
    return dict(
        workload=w, chips=int(w["chips"]),
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(root, "npbench", "cells",
                                        workload + ".json")),
        end_to_end=e2e, per_layer=layer,
        run_seconds=int(man["run_seconds"]))


def load_file(folder: str, name: str, root: str = ROOT):
    """npbench/<folder>/<name>.py, loaded as a module of its own."""
    path = os.path.join(root, "npbench", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"npbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, root: str = ROOT):
    """npbench/metrics/<name>.py's read function."""
    return load_file("metrics", name, root).read


def job_kind(config: dict):
    return importlib.import_module("npbench.jobs." + config["job"])


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@dataclass
class Block:
    """One block of contigs: what one job polishes."""

    name: str
    names: list
    truths: list
    drafts: list
    records: list  # the generator's BAM record dicts, sorted by (tid, pos)
    fa: str
    bam: str
    _starts: list = field(default_factory=list)

    @property
    def bases(self) -> int:
        return sum(len(d) for d in self.drafts)

    def records_of(self, i: int) -> list:
        if not self._starts:
            tids = np.array([r["tid"] for r in self.records])
            self._starts = np.searchsorted(
                tids, np.arange(len(self.names) + 1)).tolist()
        return self.records[self._starts[i]:self._starts[i + 1]]


def make_block(config: dict, lens: list, seed: int, outdir: str,
               name: str, root: str = ROOT) -> Block:
    """A block of contigs of the given lengths with the configuration's
    reads, generated from `seed` by the generator of its read kind,
    npbench/gens/<reads.kind>.py, and written under outdir/name."""
    from npbench import simgen

    kind = config["reads"]["kind"]
    folder = os.path.join(root, "npbench", "gens")
    if not os.path.isfile(os.path.join(folder, kind + ".py")):
        raise ValueError(f"unknown read kind {kind!r}: no {kind}.py in "
                         f"{folder}")
    case = load_file("gens", kind, root).simulate(seed, lens, config)
    fa, bam = simgen.write_case(case, os.path.join(outdir, name))
    return Block(name, case.names, case.truths, case.drafts, case.records,
                 fa, bam)


def seeds_of(seed: int, n: int) -> list:
    """n independent 63-bit seeds drawn from the run's seed."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [int(c.generate_state(1, np.uint64)[0] >> 1)
            for c in ss.spawn(n)]


def replay_order(seed: int, n: int):
    """Block indices for jobs 0, 1, ...: a fresh permutation of the pool
    each time it is used up."""
    rng = np.random.default_rng(seed)
    while True:
        yield from rng.permutation(n).tolist()


def read_fasta(path: str) -> list:
    """[(name, declared length or None, sequence)] of a worker's output
    (`>name len` headers)."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    for rec in data.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        f = head.split()
        dl = int(f[1]) if len(f) > 1 and f[1].isdigit() else None
        out.append((f[0].decode() if f else "", dl,
                    body.replace(b"\n", b"")))
    return out


def mismatches(a: bytes, b: bytes) -> int:
    """Positions at which two sequences differ, the longer one's excess
    counted whole."""
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], np.uint8)
    y = np.frombuffer(b[:n], np.uint8)
    return int((x != y).sum()) + abs(len(a) - len(b))


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclass
class Job:
    k: int
    block: Block
    out: str
    start: float
    end: float


def contig_of(block: Block, name: str) -> str | None:
    """The block's contig a record belongs to: its own name, or
    `<contig>_s<j>` for a part of a contig split at a structural split
    point; None for a name the block does not have."""
    if name in block.names:
        return name
    base, sep, j = name.rpartition("_s")
    return base if sep and j.isdigit() and base in block.names else None


def bad_records(block: Block, got: list) -> int:
    """Records of a job's output that name no contig of the block, repeat
    a name or carry a wrong length field, and contigs of the block that
    the output lacks or holds out of order."""
    names = [g[0] for g in got]
    bad = sum(1 for g in got if g[1] is None or g[1] != len(g[2]))
    bad += len(names) - len(set(names))
    of = [contig_of(block, n) for n in names]
    bad += sum(1 for c in of if c is None)
    seen = [c for k, c in enumerate(of) if c is not None
            and (k == 0 or of[k - 1] != c)]
    bad += len(set(block.names) - set(seen))
    if not bad and seen != list(block.names):
        bad += 1
    return bad


def serialize(parts: list) -> bytes:
    """Records as they are compared: name and sequence of each part."""
    return b"".join(b">" + n.encode() + b"\n" + s + b"\n"
                    for n, s in parts)


def sampled_contigs(seed: int, names: list, k: int = 1) -> list:
    """The (block, contig index) pairs a run's check compares with the
    reference: k of them (all, where there are fewer), drawn from the
    seed without repeats among the sorted (block, index) pairs of the
    blocks that ran."""
    pairs = sorted(names)
    rng = np.random.default_rng(seeds_of(seed, 4)[3])
    pick = rng.permutation(len(pairs))[:max(1, k)]
    return [pairs[int(j)] for j in pick]


def check(jobs: list, kind, config: dict, seed: int, device: str,
          k: int = 1) -> tuple:
    """(checks, attempted, failed, note): the window's outputs against
    their blocks, and k contigs drawn from the seed against the
    reference, in every job that polished them."""
    outs = [read_fasta(j.out) for j in jobs]
    bad = [bad_records(j.block, got) for j, got in zip(jobs, outs)]
    blocks = {id(j.block): j.block for j in jobs}
    picked = sampled_contigs(seed, [(b.name, i) for b in blocks.values()
                                    for i in range(len(b.names))], k)
    mm, notes = {}, []
    for bname, i in picked:
        block = next(b for b in blocks.values() if b.name == bname)
        cname = block.names[i]
        t = time.perf_counter()
        ref = serialize(kind.reference(block, i, device, config))
        ref_s = time.perf_counter() - t
        n = 0
        for j, got in zip(jobs, outs):
            if j.block is block:
                mine = serialize([(g[0], g[2]) for g in got
                                  if contig_of(block, g[0]) == cname])
                mm[id(j)] = mm.get(id(j), 0) + mismatches(mine, ref)
                n += 1
        notes.append(f"{bname}/{cname} ({len(block.drafts[i])} draft "
                     f"bases, {ref_s:.2f} s, {n} of {len(jobs)} jobs)")
    failed = sum(1 for j, b in zip(jobs, bad) if b or mm.get(id(j), 0))
    note = "reference " + ", ".join(notes)
    checks = [("bad_records", sum(bad), 0),
              ("mismatched_bases", sum(mm.values()), 0)]
    return checks, len(jobs), failed, note


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: str = ROOT, t0: float | None = None,
        traffic: dict | None = None) -> dict:
    """One run; returns the result line's object.  A test may pass
    `device="cpu"` (the program's plain versions) and a smaller
    `traffic`."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = cell_spec(workload, root)
    cfg, traffic = spec["config"], traffic or spec["traffic"]
    # every cache the program writes stays inside the checkout
    cache = os.path.join(root, "npbench", "_cache")
    os.makedirs(cache, exist_ok=True)
    os.environ["NPT_CNS_CALIB"] = os.path.join(cache, "cns_calib.json")
    os.environ["USE_FLAX"] = "0"
    for k, v in cfg.get("env", {}).items():
        os.environ[k] = str(v)
    import torch

    if device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device="cuda")
    kind = job_kind(cfg)
    build_dir = os.path.join(root, "nextpolish_tpu_torch", "_build")

    def built() -> set:
        return set(os.listdir(build_dir)) if os.path.isdir(build_dir) \
            else set()

    work = tempfile.mkdtemp(prefix="npbench.", dir=tempfile.gettempdir())
    try:
        pool = traffic["pool"]
        sd = seeds_of(seed, 4)
        bseeds = seeds_of(sd[0], len(pool))
        t = time.perf_counter()
        blocks = [make_block(cfg, lens, s, work, f"block{b}", root)
                  for b, (lens, s) in enumerate(zip(pool, bseeds))]
        # the warm job polishes the pool's first block, so the window's
        # shapes are all warm before it opens
        warm = blocks[0]
        gen_s = time.perf_counter() - t
        t = time.perf_counter()
        before = built()
        kind.run(warm, os.path.join(work, "warm.out.fa"), device, cfg)
        warm_s = time.perf_counter() - t
        new = sorted(built() - before)
        setup_s = time.perf_counter() - t0
        log(f"set-up {setup_s:.3f} s: inputs {gen_s:.3f} s "
            f"({sum(b.bases for b in blocks)} draft bases in "
            f"{len(blocks)} blocks, {sum(len(b.records) for b in blocks)} "
            f"reads), warm job {warm_s:.3f} s, which built "
            f"{', '.join(new) if new else 'nothing'} (a checkout's first "
            f"run builds the program's kernels)")

        from npbench import devtrace

        ptrace = devtrace.program_trace()
        if ptrace is not None:
            ptrace.reset()
        prof = devtrace.Profile(device) if trace else None
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        order = replay_order(sd[2], len(blocks))
        jobs = []
        if prof:
            prof.start()
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            b = blocks[next(order)]
            k = len(jobs)
            out = os.path.join(work, f"job{k}.fa")
            s = time.perf_counter()
            with devtrace.annotate(f"npbench.job{k}.{b.name}", prof):
                kind.run(b, out, device, cfg)
            if device == "cuda":
                torch.cuda.synchronize()
            jobs.append(Job(k, b, out, s, time.perf_counter()))
        window_s = jobs[-1].end - w0
        if prof:
            prof.stop()
        buckets = ptrace.snapshot() if ptrace is not None else {}
        mem = (torch.cuda.max_memory_allocated() if device == "cuda"
               else 0)
        bases = sum(j.block.bases for j in jobs)
        log(f"window {window_s:.3f} s: {len(jobs)} jobs, {bases} bases: "
            + ", ".join(f"{j.block.name} {j.end - j.start:.3f} s"
                        for j in jobs))
        bad = forbidden_modules()
        if bad:
            log("modules that may not be loaded: " + ", ".join(bad))
            raise SystemExit(3)
        ctx = dict(setup_s=setup_s, window_s=window_s, bases=bases,
                   jobs=len(jobs), buckets=buckets)
        result_metrics = {}
        devinfo = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else "cpu"),
                   "count": spec["chips"], "memory_peak_bytes": int(mem)}
        breakdown = None
        if trace:
            dt = prof.read(jobs)
            ctx["trace"] = dt
            devinfo["busy_s"] = dt.busy_s
            devinfo["window_s"] = dt.window_s
            breakdown = dt.breakdown()
            metrics = spec["per_layer"]
        else:
            metrics = spec["end_to_end"]
        for m in metrics:
            v = load_reader(m["name"], root)(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        # the program's state is freed before the reference runs
        ctx.pop("trace", None)
        prof = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        checks, attempted, failed, note = check(
            jobs, kind, cfg, seed, device, traffic.get("check_contigs", 1))
        log(note)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": attempted, "failed": failed,
           "metrics": result_metrics, "device": devinfo}
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return res


def main(argv=None, t0: float | None = None) -> int:
    p = argparse.ArgumentParser(prog="npbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    if importlib.util.find_spec("nextpolish_tpu_torch") is None:
        log("the program (nextpolish_tpu_torch) is not in this checkout")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        log(f"the cell needs {spec['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              t0=t0)
    for n, c in res["checks"].items():
        log(f"check {n} {c['value']} limit {c['limit']}")
    print(json.dumps(res), flush=True)
    return 0
