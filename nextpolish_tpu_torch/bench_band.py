"""Time csrc/band_align.cu against another build of it on one card.

    python -m nextpolish_tpu_torch.bench_band --parent OLD.cu [--json OUT]

Builds the checkout's csrc/band_align.cu ("new") and the source named by
--parent ("parent": an older version, or a trial one, with the same C
interface).  At each shape of SHAPES it checks that both builds give the
same bytes (tb, scores, end cells; ops, final cells), then times
band_align and band_traceback over REPS launches each, the builds in
turns (parent, new, new, parent; TURNS times).  Each reading is the
device time per call, its launches queued behind a spin kernel
("device", see device_ms), and beside it plain CUDA events around the
calls ("events": the wrapper's host time between short launches shows
there).  Prints one line a shape, kernel and timer (every reading, then
each build's median), the card's name and power limit, and a JSON object
last (also written to --json).  compare() times any builds at any
shapes.  chip_smoke.py takes SHAPES, time_ms and device_ms from here.
Needs a card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

from . import sim
from .align import extend as text
from .runtime import nvcc

# (R, B, reads, mode) of the main path's launches: short reads, mate
# rescue, the largest long-read segment bucket, end extensions; and
# band_align's widest warp-route band (bands over 256 take that route
# from 256 reads) and the first band always on its block route
SHAPES = ((150, 32, 8192, "local"), (150, 1150, 256, "local"),
          (4096, 512, 16, "global"), (1000, 64, 512, "extend"),
          (150, 512, 256, "global"), (150, 544, 256, "local"))
KERNELS = ("band_align", "band_traceback")
REPS, TURNS, SEED = 20, 2, 1


@contextlib.contextmanager
def using(lib):
    """Route the wrappers of align/extend.py to `lib` for a while."""
    saved = text._LIB
    text._LIB = lib
    try:
        yield
    finally:
        text._LIB = saved


def time_ms(fn, dev, reps: int) -> float:
    """CUDA events around `reps` calls of fn, per call: the device time
    and whatever host time the calls leave between launches."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / reps


def device_ms(fn, dev, reps: int) -> float:
    """Device time of one call of fn: CUDA events around `reps` calls
    queued behind a spin kernel (torch.cuda._sleep), so the card runs
    them back to back and the wrapper's host time between calls, which
    events around short launches otherwise hold, stays out.  The spin
    doubles until it outlasts the host's queueing (checked by its own
    events).  A call's device work is its kernel and, for the traceback,
    the zero fill of its ops."""
    fn()
    cycles = 1 << 24
    for _ in range(6):
        torch.cuda.synchronize(dev)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        torch.cuda._sleep(cycles)
        e[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued = (time.perf_counter() - t0) * 1e3
        e[2].record()
        torch.cuda.synchronize(dev)
        if e[0].elapsed_time(e[1]) > queued:
            return e[1].elapsed_time(e[2]) / reps
        cycles *= 4
    raise RuntimeError("the spin never outlasted the host's queueing")


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def compare(libs: dict, shapes, dev) -> list:
    """Each build of `libs` ({name: bound library}; "new" among them)
    byte-equal to "new" at each (R, B, reads, mode) of `shapes`, then both
    kernels timed by both timers, the builds in turns.  Prints a line a
    shape, kernel and timer; returns a record a shape.  Raises on a
    difference."""
    order = (list(libs) + list(libs)[::-1]) * TURNS
    recs = []
    for R, B, Bt, mode in shapes:
        kw = dict(mode=mode, **sim.BAND_SCORES[mode])
        q, t, qlen, tlen = (torch.from_numpy(x).to(dev) for x in
                            sim.band_case(SEED + R + B, Bt, R, B, mode))
        got = {}
        for name, lib in libs.items():
            with using(lib):
                core = text.band_align_core(q, t, qlen, tlen, **kw)
                got[name] = core + text.band_traceback(core[0], core[2],
                                                       core[3])
        torch.cuda.synchronize(dev)
        for name, outs in got.items():
            if not all(torch.equal(a, b) for a, b in zip(outs, got["new"])):
                raise RuntimeError(f"bench_band: {name} differs from new at "
                                   f"({R}, {B}) x {Bt} {mode}")
        tb, ei, ec = got["new"][0], got["new"][2], got["new"][3]
        del got
        calls = {"band_align":
                 lambda: text.band_align_core(q, t, qlen, tlen, **kw),
                 "band_traceback": lambda: text.band_traceback(tb, ei, ec)}
        ms = {timer: {name: {k: [] for k in KERNELS} for name in libs}
              for timer in ("device", "events")}
        for name in order:
            with using(libs[name]):
                for k, fn in calls.items():
                    ms["device"][name][k].append(device_ms(fn, dev, REPS))
                    ms["events"][name][k].append(time_ms(fn, dev, REPS))
        med = {timer: {name: {k: statistics.median(v) for k, v in m.items()}
                       for name, m in by.items()}
               for timer, by in ms.items()}
        for k in KERNELS:
            for timer in ms:
                print(f"bench_band ({R}, {B}) x {Bt} {mode} {k} {timer}: "
                      + ", ".join(f"{name} " + " ".join(
                          f"{v:.4f}" for v in ms[timer][name][k])
                          for name in libs) + " ms; medians " + ", ".join(
                          f"{name} {med[timer][name][k]:.4f}"
                          for name in libs), flush=True)
        recs.append(dict(R=R, B=B, reads=Bt, mode=mode, ms=ms,
                         median_ms=med))
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=True)
    p.add_argument("--json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_band: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = {"parent": text.bind(nvcc.build(args.parent,
                                           "band_align_parent")["path"]),
            "new": text._load()}
    out = {"card": card(), "reps": REPS,
           "shapes": compare(libs, SHAPES, dev)}
    print(out["card"])
    line = json.dumps(out)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
