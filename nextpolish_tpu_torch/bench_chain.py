"""Time csrc/chain_scan.cu's chain_traceback against another build of it on
one card.

    python -m nextpolish_tpu_torch.bench_chain --parent OLD.cu [--json OUT]

Builds the checkout's csrc/chain_scan.cu ("new") and the source named by
--parent ("parent": an older version, or a trial one, with the same C
interface; ops/chain.py's wrapper allocates the scratch either takes).  At
each (B, L) of SHAPES it draws a random pointer table on the card (rows
padded with identity maps past a random n_dp), checks that both builds
give the same bytes as traceback_batch_plain, then times chain_traceback
over REPS launches, the builds in turns (parent, new, new, parent; TURNS
times), on two timers: the device time per call, its launches queued
behind a spin kernel (bench_band.device_ms), and plain CUDA events around
the calls (bench_band.time_ms).  Beside each shape: its bytes bound (P
read once at 32 B a cell, b_end, one byte a cell written, over 3.35 TB/s).
Then each build's device time at the largest shape
split over its kernels (tb_maps, tb_walk, tb_replay) by torch.profiler,
each build in a process of its own (`--split-only SRC`).  Prints a line a
shape and timer, the card's name and power limit, and a JSON object last
(also written to --json).  Needs a card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

import torch

from .bench_band import card, device_ms, time_ms
from .ops import chain as tch
from .runtime import nvcc

# (B, L): task 1's three launches on chip_smoke.py's phase 5 (a 4.6 Mb
# chromosome and plasmids of 100 and 50 kb), a window of the window route
# (phase 6(a)), task 2's launches in phase 6(b) (each no-depth region and
# each rescue batch of its run was one row of one chunk), and a dense
# batch of many short rows (phase 6(b)'s stand-in rescue batch, 64
# regions of up to 1,024 cells)
SHAPES = ((1, 8_388_608), (1, 131_072), (1, 65_536), (1, 524_288),
          (1, 128), (64, 1_024))
REPS, TURNS, SEED = 20, 2, 1
H100_BYTES_PER_S = 3.35e12
KERNELS = ("tb_maps", "tb_walk", "tb_replay")


@contextlib.contextmanager
def using(lib):
    """Route ops/chain.py's wrappers to `lib` for a while."""
    saved = tch._LIB
    tch._LIB = lib
    try:
        yield
    finally:
        tch._LIB = saved


def pointer_case(seed: int, B: int, L: int, dev):
    """Random P [B, L, 8] int32 (entries 0..7), each row padded with the
    identity map past a random n_dp, and b_end [B], drawn on `dev`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    P = torch.randint(0, 8, (B, L, 8), generator=g, device=dev,
                      dtype=torch.int32)
    n_dp = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    pad = torch.arange(L, device=dev)[None, :] >= n_dp[:, None]
    P[pad] = torch.arange(8, device=dev, dtype=torch.int32)
    b_end = torch.randint(0, 8, (B,), generator=g, device=dev,
                          dtype=torch.int32)
    return P, b_end


def bound_ms(B: int, L: int) -> float:
    """P read once (32 B a cell), b_end, choice written (1 B a cell)."""
    return B * (L * 32 + 4 + L) / H100_BYTES_PER_S * 1e3


def compare(libs: dict, shapes, dev) -> list:
    """Each build of `libs` ({name: bound library}; "new" among them)
    byte-equal to traceback_batch_plain at each (B, L) of `shapes`, then
    timed by both timers, the builds in turns.  Prints a line a shape and
    timer; returns a record a shape.  Raises on a difference."""
    order = (list(libs) + list(libs)[::-1]) * TURNS
    recs = []
    for B, L in shapes:
        P, b_end = pointer_case(SEED + B + L, B, L, dev)
        want = tch.traceback_batch_plain(P, b_end)
        for name, lib in libs.items():
            with using(lib):
                got = tch.traceback_batch(P, b_end)
            if not torch.equal(got, want):
                raise RuntimeError(f"bench_chain: {name} differs from the "
                                   f"plain version at ({B}, {L})")
        del want, got
        ms = {timer: {name: [] for name in libs}
              for timer in ("device", "events")}
        for name in order:
            with using(libs[name]):
                fn = lambda: tch.traceback_batch(P, b_end)  # noqa: E731
                ms["device"][name].append(device_ms(fn, dev, REPS))
                ms["events"][name].append(time_ms(fn, dev, REPS))
        med = {timer: {name: statistics.median(v) for name, v in by.items()}
               for timer, by in ms.items()}
        bnd = bound_ms(B, L)
        for timer in ms:
            print(f"bench_chain ({B}, {L}) chain_traceback {timer}: "
                  + ", ".join(f"{name} " + " ".join(
                      f"{v:.4f}" for v in ms[timer][name]) for name in libs)
                  + " ms; medians " + ", ".join(
                      f"{name} {med[timer][name]:.4f}" for name in libs)
                  + f"; bound {bnd:.4f} ms (new at "
                  f"{bnd / med[timer]['new'] * 100:.1f}% of it)", flush=True)
        recs.append(dict(B=B, L=L, ms=ms, median_ms=med, bound_ms=bnd))
        del P, b_end
    return recs


def split(lib, dev, B: int, L: int, calls: int = 5) -> dict:
    """Device time per call of each chain_traceback kernel (names holding
    tb_maps, tb_walk, tb_replay) under torch.profiler, over `calls`
    calls; {} when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    P, b_end = pointer_case(SEED + B + L, B, L, dev)
    with using(lib):
        tch.traceback_batch(P, b_end)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                tch.traceback_batch(P, b_end)
            torch.cuda.synchronize(dev)
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = next((k for k in KERNELS if k in e.name), "other")
            per[k] = (per.get(k, 0.0)
                      + e.time_range.elapsed_us() / 1e3 / calls)
    return per


def split_in_process(src: str, B: int, L: int) -> dict:
    """split() of a build of `src` in a process of its own."""
    r = subprocess.run([sys.executable, "-m",
                        "nextpolish_tpu_torch.bench_chain", "--split-only",
                        src, "--shape", f"{B},{L}"],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    if r.returncode:
        raise RuntimeError(f"bench_chain split of {src} failed:\n{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent")
    p.add_argument("--json")
    p.add_argument("--split-only")
    p.add_argument("--shape", default=f"{SHAPES[0][0]},{SHAPES[0][1]}")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_chain: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.split_only:
        B, L = (int(v) for v in args.shape.split(","))
        lib = tch.bind(nvcc.build(args.split_only,
                                  "chain_scan_split")["path"])
        print(json.dumps(split(lib, dev, B, L)))
        return 0
    if not args.parent:
        p.error("--parent is required")
    libs = {"parent": tch.bind(nvcc.build(args.parent,
                                          "chain_scan_parent")["path"]),
            "new": tch._load()}
    out = {"card": card(), "reps": REPS, "shapes": compare(libs, SHAPES, dev)}
    B, L = SHAPES[0]
    out["split"] = {name: split_in_process(src, B, L) for name, src in
                    (("parent", args.parent), ("new", tch._SRC))}
    for name, per in out["split"].items():
        print(f"bench_chain ({B}, {L}) {name} by kernel (torch.profiler, "
              "device ms a call): " + (", ".join(
                  f"{k} {v:.4f}" for k, v in per.items())
                  or "no device time recorded"), flush=True)
    print(out["card"])
    line = json.dumps(out)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
