"""Time one of csrc/chain_scan.cu's two kernels against another build of
it on one card.

    python -m nextpolish_tpu_torch.bench_chain --parent OLD.cu \
        [--kernel traceback|forward] [--json OUT]

Builds the checkout's csrc/chain_scan.cu ("new") and the source named by
--parent ("parent": an older version, or a trial one, with the same C
interface; ops/chain.py's wrappers allocate the scratch either takes).  At
each (B, L) of SHAPES it draws inputs on the card, checks that both builds
give the plain version's result, then times the kernel's wrapper over
REPS launches, the builds in turns (parent, new, new, parent; TURNS
times), on two timers: the device time per call, its launches queued
behind a spin kernel (bench_band.device_ms), and plain CUDA events around
the calls (bench_band.time_ms).

- `traceback` (the default): chain_traceback on a random pointer table
  (rows padded with identity maps past a random n_dp), byte-equal to
  traceback_batch_plain; bound: P read once at 32 B a cell, b_end, one
  byte a cell written, over 3.35 TB/s.
- `forward`: chain_forward on random off-grid matrices (normal values
  times 30, 30% NEG) and s0 masks, f bit-equal to forward_states_plain;
  bound: A read once at 256 B a cell, s0, f written at 32 B a cell.

Then each build's device time at the largest shape split over its
kernels (and memsets) by torch.profiler, each build in a process of its
own (`--split-only SRC`).

    python -m nextpolish_tpu_torch.bench_chain --trace [SRC ...] \
        [--shape B,L] [--json OUT]

instead times chain_forward's units from the inside: each source (the
checkout's by default) is built with NPT_FWD_TRACE set, and the stamps
of one launch at --shape (the largest of SHAPES by default) give each
phase's median and 90th-percentile time a unit and the units in flight.

    python -m nextpolish_tpu_torch.bench_chain --ablate NAME [...] \
        [--shape B,L] [--json OUT]

times chain_forward in the checkout's build and in builds with one part
of its work taken out (ABLATIONS: A's second read, its first, the
look-back's waits, f's stores; wrong results, timing only).

Prints a line a shape and timer, the card's name and power limit, and a
JSON object last (also written to --json).  Needs a card and nvcc;
imports nothing of JAX.
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
# the kernels a build may launch for each wrapper (the parent's and the
# new design's); the profiler's memset records are named "Memset ..."
KERNELS = {"traceback": ("tb_maps", "tb_walk", "tb_replay"),
           "forward": ("fwd_chunks", "fwd_up", "fwd_down", "fwd_replay",
                       "fwd_scan", "Memset")}


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


def forward_case(seed: int, B: int, L: int, dev):
    """Random A [B, L, 8, 8] f32 off the half-integer grid (normal values
    times 30, 30% NEG) and s0 [B, 8] (state 0 and about half the others
    live), drawn on `dev`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, L, 8, 8), generator=g, device=dev) * 30.0
    A[torch.rand((B, L, 8, 8), generator=g, device=dev) < 0.3] = float(tch.NEG)
    s0 = torch.where(torch.rand((B, 8), generator=g, device=dev) < 0.5,
                     0.0, float(tch.NEG))
    s0[:, 0] = 0.0
    return A, s0


def bound_ms(B: int, L: int, kind: str = "traceback") -> float:
    """The bytes bound: for the traceback P read once (32 B a cell), b_end,
    choice written (1 B a cell); for the forward scan A read once (256 B
    a cell), s0, f written (32 B a cell)."""
    if kind == "forward":
        return B * (L * 256 + 32 + L * 32) / H100_BYTES_PER_S * 1e3
    return B * (L * 32 + 4 + L) / H100_BYTES_PER_S * 1e3


def case(kind: str, B: int, L: int, dev):
    """(inputs, wrapper, plain version) of `kind` at (B, L)."""
    if kind == "forward":
        return (forward_case(SEED + B + L, B, L, dev), tch.forward_states,
                tch.forward_states_plain)
    return (pointer_case(SEED + B + L, B, L, dev), tch.traceback_batch,
            tch.traceback_batch_plain)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def compare(libs: dict, shapes, dev, kind: str = "traceback") -> list:
    """Each build of `libs` ({name: bound library}; "new" among them)
    equal to the plain version (bit for bit) at each (B, L) of `shapes`,
    then timed by both timers, the builds in turns.  Prints a line a
    shape and timer; returns a record a shape.  Raises on a difference."""
    order = (list(libs) + list(libs)[::-1]) * TURNS
    recs = []
    for B, L in shapes:
        args, wrapper, plain = case(kind, B, L, dev)
        want = plain(*args)
        for name, lib in libs.items():
            with using(lib):
                got = wrapper(*args)
            if not same_bits(got, want):
                raise RuntimeError(f"bench_chain: {name} differs from the "
                                   f"plain version at ({B}, {L})")
        del want, got
        ms = {timer: {name: [] for name in libs}
              for timer in ("device", "events")}
        for name in order:
            with using(libs[name]):
                fn = lambda: wrapper(*args)  # noqa: E731
                ms["device"][name].append(device_ms(fn, dev, REPS))
                ms["events"][name].append(time_ms(fn, dev, REPS))
        med = {timer: {name: statistics.median(v) for name, v in by.items()}
               for timer, by in ms.items()}
        bnd = bound_ms(B, L, kind)
        for timer in ms:
            print(f"bench_chain ({B}, {L}) chain_{kind} {timer}: "
                  + ", ".join(f"{name} " + " ".join(
                      f"{v:.4f}" for v in ms[timer][name]) for name in libs)
                  + " ms; medians " + ", ".join(
                      f"{name} {med[timer][name]:.4f}" for name in libs)
                  + f"; bound {bnd:.4f} ms (new at "
                  f"{bnd / med[timer]['new'] * 100:.1f}% of it)", flush=True)
        recs.append(dict(B=B, L=L, ms=ms, median_ms=med, bound_ms=bnd,
                         bound_share={name: bnd / v for name, v in
                                      med["device"].items()}))
        del args
    return recs


def split(lib, dev, B: int, L: int, kind: str = "traceback",
          calls: int = 5) -> dict:
    """Device time per call of each kernel of the wrapper `kind` (names
    holding one of KERNELS[kind]) under torch.profiler, over `calls`
    calls; {} when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    args, wrapper, _ = case(kind, B, L, dev)
    with using(lib):
        wrapper(*args)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                wrapper(*args)
            torch.cuda.synchronize(dev)
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = next((k for k in KERNELS[kind] if k in e.name), "other")
            per[k] = (per.get(k, 0.0)
                      + e.time_range.elapsed_us() / 1e3 / calls)
    return per


def split_in_process(src: str, B: int, L: int,
                     kind: str = "traceback") -> dict:
    """split() of a build of `src` in a process of its own."""
    r = subprocess.run([sys.executable, "-m",
                        "nextpolish_tpu_torch.bench_chain", "--split-only",
                        src, "--shape", f"{B},{L}", "--kernel", kind],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    if r.returncode:
        raise RuntimeError(f"bench_chain split of {src} failed:\n{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


# Builds of csrc/chain_scan.cu with one part of chain_forward's work
# taken out (wrong results, for timing only): each is a list of (text,
# replacement) edits of the source, every one of which must apply.
ABLATIONS = {
    "no-replay-read": [("      if (t < kChunk) {",
                        "      if (t < kChunk && pol == keep) {")],
    "no-phase1-read": [("      if (t < kChunk) {",
                        "      if (t < kChunk && pol == drop) {")],
    "no-look-back": [("      const bool first = ur == 0;",
                      "      const bool first = true;"),
                     ("      const int k = __ffs(ur + 1) - 1;",
                      "      const int k = 0;"),
                     ("      if (ur + 1 != 1 << k) {", "      if (false) {")],
    "no-f-store": [("      if (live) __stcs(", "      if (!live) __stcs(")],
}


def ablate(names, dev, B: int, L: int) -> dict:
    """Device time of chain_forward at (B, L) in the checkout's build and
    in each ablation of `names` (ABLATIONS): which part of the work the
    launch's time follows."""
    with open(tch._SRC) as fh:
        src = fh.read()
    A, s0 = forward_case(SEED + B + L, B, L, dev)
    out = {}
    for name in ["full", *names]:
        text = src
        for old, new in ABLATIONS.get(name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"ablation {name}: {old!r} is not in "
                                   "the source once")
            text = text.replace(old, new)
        path = os.path.join(nvcc.BUILD_DIR, f"chain_scan_{name}.cu")
        os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text)
        lib = tch.bind(nvcc.build(path, f"chain_scan_{name}")["path"])
        with using(lib):
            out[name] = device_ms(lambda: tch.forward_states(A, s0), dev,
                                  REPS)
        print(f"bench_chain ablate ({B}, {L}) {name}: {out[name]:.4f} ms",
              flush=True)
    return out


TRACE_EVENTS = ("phase1", "T", "Pinc", "prefix", "replay")


def trace(src: str, dev, B: int, L: int) -> dict:
    """chain_forward's time line at (B, L) from a build of `src` with
    NPT_FWD_TRACE set (fwd_scan stamps each unit's ticket, phase 1's end,
    T and Pinc published, the unit's prefix in hand and the replay's end
    in globaltimer ns into rs): per event the median and 90th percentile
    of the time since the unit's previous event (µs), the span of the
    launch, the units in flight on average, and f's bits against
    forward_states_plain."""
    traced = os.path.join(nvcc.BUILD_DIR, "chain_scan_trace.cu")
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    with open(src) as fh, open(traced, "w") as out:
        out.write("#define NPT_FWD_TRACE 1\n" + fh.read())
    lib = tch.bind(nvcc.build(traced, "chain_scan_trace")["path"])
    A, s0 = forward_case(SEED + B + L, B, L, dev)
    nch = L // tch.CHUNK
    n_units = (B * nch + tch.FORWARD_UNIT - 1) // tch.FORWARD_UNIT
    f = torch.empty((B, L, 8), dtype=torch.float32, device=dev)
    scratch = torch.zeros((2, B, 2 * nch, 64), dtype=torch.float32,
                          device=dev)
    for _ in range(3):  # the last launch's stamps are read
        rc = lib.npt_chain_forward(A.data_ptr(), s0.data_ptr(), B, nch,
                                   scratch[0].data_ptr(),
                                   scratch[1].data_ptr(), f.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
        tch._raise_on(lib, rc, "traced chain_forward")
    torch.cuda.synchronize(dev)
    stamps = scratch[1].reshape(-1).view(torch.int64)[:n_units * 8]
    ev = stamps.reshape(n_units, 8)[:, :6].double().cpu()
    ev = ev - ev[:, 0].min()
    out = {"src": src, "B": B, "L": L, "units": n_units,
           "bit_equal": same_bits(f, tch.forward_states_plain(A, s0)),
           "span_us": float(ev[:, 5].max()) / 1e3,
           "in_flight": float((ev[:, 5] - ev[:, 0]).sum() / ev[:, 5].max())}
    for k, name in enumerate(TRACE_EVENTS):
        d = (ev[:, k + 1] - ev[:, k]) / 1e3
        out[name] = {"median_us": float(d.median()),
                     "p90_us": float(d.quantile(0.9)),
                     "mean_us": float(d.mean())}
    tot = (ev[:, 5] - ev[:, 0]) / 1e3
    out["unit"] = {"median_us": float(tot.median()),
                   "p90_us": float(tot.quantile(0.9)),
                   "mean_us": float(tot.mean())}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent")
    p.add_argument("--kernel", choices=sorted(KERNELS), default="traceback")
    p.add_argument("--json")
    p.add_argument("--split-only")
    p.add_argument("--trace", nargs="*", metavar="SRC")
    p.add_argument("--ablate", nargs="+", choices=sorted(ABLATIONS))
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
        print(json.dumps(split(lib, dev, B, L, args.kernel)))
        return 0
    if args.ablate:
        B, L = (int(v) for v in args.shape.split(","))
        rec = {"card": card(), "B": B, "L": L,
               "ms": ablate(args.ablate, dev, B, L)}
        print(rec["card"])
        if args.json:
            with open(args.json, "w") as fh:
                fh.write(json.dumps(rec) + "\n")
        return 0
    if args.trace is not None:
        B, L = (int(v) for v in args.shape.split(","))
        recs = [trace(src, dev, B, L) for src in (args.trace or [tch._SRC])]
        for rec in recs:
            print(f"bench_chain trace ({B}, {L}) {rec['src']}: "
                  + json.dumps({k: v for k, v in rec.items()
                                if k not in ("src", "B", "L")}), flush=True)
        print(card())
        line = json.dumps({"card": card(), "trace": recs})
        if args.json:
            with open(args.json, "w") as fh:
                fh.write(line + "\n")
        print(line)
        return 0
    if not args.parent:
        p.error("--parent is required")
    libs = {"parent": tch.bind(nvcc.build(args.parent,
                                          "chain_scan_parent")["path"]),
            "new": tch._load()}
    out = {"card": card(), "kernel": args.kernel, "reps": REPS,
           "shapes": compare(libs, SHAPES, dev, args.kernel)}
    B, L = SHAPES[0]
    out["split"] = {name: split_in_process(src, B, L, args.kernel)
                    for name, src in (("parent", args.parent),
                                      ("new", tch._SRC))}
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
