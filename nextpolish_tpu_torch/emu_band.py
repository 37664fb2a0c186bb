"""Run csrc/band_align.cu on the CPU, without a card, against the plain
versions: a check of the kernels' logic before a build on the card.

    python -m nextpolish_tpu_torch.emu_band [--src FILE.cu] \
        [--case band_case|band_indel_case] [R,B,READS ...]

g++ builds the source as it stands against csrc/emu/cuda_runtime.h, which
stands in for CUDA (one std::thread per CUDA thread; the source's NPT_*
macros: a launch runs the kernel's blocks one at a time, cp.async is a
copy), into a shared library under the system's temporary directory,
bound like the card's build (extend.bind).  For each shape and mode it
compares tb, the scores, the end cells, the ops and the final cells with
band_align_plain and band_traceback_plain on the same inputs, and exits 1
on a difference.
It finds wrong logic (a tie rule between rows broken by a change to the
best-cell key showed here before the card); it cannot find a race
between blocks, a compile error of nvcc, or a time.
Needs g++ with C++20; a few seconds a shape at R = 150.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile
import time

import torch

from . import sim
from .align import extend as text

EMU_DIR = os.path.join(os.path.dirname(text._SRC), "emu")
SHAPES = ("150,32,10", "120,100,9", "150,544,5", "60,512,3", "20,512,256",
          "1100,64,3", "150,1150,3", "40,1,5", "30,2048,2")


def build(src: str, defines=()) -> str:
    """g++ builds `src` (with -D `defines`) against the stand-in header
    into the system's temporary directory, once per content."""
    tag = hashlib.sha1(open(src, "rb").read() + open(
        os.path.join(EMU_DIR, "cuda_runtime.h"), "rb").read()
        + " ".join(defines).encode()).hexdigest()
    so = os.path.join(tempfile.gettempdir(), f"npt_emu_{tag[:12]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"  # builds in parallel never share one
        r = subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC",
                            "-pthread", "-Wno-unknown-pragmas", "-I", EMU_DIR,
                            *defines, "-x", "c++", "-o", tmp, src],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"g++ failed:\n{r.stderr}")
        os.replace(tmp, so)
    return so


def run(lib, q, t, qlen, tlen, mode, kw):
    """Both emulated kernels, as the wrappers call them on a card."""
    Bt, R = q.shape
    B = t.shape[1] - R
    tb = torch.full((Bt, R, B), 0xEE, dtype=torch.uint8)
    best, bi, bc = (torch.empty(Bt, dtype=torch.int32) for _ in range(3))
    rc = lib.npt_band_align(
        q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), Bt, R,
        B, text.MODES.index(mode), kw["match"], kw["mismatch"], kw["gapo"],
        kw["gape"], kw.get("clip5", 0), kw.get("clip3", 0), tb.data_ptr(),
        best.data_ptr(), bi.data_ptr(), bc.data_ptr(), None)
    text._raise_on(lib, rc, "emulated band_align")
    S = text.steps_for(R, B)
    ops = torch.zeros((Bt, S // 4), dtype=torch.uint8)
    fi, fc = (torch.empty(Bt, dtype=torch.int32) for _ in range(2))
    rc = lib.npt_band_traceback(tb.data_ptr(), bi.data_ptr(), bc.data_ptr(),
                                Bt, R, B, S, ops.data_ptr(), fi.data_ptr(),
                                fc.data_ptr(), None)
    text._raise_on(lib, rc, "emulated band_traceback")
    return tb, best, bi, bc, ops, fi, fc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("shapes", nargs="*", default=list(SHAPES))
    p.add_argument("--src", default=text._SRC)
    p.add_argument("--case", default="band_case",
                   choices=("band_case", "band_indel_case"))
    args = p.parse_args(argv)
    lib = text.bind(build(args.src))
    names = ("tb", "best", "best_i", "best_c", "ops", "fin_i", "fin_c")
    bad = 0
    for shape in args.shapes:
        R, B, Bt = (int(v) for v in shape.split(","))
        for mode in text.MODES:
            kw = sim.BAND_SCORES[mode]
            q, t, qlen, tlen = (torch.from_numpy(x) for x in getattr(
                sim, args.case)(B + R, Bt, R, B, mode))
            t0 = time.perf_counter()
            got = run(lib, q, t, qlen, tlen, mode, kw)
            want = text.band_align_plain(q, t, qlen, tlen, mode=mode, **kw)
            want = want + text.band_traceback_plain(*want[:1], want[2],
                                                    want[3])
            diff = [n for n, g, w in zip(names, got, want)
                    if not torch.equal(g, w)]
            bad += bool(diff)
            print(f"({R}, {B}) x {Bt} {mode}: "
                  f"{'differs in ' + ', '.join(diff) if diff else 'equal'} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
