"""Build a hand-written CUDA source into a shared library with a plain C
interface, for ctypes.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.<hash>.so <src>

The library lands in the package's `_build/` directory (git ignores it)
under a name that hashes the source and the flags, so an edited source
builds anew and an unchanged one is reused; a file lock keeps concurrent
processes from building it twice.  Nothing is built at import: callers
build at first use, on the machine with the card.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC_DIR = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc(src: str) -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       f"the kernels of {src} are built at first use")


def build(src: str, name: str) -> dict:
    """Compile `src` for sm_90a into _build/lib<name>.<hash>.so (once per
    source content, under a file lock).  Returns {"path", "seconds",
    "ptxas"}: seconds is 0.0 when an earlier build was reused, ptxas is
    what `-Xptxas -v` reported when it was built."""
    text = open(src, "rb").read()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(BUILD_DIR, f"lib{name}.{digest[:12]}.so")
    log = so + ".log"
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        seconds = 0.0
        if not os.path.exists(so):
            t0 = time.perf_counter()
            r = subprocess.run([find_nvcc(src), *NVCC_FLAGS, "-o",
                                so + ".tmp", src], capture_output=True,
                               text=True, timeout=600)
            seconds = time.perf_counter() - t0
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({r.returncode}):"
                                   f"\n{r.stdout}\n{r.stderr}")
            with open(log, "w") as fh:
                fh.write(r.stdout + r.stderr)
            os.replace(so + ".tmp", so)
    ptxas = open(log).read() if os.path.exists(log) else ""
    return dict(path=so, seconds=seconds, ptxas=ptxas)
