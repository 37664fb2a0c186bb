"""Run csrc/chain_scan.cu on the CPU, without a card, against the plain
versions: a check of the kernels' logic before a build on the card.

    python -m nextpolish_tpu_torch.emu_chain [--src FILE.cu] [--lg-walk K] \
        [--big] [B,NCH ...]

g++ builds the source as it stands against csrc/emu/cuda_runtime.h (see
emu_band.py: one std::thread per CUDA thread, a launch runs its blocks one
at a time), bound like the card's build (ops/chain.py::bind).  For each
(B, NCH) it runs chain_traceback on random pointer tables, each row
padded with identity maps past a random n_dp, as the wrappers call it on
a card, and compares the choices with traceback_batch_plain; and
chain_forward on random half-integer matrices with NEG entries (with
--big: magnitudes whose chunk products pass 2^24, where f32 rounds and
the look-back's order of combining shows in the bits), bit for bit with
forward_states_plain, where B x NCH is at most FORWARD_CHUNKS.  The
emulated launch runs its blocks one at a time, so a unit's look-back
waits only on warps of the same block, which run beside it.  --lg-walk
builds the source with tb_walk's most threads cut to 2^K, so that small
rows reach its routes of several warps and of several group maps a
thread (a group is 8 chunks).  Exits 1 on a difference.  It finds wrong
logic; it cannot find a race between blocks, a compile error of nvcc, or
a time.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .emu_band import build
from .ops import chain as tch

# (B, nch): groups of one, two, four and eight chunks; one row of 32
# groups (a warp of tb_walk, a group a thread), many rows of one and two
# chunks (a block a row)
SHAPES = ("1,1", "1,2", "1,256", "64,1", "64,2", "3,4")
FORWARD_CHUNKS = 128


def pointer_case(seed: int, B: int, nch: int):
    """Random P [B, L, 8] int32 with rows padded by identity maps past a
    random n_dp, and b_end [B], as test_torch_chain builds them."""
    rng = np.random.default_rng(seed)
    L = tch.CHUNK * nch
    P = rng.integers(0, 8, (B, L, 8)).astype(np.int32)
    for b, n in enumerate(rng.integers(1, L + 1, B)):
        P[b, n:] = np.arange(8)
    b_end = rng.integers(0, 8, B).astype(np.int32)
    return torch.from_numpy(P), torch.from_numpy(b_end)


def forward_case(seed: int, B: int, nch: int, big: bool = False):
    """Random A [B, L, 8, 8] (half-integers, 30% NEG; or, with `big`,
    multiples of 1000.5 up to 10^6, as test_torch_chain draws them) and
    s0 [B, 8]."""
    rng = np.random.default_rng(seed)
    if big:
        A = rng.integers(-1000, 1000, (B, tch.CHUNK * nch, 8, 8)) * 1000.5
    else:
        A = rng.integers(-40, 40, (B, tch.CHUNK * nch, 8, 8)) * 0.5
        A[rng.random(A.shape) < 0.3] = tch.NEG
    s0 = np.where(rng.random((B, 8)) < 0.5, 0.0, tch.NEG)
    s0[:, 0] = 0.0
    return (torch.from_numpy(A.astype(np.float32)),
            torch.from_numpy(s0.astype(np.float32)))


def traceback(lib, P, b_end):
    """The emulated chain_traceback, as traceback_batch calls it."""
    B, L = P.shape[0], P.shape[1]
    choice = torch.full((B, L), -1, dtype=torch.int8)
    maps, ends = tch.traceback_scratch(B, L // tch.CHUNK, "cpu")
    rc = lib.npt_chain_traceback(P.data_ptr(), b_end.data_ptr(), B,
                                 L // tch.CHUNK, maps.data_ptr(),
                                 ends.data_ptr(), choice.data_ptr(), None)
    tch._raise_on(lib, rc, "emulated chain_traceback")
    return choice


def forward(lib, A, s0):
    """The emulated chain_forward, as forward_states calls it."""
    B, L = A.shape[0], A.shape[1]
    nch = L // tch.CHUNK
    f = torch.full((B, L, 8), float("nan"), dtype=torch.float32)
    scratch = torch.empty((2, B, 2 * nch, 64), dtype=torch.float32)
    rc = lib.npt_chain_forward(A.data_ptr(), s0.data_ptr(), B, nch,
                               scratch[0].data_ptr(), scratch[1].data_ptr(),
                               f.data_ptr(), None)
    tch._raise_on(lib, rc, "emulated chain_forward")
    return f


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("shapes", nargs="*", default=list(SHAPES))
    p.add_argument("--src", default=tch._SRC)
    p.add_argument("--lg-walk", type=int)
    p.add_argument("--big", action="store_true")
    args = p.parse_args(argv)
    defs = [] if args.lg_walk is None else [f"-DNPT_LG_WALK={args.lg_walk}"]
    lib = tch.bind(build(args.src, defs))
    bad = 0
    for i, shape in enumerate(args.shapes):
        B, nch = (int(v) for v in shape.split(","))
        t0 = time.perf_counter()
        P, b_end = pointer_case(i, B, nch)
        same = torch.equal(traceback(lib, P, b_end),
                           tch.traceback_batch_plain(P, b_end))
        msg = f"traceback {'equal' if same else 'DIFFERS'}"
        bad += not same
        if B * nch <= FORWARD_CHUNKS:
            A, s0 = forward_case(i, B, nch, args.big)
            fs = torch.equal(forward(lib, A, s0).view(torch.int32),
                             tch.forward_states_plain(A, s0).view(
                                 torch.int32))
            msg += f", forward {'bit-equal' if fs else 'DIFFERS'}"
            bad += not fs
        print(f"(B, nch) = ({B}, {nch}): {msg} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
