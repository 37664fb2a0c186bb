"""The port's dry run: one task-1 DP step, and task 1's and engine 2's
routes over several device entries, each held to one device.

    python -m nextpolish_tpu_torch.dryrun [--devices N] [--device cuda|cpu]

The counterpart of the repo's __graft_entry__.py:

- `entry(device)` gives (fn, example_args): `fn` is the dense chain DP
  (ops/chain.py::chain_correct_batch at chunk 128 and rate 0.5) on a
  leading axis of one region, the args the same L = 512 inputs from
  np.random.default_rng(0).  It returns the choices [1, 512] int8 (the
  JAX step also returns the running best score, which its callers do not
  use).  `fn(*args, plain=True)` runs both scans' plain versions.
- `dryrun_multichip(n, device)` runs over n entries taken in turn from
  resolve_devices(device), so [device] * n where `device` names one
  device (`cpu`, `cuda:0`, or `cuda` on a machine with one card): task 1's router
  (score_chain_pipeline_multichip with shard_min=0, so the contig of 512
  x n bases takes the reads-sharded route) against score_chain_contig on
  one device, and engine 2's _run_batch on two 6 kb long-read windows
  against the same call over one device.  It prints one line and returns
  what it compared; a difference raises.

The JAX dry run's mesh step (make_mesh, make_sharded_polish_step,
shard_inputs) and its step efficiency have no counterpart: the port's
router and reads-sharded merge take their place.  --devices N gives
dryrun_multichip's n; without it the CLI names every visible card once,
and takes two entries where --device resolves to one device ([cuda:0,
cuda:0] on a machine with one card).  The default device is `cuda`, which
raises without a card.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .device import resolve_device, resolve_devices

ENTRY_L = 512
ENTRY_RATE = 0.5
ENTRY_CHUNK = 128


def entry(device="cuda"):
    """(fn, example_args): the dense chain DP on one L = 512 region."""
    from .ops.chain import chain_correct_batch, init_state
    from .ops.symbols import K3

    dev = resolve_device(device)
    L = ENTRY_L
    rng = np.random.default_rng(0)
    counts = np.zeros((L, K3), dtype=np.int32)
    for c in range(L):
        ks = rng.integers(0, K3, 5)
        counts[c, ks] = rng.integers(1, 30, 5)
    refkmer = rng.integers(0, K3, L).astype(np.int32)
    counts[np.arange(L), refkmer] += 1
    total = counts.sum(axis=1).astype(np.int32)
    valid = np.ones(L, dtype=bool)
    s0 = init_state(counts[0])
    obs = counts > 0
    rank = np.where(obs, np.cumsum(obs, axis=1) - 1, 0xFFFF).astype(np.int32)

    def fn(counts, rank, refkmer, total, valid, s0, plain=False):
        return chain_correct_batch(counts, rank, refkmer, total, valid,
                                   ENTRY_RATE, s0, chunk=ENTRY_CHUNK,
                                   plain=plain)

    example_args = tuple(torch.from_numpy(a[None]).to(dev)
                         for a in (counts, rank, refkmer, total, valid, s0))
    return fn, example_args


def _task5_windows(names, drafts, batch) -> list:
    """Each contig as one engine-2 window (a DenseWindow over its whole
    length), built as __graft_entry__.py builds them."""
    from .models.cns.device_dp import densify_window
    from .models.cns.msa import build_edges
    from .models.cns.tags import WindowAccum, read_columns, trim_read_columns
    from .ops import pileup as pl

    dws = []
    for nm, dr in zip(names, drafts):
        tid = batch.header.name2id(nm)
        ca = np.frombuffer(dr.upper(), np.uint8)
        accum = WindowAccum(ca, 0, len(dr), 3)
        for rr in np.flatnonzero(pl.region_overlap_mask(
                batch, tid, 0, len(dr) - 1)):
            rr = int(rr)
            if int(batch.flag[rr]) & 0xD04:
                continue
            tr = trim_read_columns(*read_columns(batch, rr), accum.ref_cns,
                                   0, len(dr))
            if tr is not None:
                accum.add_row(tr[0], tr[1], tr[2], rr)
        merged = accum.finish()
        cov = accum.coverage[:len(dr)] + 1
        dw = densify_window(build_edges(merged), cov, len(dr))
        if dw is None:
            raise RuntimeError(f"{nm}: no device window")
        dws.append(dw)
    return dws


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Task 1's router and engine 2's groups over n_devices entries taken
    in turn from resolve_devices(device) (entries may repeat), each
    against one device (the first entry).  Returns {"task1": polished
    bytes, "task5": [(best, sc)], "bases", "windows", "wall_s"}."""
    from . import sim
    from .models.cns.device_dp import _run_batch
    from .models.score_chain import (
        AlgoConfig,
        score_chain_contig,
        score_chain_pipeline_multichip,
    )

    visible = resolve_devices(device)
    devs = [visible[k % len(visible)] for k in range(n_devices)]
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    names, trues, batch, _ = sim.make_task1_case(
        rng, L=ENTRY_L * len(devs), depth=12, n_contigs=1, p_indel=0.0,
        clip_frac=0.0, p_sub=0.02)
    cfg = AlgoConfig()
    routed = list(score_chain_pipeline_multichip(
        [(names[0], trues[0])], batch, cfg, devices=devs, shard_min=0))
    want1 = score_chain_contig(names[0], trues[0], batch, cfg,
                               device=devs[0])
    if routed != [(names[0], want1)]:
        raise AssertionError("task 1's router over "
                             f"{[str(d) for d in devs]} != one device")
    n5, d5, b5 = sim.make_task5_case(rng, L=6000, n_contigs=2, depth=25)
    dws = _task5_windows(n5, d5, b5)
    res = _run_batch(dws, "ont", devices=devs)
    res_one = _run_batch(dws, "ont", devices=[devs[0]])
    for (bm, sm), (bo, so) in zip(res, res_one):
        if not (np.array_equal(bm, bo) and np.array_equal(sm, so)):
            raise AssertionError("engine 2 over "
                                 f"{[str(d) for d in devs]} != one device")
    wall = time.perf_counter() - t0
    print(f"dryrun_multichip OK: devices={[str(d) for d in devs]} task1 "
          f"router byte-equal to one device ({len(want1)} bases), task5 "
          f"windows equal ({len(dws)}), wall {wall:.2f} s", flush=True)
    return {"task1": want1, "task5": res, "bases": len(want1),
            "windows": len(dws), "wall_s": wall}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--devices", type=int, default=None,
                   help="device entries, taken in turn from --device "
                        "(default: every visible card once, two entries "
                        "with one card)")
    args = p.parse_args(argv)
    fn, ex = entry(args.device)
    print(f"entry: {tuple(fn(*ex).shape)}", flush=True)
    n = args.devices or max(2, len(resolve_devices(args.device)))
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
