"""Several processes and hosts: work partitioning and launch glue (port of
nextpolish_tpu/parallel/hosts.py).

Partitioning (blc_genome role, source/nextPolish:93-117): the reference
bins contigs into `parallel_jobs` blocks by cumulative length and submits
one shell job per block.  Here the same greedy binning assigns contig
blocks to processes: each process polishes its block and writes its own
part file; rank 0 gathers (shared filesystem, like the reference's `cat`).

Launch (Paralleltask multi-node role, doc/OPTION.rst:75-113): every host
runs the same `python -m nextpolish_tpu_torch run.cfg` with three
environment variables (launch.py starts them):

    NPT_COORDINATOR=host0:9876  NPT_NUM_PROCS=4  NPT_PROC_ID=<rank>

and the processes meet in a torch.distributed process group.  Its
backend is gloo: the pipeline's barriers sync the hosts between stages
over a shared filesystem, no device tensor is reduced, and NCCL refuses
two ranks on one card.  Each rank's polishing still runs on its own
`--device` (a rank's `cuda` is its process's current card).
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch.distributed as dist

# Every rank must reach the rendezvous within this (the JAX package's
# jax.distributed.initialize waits 300 s): a rank that never starts, on a
# host where the launch failed, ends the others' wait after it.
RENDEZVOUS_TIMEOUT = timedelta(seconds=300)
# The longest a rank waits at one barrier for the others.  A barrier waits
# for the slowest rank's stage, and one rank's stage on a large genome can
# take hours (blc_genome's blocks differ by up to a contig, and a rank
# may get none), so this bound is long.  It is not what ends a run whose
# rank died: a process that ends closes its gloo connections, and the
# others' next barrier raises at once.  It bounds a rank that hangs, or a
# host lost without closing its connections.
BARRIER_TIMEOUT = timedelta(hours=24)


def _slurm_first_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist ('a,b', 'tpu[003-004]', ...)."""
    head = nodelist.split(",")[0]
    if "[" in head:
        base, rng = head.split("[", 1)
        first = rng.rstrip("]").split(",")[0].split("-")[0]
        return base + first
    return head


def init_distributed() -> int:
    """Join the process group that the NPT_* environment names (no-op
    without a coordinator or with one process).  Under SLURM (launch.py
    --slurm), rank/count/coordinator fall back to SLURM_PROCID /
    SLURM_NTASKS / the first allocation node.  Rank 0 serves the
    rendezvous store at the coordinator's address.  Returns the process
    count."""
    env = os.environ
    coord = env.get("NPT_COORDINATOR")
    nprocs = env.get("NPT_NUM_PROCS") or env.get("SLURM_NTASKS")
    rank = env.get("NPT_PROC_ID") or env.get("SLURM_PROCID")
    if coord is None and env.get("SLURM_JOB_NODELIST") and nprocs:
        coord = _slurm_first_node(env["SLURM_JOB_NODELIST"]) + ":9876"
    if coord and int(nprocs or 1) > 1 and not dist.is_initialized():
        host, port = coord.rsplit(":", 1)
        n, r = int(nprocs), int(rank)
        store = dist.TCPStore(host, int(port), n, r == 0,
                              timeout=RENDEZVOUS_TIMEOUT)
        dist.init_process_group("gloo", store=store, world_size=n, rank=r,
                                timeout=BARRIER_TIMEOUT)
    return process_count()


def process_count() -> int:
    """Processes in the run (jax.process_count's role): 1 unless
    init_distributed joined a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (jax.process_index's role)."""
    return dist.get_rank() if dist.is_initialized() else 0


def barrier(name: str) -> None:
    """Block until every process reaches this point (the analog of the
    reference waiting for all Paralleltask jobs of a stage).  gloo
    matches barriers by order; `name` says which one failed."""
    if process_count() <= 1:
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name}: {e}") from e


def blc_genome(lengths: dict, n_blocks: int) -> dict:
    """contig name -> block id, greedy by cumulative length
    (source/nextPolish:106-114 semantics)."""
    total = sum(lengths.values())
    blocksize = int(total / float(n_blocks) + 1)
    out = {}
    acc = 0
    block = 0
    for name, ln in lengths.items():
        out[name] = block
        acc += ln
        if acc >= blocksize:
            acc = 0
            block += 1
    return out


def my_contigs(lengths: dict) -> list:
    """Contigs assigned to this process.

    Single-process runs get everything; runs of several processes split
    by blc_genome over process_count()."""
    n = process_count()
    if n <= 1:
        return list(lengths)
    blocks = blc_genome(lengths, n)
    me = process_index()
    return [name for name, b in blocks.items() if b == me]
