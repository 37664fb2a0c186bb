"""Work partitioning for the run.cfg pipeline: one process on one card.

Port of nextpolish_tpu/parallel/hosts.py for a single process.  The JAX
package splits contigs over jax.distributed processes (blc_genome) and
synchronises stages with device barriers; the port's several-process route
is ROADMAP A6.2 and not written yet.  So `process_count` is 1, `barrier`
has nothing to wait for, and `my_contigs` returns every contig.  A launch
that asks for more processes (NPT_NUM_PROCS or SLURM_NTASKS above 1)
raises instead of running as one process without saying so.
"""
from __future__ import annotations

import os


def process_count() -> int:
    """1; raises when the environment asks for several processes."""
    env = os.environ
    n = env.get("NPT_NUM_PROCS") or env.get("SLURM_NTASKS")
    if n and int(n) > 1:
        raise RuntimeError(
            f"{n} processes requested (NPT_NUM_PROCS / SLURM_NTASKS): the "
            "port runs one process on one card; several processes and "
            "hosts are ROADMAP A6.2, not ported yet")
    return 1


def barrier(name: str) -> None:
    """Block until every process reaches this point: with one process,
    return at once."""
    process_count()


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
    """Contigs assigned to this process: every one."""
    process_count()
    return list(lengths)
