"""Tasks 5/6 — long-read (lgs_polish) / HiFi (hifi_polish) consensus.

Entry point over the window engine in models/cns/ (ctg_cns_core,
lib/ctg_cns.c:3399-3623).  Emits (name, sequence) parts; with split=1
(the worker's -sp default) contigs over 100 kb can split at structural
split points, yielding `name_sJ` parts (lib/nextpolish2.py:195-200).
"""
from __future__ import annotations

from .cns.window import consensus_for_contig

READ_TYPES = {"ont", "clr", "hifi", "rs"}


def ctg_cns_contig(name: str, draft: bytes, batch, read_type: str,
                   split: int = 0, window: int = 5_000_000,
                   min_cov: int = 4, qv_desc: str | None = None,
                   batcher=None, device=None):
    if read_type not in READ_TYPES:
        raise ValueError(f"unknown read type {read_type!r}")
    tid = batch.header.name2id(name)
    if tid < 0:
        return [(name, draft)]
    seqs = consensus_for_contig(batch, tid, draft, read_type, window=window,
                                min_cov=min_cov, split=int(split),
                                contig_name=name, qv_desc=qv_desc,
                                batcher=batcher, device=device)
    if len(seqs) == 1:
        if len(seqs[0]) <= 10:
            # the reference hard-errors on tiny outputs
            # (lib/nextpolish2.py:195-202); keep the draft instead
            return [(name, draft)]
        return [(name, seqs[0])]
    return [(f"{name}_s{j}", seq) for j, seq in enumerate(seqs)]
