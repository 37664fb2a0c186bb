"""Job kind `worker2_sv`: engine 2 (`worker2 -r <read type>`) on reads
that carry aux tags, SA tags of split reads among them.  The program runs
as job kind `worker2` runs it.

The reference is npbench/ref/cns/ over the contig's records with their
raw tag bytes: the SA walk finds split-read gap candidates, lets clipped
split reads past the clip filter and collects supplementary alignments,
so the structural layer runs as NextPolish runs it
(lib/ctg_cns.c:3487-3508).  The `worker2` job kind's record batch
(npbench/ref/cns/bam.py) carries no tags, and on split reads its
reference is not NextPolish's result.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from npbench.jobs.worker2 import CONTROL_DTYPE, DTYPE, run  # noqa: F401
from npbench.ref.cns import WINDOW
from npbench.ref.cns.bam import AlnBatch
from npbench.ref.cns.window import consensus_for_contig


@dataclass
class TaggedBatch(AlnBatch):
    """AlnBatch with each record's raw aux bytes (`tags`: one bytes
    object a record)."""

    tags: list = None

    @classmethod
    def of(cls, records: list, tid: int = 0) -> "TaggedBatch":
        batch = super().of(records, tid)
        batch.tags = [bytes(r.get("tags", b"")) for r in records]
        return batch

    def rec_tags(self, i: int) -> bytes:
        return self.tags[i]


def reference(block, i: int, device: str, config: dict,
              dtype=DTYPE) -> list:
    """[(name, sequence)] parts of contig i of the block, polished by the
    plain reference from the records and their tags (on the host:
    `device` is not used), as npbench.ref.cns.polish_contig names
    them."""
    name, draft = block.names[i], block.drafts[i]
    seqs = consensus_for_contig(
        TaggedBatch.of(block.records_of(i)), 0, draft,
        config["read_type"], window=WINDOW, split=1, contig_name=name,
        dtype=dtype)
    if len(seqs) == 1:
        return [(name, draft if len(seqs[0]) <= 10 else seqs[0])]
    return [(f"{name}_s{j}", s) for j, s in enumerate(seqs)]
