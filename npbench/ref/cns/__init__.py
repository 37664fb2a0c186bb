"""Plain reference of engine 2 (`worker2 -r <type>`, NextPolish's
nextpolish2 / ctg_cns consensus) for the benchmark's check of the polished
bytes: per window the read tags, the MSA edges, the second-order link DP,
its traceback, the low-quality repair (POA seeds and realignment) and the
stitch, with the structural layer of contigs over 100 kb; numpy only.

A frozen copy of the port's plain path as of commit 6e13449
(nextpolish_tpu_torch/models/cns/{window,tags,msa,dp,lqrepair,poadag,
structural}.py, and models/ctg_cns.py's naming of parts): the python
window prep, the numpy link DP, the python POA.  The program's native
tag walker, native DP and POA, its densify and its CUDA level scan are
not here.  Only the imports changed, and the native, device and fetcher
branches were cut.
"""
from __future__ import annotations

import numpy as np

from npbench.ref.cns.bam import AlnBatch
from npbench.ref.cns.window import consensus_for_contig

WINDOW = 5_000_000  # worker2's -w default


def polish_contig(name: str, draft: bytes, records: list, read_type: str,
                  split: int = 1, dtype=np.int64) -> list:
    """[(name, sequence)] parts of one contig, as worker2 writes them
    (split at structural split points into name_sJ parts; a result of 10
    bases or fewer keeps the draft).  `dtype` holds the link DP's scores:
    exact int64, or a narrower type for the control."""
    seqs = consensus_for_contig(AlnBatch.of(records), 0, draft, read_type,
                                window=WINDOW, split=split,
                                contig_name=name, dtype=dtype)
    if len(seqs) == 1:
        return [(name, draft if len(seqs[0]) <= 10 else seqs[0])]
    return [(f"{name}_s{j}", s) for j, s in enumerate(seqs)]
