"""Job kind `worker1_t1`: task 1, NextPolish's short-read score-chain
polish, as users run it on one block of contigs:

    python -m nextpolish_tpu_torch.worker1 -g block.fa -s sgs.sort.bam \
        -t 1 -o out.fa --device cuda

here through `nextpolish_tpu_torch.worker1.main` in the benchmark's
process.  The reference is npbench/ref/task1.py.
"""
from __future__ import annotations

import torch

from npbench.ref import task1

# the precision the configuration states for the chain DP's scores, and
# the nearest one below it, which the control runs in
DTYPE = torch.float32
CONTROL_DTYPE = torch.bfloat16


def run(block, out: str, device: str, config: dict) -> None:
    from nextpolish_tpu_torch import worker1

    worker1.main(["-g", block.fa, "-s", block.bam, "-t", "1", "-o", out,
                  "--device", device])


def reference(block, i: int, device: str, config: dict,
              dtype=DTYPE) -> list:
    """[(name, sequence)]: contig i of the block, polished by the plain
    reference."""
    return [(block.names[i],
             task1.polish_contig(block.drafts[i], block.records_of(i),
                                 device=device, dtype=dtype))]
