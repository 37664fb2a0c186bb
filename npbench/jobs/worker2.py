"""Job kind `worker2`: engine 2, NextPolish's long-read consensus
(nextpolish2), as users run it on one block of contigs:

    python -m nextpolish_tpu_torch.worker2 -g block.fa -l lgs.sort.bam \
        -r <read type> -o out.fa --device cuda

here through `nextpolish_tpu_torch.worker2.main` in the benchmark's
process; the configuration names the read type and may set the
program's documented overrides (NPT_CNS_ENGINE) in its `env`.  The
reference is npbench/ref/cns/.
"""
from __future__ import annotations

import numpy as np

from npbench.ref import cns

# the link DP's scores: exact integers (int32 on the card, int64 in the
# reference); the control holds them in int16, the next integer width
# below the card's
DTYPE = np.int64
CONTROL_DTYPE = np.int16


def run(block, out: str, device: str, config: dict) -> None:
    from nextpolish_tpu_torch import worker2

    worker2.main(["-g", block.fa, "-l", block.bam, "-r",
                  config["read_type"], "-o", out, "--device", device])


def reference(block, i: int, device: str, config: dict,
              dtype=DTYPE) -> list:
    """[(name, sequence)] parts of contig i of the block, polished by the
    plain reference (on the host: `device` is not used)."""
    return cns.polish_contig(block.names[i], block.drafts[i],
                             block.records_of(i), config["read_type"],
                             dtype=dtype)
