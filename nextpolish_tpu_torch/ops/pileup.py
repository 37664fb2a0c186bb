"""Read-selection helper shared by the consensus window loop."""
from __future__ import annotations

import numpy as np

from ..io.bam import AlnBatch


def region_overlap_mask(batch: AlnBatch, tid: int, start: int, end: int
                        ) -> np.ndarray:
    """Reads the BAM region iterator [start, end+1) would return."""
    span = batch.ref_span()
    return (
        (batch.tid == tid)
        & (batch.pos.astype(np.int64) + span > start)
        & (batch.pos <= end)
    )
