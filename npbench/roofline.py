"""The least time a kernel's work could take on one NVIDIA H100, from the
bytes and operations its launch shapes need: each input read once, each
output written once, over the published peaks (NVIDIA's H100 SXM data
sheet, at its 700 W power limit; the result line names the card, and
PERF.md gives its power limit beside each share).

A frozen copy of chip_smoke.py's bound arithmetic as of commit 6e13449
(`H100_BYTES_PER_S`, `H100_INT_OPS_PER_S` and `chain_bounds`' forward
scan, the one kernel a reader holds to its roofline).  It counts the
work, not an implementation, so a later kernel that does the same work
reads on the same yardstick.
"""
from __future__ import annotations

H100_BYTES_PER_S = 3.35e12  # HBM3
H100_OPS_PER_S = 67e12      # fp32 outside the tensor cores; int32 rated so


def least_seconds(nbytes: float, ops: float) -> tuple:
    """(seconds, "bytes" | "operations"): the larger of the two bounds."""
    tb = nbytes / H100_BYTES_PER_S
    to = ops / H100_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def chain_forward_work(rows: int, cells: int) -> tuple:
    """(bytes, operations) of task 1's forward (max,+) scan over `rows`
    rows of `cells` cells in all (each row a multiple of 128 cells): the
    transitions A [cells, 8, 8] f32 read and the states f [cells, 8] f32
    written, 32 bytes of s0 a row; per cell one 8x8 (max,+) product (512
    adds, 448 maxes) and its renormalisation (63 maxes, 64
    subtractions) in the chunk pass, 64 adds and 56 maxes in the replay,
    and two products per 128-cell chunk in the tree."""
    prod = 512 + 448
    nbytes = cells * 256 + rows * 32 + cells * 32
    ops = cells * (prod + 127 + 120) + 2 * (cells // 128) * prod
    return nbytes, ops
