"""Cells per chain-DP launch of task 1 (the program's counters
task1.chain_cells / task1.chain_launches: exact counts)."""
from npbench.metrics import _buckets


def read(ctx):
    cells = _buckets.total(ctx, "task1.chain_cells")
    launches = _buckets.total(ctx, "task1.chain_launches")
    return cells / launches if cells and launches else None
