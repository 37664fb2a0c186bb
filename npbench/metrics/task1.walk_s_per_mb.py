"""Seconds of the program's `task1.walk` span per polished megabase, summed
over the threads that run it (so it can exceed the wall)."""
from npbench.metrics import _buckets


def read(ctx):
    return _buckets.per_mb(ctx, "task1.walk")
