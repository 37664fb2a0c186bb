"""DP levels per engine-2 launch (the program's counters cns.levels /
cns.launches: exact counts)."""
from npbench.metrics import _buckets


def read(ctx):
    levels = _buckets.total(ctx, "cns.levels")
    launches = _buckets.total(ctx, "cns.launches")
    return levels / launches if levels and launches else None
