"""Device nanoseconds of engine 2's level scan per DP level: the
profiler's device time of the `level_chain_kernel` and
`level_winners_kernel` kernels in the traced window over the levels the
program counted (cns.levels)."""
from npbench.metrics import _buckets

KERNELS = ("level_chain_kernel", "level_winners_kernel")


def read(ctx):
    tr = ctx.get("trace")
    levels = _buckets.total(ctx, "cns.levels")
    if tr is None or not levels:
        return None
    s = tr.kernel_seconds(lambda n: n in KERNELS)
    return s / levels * 1e9 if s > 0 else None
