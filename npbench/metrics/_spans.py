"""Shared by the readers of the program's span log
(nextpolish_tpu_torch/runtime/trace.py, `spans()`): one record a span,
with its thread, its request (engine 2's window), its start and end on
`time.time_ns()` and its thread's CPU time.  The harness resets the log
just before the window opens, so the log holds the window's spans.

Each function returns None where the program keeps no span log, where
the log dropped records (it is bounded), or where nothing matches.
`on_trace` places the spans on the profiler's clock (npbench/devtrace.py
`DeviceTrace`) job by job: a job's offset is its `worker2` span's start
less the job's range start.  The profiler converts its timestamps to the
clock the spans are on (`time.time_ns()`), so every job's offset is the
first job's, give or take the moment between a job's range opening and
its worker2 span; a job whose offset strays further reads None."""
from bisect import bisect_right

from npbench import devtrace

# spans that hold a whole job, not one stage of its work
OUTER = ("worker2",)
# how far a job's offset may stray from the first job's, and its worker2
# span's end from the job's range end, in seconds
TOL_S = 1e-3


def records():
    """The window's span records, or None."""
    t = devtrace.program_trace()
    if t is None or not hasattr(t, "spans") or t.dropped():
        return None
    return t.spans()


def per_mb(ctx, name, cpu=False):
    """Wall seconds (thread CPU seconds with `cpu`) of every `name` span,
    summed over the threads, per polished megabase."""
    recs = records()
    sel = [r for r in recs or () if r.name == name]
    if not sel:
        return None
    ns = sum(r.cpu_ns if cpu else r.end_ns - r.start_ns for r in sel)
    return ns / 1e9 / (ctx["bases"] / 1e6)


def mean_s(name):
    """Mean seconds of the `name` spans."""
    sel = [r.end_ns - r.start_ns for r in records() or () if r.name == name]
    return sum(sel) / len(sel) / 1e9 if sel else None


def on_trace(ctx):
    """The records as devtrace.Interval on the DeviceTrace's clock, each
    moved by the offset of the job whose worker2 span began last before
    it; None where the worker2 spans and the jobs do not pair up, where
    a job's offset strays from the first job's by more than TOL_S, or
    where a worker2 span so placed ends after its job by more."""
    tr, recs = ctx.get("trace"), records()
    if tr is None or recs is None:
        return None
    w2 = sorted((r for r in recs if r.name == "worker2"),
                key=lambda r: r.start_ns)
    if not w2 or len(w2) != len(tr.jobs):
        return None
    offs = [r.start_ns - round(j.start * 1e9) for r, j in zip(w2, tr.jobs)]
    for r, j, off in zip(w2, tr.jobs, offs):
        if (abs(off - offs[0]) > TOL_S * 1e9
                or (r.end_ns - off) / 1e9 > j.end + TOL_S):
            return None
    starts = [r.start_ns for r in w2]
    out = []
    for r in recs:
        off = offs[max(bisect_right(starts, r.start_ns) - 1, 0)]
        out.append(devtrace.Interval(r.name, (r.start_ns - off) / 1e9,
                                     (r.end_ns - off) / 1e9))
    return out


def _union(pairs):
    out = []
    for s, e in sorted(pairs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_seconds(a, b):
    """Length of the intersection of two sets of (start, end) pairs, each
    taken as the union of its pairs."""
    a, b = _union(a), _union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(ctx, pick):
    """(seconds of the traced window in which the card ran nothing, the
    part of them in which some span whose name `pick` accepts was open
    on any thread), or None."""
    spans = on_trace(ctx)
    if spans is None:
        return None
    tr = ctx["trace"]
    gaps = devtrace.idle_gaps(tr.ops, tr.lo, tr.hi)
    return (sum(e - s for s, e in gaps),
            overlap_seconds(gaps, [(s.start, s.end) for s in spans
                                   if pick(s.name)]))
