"""The readers of the program's span log (npbench/metrics/_spans.py and
the cns.* metrics that use it) on a synthetic DeviceTrace and span log:
the job-by-job placement on the profiler's clock, the idle intersection,
the sums per megabase, and the cases that read None."""
import json
import os

import pytest

from npbench import devtrace, harness
from npbench.metrics import _spans
from nextpolish_tpu_torch.runtime import trace

NEW = ("cns.prep_cpu_s_per_mb", "cns.prep_reads_s_per_mb",
       "cns.prep_struct_s_per_mb", "cns.repair_s_per_mb",
       "cns.queue_s_per_window", "cns.idle_prep_s_per_mb",
       "cns.idle_unattributed_s_per_mb")
T0 = 1_700_000_000_000_000_000  # a Unix time in ns
MS = 1_000_000


def _iv(s, e, name="k"):
    return devtrace.Interval(name, s, e)


def _span(name, a_ms, b_ms, off_ms=0, cpu_ms=None, thread=1):
    """A span [a, b] ms of the profiler's clock, written on a Unix clock
    that runs off_ms ahead of it."""
    trace.span_at(name, T0 + round((a_ms + off_ms) * MS),
                  T0 + round((b_ms + off_ms) * MS), thread=thread,
                  req="ctg:0", parent=None,
                  cpu_ns=None if cpu_ms is None else cpu_ms * MS)


@pytest.fixture
def log():
    trace.reset()
    yield
    trace.reset()


def _ctx(jobs=((0, 1000), (1000, 2000)), ops=(), bases=2_000_000):
    jobs = [_iv(a / 1e3, b / 1e3, f"job{k}:block0")
            for k, (a, b) in enumerate(jobs)]
    tr = devtrace.DeviceTrace([_iv(a / 1e3, b / 1e3) for a, b in ops],
                              jobs, jobs[0].start, jobs[-1].end)
    return {"trace": tr, "bases": bases, "buckets": {}}


def _two_jobs(off1=3.4):
    """Job 0's spans on a clock 3 ms ahead of the profiler's, job 1's
    off1 ms ahead; each worker2 span opens a little after its job's
    range, so the jobs' offsets differ by 0.1 ms."""
    _span("worker2", 0.5, 999, off_ms=3)
    _span("cns.prep", 10, 400, off_ms=3, cpu_ms=300)
    _span("cns.prep", 20, 300, off_ms=3, cpu_ms=100, thread=2)
    _span("cns.prep.reads", 10, 350, off_ms=3)
    _span("cns.prep.struct", 350, 390, off_ms=3)
    _span("cns.dp", 400, 700, off_ms=3)
    _span("cns.queue", 400, 400.5, off_ms=3)
    _span("cns.repair", 720, 900, off_ms=3)
    _span("worker2", 1000.2, 1999, off_ms=off1)
    _span("cns.prep", 1010, 1500, off_ms=off1, cpu_ms=450)
    _span("cns.queue", 1500, 1501.5, off_ms=off1)


def _read(name, ctx):
    return harness.load_reader(name)(ctx)


def test_placed_job_by_job(log):
    _two_jobs()
    got = {(s.name, round(s.start, 6)) for s in _spans.on_trace(_ctx())}
    # each job's spans move by its worker2 span's offset: the span
    # starts with its job's range
    assert ("worker2", 0.0) in got and ("worker2", 1.0) in got
    assert ("cns.prep", round(0.0095, 6)) in got
    assert ("cns.prep", round(1.0098, 6)) in got


def test_idle_intersection(log):
    _two_jobs()
    # the card runs [200, 600) and [1200, 1300) ms; idle elsewhere
    ctx = _ctx(ops=((200, 600), (1200, 1300)))
    idle_s, prep_s = _spans.idle(ctx, lambda n: n == "cns.prep")
    assert idle_s == pytest.approx(1.5)
    # prep (threads' union) covers [9.5, 399.5) and [1009.8, 1499.8):
    # idle inside it [9.5, 200) and [1009.8, 1200), [1300, 1499.8)
    assert prep_s == pytest.approx(0.1905 + 0.1902 + 0.1998)
    assert _read("cns.idle_prep_s_per_mb", ctx) == pytest.approx(
        (0.1905 + 0.1902 + 0.1998) / 2)
    # stage spans (all but worker2) cover job 0's
    # [9.5, 399.5), [399.5, 699.5), [719.5, 899.5) and job 1's
    # [1009.8, 1499.8), [1499.8, 1501.3): idle outside them
    uncovered = (0.0095 + (0.7195 - 0.6995) + (1.0 - 0.8995)
                 + (1.0098 - 1.0) + (2.0 - 1.5013))
    assert _read("cns.idle_unattributed_s_per_mb", ctx) == pytest.approx(
        uncovered / 2)


def test_sums_per_mb_and_queue_mean(log):
    _two_jobs()
    ctx = _ctx()
    assert _read("cns.prep_cpu_s_per_mb", ctx) == pytest.approx(0.85 / 2)
    assert _read("cns.prep_reads_s_per_mb", ctx) == pytest.approx(0.34 / 2)
    assert _read("cns.prep_struct_s_per_mb", ctx) == pytest.approx(
        0.04 / 2)
    assert _read("cns.repair_s_per_mb", ctx) == pytest.approx(0.18 / 2)
    assert _read("cns.queue_s_per_window", ctx) == pytest.approx(0.001)


def test_none_without_spans_or_fit(log, monkeypatch):
    ctx = _ctx()
    # no span log at all (a program without one), or an empty one
    for name in NEW:
        assert _read(name, ctx) is None
    monkeypatch.setattr(devtrace, "program_trace", lambda: None)
    _two_jobs()
    for name in NEW:
        assert _read(name, ctx) is None
    monkeypatch.undo()
    assert _read("cns.idle_prep_s_per_mb", ctx) is not None
    # a third job whose offset is the first's within 1 ms reads; one
    # whose offset strays by 1.5 ms, or whose worker2 span ends 2 ms
    # after it, does not
    three = _ctx(jobs=((0, 1000), (1000, 2000), (2000, 3000)))
    for w2, off, fits in (((2000.3, 2999.5), 3.5, True),
                          ((2000, 2990), 5, False),
                          ((2000, 3002), 3.5, False)):
        trace.reset()
        _two_jobs()
        _span("worker2", *w2, off_ms=off)
        got = _read("cns.idle_prep_s_per_mb", three)
        assert (got is not None) == fits, (w2, off)
    # more worker2 spans than jobs
    assert _read("cns.idle_unattributed_s_per_mb", ctx) is None
    # a log that dropped records: every reader reads None
    trace.reset()
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    _two_jobs()
    assert trace.dropped()
    for name in NEW:
        assert _read(name, ctx) is None


def test_readers_listed_for_the_cell():
    man = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    got = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        assert got[name]["source"] == "program_span"
        assert got[name]["moves"] == "polished_bases_per_s"
        assert got[name]["workloads"] == ["lgs_ont_30x.chrom"]


def test_cpu_traced_run_reads_the_spans(monkeypatch):
    """A traced run of the ONT cell on the CPU (no card: the window is
    all idle) reads the span metrics, within the bounds they keep."""
    seen = {}
    real = harness.load_reader

    def spy(name, root=harness.ROOT):
        f = real(name, root)

        def read(ctx):
            seen.update(ctx)
            return f(ctx)
        return read

    monkeypatch.setattr(harness, "load_reader", spy)
    res = harness.run("lgs_ont_30x.chrom", 2**31 + 5, 0.2, True,
                      device="cpu", traffic={"pool": [[15000, 12000]]})
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # contigs under 100 kb take no structural pass
    assert set(NEW) - set(m) == {"cns.prep_struct_s_per_mb"}
    assert m["cns.prep_cpu_s_per_mb"] <= m["cns.prep_s_per_mb"]
    assert m["cns.prep_reads_s_per_mb"] <= m["cns.prep_s_per_mb"]
    tr = seen["trace"]
    idle_per_mb = (tr.window_s - tr.busy_s) / (seen["bases"] / 1e6)
    assert (m["cns.idle_prep_s_per_mb"]
            + m["cns.idle_unattributed_s_per_mb"]) <= idle_per_mb + 1e-9
    assert m["cns.idle_prep_s_per_mb"] > 0
