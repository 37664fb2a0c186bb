"""The port's span log (nextpolish_tpu_torch/runtime/trace.py): the
records `timed` and `span_at` leave beside the buckets, their bound, and
engine 2's spans per window and per thread, on the clock torch.profiler
converts its timestamps to."""
import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from nextpolish_tpu_torch import sim, worker2
from nextpolish_tpu_torch.runtime import trace

WINDOW_SPANS = {
    # name: its parent in a window of the device engine
    "cns.fetch": None, "cns.prep": None,
    "cns.prep.reads": "cns.prep", "cns.densify": None,
    "cns.queue": "cns.dp", "cns.dp": None,
    "cns.finish": None, "cns.repair": "cns.finish",
}


@pytest.fixture
def clean():
    trace.reset()
    yield
    trace.reset()


def _spin(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_span_records(clean):
    """Name, parent, thread, request, start <= end, CPU time within the
    wall; nested spans and spans of another thread."""
    def work():
        with trace.request("ctg:0"), trace.timed("t.outer"):
            _spin(0.002)
            with trace.timed("t.inner"):
                time.sleep(0.003)
        with trace.timed("t.outer"):
            pass

    work()
    other = threading.Thread(target=work)
    other.start()
    other.join(timeout=30)
    assert not other.is_alive()
    recs = trace.spans("t.")
    assert len(recs) == 6
    assert {r.thread for r in recs} == {threading.get_native_id(),
                                        other.native_id}
    for r in recs:
        assert r.start_ns <= r.end_ns
        assert 0 <= r.cpu_ns <= r.end_ns - r.start_ns
    inner = [r for r in recs if r.name == "t.inner"]
    assert all(r.parent == "t.outer" and r.req == "ctg:0" for r in inner)
    assert all(r.end_ns - r.start_ns >= 3e6 for r in inner)
    # a sleeping span costs its thread (almost) no CPU time
    assert all(r.cpu_ns < (r.end_ns - r.start_ns) / 2 for r in inner)
    outer = [r for r in recs if r.name == "t.outer"]
    assert [r.req for r in outer] == ["ctg:0", None] * 2
    assert all(r.parent is None for r in outer)
    for o, i in zip(outer[0::2], inner):
        assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    snap = trace.snapshot("t.")
    assert snap["t.outer"]["n"] == 4 and snap["t.inner"]["n"] == 2


def test_threads_lose_no_span(clean):
    """More threads than cores, switching often: every span reaches its
    bucket and the log, and each bucket equals its records' sum."""
    import sys

    n_threads, n_spans = 16, 1000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            with trace.request(f"r{k}"):
                for _ in range(n_spans):
                    with trace.timed("s.a"), trace.timed("s.b"):
                        pass
        ts = [threading.Thread(target=work, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    recs = trace.spans("s.")
    assert len(recs) == 2 * n_threads * n_spans
    assert trace.snapshot("s.")["s.b"]["n"] == n_threads * n_spans
    assert all(r.parent == "s.a" for r in recs if r.name == "s.b")
    assert len({(r.thread, r.req) for r in recs}) == n_threads
    _assert_buckets_match_records(["s.a", "s.b"])


def test_reset_by_prefix_and_span_at(clean):
    with trace.request("c:5"), trace.timed("a.x"):
        trace.span_at("a.q", 10, 2_000_000_010)
        trace.span_at("b.q", 0, 1_000, thread=7, req="d:0", parent=None,
                      cpu_ns=500)
    a_q, b_q = trace.spans("a.q")[0], trace.spans("b.q")[0]
    assert a_q == trace.Span("a.q", "a.x", threading.get_native_id(), "c:5",
                             10, 2_000_000_010, None)
    assert b_q == trace.Span("b.q", None, 7, "d:0", 0, 1_000, 500)
    assert trace.snapshot("a.q")["a.q"] == {"s": 2.0, "n": 1}
    trace.reset("a.")
    assert [r.name for r in trace.spans()] == ["b.q"]
    assert list(trace.snapshot()) == ["b.q"]


def test_log_bound_counts_drops(clean, monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 5)
    for k in range(8):
        with trace.timed(f"{'ab'[k % 2]}.s"):
            pass
    assert len(trace.spans()) == 5
    assert trace.dropped() == 3
    # the buckets still count every span
    assert sum(v["n"] for v in trace.snapshot().values()) == 8
    # a prefix reset keeps the count: the log lost records since the
    # last whole reset, whichever names they had
    trace.reset("a.")
    assert trace.dropped() == 3
    trace.reset()
    assert trace.dropped() == 0 and not trace.spans()


def test_spans_on_the_profiler_clock(clean):
    """A record_function range around a program span, placed by the
    profiler's trace_start_ns, matches the span within 1 ms at both
    ends."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # a first range pays about 1.5 ms of set-up after its start
        with torch.profiler.record_function("clock.warm"):
            pass
        _spin(0.005)
        with torch.profiler.record_function("clock.range"):
            with trace.timed("clock.span"):
                _spin(0.02)
        _spin(0.005)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "clock.range"]
    (span,) = trace.spans("clock.")
    assert abs(t0 + ev.time_range.start * 1000 - span.start_ns) < 1e6
    assert abs(t0 + ev.time_range.end * 1000 - span.end_ns) < 1e6


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    c = sim.simulate_case(23, 4, [3000, 2500, 2000, 2800], 25,
                          read_len=(800, 2500))
    fa, bam = sim.write_case(c, str(d))
    return c, fa, bam


def _assert_buckets_match_records(names):
    """Each bucket equals its records' sum (the snapshot rounds to
    0.1 ms)."""
    snap = trace.snapshot()
    got = defaultdict(int)
    for r in trace.spans():
        got[r.name] += r.end_ns - r.start_ns
    for n in names:
        assert got[n] / 1e9 == pytest.approx(snap[n]["s"], rel=0.01,
                                             abs=1e-4), n


def test_engine2_spans_per_window(case, monkeypatch, clean):
    """Contigs polished concurrently through one shared batcher: every
    window has each of its spans, under one request and the right
    parents, from the threads that prep them; the output stays the
    native engine's; the buckets equal the records' sums."""
    from nextpolish_tpu_torch.io.bamregion import RegionFetcher
    from nextpolish_tpu_torch.models.cns.batcher import CnsBatcher
    from nextpolish_tpu_torch.models.ctg_cns import ctg_cns_contig
    from nextpolish_tpu_torch.runtime.overlap import pipelined_map

    c, _, bam = case
    fetcher = RegionFetcher([bam])
    items = list(zip(c.names, c.drafts))
    monkeypatch.setenv("NPT_CNS_ENGINE", "native")
    want = [ctg_cns_contig(n, d, fetcher, "ont", device="cpu")
            for n, d in items]
    monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    trace.reset()
    bat = CnsBatcher("ont", max_batch=4, device="cpu")
    got = list(pipelined_map(
        lambda nd: ctg_cns_contig(nd[0], nd[1], fetcher, "ont",
                                  batcher=bat, device="cpu"),
        items, depth=4))
    assert got == want
    recs = trace.spans()
    assert trace.dropped() == 0
    assert {r.req for r in recs} == {f"{n}:0" for n in c.names}
    threads = set()
    for name in c.names:
        win = [r for r in recs if r.req == f"{name}:0"]
        by = defaultdict(list)
        for r in win:
            by[r.name].append(r)
        assert set(by) == set(WINDOW_SPANS), name
        # cns.dp twice: the submit, then the wait on the scan
        assert len(by["cns.dp"]) == 2
        assert all(len(v) == 1 for k, v in by.items() if k != "cns.dp")
        # one thread preps, queues, waits on and finishes the window
        assert len({r.thread for r in win}) == 1, name
        threads.add(win[0].thread)
        for r in win:
            assert r.parent == WINDOW_SPANS[r.name], r
        (prep,), (reads,) = by["cns.prep"], by["cns.prep.reads"]
        assert prep.start_ns <= reads.start_ns <= reads.end_ns \
            <= prep.end_ns
    # the contigs ran on threads of their own
    assert len(threads) > 1
    _assert_buckets_match_records(sorted(WINDOW_SPANS))


def test_worker2_span_and_output(case, tmp_path, monkeypatch, clean):
    """One worker2 span a worker2.main call, opened around every other
    span of the call; the device engine's FASTA stays the native one's."""
    _, fa, bam = case
    outs = {}
    for eng in ("native", "device"):
        monkeypatch.setenv("NPT_CNS_ENGINE", eng)
        trace.reset()
        outs[eng] = str(tmp_path / f"{eng}.fa")
        assert worker2.main(["-g", fa, "-l", bam, "-r", "ont", "-o",
                             outs[eng], "--device", "cpu"]) == 0
        recs = trace.spans()
        (w2,) = [r for r in recs if r.name == "worker2"]
        assert w2.parent is None
        assert all(w2.start_ns <= r.start_ns <= r.end_ns <= w2.end_ns
                   for r in recs)
        assert {"cns.prep", "cns.finish", "cns.repair"} <= {
            r.name for r in recs}
    assert open(outs["device"], "rb").read() == \
        open(outs["native"], "rb").read()


def test_host_engine_spans(case, monkeypatch, clean):
    """The host engines' path leaves cns.fetch, cns.prep and cns.finish
    per window, under the window's request, and no cns.host."""
    from nextpolish_tpu_torch.io.bamregion import RegionFetcher
    from nextpolish_tpu_torch.models.ctg_cns import ctg_cns_contig

    c, _, bam = case
    monkeypatch.setenv("NPT_CNS_ENGINE", "native")
    ctg_cns_contig(c.names[0], c.drafts[0], RegionFetcher([bam]), "ont",
                   device="cpu")
    recs = trace.spans()
    req = f"{c.names[0]}:0"
    names = {r.name for r in recs if r.req == req}
    assert {"cns.fetch", "cns.prep", "cns.prep.reads", "cns.finish",
            "cns.repair"} <= names
    assert not [r for r in recs if r.name == "cns.host"]
    # a group's DP serves several windows, so no one request
    (dp,) = [r for r in recs if r.name == "cns.dp"]
    assert dp.req is None and dp.parent is None


def test_structural_pass_span(monkeypatch, tmp_path, clean):
    """A window of a contig over INS_MIN_CHECK_LEN takes the read pass
    and, while the structural layer is on, the structural pass: each
    under its own span inside cns.prep."""
    from nextpolish_tpu_torch.io.bam import read_bam
    from nextpolish_tpu_torch.models.cns import structural as st
    from nextpolish_tpu_torch.models.cns import window as twin

    monkeypatch.setattr(st, "INS_MIN_CHECK_LEN", 1000)
    c = sim.simulate_case(5, 1, 3000, 20, read_len=(800, 2000))
    _, bam = sim.write_case(c, str(tmp_path))
    ctx = twin.StructState(brk_g=True, depth=st.DepthTrack(3000), qv=[])
    ca = np.frombuffer(c.drafts[0], dtype=np.uint8)
    with trace.timed("cns.prep"):
        twin.window_prep(read_bam(bam), 0, ca, 0, len(c.drafts[0]), "ont",
                         ctx, c.names[0])
    recs = trace.spans()
    assert [r.name for r in recs] == [
        "cns.prep.reads", "cns.prep.struct", "cns.prep"]
    assert all(r.parent == "cns.prep" for r in recs[:2])
    # the simulated reads carry no split reads: the pass turns the
    # structural layer off for the contig's later windows
    assert ctx.brk_g is False
