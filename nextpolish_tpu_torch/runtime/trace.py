"""Wall-time tracing (the reference's STEP/TIME trace channels,
lib/config.c:117-130, as an always-on in-process collector).

Engines attribute their time to named buckets; the convention is
  <engine>.host    — host-side preparation / finish work
  <engine>.wait    — time blocked on device results (device-not-ready)
  <engine>.wall    — end-to-end
so `1 - wait/wall` is a host-busy proxy and `wait/wall` bounds the
device-critical fraction from above.  `snapshot()` feeds the pipeline's
per-stage TIME log lines.

Every `timed` span also leaves one record in an in-memory span log
(`spans()`): its name, the span open on the same thread when it began
(its parent), the thread, the request it served (`request()`: engine 2
names a window `<contig>:<start>`), its start and end on `time.time_ns()`
and the thread's CPU time over it.  `time.time_ns()` is the Unix clock
that torch.profiler converts its host and device timestamps to before it
subtracts its trace start, so a record can be placed on a profiler
trace.  `span_at` records an interval that opens on one thread and
closes on another.  The log holds at most MAX_SPANS records; past that
it counts what it drops (`dropped()`).  Spans open no profiler range.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import NamedTuple

MAX_SPANS = 100_000

_ACC: dict = defaultdict(float)
_N: dict = defaultdict(int)
_LOG: list = []
_DROPPED = 0  # records the full log did not keep since the last reset()
_LOCK = threading.Lock()


class Span(NamedTuple):
    name: str
    parent: str | None  # the span open on the thread when this one began
    thread: int  # threading.get_native_id()
    req: str | None  # the request the span served
    start_ns: int  # time.time_ns()
    end_ns: int
    cpu_ns: int | None  # the thread's CPU time over the span


class _Local(threading.local):
    def __init__(self):
        self.thread = threading.get_native_id()
        self.stack = []
        self.req = None


_TLS = _Local()


def _record(bucket: str, seconds: float, span: Span | None = None) -> None:
    global _DROPPED
    with _LOCK:
        _ACC[bucket] += seconds
        _N[bucket] += 1
        if span is None:
            return
        if len(_LOG) < MAX_SPANS:
            _LOG.append(span)
        else:
            _DROPPED += 1


@contextmanager
def timed(bucket: str):
    tl = _TLS
    parent = tl.stack[-1] if tl.stack else None
    tl.stack.append(bucket)
    # the bucket and the record share the wall clock's reads, and the
    # CPU clock is read inside them, so a span's CPU time never exceeds
    # its wall time
    w0 = time.time_ns()
    c0 = time.thread_time_ns()
    try:
        yield
    finally:
        c1 = time.thread_time_ns()
        w1 = time.time_ns()
        tl.stack.pop()
        _record(bucket, (w1 - w0) / 1e9,
                Span(bucket, parent, tl.thread, tl.req, w0, w1, c1 - c0))


@contextmanager
def request(req: str):
    """Spans this thread opens inside serve the request `req`."""
    tl = _TLS
    prev, tl.req = tl.req, req
    try:
        yield
    finally:
        tl.req = prev


def here() -> dict:
    """This thread's identifiers, for a `span_at` made on another."""
    tl = _TLS
    return dict(thread=tl.thread, req=tl.req,
                parent=tl.stack[-1] if tl.stack else None)


def span_at(name: str, start_ns: int, end_ns: int, **ids) -> None:
    """Record [start_ns, end_ns) (time.time_ns()) under `name`, in its
    bucket too.  `ids` may give `thread`, `req` and `parent` (the
    caller's by default, as `here()` has them) and `cpu_ns` (None)."""
    span = Span(name, **{**here(), "cpu_ns": None, **ids},
                start_ns=start_ns, end_ns=end_ns)
    _record(name, (end_ns - start_ns) / 1e9, span)


def add(bucket: str, seconds: float) -> None:
    _record(bucket, seconds)


def count(bucket: str, n: float) -> None:
    """Work-volume counter (units per bucket convention, e.g. `.levels` =
    DP levels launched, `.launches` = device programs).  Stored in the
    same table; `snapshot()['x']['s']` is then a count, not seconds —
    buckets ending in a count suffix are excluded from time splits."""
    _record(bucket, n)


def reset(prefix: str = "") -> None:
    """Clear the matching buckets and span records; a whole reset (no
    prefix) also clears the drop count."""
    global _DROPPED
    with _LOCK:
        for k in [k for k in _ACC if k.startswith(prefix)]:
            del _ACC[k]
            del _N[k]
        _LOG[:] = [s for s in _LOG if not s.name.startswith(prefix)]
        if not prefix:
            _DROPPED = 0


def spans(prefix: str = "") -> list:
    """The span records whose name starts with `prefix`, in the order
    they closed."""
    with _LOCK:
        return [s for s in _LOG if s.name.startswith(prefix)]


def dropped() -> int:
    """Records the full log did not keep since the last whole reset."""
    return _DROPPED


def snapshot(prefix: str = "") -> dict:
    """{bucket: {"s": total_seconds, "n": calls}} for matching buckets."""
    with _LOCK:
        return {k: {"s": round(v, 4), "n": _N[k]}
                for k, v in sorted(_ACC.items()) if k.startswith(prefix)}


def fmt(prefix: str = "") -> str:
    """One TIME log line, reference trace_log style."""
    with _LOCK:
        return " ".join(f"{k}={v:.2f}s/{_N[k]}"
                        for k, v in sorted(_ACC.items())
                        if k.startswith(prefix))
