"""Cross-contig window batching for the device consensus engine (port of
nextpolish_tpu/models/cns/batcher.py).

The reference fills its machine by giving every worker process one window
at a time (lib/nextpolish2.py:67-90, the window loop at
lib/ctg_cns.c:3455-3594); here each level-scan launch takes B windows,
one thread block each.  A single contig under ~5 Mb only has ONE window,
so per-contig dispatch leaves the batch axis empty — this module shares
one batcher across every contig in flight: producer threads (pipelined
contigs) prep windows and `submit` them, and groups of B windows — from
ANY mix of contigs — leave in one launch.

Dispatch policy: a full group dispatches on the spot; partial groups wait
while any producer is still prepping (it will fill the batch) and flush
as soon as every in-flight producer is blocked waiting or done, so no
batching deadline is needed and no deadlock is possible.  Results are
independent of grouping (the scan is exact per window), so polished
output does not depend on contig scheduling.
"""
from __future__ import annotations

import threading
import time

from ...runtime import trace
from .device_dp import B_MAX, _to_edge_outputs, collect_group, dispatch_group


class _Group:
    """One dispatched batch of dense windows; first waiter collects."""

    def __init__(self, dws, read_type, device):
        self.dws = dws
        self.lock = threading.Lock()
        self.results = None
        self.pend = dispatch_group(dws, read_type, device, sc_tail=True)

    def collect(self):
        with self.lock:
            if self.results is None:
                self.results = collect_group(self.pend)
                self.pend = None
        return self.results


class _Fut:
    __slots__ = ("batcher", "group", "idx", "value", "ready")

    def __init__(self, batcher):
        self.batcher = batcher
        self.group = None
        self.idx = -1
        self.value = None
        self.ready = False

    def result(self):
        """(score_arr, best_arr) for dp.traceback, or None when the window
        must fall back to a host engine."""
        if not self.ready:
            self.batcher._wait(self)
        return self.value


class CnsBatcher:
    """Shared window-DP batcher; one per polishing run (thread-safe)."""

    def __init__(self, read_type: str, max_batch: int | None = None,
                 device=None):
        self.read_type = read_type
        self.device = device
        self.B = max_batch or B_MAX
        self.cond = threading.Condition()
        self.pending = []  # [(dw, fut, trace.here(), submit time_ns)]
        self.prepping = 0
        self.waiting = 0

    # ---- producer lifecycle -------------------------------------------
    def contig(self):
        """Context manager marking a producer as actively prepping."""
        return _Producer(self)

    # ---- submission ---------------------------------------------------
    def submit(self, dw):
        """Queue a DenseWindow for the next device launch; a window that
        densify refused (None) goes to the host engine."""
        fut = _Fut(self)
        if dw is None:
            trace.count("cns.windows_host", 1)
            fut.ready = True  # host fallback (result None)
            return fut
        with self.cond:
            self.pending.append((dw, fut, trace.here(), time.time_ns()))
            if len(self.pending) >= self.B:
                self._dispatch_locked()
        return fut

    # ---- internals ----------------------------------------------------
    def _dispatch_locked(self, force=False):
        while len(self.pending) >= self.B or (force and self.pending):
            batch = self.pending[:self.B]
            del self.pending[:len(batch)]
            # cns.queue: each window's wait from its submit to this
            # launch, on its producer's thread and window
            now = time.time_ns()
            for _, _, ids, t in batch:
                trace.span_at("cns.queue", t, now, **ids)
            dws = [b[0] for b in batch]
            g = _Group(dws, self.read_type, self.device)
            for i, (_, f, _, _) in enumerate(batch):
                f.group = g
                f.idx = i
        self.cond.notify_all()

    def _wait(self, fut):
        with self.cond:
            self.waiting += 1
            try:
                while fut.group is None:
                    if self.waiting >= self.prepping:
                        # nobody left to fill the batch — flush partials
                        self._dispatch_locked(force=True)
                        break
                    self.cond.wait(timeout=0.05)
            finally:
                self.waiting -= 1
        best, sc = fut.group.collect()[fut.idx]
        dw = fut.group.dws[fut.idx]
        fut.value = _to_edge_outputs(dw, best, sc)
        fut.ready = True


class _Producer:
    def __init__(self, batcher):
        self.b = batcher

    def __enter__(self):
        with self.b.cond:
            self.b.prepping += 1
        return self.b

    def __exit__(self, *exc):
        with self.b.cond:
            self.b.prepping -= 1
            if self.b.pending and self.b.waiting >= self.b.prepping:
                self.b._dispatch_locked(force=True)
            self.b.cond.notify_all()
        return False
