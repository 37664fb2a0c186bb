"""What a traced run reads: the device's operations from torch.profiler
over the window, the benchmark's own job spans, and the program's trace
buckets (nextpolish_tpu_torch/runtime/trace.py: host seconds summed over
the threads that add to them, and exact counters).

Device time comes from the profiler's device events (kernels, memsets,
copies), which include the kernels the program launches through ctypes.
`busy_s` is the union of their intervals inside the window; `window_s`
runs from the first job's start to the last job's end, both as the
profiler's clock has them.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

# range names that are spans, not device work: the benchmark's own jobs
# and the program's chain.* stages (nextpolish_tpu_torch/ops/chain.py)
SPAN_PREFIXES = ("npbench.", "chain.")


def program_trace():
    """The program's trace module, or None if it has none."""
    try:
        from nextpolish_tpu_torch.runtime import trace
    except ImportError:
        return None
    return trace


def annotate(name: str, prof):
    """A profiler range around a job while a profile runs."""
    if prof is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@dataclass
class Interval:
    name: str
    start: float  # seconds, on the profiler's clock
    end: float


def union_seconds(spans: list, lo: float, hi: float) -> float:
    """Length of the union of [start, end) spans clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(a.start, lo), min(a.end, hi)) for a in spans):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(spans: list, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi) that no span covers, longest first."""
    gaps, at = [], lo
    for s, e in sorted((a.start, a.end) for a in spans):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


@dataclass
class DeviceTrace:
    ops: list   # Interval per device operation
    jobs: list  # Interval per job span
    lo: float
    hi: float

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_seconds(self.ops, self.lo, self.hi)

    def kernel_seconds(self, match=lambda name: True,
                       copies: bool = False) -> float:
        """Summed device time of the operations whose base name matches
        (copies left out unless asked for)."""
        return sum(o.end - o.start for o in self.ops
                   if match(base_name(o.name))
                   and (copies or not is_copy(o.name)))

    def breakdown(self) -> dict:
        by_name: dict = {}
        for o in self.ops:
            d = min(o.end, self.hi) - max(o.start, self.lo)
            if d > 0:
                k = base_name(o.name)
                by_name[k] = by_name.get(k, 0.0) + d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = [[self.label(s, e), e - s]
                for s, e in idle_gaps(self.ops, self.lo, self.hi)[:10]]
        return {"device_ops": [[n, v] for n, v in top], "idle_gaps": gaps}

    def label(self, s: float, e: float) -> str:
        """What the host was doing in an idle gap: the job that holds
        it, and where in the job it falls."""
        mid = (s + e) / 2
        for j in self.jobs:
            if j.start <= mid < j.end:
                inside = [o for o in self.ops
                          if j.start <= o.start < j.end]
                if not inside:
                    return f"{j.name}: no device work"
                if e <= min(o.start for o in inside):
                    return f"{j.name}: before its first device op"
                if s >= max(o.end for o in inside):
                    return f"{j.name}: after its last device op"
                return f"{j.name}: between device ops"
        return "between jobs"


def base_name(name: str) -> str:
    """A kernel's own name, without its namespace, template arguments
    and parameters: `(anonymous namespace)::fwd_scan(float const*, ...)`
    and `void at::native::reduce_kernel<512, 1, ...>(...)` give
    `fwd_scan` and `reduce_kernel`."""
    n = name.replace("(anonymous namespace)::", "")
    n = n.split("(")[0].split("<")[0].strip()
    n = n[5:] if n.startswith("void ") else n
    return n.split("::")[-1] if n else name


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or "memcpy" in name.lower()


class Profile:
    """One torch.profiler session over the window (one session a
    process: later sessions have been seen to drop kernel records)."""

    def __init__(self, device: str):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._p = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._p.start()

    def stop(self) -> None:
        self._p.stop()

    def read(self, jobs) -> DeviceTrace:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        ops, spans = [], []
        for e in self._p.events():
            t = e.time_range
            iv = Interval(e.name, t.start / 1e6, t.end / 1e6)
            if e.name.startswith("npbench.job"):
                if e.device_type != cuda:
                    spans.append(iv)
            elif (e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith(SPAN_PREFIXES)):
                ops.append(iv)
        spans.sort(key=lambda s: s.start)
        for s, j in zip(spans, jobs):
            s.name = f"job{j.k}:{j.block.name}"
        lo = spans[0].start if spans else 0.0
        hi = spans[-1].end if spans else 0.0
        return DeviceTrace(ops, spans, lo, hi)
