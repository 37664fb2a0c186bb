"""Wall-time tracing (the reference's STEP/TIME trace channels,
lib/config.c:117-130, as an always-on in-process collector).

Engines attribute their time to named buckets; the convention is
  <engine>.host    — host-side preparation / finish work
  <engine>.wait    — time blocked on device results (device-not-ready)
  <engine>.wall    — end-to-end
so `1 - wait/wall` is a host-busy proxy and `wait/wall` bounds the
device-critical fraction from above.  `snapshot()` feeds the pipeline's
per-stage TIME log lines and bench.py's host/device split.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

_ACC: dict = defaultdict(float)
_N: dict = defaultdict(int)


@contextmanager
def timed(bucket: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _ACC[bucket] += dt
        _N[bucket] += 1


def add(bucket: str, seconds: float) -> None:
    _ACC[bucket] += seconds
    _N[bucket] += 1


def count(bucket: str, n: float) -> None:
    """Work-volume counter (units per bucket convention, e.g. `.levels` =
    DP levels launched, `.launches` = device programs).  Stored in the
    same table; `snapshot()['x']['s']` is then a count, not seconds —
    buckets ending in a count suffix are excluded from time splits."""
    _ACC[bucket] += n
    _N[bucket] += 1


def reset(prefix: str = "") -> None:
    for k in [k for k in _ACC if k.startswith(prefix)]:
        del _ACC[k]
        del _N[k]


def snapshot(prefix: str = "") -> dict:
    """{bucket: {"s": total_seconds, "n": calls}} for matching buckets."""
    return {k: {"s": round(v, 4), "n": _N[k]}
            for k, v in sorted(_ACC.items()) if k.startswith(prefix)}


def fmt(prefix: str = "") -> str:
    """One TIME log line, reference trace_log style."""
    parts = [f"{k}={v:.2f}s/{_N[k]}" for k, v in sorted(_ACC.items())
             if k.startswith(prefix)]
    return " ".join(parts)
