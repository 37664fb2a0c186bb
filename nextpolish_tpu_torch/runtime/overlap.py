"""Ordered pipelined map: run fn over items with a bounded pool so one
item's host work overlaps another's device waits (fetches release the
GIL; numpy/C++ stages contend only for the 2 host cores).

The multiprocessing.Pool.imap of the reference workers
(lib/nextpolish1.py:223-224) becomes this thread pipeline: device
dispatch is async and share-nothing per contig, so threads — not
processes — are enough to keep the chip and the host busy at once.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor


def pipelined_map(fn, items, depth: int = 2):
    """Yield fn(item) for each item IN ORDER, keeping up to `depth`
    items in flight."""
    items = list(items)
    if depth <= 1 or len(items) <= 1:
        for it in items:
            yield fn(it)
        return
    with ThreadPoolExecutor(max_workers=depth) as pool:
        pend: deque = deque()
        it = iter(items)
        for x in it:
            pend.append(pool.submit(fn, x))
            if len(pend) >= depth:
                yield pend.popleft().result()
        while pend:
            yield pend.popleft().result()
