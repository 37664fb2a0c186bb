"""Score-based anchor chaining — minimap2-grade chain DP + extraction
(the role of mm_chain_dp / mm_chain_backtrack, util/minimap2/chain.c in
the reference's vendored v2.22; command contract source/nextPolish:208-216).

Replaces the count-based LIS chain: chaining anchor i after j scores
min(dq, dr, k) matching bases minus a gap cost
0.01*avg_qspan*|dq-dr| + 0.5*floor(log2|dq-dr|), so the winning chain
maximizes matched bases net of indels.  On repeat loci this keeps the
chain on the copy that needs the fewest gaps, where anchor-count LIS
happily jumps between copies inside its diagonal band.

The O(n*H) DP runs in native C++ (native/chain.cpp); `chain_dp_py` is
the bit-identical numpy/python fallback and test oracle.
"""
from __future__ import annotations

import numpy as np

# map-ont-shaped defaults (minimap2 v2.22: -r 500 -g 5000, max_iter 5000,
# max_skip 25, min chain score 40, min count 3)
BW = 500
MAX_DIST = 5000
MAX_ITER = 5000
MAX_SKIP = 25
MIN_SC = 40
MIN_CNT = 3


def chain_dp_py(qp: np.ndarray, rp: np.ndarray, k: int, bw: int = BW,
                max_dist: int = MAX_DIST, max_iter: int = MAX_ITER,
                max_skip: int = MAX_SKIP, avg_qspan: float | None = None):
    """Python mirror of native/chain.cpp (same scores, same skip rule)."""
    if avg_qspan is None:
        avg_qspan = float(k)
    n = len(qp)
    f = np.zeros(n, dtype=np.int32)
    p = np.full(n, -1, dtype=np.int32)
    st = 0
    for i in range(n):
        while st < i and rp[i] - rp[st] > max_dist:
            st += 1
        max_f, max_j = k, -1
        n_skip = 0
        lo = max(st, i - max_iter)
        for j in range(i - 1, lo - 1, -1):
            dr = int(rp[i] - rp[j])
            dq = int(qp[i] - qp[j])
            if dr <= 0 or dq <= 0 or dq > max_dist:
                continue
            dd = abs(dr - dq)
            if dd > bw:
                continue
            sc = min(dq, dr, k)
            if dd:
                sc -= int(dd * 0.01 * avg_qspan) + (int(dd).bit_length() - 1
                                                    >> 1)
            sc += int(f[j])
            if sc > max_f:
                max_f, max_j = sc, j
                if n_skip > 0:
                    n_skip -= 1
            else:
                n_skip += 1
                if n_skip > max_skip:
                    break
        f[i] = max_f
        p[i] = max_j
    return f, p


def chain_anchors(qp: np.ndarray, rp: np.ndarray, k: int,
                  min_sc: int = MIN_SC, min_cnt: int = MIN_CNT):
    """DP + backtrack: returns [(score, sel)] best-first, sel = anchor
    indices (ascending qp/rp) of each non-overlapping chain."""
    n = len(qp)
    if n == 0:
        return []
    order = np.lexsort((qp, rp))
    qs, rs = qp[order], rp[order]
    from .. import native

    out = native.chain_dp(qs, rs, k, BW, MAX_DIST, MAX_ITER, MAX_SKIP,
                          float(k))
    if out is None:
        out = chain_dp_py(qs, rs, k)
    f, p = out
    used = np.zeros(n, dtype=bool)
    chains = []
    for i in np.argsort(-f, kind="stable"):
        if used[i] or f[i] < min_sc:
            continue
        path = []
        j = int(i)
        while j >= 0 and not used[j]:
            path.append(j)
            used[j] = True
            j = int(p[j])
        # hitting a used anchor truncates the chain there (its prefix
        # belongs to a better chain already extracted)
        sc = int(f[i]) - (int(f[j]) if j >= 0 else 0)
        if len(path) >= min_cnt and sc >= min_sc:
            sel = np.array(path[::-1], dtype=np.int64)
            chains.append((sc, order[sel]))
    chains.sort(key=lambda t: -t[0])
    return chains
