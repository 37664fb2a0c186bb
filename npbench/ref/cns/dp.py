"""Second-order link DP over the MSA (get_cns_from_align_tags,
lib/ctg_cns.c:1876-2144) and consensus traceback.

Scores: score(entry m at tag t) = max(0, max_n score(n) + 10*link(m)
        - c*coverage(p)), where n ranges over entries at m's pp tag whose
        own pp equals m's ppp (the second-order chain); head entries (read
        starts) take 10*link - c*cov directly (no zero floor).  c = 3 for
        ONT/CLR/RS, 4 for HiFi in the main DP (:1900,:1950,:2015,:2081);
        the LQ mini-DP uses 2 for ONT (:1057) via the cov_coef override.

The per-tag winning-entry ("max_size") bookkeeping follows the C exactly:
entries iterate in insertion order; the p_pp_score / p_pp_score_ state
carries across entries of a cell; ONT's cond1 takes the *last* matching
predecessor's score while cond2 takes the running max; ties upgrade when
the entry's pp base is not a gap (head pp counts as base 0, so it
upgrades).  Verified byte-exact against the reference engine via
tools/ref_sim.py + tools/ref_parity2.py.

The entry scoring pass is vectorized per (position, delta) column; the
winning-entry rules run on each column's few entries directly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from npbench.ref.cns.msa import NB, EdgeTable, unpack_keys
from npbench.ref.cns.tags import CNS_TO_ASCII, GAP

COV_COEF = {"ont": 3, "clr": 3, "rs": 3, "hifi": 4}
NEG = np.int64(-(10 ** 15))
INT64_MIN = -(2 ** 63)


@dataclass
class Consensus:
    pos: np.ndarray  # int32 window-local t_pos per consensus base
    base: np.ndarray  # uint8 ascii (lowercase = low quality)
    qv: np.ndarray  # int32 (100 * link / coverage)


def link_dp(edges: EdgeTable, coverage: np.ndarray, read_type: str,
            cov_coef: int | None = None, dtype=np.int64):
    """Score all entries; returns (score[E], best[Tn]) where best holds the
    absolute entry index selected per tag (the C p_base->max_size).
    `dtype` holds the scores: exact int64, or a narrower type for the
    benchmark's control (each entry's score cast to it as it is
    stored)."""
    E = len(edges.cur)
    Tn = len(edges.tag_key)
    score = np.zeros(E, dtype=dtype)
    best = np.zeros(Tn, dtype=np.int64)
    if not E:
        return score, best
    c = COV_COEF[read_type] if cov_coef is None else cov_coef

    tag_of_entry = (
        np.searchsorted(edges.tag_key, edges.cur).astype(np.int64)
    )
    is_head = edges.pp < 0
    ppid = np.searchsorted(edges.tag_key, edges.pp).astype(np.int64)
    pppid = np.searchsorted(edges.tag_key, edges.ppp).astype(np.int64)
    pppid_s = np.where(edges.ppp < 0, np.int64(-1), pppid)

    # candidate ranges: entries n with (cur == pp_m, pp == ppp_m);
    # entries are sorted by (cur, pp, ppp) and tag ids are key-monotone,
    # with head (-1) ordered first — so this pair key is sorted
    B = np.int64(Tn + 2)
    ppid_of_entry = np.where(is_head, np.int64(-1),
                             np.searchsorted(edges.tag_key, edges.pp))
    pair_sorted = tag_of_entry * B + (ppid_of_entry + 1)
    q = ppid * B + (pppid_s + 1)
    lo = np.searchsorted(pair_sorted, q, side="left")
    hi = np.searchsorted(pair_sorted, q, side="right")
    lo[is_head] = 0
    hi[is_head] = 0

    ep, ed, eb = unpack_keys(edges.cur)
    link10 = 10 * edges.link.astype(np.int64)
    covp = coverage[ep].astype(np.int64)

    # entries grouped by column (p, d): contiguous runs in sorted order
    colkey = edges.cur >> 3
    col_change = np.ones(E, dtype=bool)
    col_change[1:] = colkey[1:] != colkey[:-1]
    col_starts = np.concatenate([np.flatnonzero(col_change), [E]])

    woff = np.arange(64)

    for ci in range(len(col_starts) - 1):
        a, b = int(col_starts[ci]), int(col_starts[ci + 1])
        sl = slice(a, b)
        n_lo = lo[sl]
        n_hi = hi[sl]
        w = int(np.maximum(n_hi - n_lo, 0).max()) if b > a else 0
        if w <= 64:
            idx = n_lo[:, None] + woff[None, :max(w, 1)]
            mask = woff[None, :max(w, 1)] < (n_hi - n_lo)[:, None]
            cand = np.where(mask, score[np.minimum(idx, E - 1)], NEG)
            best_pp = cand.max(axis=1)
        else:
            best_pp = np.array(
                [score[l:h].max() if h > l else NEG
                 for l, h in zip(n_lo, n_hi)], dtype=score.dtype)
        sc = best_pp + link10[sl] - c * covp[sl]
        # heads: direct assignment (no floor); non-heads: floor at 0 init
        sc = np.where(is_head[sl], link10[sl] - c * covp[sl],
                      np.where(best_pp <= NEG // 2, 0,
                               np.maximum(sc, 0)))
        score[sl] = sc
    _select_best(edges, score, best, lo, hi, is_head, eb, covp, read_type)
    return score, best


def _select_best(edges, score, best, lo, hi, is_head, eb, covp, read_type):
    """Per-tag winning-entry selection — the C max_size bookkeeping,
    entry-by-entry in insertion order with the stateful p_pp_score /
    p_pp_score_ carried across entries (lib/ctg_cns.c:1890-2124)."""
    _, pp_d, pp_b = unpack_keys(np.maximum(edges.pp, 0))
    pp_b = np.where(is_head, np.uint8(0), pp_b)  # head q_base = 0
    pp_d = np.where(is_head, np.int32(0), pp_d)
    is_head_ppp = edges.ppp < 0
    _, ppp_d, ppp_b = unpack_keys(np.maximum(edges.ppp, 0))
    ppp_b = np.where(is_head_ppp, np.uint8(0), ppp_b)
    ppp_d = np.where(is_head_ppp, np.int32(0), ppp_d)

    t_lo = edges.tag_off[:-1]
    t_hi = edges.tag_off[1:]
    single = t_hi - t_lo == 1
    best[single] = t_lo[single]
    multi = np.flatnonzero(~single)
    link = edges.link
    ins = edges.ins

    for ti in multi:
        a, b = int(t_lo[ti]), int(t_hi[ti])
        ents = list(range(a, b))
        ents.sort(key=lambda e: ins[e])
        bm = ents[0]  # C max_size = 0 (first-inserted entry)
        p_pp = INT64_MIN
        raiser = INT64_MIN  # p_pp_score_, carries across entries
        if read_type == "ont":
            tmp = int(link[a:b].max())
        for m in ents:
            if not is_head[m]:
                l, h = int(lo[m]), int(hi[m])
                # a non-head entry always has >= 1 matching predecessor
                # (the emitting read put one there)
                n_best = int(score[l:h].max())
                if score[m] > 0:
                    raiser = n_best
                if read_type in ("clr", "hifi"):
                    if n_best > p_pp or (n_best == p_pp and pp_b[m] != GAP):
                        bm = m
                        p_pp = n_best
                elif read_type == "ont":
                    cond1 = (ppp_d[m] > 1 or pp_d[m] > 0) and (
                        link[m] > covp[m] * 0.2 or link[m] > tmp // 2
                    )
                    if cond1:
                        bm = m
                        # C sets p_pp per matching n; last one sticks
                        span = slice(l, h)
                        n_last = l + int(np.argmax(ins[span]))
                        p_pp = int(score[n_last])
                    elif (link[m] > int(link[bm]) // 2
                          and n_best > p_pp
                          and (pp_b[m] == GAP or pp_b[m] == eb[m]
                               or ppp_b[m] == eb[m]
                               or pp_b[m] == ppp_b[m])):
                        bm = m
                        p_pp = n_best
            # the common final rule
            if read_type == "rs":
                if score[m] >= score[bm]:
                    bm = m
                    p_pp = raiser
            else:
                if score[m] > score[bm] or (
                    score[m] == score[bm] and pp_b[m] != GAP
                ):
                    bm = m
                    p_pp = raiser
        best[ti] = bm


def traceback(edges: EdgeTable, score: np.ndarray, best: np.ndarray,
              coverage: np.ndarray, length: int, read_type: str,
              min_cov: int = 4, lq_min_qv: int = 20) -> Consensus:
    """Global best at the last position, then follow winning pp pointers
    (generate_cns_from_best_score, lib/ctg_cns.c:1828-1874)."""
    Tn = len(edges.tag_key)
    tp, td, tb = unpack_keys(edges.tag_key)
    last = np.flatnonzero(tp == length - 1)
    if not last.size:
        return Consensus(np.empty(0, np.int32), np.empty(0, np.uint8),
                         np.empty(0, np.int32))
    bs = score[best[last]]
    # >= with later-wins: take the last argmax (C scans (d, b) ascending)
    gi = int(last[len(bs) - 1 - int(np.argmax(bs[::-1]))])

    # per-tag successor: the winning entry's pp tag (precomputed so the
    # chase is a bare index-chain walk; emission is vectorized after)
    pp_best = edges.pp[best]
    nxt_arr = np.searchsorted(edges.tag_key, pp_best)
    ok = (pp_best >= 0) & (nxt_arr < Tn)
    ok &= edges.tag_key[np.minimum(nxt_arr, Tn - 1)] == pp_best
    nxt_arr = np.where(ok, nxt_arr, -1)

    maxn = int(edges.tag_off[-1]) + length + 8
    path = np.empty(maxn, dtype=np.int64)
    nxt_l = nxt_arr.tolist()
    ti = gi
    n = 0
    while ti >= 0 and n < maxn:
        path[n] = ti
        n += 1
        ti = nxt_l[ti]
    path = path[:n]

    keep = tb[path] != GAP
    vis = path[keep]
    covp = np.maximum(coverage[tp[vis]], 1).astype(np.int64)
    qv = (100 * edges.link[best[vis]].astype(np.int64)) // covp
    ch = CNS_TO_ASCII[tb[vis]].astype(np.int32)
    low = ~((coverage[tp[vis]] > min_cov) & (qv > lq_min_qv))
    ch = np.where(low & (ch < 97), ch + 32, ch).astype(np.uint8)
    return Consensus(tp[vis][::-1].astype(np.int32).copy(),
                     ch[::-1].copy(), qv[::-1].astype(np.int32).copy())
