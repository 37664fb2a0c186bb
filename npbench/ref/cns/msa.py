"""MSA link tables: tag triples -> grouped (cur, pp, ppp) edges with counts.

Equivalent of update_msa (lib/ctg_cns.c:324-365): for every read column,
count the distinct (previous, before-previous) column pairs.  Tags are keyed
as (t_pos, delta, q_base) packed into int64; the head sentinel is -1
(the C align_tag_head is {t_pos=-1, delta=0, q_base=0},
lib/ctg_cns.c:52-56 — its q_base of 0 matters for tie rules, handled in
dp.py).

The C keeps each cell's entries in *insertion order* (first occurrence over
reads in BAM order) and its tie-break rules depend on that order, so every
edge carries `ins`, its first-occurrence column index.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from npbench.ref.cns.tags import TagColumns

NB = 6  # q_base alphabet
HEAD = np.int64(-1)


def pack_keys(t_pos, delta, q_base) -> np.ndarray:
    """(t_pos << 20) | (delta << 3) | q_base — monotone in (t, d, b)."""
    return (
        (t_pos.astype(np.int64) << 20)
        + (delta.astype(np.int64) << 3)
        + q_base.astype(np.int64)
    )


def unpack_keys(key: np.ndarray):
    b = key & 7
    d = (key >> 3) & ((1 << 17) - 1)
    p = key >> 20
    return p.astype(np.int32), d.astype(np.int32), b.astype(np.uint8)


@dataclass
class EdgeTable:
    """Edges sorted by (cur, pp, ppp); tags sorted by cur key."""

    cur: np.ndarray  # int64 [E]
    pp: np.ndarray  # int64 [E] (HEAD for read-start columns)
    ppp: np.ndarray  # int64 [E]
    link: np.ndarray  # int32 [E]
    ins: np.ndarray  # int64 [E] first-occurrence column index (C order)
    tag_key: np.ndarray  # int64 [Tn] unique cur keys
    tag_off: np.ndarray  # int64 [Tn+1] entry slices per tag


def build_edges(cols: TagColumns) -> EdgeTable:
    keys = pack_keys(cols.t_pos, cols.delta, cols.q_base)
    n = len(keys)
    if n == 0:
        z = np.empty(0, np.int64)
        return EdgeTable(z, z, z, np.empty(0, np.int32), z.copy(), z,
                         np.zeros(1, np.int64))
    pp = np.empty(n, dtype=np.int64)
    ppp = np.empty(n, dtype=np.int64)
    pp[1:] = keys[:-1]
    ppp[2:] = keys[:-2]
    firsts = cols.row_off[:-1]
    firsts = firsts[firsts < n]
    pp[firsts] = HEAD
    ppp[firsts] = HEAD
    second = firsts + 1
    ok = second < cols.row_off[1:][: len(firsts)]
    ppp[second[ok]] = HEAD

    order = np.lexsort((ppp, pp, keys))
    ck, pk, qk = keys[order], pp[order], ppp[order]
    change = np.ones(n, dtype=bool)
    change[1:] = (ck[1:] != ck[:-1]) | (pk[1:] != pk[:-1]) | (qk[1:] != qk[:-1])
    gid = np.cumsum(change) - 1
    starts = np.flatnonzero(change)
    link = np.diff(np.concatenate([starts, [n]])).astype(np.int32)
    cur = ck[starts]
    ppv = pk[starts]
    pppv = qk[starts]
    # first-occurrence (minimum original column index) per group —
    # groups are contiguous in sorted order, so reduceat beats ufunc.at
    ins = np.minimum.reduceat(order, starts)

    tag_change = np.ones(len(cur), dtype=bool)
    tag_change[1:] = cur[1:] != cur[:-1]
    tstarts = np.flatnonzero(tag_change)
    tag_key = cur[tstarts]
    tag_off = np.concatenate([tstarts, [len(cur)]]).astype(np.int64)
    return EdgeTable(cur, ppv, pppv, link, ins, tag_key, tag_off)
