"""Indel left-normalization of alignment op runs, shared by the
short-read (mapper.py) and long-read (longread.py) mappers.  In the JAX
package these two functions live in align/longread.py; here they have a
module of their own so that mapper.py can import them at module level
(longread.py imports mapper.py)."""
from __future__ import annotations

import numpy as np

_M, _I, _D = 0, 1, 2


def left_align_runs(runs, qcodes, rcodes, qa: int, ra: int):
    """Left-normalize indels in an op-run list (the standard left-align
    pass of bcftools norm / GATK LeftAlignIndels).

    In a repeat, a gap's column is ambiguous and our banded DP breaks
    the tie differently per read (band offset, anchor layout), so reads
    carrying the SAME event scatter it over several pileup columns and
    no column reaches a consensus majority; minimap2's reads agree on
    one column and the engine fixes the site (measured: at every
    residual mid-contig indel of the ONT truth-sim, minimap2's BAM had
    13-22 reads deleting in one column where ours spread 1-4 per
    column).  Shifting every gap to its leftmost equivalent position
    makes placement canonical without changing any aligned pair:
    a deletion may move left one step when ref[r0-1] == ref[r0+L-1],
    an insertion when q[q0-1] == q[q0+L-1] — the displaced M column
    pairs the same base values before and after.

    runs: [[op, len], ...] over q[qa:...] / ref[ra:...] with op in
    {M, I, D} (no clips).  Returns a normalized list (same spans).
    One forward pass with incremental cursors (shifting a gap left only
    grows the NEXT gap's left room, so forward order converges); the
    rare gap-merge case restarts the pass."""
    out = [[op, ln] for op, ln in runs if ln > 0]
    for _ in range(len(out) + 2):  # restart bound (merges are rare)
        qc, rc = qa, ra  # start of run i
        i = 0
        merged_gap = False
        while i < len(out):
            op, ln = out[i]
            if i > 0 and op != _M and out[i - 1][0] == _M:
                # never shift a gap onto the alignment start (a leading
                # I/D after the clip is not a valid BAM alignment)
                left_room = out[i - 1][1] - (1 if i == 1 else 0)
                s = 0
                if op == _D:
                    while (s < left_room
                           and rcodes[rc - 1 - s]
                           == rcodes[rc - 1 - s + ln]):
                        s += 1
                else:
                    while (s < left_room
                           and qcodes[qc - 1 - s]
                           == qcodes[qc - 1 - s + ln]):
                        s += 1
                if s:
                    out[i - 1][1] -= s
                    # displaced M columns reappear right of the gap
                    if i + 1 < len(out) and out[i + 1][0] == _M:
                        out[i + 1][1] += s
                    else:
                        out.insert(i + 1, [_M, s])
                    qc -= s
                    rc -= s
                    if out[i - 1][1] == 0:
                        del out[i - 1]
                        i -= 1
                        if i > 0 and out[i - 1][0] == op:
                            # gaps fused across the vanished M: merge
                            # and restart (cursor bookkeeping resets)
                            out[i - 1][1] += out[i][1]
                            del out[i]
                            merged_gap = True
                            break
            if op == _M:
                qc += ln
                rc += ln
            elif op == _I:
                qc += ln
            else:
                rc += ln
            i += 1
        if not merged_gap:
            break
    return out


def left_align_cigar(cig: np.ndarray, qcodes: np.ndarray,
                     ref_codes: np.ndarray, q0: int, r0: int) -> np.ndarray:
    """left_align_runs over a BAM cigar array (clips preserved).
    q0/r0 = query offset (after the 5' clip) and global ref start of the
    aligned span."""
    ops = (cig & 0xF).astype(np.int64)
    lens = (cig >> 4).astype(np.int64)
    head = []
    tail = []
    mid = []
    for op, ln in zip(ops.tolist(), lens.tolist()):
        if op in (4, 5) and not mid:
            head.append((op, ln))
        elif op in (4, 5):
            tail.append((op, ln))
        else:
            mid.append([op, ln])
    if not any(op in (_I, _D) for op, _ in mid):
        return cig
    mid = left_align_runs(mid, qcodes, ref_codes, q0, r0)
    out = ([(ln << 4) | op for op, ln in head]
           + [(ln << 4) | op for op, ln in mid]
           + [(ln << 4) | op for op, ln in tail])
    return np.array(out, dtype=np.uint32)
