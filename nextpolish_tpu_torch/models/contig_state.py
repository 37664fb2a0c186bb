"""Mutable per-contig polishing state over the cell chain.

Dense-tensor replacement for the reference's `Contig` of `Base` cells
(lib/contig.h:27-45): `base[n_cells]` compact symbols (DEL = deleted slot),
`flag[n_cells]` status bits, plus region morphology and FASTA emission
(contig_get_contig, lib/contig.c:736-799).

A copy of nextpolish_tpu/models/contig_state.py: only its imports may differ,
and none had to (they are relative).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fasta import ASCII_TO_NIB
from ..ops.pileup import CellIndex
from ..ops.symbols import DEL, NIB_TO_SYM, SYM_TO_ASCII
from .flags import FLAG_ZERO


def draft_to_syms(seq: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(compact symbols, lowercase mask) of a draft sequence."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    lower = (arr >= 97) & (arr <= 122)
    return NIB_TO_SYM[ASCII_TO_NIB[arr]], lower


@dataclass
class ContigState:
    name: str
    index: CellIndex
    base: np.ndarray  # [n_cells] uint8 compact symbols
    flag: np.ndarray  # [n_cells] uint8

    @classmethod
    def from_draft(cls, name: str, seq: bytes, index: CellIndex) -> "ContigState":
        """Initialize from a draft sequence: position cells carry the draft
        base, insert cells start as DEL; lowercase draft letters set FLAG_ZERO
        (contig_init_data, lib/contig.c:81-102); insert cells inherit their
        anchor's initial flag (contig_parse_read_insert :232-238)."""
        syms, lower = draft_to_syms(seq)
        base = np.full(index.n_cells, DEL, dtype=np.uint8)
        base[index.cell_of] = syms[index.start : index.end + 1]
        flag_pos = np.where(lower[index.start : index.end + 1], FLAG_ZERO, 0
                            ).astype(np.uint8)
        flag = np.zeros(index.n_cells, dtype=np.uint8)
        flag[index.cell_of] = flag_pos
        ins_cells = index.is_insert_cell()
        anchor = np.repeat(np.arange(index.end - index.start + 1),
                           index.ins_len)
        flag[ins_cells] = flag_pos[anchor]
        return cls(name, index, base, flag)

    def pos_base(self) -> np.ndarray:
        """Current base at each reference position (position cells only)."""
        return self.base[self.index.cell_of]

    def pos_flag(self) -> np.ndarray:
        return self.flag[self.index.cell_of]

    def emit(self, out_flags: int, start_cell: int = 0,
             end_cell: int | None = None) -> bytes:
        """Render cells [start_cell, end_cell) to sequence; DEL cells are
        dropped, flagged cells (and the base following a flagged deletion)
        lowercased — contig_get_contig semantics (lib/contig.c:736-799)."""
        if end_cell is None:
            end_cell = self.index.n_cells_dp
        base = self.base[start_cell:end_cell]
        flag = self.flag[start_cell:end_cell]
        emit = base != DEL
        flagged = (flag & out_flags) != 0
        pos = np.flatnonzero(emit)
        if not len(pos):
            return b""
        # `sign`: a flagged deleted cell lowercases the next emitted base
        del_flagged = (~emit) & flagged
        cum = np.cumsum(del_flagged)
        prev_cum = np.concatenate([[0], cum[pos[:-1]]])
        sign = (cum[pos] - prev_cum) > 0
        lower = flagged[pos] | sign
        chars = SYM_TO_ASCII[base[pos]]
        chars = np.where(lower, chars + 32, chars).astype(np.uint8)
        return chars.tobytes()

    def update_flags(self, cells: np.ndarray, set_mask: np.ndarray,
                     flag_bit: int) -> None:
        """Set flag_bit where set_mask, clear elsewhere (the set-or-clear
        pattern of contig_region_correct :480-492)."""
        self.flag[cells[set_mask]] |= flag_bit
        self.flag[cells[~set_mask]] &= 0xFF ^ flag_bit

    def clear_flag(self, cells: np.ndarray, flag_bit: int) -> None:
        self.flag[cells] &= 0xFF ^ flag_bit

    def set_flag(self, cells: np.ndarray, flag_bit: int) -> None:
        self.flag[cells] |= flag_bit


def debug_points(state: ContigState, draft: bytes) -> list:
    """PolishPoint trace for -debug (the trace_polish_open branch of
    contig_get_contig, lib/contig.c:743-777): one (pos, index, curbase,
    draftbase) per changed base.  curbase '.' marks a deleted draft base;
    draftbase '.' marks an inserted one.  curbase is reported uppercase
    (recorded before lowercase flagging, like the reference)."""
    idx = state.index
    n = idx.n_cells_dp
    cell_pos = idx.cell_pos()[:n]
    cell_j = np.arange(n) - idx.cell_of[cell_pos - idx.start]
    base = state.base[:n]
    dr = np.frombuffer(draft, dtype=np.uint8)
    dr_up = np.where((dr >= 97) & (dr <= 122), dr - 32, dr)
    is_del = base == DEL
    ch = SYM_TO_ASCII[base]
    dch = dr_up[cell_pos]
    m = (is_del & (cell_j == 0)) | ((~is_del) & (cell_j > 0)) \
        | ((~is_del) & (cell_j == 0) & (ch != dch))
    pts = []
    for c in np.flatnonzero(m):
        if is_del[c]:
            pts.append((int(cell_pos[c]), 0, ".", chr(dch[c])))
        elif cell_j[c] > 0:
            pts.append((int(cell_pos[c]), int(cell_j[c]), chr(ch[c]), "."))
        else:
            pts.append((int(cell_pos[c]), 0, chr(ch[c]), chr(dch[c])))
    return pts


def maybe_trace(cfg, name: str, state: ContigState, draft: bytes) -> None:
    """Append this contig's PolishPoints to cfg.trace_sink when -debug is
    active (lib/nextpolish1.py:230-231 stderr reporting)."""
    sink = getattr(cfg, "trace_sink", None)
    if sink is not None:
        for p in debug_points(state, draft):
            sink.append((name,) + p)


def brim_region(state: ContigState, qs: int, qe: int, bstart: int, bend: int,
                flag_bit: int, extend: bool, ext_len_edge: int
                ) -> tuple[int, int]:
    """Region boundary widening (contig_brim_no_extension /
    contig_brim_with_extension, lib/contig.c:498-517).

    With extend=True, the left bound steps back while base[s+1] == base[s] or
    flag[s] has flag_bit; the right bound steps forward while base[e-1] ==
    base[e] or flag[e] has flag_bit (position cells only)."""
    qs = qs - ext_len_edge if qs >= bstart + ext_len_edge else bstart
    qe = qe + ext_len_edge if qe <= bend - ext_len_edge else bend
    if extend:
        pb = state.pos_base()
        pf = state.pos_flag()
        off = state.index.start
        while qs > bstart and qs + 1 - off < len(pb) and (
            pb[qs + 1 - off] == pb[qs - off]
            or (pf[qs - off] & flag_bit) != 0
        ):
            qs -= 1
        while qe < bend and qe - off >= 1 and (
            pb[qe - 1 - off] == pb[qe - off]
            or (pf[qe - off] & flag_bit) != 0
        ):
            qe += 1
    return qs, qe


def find_regions(state: ContigState, bstart: int, bend: int, gap: int,
                 con: int, flag_bit: int, extend: bool, ext_len_edge: int
                 ) -> list[tuple[int, int]]:
    """Flag-run discovery along the cell chain -> position-space regions
    (contig_get_region, lib/contig.c:519-563).

    gap/con count cell steps; region bounds are reference positions."""
    index = state.index
    cell_pos = index.cell_pos()
    flag = state.flag
    c_lo = int(index.cell_of[bstart - index.start])
    c_hi = int(index.cell_of[bend - index.start])  # inclusive
    regions: list[tuple[int, int]] = []
    qstart = qend = -1
    pgap = pcon = 0
    c = c_lo
    while c <= c_hi:
        p = int(cell_pos[c])
        if (flag[c] & flag_bit) != 0:
            if qstart == -1:
                qstart = p
                pcon = 1
            elif pgap == 0:
                pcon += 1
            else:
                pcon = 1
            pgap = 0
            qend = p
        elif qstart != -1:
            pgap += 1
            if pgap > gap:
                if pcon > con:
                    qs, qe = brim_region(state, qstart, qend, bstart, bend,
                                         flag_bit, extend, ext_len_edge)
                    regions.append((qs, qe))
                    if qe > p:
                        c = int(index.cell_of[qe - index.start])
                qstart = qend = -1
        c += 1
    if qstart != -1:
        regions.append(brim_region(state, qstart, qend, bstart, bend,
                                   flag_bit, extend, ext_len_edge))
    return regions


def merge_regions(regions: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Overlap merge (contig_merge_region, lib/contig.c:595-620)."""
    if not regions:
        return []
    out = [list(regions[0])]
    for s, e in regions[1:]:
        if s >= out[-1][1]:
            out.append([s, e])
        else:
            while len(out) > 1 and s < out[-1][0]:
                out.pop()
            out[-1][1] = e
    return [(s, e) for s, e in out]
