"""Device path for the engine-2 link DP (get_cns_from_align_tags,
lib/ctg_cns.c:1876-2144) — port of nextpolish_tpu/models/cns/device_dp.py.

Reformulation (as in the JAX package): the sparse (t_pos, delta, q_base)
lattice becomes a flat sequence of *levels* (one level per occupied
(t_pos, delta) pair, in DP order); every level holds exactly the 6 base
cells, each with up to E entry slots in reference insertion order.  The
level scan (level_scan.py: two hand-written CUDA kernels on the card, the
chain and the winners; plain PyTorch on the CPU) walks the levels:

  - within a position, level d's predecessors live in level d-1 (carried
    as `prev`), because a read's insertion run increments delta by exactly
    one per column;
  - across positions, a delta-0 level's predecessors are the *chain-end*
    cells of the previous position, staged into a small boundary ring
    ([Vb, 6, E]) that resets when a new position starts.

Scores are int32 (the C uses int64; densify_window checks an upper bound
and refuses windows that could overflow).  All tie-break inputs that the
read-type rules need are precomputed on the host into per-entry flag bits.

The scan emits per-level winners (best entry slot + its score per cell);
the host maps them back onto the EdgeTable and reuses dp.traceback, so
byte-parity with the host paths is structural.

Launch (dispatch_group / collect_group): up to B_MAX windows are packed
into one compact entry stream in pinned host memory, copied to the card
without blocking, scanned on the current stream, and the winners copied
back into pinned memory; a CUDA event marks the end and collect waits on
it.  On the CPU the same launch form runs through the plain version.
_run_batch sends its groups round-robin over a list of devices; the
batcher and calib launch on one device, as the JAX package's do (its
round-robin restarts at every call of at most B_MAX windows).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device, resolve_devices
from ...runtime import trace
from .dp import COV_COEF
from .level_scan import (
    F_COND1A,
    F_COND2B,
    F_HEAD,
    F_PPB_NOT_GAP,
    F_VALID,
    MAX_E,
    MAX_VB,
    NEG,
    WIN_FIELDS,
    ScanBatch,
    level_scan,
)
from .msa import EdgeTable, build_edges, unpack_keys
from .tags import GAP

READ_TYPE_ID = {"ont": 0, "clr": 1, "rs": 2, "hifi": 3}

# windows per launch (one thread block each)
B_MAX = 8


@dataclass
class DenseWindow:
    """Entry-major packed level data + host-only maps for traceback.
    Entries stay as flat [Et] vectors (tag-major, slot ascending) and are
    scattered straight into the batch slab at launch — no dense
    [Lt, 6, E] intermediates on the host."""

    ent_lvl: np.ndarray  # int64 [Et] level index
    ent_b: np.ndarray  # int8 [Et] base cell 0..5
    ent_slot: np.ndarray  # int8 [Et] entry slot (insertion order)
    ent_A: np.ndarray  # int32 [Et] (link<<16)|(pp_idx<<8)|flags
    ent_M: np.ndarray  # int32 [Et] match bits
    ent_same: np.ndarray  # bool [Et] pp_idx points at the same-pos section
    meta: np.ndarray  # int32 [Lt] (cov<<8)|((vslot+1)<<2)|(is_d0<<1)
    eorder: np.ndarray  # int64 [Et] absolute EdgeTable index per entry
    level_pos: np.ndarray  # int32 [Lt]
    n_levels: int
    Vb: int
    E: int
    edges: EdgeTable
    length: int


def densify_window(edges: EdgeTable, coverage: np.ndarray, length: int
                   ) -> DenseWindow | None:
    """EdgeTable -> DenseWindow, or None when the window exceeds the
    device caps / int32 score range (caller falls back to host)."""
    Tn = len(edges.tag_key)
    if Tn == 0:
        return None
    tp, td, tb = unpack_keys(edges.tag_key)
    ent_n = np.diff(edges.tag_off)
    E = int(ent_n.max())
    if E > MAX_E:
        return None

    # ---- levels: unique (p, d) in DP order (tag keys are sorted) -------
    lvl_key = edges.tag_key >> 3
    new_lvl = np.ones(Tn, dtype=bool)
    new_lvl[1:] = lvl_key[1:] != lvl_key[:-1]
    lvl_of_tag = np.cumsum(new_lvl) - 1
    lstarts = np.flatnonzero(new_lvl)
    Lt = len(lstarts)
    level_pos = tp[lstarts].astype(np.int32)
    level_d = td[lstarts].astype(np.int32)
    is_d0 = level_d == 0

    # int32 score-overflow guard: sum over levels of the largest positive
    # per-entry increment bounds any chain score
    c = 3  # smallest cov coefficient gives the largest increment bound
    # tags are contiguous per level: per-tag max then per-level max,
    # both as reduceat over the sorted layout
    tag_link_max = np.maximum.reduceat(
        edges.link.astype(np.int64), edges.tag_off[:-1])
    link_max = np.maximum.reduceat(tag_link_max, lstarts)
    inc = np.maximum(10 * link_max - c * coverage[level_pos], 0)
    if int(inc.sum()) >= 2 ** 30:
        return None
    if int(link_max.max()) >= 2 ** 15:  # link packs into 16 bits of A
        return None

    # ---- entry slots: insertion order within each cell -----------------
    # everything below is entry-major (flat [E_total]) with one scatter
    # into the [Lt, 6, E] dense arrays at the end
    Et = len(edges.cur)
    tag_of_entry = np.repeat(np.arange(Tn, dtype=np.int64), ent_n)
    eorder = np.lexsort((edges.ins, tag_of_entry))
    slot_sorted = (np.arange(Et, dtype=np.int64)
                   - np.repeat(edges.tag_off[:-1], ent_n))

    lvl_e = lvl_of_tag[tag_of_entry]
    b_e = tb[tag_of_entry].astype(np.int64)
    link_e = edges.link[eorder].astype(np.int32)
    pp_e = edges.pp[eorder]
    ppp_e = edges.ppp[eorder]
    head_e = pp_e < 0
    ppd = np.where(head_e, 0, (pp_e >> 3) & ((1 << 17) - 1))
    ppb = np.where(head_e, 0, pp_e & 7)
    hppp = ppp_e < 0
    pppd = np.where(hppp, 0, (ppp_e >> 3) & ((1 << 17) - 1))
    pppb = np.where(hppp, 0, ppp_e & 7)

    flags_e = np.full(Et, F_VALID, dtype=np.uint8)
    flags_e |= np.where(head_e, F_HEAD, 0).astype(np.uint8)
    flags_e |= np.where((pppd > 1) | (ppd > 0), F_COND1A, 0).astype(
        np.uint8)
    flags_e |= np.where((ppb == GAP) | (ppb == b_e) | (pppb == b_e)
                        | (ppb == pppb), F_COND2B, 0).astype(np.uint8)
    flags_e |= np.where(ppb != GAP, F_PPB_NOT_GAP, 0).astype(np.uint8)

    # ---- boundary ring: levels referenced as pp by next-position d0 ----
    # pp of a d0 entry is the read's last column at p-1 (any level there)
    d0_e = is_d0[lvl_e]
    lkeys = (level_pos.astype(np.int64) << 17) | level_d.astype(np.int64)
    ref_keys = np.unique(pp_e[d0_e & ~head_e] >> 3)
    ref_lvl = np.searchsorted(lkeys, ref_keys)
    ok = (ref_lvl < Lt) & (lkeys[np.minimum(ref_lvl, Lt - 1)] == ref_keys)
    ref_lvl = ref_lvl[ok]
    # assign ring slots per position in order of appearance
    vslot = np.full(Lt, -1, dtype=np.int32)
    if len(ref_lvl):
        rp = level_pos[ref_lvl]
        firsts = np.ones(len(ref_lvl), dtype=bool)
        firsts[1:] = rp[1:] != rp[:-1]
        grp = np.cumsum(firsts) - 1
        gstart = np.flatnonzero(firsts)
        vslot[ref_lvl] = (np.arange(len(ref_lvl)) - gstart[grp]).astype(
            np.int32)
    Vb = int(vslot.max()) + 1 if len(ref_lvl) else 1
    if Vb > MAX_VB:
        return None
    Vb = max(Vb, 1)

    # ---- pp_idx: gather index into concat(bnd [Vb*6,E], prev [6,E]) ----
    # d0 levels gather from the boundary ring slot of their pp level;
    # d>0 levels gather from the previous level (their pp is (p, d-1))
    pp_lvl_key = pp_e >> 3
    pos_pp = np.minimum(np.searchsorted(lkeys, pp_lvl_key), Lt - 1)
    pp_vs = np.maximum(
        np.where(lkeys[pos_pp] == pp_lvl_key, vslot[pos_pp], 0), 0)
    pp_idx_e = np.where(d0_e, pp_vs * 6 + ppb, Vb * 6 + ppb)
    pp_idx_e = np.where(head_e, 0, pp_idx_e).astype(np.int32)

    # ---- match bits: pred-cell entries whose pp equals our ppp ---------
    # per tag: its entries' pp keys in slot order
    tag_pp = np.full((Tn, E), -2, dtype=np.int64)
    tag_pp[tag_of_entry, slot_sorted] = pp_e
    # pred tag id for each entry (the cell keyed by our pp)
    pred_tag = np.minimum(np.searchsorted(edges.tag_key, pp_e), Tn - 1)
    pred_ok = edges.tag_key[pred_tag] == pp_e
    m = tag_pp[pred_tag] == ppp_e[:, None]  # [Et, E]
    m &= (pred_ok & ~head_e)[:, None]
    weights = (1 << np.arange(E, dtype=np.uint64)).astype(np.uint64)
    match_e = (m.astype(np.uint64) * weights[None]).sum(axis=1).astype(
        np.uint32)

    # ---- entry-major packed words + per-level meta ---------------------
    ent_A = ((link_e.astype(np.int32) << 16)
             | (pp_idx_e << 8)
             | flags_e.astype(np.int32))
    meta = ((coverage[level_pos].astype(np.int32) << 8)
            | ((vslot + 1) << 2)
            | (is_d0.astype(np.int32) << 1))
    return DenseWindow(
        ent_lvl=lvl_e, ent_b=b_e.astype(np.int8),
        ent_slot=slot_sorted.astype(np.int8), ent_A=ent_A,
        ent_M=match_e.astype(np.int64).astype(np.int32),
        ent_same=~d0_e & ~head_e, meta=meta, eorder=eorder,
        level_pos=level_pos, n_levels=Lt, Vb=Vb, E=E,
        edges=edges, length=length)


def dense_window_from_arrays(fields: dict) -> DenseWindow:
    """Build the port's DenseWindow from plain numpy arrays: the JAX
    package's DenseWindow fields, with its EdgeTable's fields as a dict
    under "edges" (``dataclasses.asdict`` of a JAX DenseWindow has this
    form).  Lets one window, prepared once, feed both packages."""
    ed = fields["edges"]
    edges = EdgeTable(
        cur=np.asarray(ed["cur"], dtype=np.int64),
        pp=np.asarray(ed["pp"], dtype=np.int64),
        ppp=np.asarray(ed["ppp"], dtype=np.int64),
        link=np.asarray(ed["link"], dtype=np.int32),
        ins=np.asarray(ed["ins"], dtype=np.int64),
        tag_key=np.asarray(ed["tag_key"], dtype=np.int64),
        tag_off=np.asarray(ed["tag_off"], dtype=np.int64))
    return DenseWindow(
        ent_lvl=np.asarray(fields["ent_lvl"], dtype=np.int64),
        ent_b=np.asarray(fields["ent_b"], dtype=np.int8),
        ent_slot=np.asarray(fields["ent_slot"], dtype=np.int8),
        ent_A=np.asarray(fields["ent_A"], dtype=np.int32),
        ent_M=np.asarray(fields["ent_M"], dtype=np.int32),
        ent_same=np.asarray(fields["ent_same"], dtype=bool),
        meta=np.asarray(fields["meta"], dtype=np.int32),
        eorder=np.asarray(fields["eorder"], dtype=np.int64),
        level_pos=np.asarray(fields["level_pos"], dtype=np.int32),
        n_levels=int(fields["n_levels"]), Vb=int(fields["Vb"]),
        E=int(fields["E"]), edges=edges, length=int(fields["length"]))


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------

def tail_start(dw: DenseWindow) -> int:
    """First level of the window's last position: the traceback reads
    only the scores of levels from here on."""
    lp = dw.level_pos
    return int(np.searchsorted(lp, lp[-1]))


def _check_stream(dw: DenseWindow) -> None:
    """What the level-scan kernels rely on: entries in (level, cell, slot)
    order (the winners walk a cell's slots in insertion order), so at most
    6*E a level; match bits and pred rows inside the window's E and Vb."""
    if dw.E > MAX_E or dw.Vb > MAX_VB:
        raise ValueError(f"window E={dw.E} Vb={dw.Vb} over the caps")
    if not len(dw.ent_A):
        return
    b = dw.ent_b.astype(np.int64)
    s = dw.ent_slot.astype(np.int64)
    if (dw.ent_lvl[0] < 0 or dw.ent_lvl[-1] >= dw.n_levels or b.min() < 0
            or b.max() > 5 or s.min() < 0 or s.max() >= dw.E):
        raise ValueError("DenseWindow entry level / cell / slot out of "
                         "range")
    key = (dw.ent_lvl * 6 + b) * MAX_E + s
    if np.any(key[1:] <= key[:-1]):
        raise ValueError("DenseWindow entries are not in (level, cell, "
                         "slot) order")
    if np.any(dw.ent_M.view(np.uint32) >> np.uint32(dw.E)):
        raise ValueError("DenseWindow match bit at or past E")
    if np.any(((dw.ent_A >> 8) & 0xFF) >= (dw.Vb + 1) * 6):
        raise ValueError("DenseWindow pp_idx past the window's carry rows")
    if np.any(((dw.meta >> 2) & 0x3F) > dw.Vb):
        raise ValueError("DenseWindow ring slot at or past Vb")


def pack_batch(dws, sc_tail: bool = False, pin: bool = False) -> ScanBatch:
    """Pack windows into the level scan's launch form (CPU tensors, in
    pinned memory when `pin`).  With sc_tail, each window's scores are
    kept only from tail_start on."""
    B = len(dws)
    Lts = np.array([dw.n_levels for dw in dws], dtype=np.int64)
    Ets = np.array([len(dw.ent_A) for dw in dws], dtype=np.int64)
    Lt, Et = int(Lts.sum()), int(Ets.sum())
    if Lt >= 2 ** 31 or Et >= 2 ** 31:
        raise ValueError("batch too large for int32 level/entry offsets")
    sc_from = np.array([tail_start(dw) if sc_tail else 0 for dw in dws],
                       dtype=np.int64)
    lvl_base = np.concatenate([[0], np.cumsum(Lts)[:-1]]).astype(np.int64)
    ent_base = np.concatenate([[0], np.cumsum(Ets)[:-1]]).astype(np.int64)
    sc_rows = Lts - sc_from
    sc_base = np.concatenate([[0], np.cumsum(sc_rows)[:-1]]).astype(np.int64)

    def buf(n, dtype):
        t = torch.empty(n, dtype=dtype, pin_memory=pin)
        return t, t.numpy()

    A_t, A = buf(Et, torch.int32)
    M_t, M = buf(Et, torch.int32)
    b_t, b = buf(Et, torch.int8)
    s_t, s = buf(Et, torch.int8)
    off_t, off = buf(Lt + 1, torch.int32)
    meta_t, meta = buf(Lt, torch.int32)
    win_t, win = buf(B * WIN_FIELDS, torch.int32)
    win = win.reshape(B, WIN_FIELDS)
    win[:] = 0
    for i, dw in enumerate(dws):
        _check_stream(dw)
        n, lo, lb = int(Ets[i]), int(ent_base[i]), int(lvl_base[i])
        A[lo:lo + n] = dw.ent_A
        M[lo:lo + n] = dw.ent_M
        b[lo:lo + n] = dw.ent_b
        s[lo:lo + n] = dw.ent_slot
        nl = int(Lts[i])
        off[lb:lb + nl] = lo + np.searchsorted(dw.ent_lvl, np.arange(nl))
        meta[lb:lb + nl] = dw.meta
        win[i, :6] = (lb, nl, dw.E, dw.Vb, sc_from[i], sc_base[i])
    off[Lt] = Et
    return ScanBatch(A_t, M_t, b_t, s_t, off_t, meta_t,
                     win_t.view(B, WIN_FIELDS), win.copy(),
                     int(sc_rows.sum()))


@dataclass
class Pending:
    """One dispatched group: host results (filled once `done` fires; at
    once on the CPU) and what must stay alive until then."""

    win: np.ndarray
    best: torch.Tensor
    sc: torch.Tensor
    done: object  # torch.cuda.Event | None
    keep: tuple


def dispatch_group(dws, read_type: str, device=None,
                   cov_coef: int | None = None,
                   sc_tail: bool = False) -> Pending:
    """ONE launch for up to B_MAX windows; returns at once on a card."""
    dev = resolve_device(device)
    rt_id = READ_TYPE_ID[read_type]
    c = COV_COEF[read_type] if cov_coef is None else cov_coef
    host = pack_batch(dws, sc_tail=sc_tail, pin=dev.type == "cuda")
    trace.count("cns.levels", int(host.win_host[:, 1].sum()))
    trace.count("cns.launches", 1)
    trace.count("cns.windows", len(dws))
    if dev.type == "cpu":
        best, sc = level_scan(host, rt_id, c)
        return Pending(host.win_host, best, sc, None, ())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        dbatch = host.to(dev, non_blocking=True)
        best_d, sc_d = level_scan(dbatch, rt_id, c)
        best = torch.empty(best_d.shape, dtype=best_d.dtype,
                           pin_memory=True)
        sc = torch.empty(sc_d.shape, dtype=sc_d.dtype, pin_memory=True)
        best.copy_(best_d, non_blocking=True)
        sc.copy_(sc_d, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return Pending(host.win_host, best, sc, done,
                   (host, dbatch, best_d, sc_d))


def collect_group(pend: Pending) -> list:
    """Wait for a dispatched group -> per-window (best [Lt, 6] int8,
    sc [Lt, 6] int32); levels before the window's sc_from read NEG."""
    if pend.done is not None:
        pend.done.synchronize()
    best_all = pend.best.numpy()
    sc_all = pend.sc.numpy()
    out = []
    for row in pend.win:
        lb, nl, _, _, sc_from, sc_base = (int(x) for x in row[:6])
        best = best_all[lb:lb + nl].copy()
        if sc_from == 0:
            sc = sc_all[sc_base:sc_base + nl].copy()
        else:
            sc = np.full((nl, 6), NEG, dtype=np.int32)
            sc[sc_from:] = sc_all[sc_base:sc_base + nl - sc_from]
        out.append((best, sc))
    return out


def _run_batch(dws, read_type, cov_coef=None, devices=None, sc_tail=False):
    """Scan a batch of DenseWindows, B_MAX windows per launch, all launched
    before any is collected; returns per-window (best [Lt,6], sc_bm
    [Lt,6]) numpy arrays.  Group gi runs on devices[gi % len(devices)]
    (resolve_devices: by default every visible card), as the JAX
    package's _dispatch_batch_pallas spreads its groups over every local
    chip; trace cns.groups.entry{k} counts the groups sent to entry k.
    With sc_tail=True only each window's last-position score levels are
    kept (all a traceback needs); earlier levels read NEG."""
    devs = resolve_devices(devices)
    pends = []
    for gi, lo in enumerate(range(0, len(dws), B_MAX)):
        k = gi % len(devs)
        trace.count(f"cns.groups.entry{k}", 1)
        pends.append(dispatch_group(dws[lo:lo + B_MAX], read_type, devs[k],
                                    cov_coef, sc_tail))
    return [r for p in pends for r in collect_group(p)]


def _to_edge_outputs(dw: DenseWindow, best: np.ndarray, sc_bm: np.ndarray):
    """Map per-level winners back to per-tag arrays on the EdgeTable.
    Entries are tag-major with slots ascending, so a tag's winning entry
    is eorder[tag_off[t] + best_slot[t]]."""
    edges = dw.edges
    Tn = len(edges.tag_key)
    tp, td, tb = unpack_keys(edges.tag_key)
    lvl_key = edges.tag_key >> 3
    new_lvl = np.ones(Tn, dtype=bool)
    new_lvl[1:] = lvl_key[1:] != lvl_key[:-1]
    lvl_of_tag = np.cumsum(new_lvl) - 1
    b_of_tag = tb.astype(np.int64)
    best_slot = best[lvl_of_tag, b_of_tag].astype(np.int64)
    best_arr = dw.eorder[edges.tag_off[:-1] + best_slot]
    score_arr = np.full(len(edges.cur), NEG, dtype=np.int64)
    score_arr[best_arr] = sc_bm[lvl_of_tag, b_of_tag]
    return score_arr, best_arr


def prepare_window(merged, coverage, length):
    """TagColumns -> (EdgeTable, DenseWindow | None), via the native
    single-pass preparer (cns_prep.cpp) when available; the numpy
    build_edges + densify_window pair is the fallback and the oracle the
    native path is tested against."""
    from ... import native

    if native.available():
        cov = np.ascontiguousarray(coverage, dtype=np.int32)
        out = native.cns_prepare(merged.t_pos, merged.delta, merged.q_base,
                                 merged.row_off, cov, length, MAX_E, MAX_VB)
        if out is not None:
            ed, dn = out
            edges = EdgeTable(ed["cur"], ed["pp"], ed["ppp"], ed["link"],
                              ed["ins"], ed["tag_key"], ed["tag_off"])
            dw = None
            if dn is not None:
                dw = DenseWindow(
                    ent_lvl=dn["ent_lvl"], ent_b=dn["ent_b"],
                    ent_slot=dn["ent_slot"], ent_A=dn["ent_A"],
                    ent_M=dn["ent_M"], ent_same=dn["ent_same"],
                    meta=dn["meta"], eorder=dn["eorder"],
                    level_pos=dn["level_pos"], n_levels=dn["n_levels"],
                    Vb=dn["Vb"], E=dn["E"], edges=edges, length=length)
            return edges, dw
    edges = build_edges(merged)
    return edges, densify_window(edges, coverage, length)
