"""Level-scan inputs for the port's tests, beside the simulated windows:
random level streams that reach carry states real windows seldom reach,
and cuts of a window.  Imports numpy and the port only (the card's
machine has no JAX).

A random stream is any input the scan defines, not a simulated pileup:
per level a random coverage, delta-0 flag and ring slot; per (cell, slot)
an entry with probability `density`, with a random link, flags, carry
row and match bits below E.  Its entries are in (level, cell, slot)
order, as device_dp.pack_batch requires.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from nextpolish_tpu_torch.models.cns.device_dp import DenseWindow
from nextpolish_tpu_torch.models.cns.level_scan import F_HEAD, F_VALID


def random_window(seed: int, n_levels: int, E: int, Vb: int,
                  density: float = 0.2, d0_frac: float = 0.6,
                  ring_frac: float = 0.5) -> DenseWindow:
    """A random level stream of n_levels levels with E slots and Vb ring
    slots.  `ring_frac` of the non-head entries gather from a ring row,
    the rest from the previous level."""
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 60, n_levels)
    d0 = rng.random(n_levels) < d0_frac
    vslot = rng.integers(-1, Vb, n_levels)
    meta = (cov << 8) | ((vslot + 1) << 2) | (d0.astype(np.int64) << 1)
    present = rng.random((n_levels, 6, E)) < density
    lvl, b, slot = np.nonzero(present)  # (level, cell, slot) order
    n = len(lvl)
    head = rng.random(n) < 0.1
    link = rng.integers(0, 40, n)
    pp = np.where(rng.random(n) < ring_frac,
                  rng.integers(0, Vb * 6, n),
                  Vb * 6 + rng.integers(0, 6, n))
    pp = np.where(head, 0, pp)
    flags = (np.where(rng.random(n) < 0.95, F_VALID, 0)
             | np.where(head, F_HEAD, 0) | rng.integers(0, 8, n) * 4)
    bits = rng.random((n, E)) < 0.25
    match = (bits.astype(np.int64) << np.arange(E)).sum(axis=1)
    match = np.where(head, 0, match)
    return DenseWindow(
        ent_lvl=lvl.astype(np.int64), ent_b=b.astype(np.int8),
        ent_slot=slot.astype(np.int8),
        ent_A=((link << 16) | (pp << 8) | flags).astype(np.int32),
        ent_M=match.astype(np.int32), ent_same=pp >= Vb * 6,
        meta=meta.astype(np.int32), eorder=np.arange(n, dtype=np.int64),
        level_pos=np.arange(n_levels, dtype=np.int32), n_levels=n_levels,
        Vb=Vb, E=E, edges=None, length=n_levels)


def truncate(dw: DenseWindow, n: int) -> DenseWindow:
    """The window's first n levels (a prefix of the level scan is the scan
    of the prefix)."""
    n = min(n, dw.n_levels)
    keep = dw.ent_lvl < n
    return dataclasses.replace(
        dw, ent_lvl=dw.ent_lvl[keep], ent_b=dw.ent_b[keep],
        ent_slot=dw.ent_slot[keep], ent_A=dw.ent_A[keep],
        ent_M=dw.ent_M[keep], ent_same=dw.ent_same[keep],
        eorder=dw.eorder[keep], meta=dw.meta[:n],
        level_pos=dw.level_pos[:n], n_levels=n)


def max_level_entries(dw: DenseWindow) -> int:
    return int(np.bincount(dw.ent_lvl, minlength=dw.n_levels).max())


def stale_ring_reads(dw: DenseWindow) -> int:
    """Entries with match bits that gather from a ring row whose last
    writer came before the latest delta-0 reset: cells that hold an old
    score and must read NEG."""
    vb6 = dw.Vb * 6
    writer = np.full(dw.Vb, -1)  # level that last wrote each ring row
    reset = -1  # the latest delta-0 level
    pp = (dw.ent_A >> 8) & 0xFF
    starts = np.searchsorted(dw.ent_lvl, np.arange(dw.n_levels + 1))
    stale = 0
    for lv in range(dw.n_levels):
        sl = slice(starts[lv], starts[lv + 1])
        rows = pp[sl] // 6
        ring = (pp[sl] < vb6) & (dw.ent_M[sl] != 0)
        stale += int(np.sum(ring & (writer[np.minimum(rows, dw.Vb - 1)]
                                    >= 0)
                            & (writer[np.minimum(rows, dw.Vb - 1)] < reset)))
        mt = int(dw.meta[lv])
        vslot = ((mt >> 2) & 0x3F) - 1
        if (mt >> 1) & 1:
            reset = lv
        if vslot >= 0:
            writer[vslot] = lv
    return stale
