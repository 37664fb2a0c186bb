"""Engine-2 level scan: the wrappers of the two hand-written CUDA kernels
(csrc/level_scan.cu) and their plain PyTorch versions.

Port of nextpolish_tpu/models/cns/pallas_scan.py (the TPU kernel
`_kernel` and its launch glue `get_level_scan`); the plain versions follow
the lax.scan twin, nextpolish_tpu/models/cns/device_dp.py::_dp_level.

The scan runs in two halves:
  level_chain    the sequential DP over each window's levels (one chain
                 per window): per entry its score sc, n_best and, for ONT,
                 n_last, int32 [3 or 2, Et] in entry-stream order;
  level_winners  the read-type rules, independent per level: the winning
                 slot and its score per (level, cell).
level_scan runs both.

Launch form (ScanBatch), built by device_dp.pack_batch from B windows:
  ent_A    int32 [Et]  (link << 16) | (pp_idx << 8) | flags, level-major
  ent_M    int32 [Et]  match bits (bit n: pred slot n matches our ppp)
  ent_b    int8  [Et]  base cell 0..5
  ent_slot int8  [Et]  entry slot 0..E-1 (insertion order)
  lvl_off  int32 [Lt+1] first entry of every level (all windows, in order)
  meta     int32 [Lt]  (cov << 8) | ((vslot + 1) << 2) | (is_d0 << 1)
  win      int32 [B, 8] (lvl_base, n_levels, E, Vb, sc_from, sc_base, 0, 0)
Within a level, entries are in (cell, slot) order.  Each window keeps its
own E and Vb, so pp_idx needs no re-basing: an index at or past Vb*6 names
the previous level, any other a ring row.  Slot and cell are separate
fields, so every E <= MAX_E runs (the TPU's 20-slot cap came from packing
both into one 7-bit byte).

Outputs: best int8 [Lt, 6] (winning slot per level and cell) and sc int32
[n_sc_rows, 6], the winners' scores of each window's levels from sc_from
on (row sc_base + l - sc_from of the window's level l).

Each wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors, nothing else: on a card the kernel runs or the call raises.  The
winners refuse a negative link (a device-side assert on the card).
"""
from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ...runtime import nvcc

NEG = -(2 ** 29)  # masked-out candidate score
NEGINIT = -(2 ** 30)  # "unset" p_pp / raiser

F_VALID = 1
F_HEAD = 2
F_COND1A = 4
F_COND2B = 8
F_PPB_NOT_GAP = 16

MAX_E = 24
MAX_VB = 24
WIN_FIELDS = 8

_SRC = os.path.join(nvcc.CSRC_DIR, "level_scan.cu")


@dataclass
class ScanBatch:
    """The kernel's launch form (see the module docstring).  `win_host`
    is the host copy of `win`, which shapes and checks read."""

    ent_A: torch.Tensor
    ent_M: torch.Tensor
    ent_b: torch.Tensor
    ent_slot: torch.Tensor
    lvl_off: torch.Tensor
    meta: torch.Tensor
    win: torch.Tensor
    win_host: np.ndarray
    n_sc_rows: int

    def tensors(self):
        return (self.ent_A, self.ent_M, self.ent_b, self.ent_slot,
                self.lvl_off, self.meta, self.win)

    def to(self, device, non_blocking: bool = False) -> "ScanBatch":
        t = [x.to(device, non_blocking=non_blocking) for x in self.tensors()]
        return ScanBatch(*t, win_host=self.win_host,
                         n_sc_rows=self.n_sc_rows)


# ---------------------------------------------------------------------------
# build + bind (nvcc -> shared library with a plain C interface -> ctypes)
# ---------------------------------------------------------------------------

_LIB = None


def build() -> dict:
    """Compile csrc/level_scan.cu for sm_90a into _build/ (see
    runtime/nvcc.py).  Returns {"path", "seconds", "ptxas"}."""
    return nvcc.build(_SRC, "level_scan")


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.npt_level_chain.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p,
                                        p, p]
        lib.npt_level_chain.restype = i
        lib.npt_level_winners.argtypes = [p, p, p, p, p, p, i, i, i, p, p,
                                          p, p, p, p]
        lib.npt_level_winners.restype = i
        lib.npt_level_chain_smem_bytes.argtypes = []
        lib.npt_level_chain_smem_bytes.restype = i
        lib.npt_smem_step_cycles.argtypes = [i, p, p]
        lib.npt_smem_step_cycles.restype = i
        lib.npt_cuda_error_string.argtypes = [i]
        lib.npt_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.npt_cuda_error_string(rc).decode())


def chain_smem_bytes() -> int:
    """Dynamic shared memory of one level_chain block (bytes)."""
    return int(_load().npt_level_chain_smem_bytes())


def smem_step_cycles(device, steps: int = 1 << 16) -> int:
    """SM cycles of one dependent shared-memory load -> store step (with
    a __syncwarp), measured on the card by a one-warp probe: the floor of
    one level of the chain.  A measurement, not part of the scan."""
    dev = torch.device(device)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.npt_smem_step_cycles(
            steps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "smem_step_probe")
    return int(out[0])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def inter_rows(rt_id: int) -> int:
    """Rows of the chain's per-entry result: sc, n_best, and n_last, which
    only the ONT rules read."""
    return 3 if rt_id == 0 else 2


def _device_of(batch: ScanBatch) -> torch.device:
    devs = {t.device for t in batch.tensors()}
    if len(devs) != 1:
        raise ValueError(f"batch tensors span devices {devs}")
    (dev,) = devs
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the level scan runs on cuda or cpu, not {dev}")
    return dev


def _check(batch: ScanBatch, device: torch.device) -> None:
    want = (torch.int32, torch.int32, torch.int8, torch.int8, torch.int32,
            torch.int32, torch.int32)
    for name, t, dt in zip(("ent_A", "ent_M", "ent_b", "ent_slot",
                            "lvl_off", "meta", "win"), batch.tensors(), want):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    win = batch.win_host
    B = len(win)
    if tuple(batch.win.shape) != (B, WIN_FIELDS):
        raise ValueError(f"win has shape {tuple(batch.win.shape)}")
    Lt = batch.meta.numel()
    if batch.lvl_off.numel() != Lt + 1 or int(win[:, 1].sum()) != Lt:
        raise ValueError("lvl_off / meta / win level counts disagree")
    if B and (win[:, 2].max() > MAX_E or win[:, 3].max() > MAX_VB
              or win[:, 2].min() < 1 or win[:, 3].min() < 1):
        raise ValueError("window E / Vb outside 1..24")


def _check_inter(batch: ScanBatch, inter: torch.Tensor, rt_id: int) -> None:
    want = (inter_rows(rt_id), batch.ent_A.numel())
    if inter.device != batch.ent_A.device or inter.dtype != torch.int32:
        raise TypeError(f"inter is {inter.dtype} on {inter.device}")
    if tuple(inter.shape) != want or not inter.is_contiguous():
        raise ValueError(f"inter has shape {tuple(inter.shape)}, expected "
                         f"{want} contiguous")


def level_chain(batch: ScanBatch, rt_id: int, cov_coef: int) -> torch.Tensor:
    """The chain half: per entry sc, n_best (and n_last for ONT), int32
    [inter_rows(rt_id), Et] on the batch's device.  CUDA tensors go to
    level_chain_kernel (which runs or raises), CPU tensors to
    level_chain_plain.  `level_chain.launches` counts kernel launches."""
    dev = _device_of(batch)
    if dev.type == "cpu":
        return level_chain_plain(batch, rt_id, cov_coef)
    _check(batch, dev)
    if rt_id not in (0, 1, 2, 3):
        raise ValueError(f"rt_id {rt_id}")
    Et = batch.ent_A.numel()
    inter = torch.empty((inter_rows(rt_id), Et), dtype=torch.int32,
                        device=dev)
    B = len(batch.win_host)
    if B == 0 or batch.meta.numel() == 0:
        return inter
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nl = inter[2].data_ptr() if rt_id == 0 else 0
    with torch.cuda.device(dev):
        rc = lib.npt_level_chain(
            *(t.data_ptr() for t in batch.tensors()), B, int(rt_id == 0),
            cov_coef, inter[0].data_ptr(), inter[1].data_ptr(), nl, stream)
    _raise_on(lib, rc, "level_chain kernel")
    with _COUNT_LOCK:  # launches come from several producer threads
        level_chain.launches += 1
    return inter


def level_winners(batch: ScanBatch, inter: torch.Tensor, rt_id: int):
    """The winners half: (best int8 [Lt, 6], sc int32 [n_sc_rows, 6]) from
    the chain's per-entry results, on the batch's device.  CUDA tensors go
    to level_winners_kernel (which runs or raises), CPU tensors to
    level_winners_plain.  `level_winners.launches` counts kernel
    launches."""
    dev = _device_of(batch)
    if dev.type == "cpu":
        return level_winners_plain(batch, inter, rt_id)
    _check(batch, dev)
    if rt_id not in (0, 1, 2, 3):
        raise ValueError(f"rt_id {rt_id}")
    _check_inter(batch, inter, rt_id)
    Lt = batch.meta.numel()
    best = torch.empty((Lt, 6), dtype=torch.int8, device=dev)
    sc = torch.empty((batch.n_sc_rows, 6), dtype=torch.int32, device=dev)
    B = len(batch.win_host)
    if B == 0 or Lt == 0:
        return best, sc
    if batch.ent_A.numel():
        # links >= 0 keep C's truncating halving in the ONT rules equal to
        # JAX's floor division; checked on the card, without a host sync
        torch._assert_async(batch.ent_A.min() >= 0,
                            "negative link in ent_A")
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nl = inter[2].data_ptr() if rt_id == 0 else 0
    t = batch.tensors()
    with torch.cuda.device(dev):
        rc = lib.npt_level_winners(
            t[0].data_ptr(), t[2].data_ptr(), t[3].data_ptr(),
            t[4].data_ptr(), t[5].data_ptr(), t[6].data_ptr(), B,
            int(batch.win_host[:, 1].max()), rt_id, inter[0].data_ptr(),
            inter[1].data_ptr(), nl, best.data_ptr(), sc.data_ptr(), stream)
    _raise_on(lib, rc, "level_winners kernel")
    with _COUNT_LOCK:
        level_winners.launches += 1
    return best, sc


level_chain.launches = 0
level_winners.launches = 0
_COUNT_LOCK = threading.Lock()


def level_scan(batch: ScanBatch, rt_id: int, cov_coef: int):
    """Scan every window of `batch`: the chain, then the winners; returns
    (best int8 [Lt, 6], sc int32 [n_sc_rows, 6]) on the batch's device.
    On a card that is one launch of each kernel, on the CPU their plain
    versions."""
    return level_winners(batch, level_chain(batch, rt_id, cov_coef), rt_id)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

@dataclass
class _Slabs:
    """A batch as dense level-major slabs [L, B, 6, E] (L the longest
    window, E and Vb the widest); `flat` is each entry's index into a
    flattened slab."""

    B: int
    L: int
    E: int
    Vb: int
    win: np.ndarray
    flat: torch.Tensor
    A: torch.Tensor
    M: torch.Tensor
    meta: torch.Tensor  # [L, B], pad levels carry the pad bit

    def scatter(self, vals: torch.Tensor, fill: int) -> torch.Tensor:
        return _scatter(self.flat, vals, fill, (self.L, self.B, 6, self.E))


def _scatter(flat, vals, fill, shape):
    out = torch.full((int(np.prod(shape)),), fill, dtype=vals.dtype,
                     device=vals.device)
    out[flat] = vals
    return out.view(shape)


def _slabs(batch: ScanBatch) -> _Slabs:
    dev = batch.meta.device
    win = batch.win_host.astype(np.int64)
    B = len(win)
    Lt_all = batch.meta.numel()
    Lts = win[:, 1]
    E = int(win[:, 2].max())
    Vb = int(win[:, 3].max())
    L = int(Lts.max())
    counts = (batch.lvl_off[1:] - batch.lvl_off[:-1]).long()
    g_of_ent = torch.repeat_interleave(
        torch.arange(Lt_all, device=dev), counts)
    w_of_lvl = torch.repeat_interleave(
        torch.arange(B, device=dev), torch.as_tensor(Lts, device=dev))
    base = torch.as_tensor(win[:, 0], device=dev)
    loc_of_lvl = torch.arange(Lt_all, device=dev) - base[w_of_lvl]
    w_e = w_of_lvl[g_of_ent]
    flat = (((loc_of_lvl[g_of_ent] * B + w_e) * 6
             + batch.ent_b.long()) * E + batch.ent_slot.long())
    shape = (L, B, 6, E)
    meta = torch.ones(L * B, dtype=torch.int32, device=dev)  # pad bit set
    meta[loc_of_lvl * B + w_of_lvl] = batch.meta
    return _Slabs(B, L, E, Vb, win, flat,
                  _scatter(flat, batch.ent_A, 0, shape),
                  _scatter(flat, batch.ent_M, 0, shape), meta.view(L, B))


def level_chain_plain(batch: ScanBatch, rt_id: int, cov_coef: int
                      ) -> torch.Tensor:
    """The chain half in plain PyTorch ops, on any device: int32
    [inter_rows(rt_id), Et] (sc, n_best, n_last for ONT) in entry-stream
    order.

    A Python loop over levels carries (prev [B, 6, E], ring [B, Vb*6, E])
    exactly as device_dp._dp_level does, vectorised over the B windows
    (windows past their last level are padding and leave the carry
    alone)."""
    dev = batch.meta.device
    rows = inter_rows(rt_id)
    if len(batch.win_host) == 0 or batch.meta.numel() == 0:
        return torch.zeros((rows, batch.ent_A.numel()), dtype=torch.int32,
                           device=dev)
    s = _slabs(batch)
    B, L, E, Vb = s.B, s.L, s.E, s.Vb
    i32 = torch.int32
    A, M, meta = s.A, s.M, s.meta
    link = A >> 16
    flags = A & 0xFF
    valid = (flags & F_VALID) != 0
    is_head = (flags & F_HEAD) != 0
    cov = meta >> 8
    w = 10 * link - cov_coef * cov[:, :, None, None]
    # gather index into the carry [ring rows 0..Vb*6-1 | prev rows] of the
    # widest window: same-position indices (>= the window's own Vb*6) move
    # past the ring
    pp = (A >> 8) & 0xFF
    vb6 = torch.as_tensor(s.win[:, 3] * 6, device=dev).view(1, B, 1, 1)
    pp = torch.where(pp >= vb6, pp - vb6 + Vb * 6, pp).long()
    vslot = ((meta >> 2) & 0x3F) - 1
    is_d0 = ((meta >> 1) & 1) != 0
    is_pad = (meta & 1) != 0
    slot_ids = torch.arange(E, dtype=i32, device=dev)
    # last set match bit per entry (0 when none: JAX reads slot 0)
    last = torch.zeros((L, B, 6, E), dtype=torch.long, device=dev)
    for n in range(E):
        last = torch.where(((M >> n) & 1) != 0, n, last)
    # what a level does to the carry rows [Vb ring slots | prev]: its
    # scores go to its own ring slot and to prev; a d0 level resets the
    # rest of the ring to NEG; pad levels leave everything untouched
    rws = torch.arange(Vb + 1, device=dev)
    live = ~is_pad[:, :, None]
    take = live & (((rws == vslot[:, :, None]) & (rws < Vb))
                   | (rws == Vb))
    clear = live & is_d0[:, :, None] & (rws < Vb)
    # a score without a usable match: w at a head, 0, or NEG when invalid
    scored = valid & ~is_head
    sc_else = torch.where(valid, torch.where(is_head, w, 0), NEG).to(i32)

    carry = torch.full((B, Vb + 1, 6, E), NEG, dtype=i32, device=dev)
    sc_h = torch.empty((L, B, 6, E), dtype=i32, device=dev)
    nb_h = torch.empty((L, B, 6, E), dtype=i32, device=dev)
    nl_h = torch.empty((L, B, 6, E), dtype=i32, device=dev)
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    chunk = 4096  # levels whose match bits are unpacked at once
    for c0 in range(0, L, chunk):
        mbits = ((M[c0:c0 + chunk, ..., None] >> slot_ids) & 1) != 0
        for lv in range(c0, min(c0 + chunk, L)):
            idx = pp[lv].view(B, 6 * E, 1).expand(B, 6 * E, E)
            pred = carry.view(B, (Vb + 1) * 6, E).gather(1, idx).view(
                B, 6, E, E)
            n_best = torch.amax(torch.where(mbits[lv - c0], pred, neg),
                                dim=-1, out=nb_h[lv])
            if rt_id == 0:  # only the ONT rules read n_last
                nl_h[lv] = pred.gather(-1, last[lv][..., None])[..., 0]
            sc = torch.where(scored[lv] & (n_best > NEG // 2),
                             (n_best + w[lv]).clamp_min_(0), sc_else[lv],
                             out=sc_h[lv])
            carry = torch.where(
                take[lv][:, :, None, None], sc[:, None],
                torch.where(clear[lv][:, :, None, None], neg, carry))
    out = [sc_h, nb_h, nl_h][:rows]
    return torch.stack([h.view(-1)[s.flat] for h in out])


def level_winners_plain(batch: ScanBatch, inter: torch.Tensor, rt_id: int):
    """The winners half in plain PyTorch ops, on any device, over all
    levels at once: the read-type rules still walk the E slots in
    insertion order.  An empty slot scores NEG (with link 0)."""
    if batch.ent_A.numel() and int(batch.ent_A.min()) < 0:
        raise ValueError("negative link in ent_A: C's division of the ONT "
                         "rules would differ from floor division")
    dev = batch.meta.device
    Lt_all = batch.meta.numel()
    best_out = torch.zeros((Lt_all, 6), dtype=torch.int8, device=dev)
    sc_out = torch.zeros((batch.n_sc_rows, 6), dtype=torch.int32,
                         device=dev)
    if len(batch.win_host) == 0 or Lt_all == 0:
        return best_out, sc_out
    s = _slabs(batch)
    B, L, E = s.B, s.L, s.E
    i32 = torch.int32
    sc_h = s.scatter(inter[0], NEG)
    nb_h = s.scatter(inter[1], NEG)
    nl_h = s.scatter(inter[2], 0) if rt_id == 0 else None
    link = s.A >> 16
    flags = s.A & 0xFF
    valid = (flags & F_VALID) != 0
    is_head = (flags & F_HEAD) != 0
    cond1a = (flags & F_COND1A) != 0
    cond2b = (flags & F_COND2B) != 0
    ppb_ng = (flags & F_PPB_NOT_GAP) != 0
    hm_all = valid & ~is_head & (nb_h > NEG // 2)
    bm = torch.zeros((L, B, 6), dtype=i32, device=dev)
    sc_bm = sc_h[..., 0].clone()
    link_bm = link[..., 0].clone()
    p_pp = torch.full((L, B, 6), NEGINIT, dtype=i32, device=dev)
    raiser = torch.full((L, B, 6), NEGINIT, dtype=i32, device=dev)
    if rt_id == 0:  # ont: tmp = max link over valid entries
        tmp = torch.where(valid, link, 0).amax(dim=-1)
        cov3 = (s.meta >> 8)[:, :, None]
    for e in range(E):
        v = valid[..., e]
        hm = hm_all[..., e]
        sc_e = sc_h[..., e]
        nb_e = nb_h[..., e]
        ln_e = link[..., e]
        ng_e = ppb_ng[..., e]
        raiser = torch.where(v & (sc_e > 0), nb_e, raiser)
        if rt_id in (1, 3):  # clr / hifi
            upd = hm & ((nb_e > p_pp) | ((nb_e == p_pp) & ng_e))
            bm = torch.where(upd, e, bm)
            sc_bm = torch.where(upd, sc_e, sc_bm)
            link_bm = torch.where(upd, ln_e, link_bm)
            p_pp = torch.where(upd, nb_e, p_pp)
        elif rt_id == 0:  # ont
            c1 = hm & cond1a[..., e] & (
                (5 * ln_e > cov3) | (ln_e > torch.div(
                    tmp, 2, rounding_mode="floor")))
            c2 = ~c1 & hm & (ln_e > torch.div(link_bm, 2,
                                              rounding_mode="floor")) \
                & (nb_e > p_pp) & cond2b[..., e]
            upd = c1 | c2
            bm = torch.where(upd, e, bm)
            sc_bm = torch.where(upd, sc_e, sc_bm)
            link_bm = torch.where(upd, ln_e, link_bm)
            p_pp = torch.where(c1, nl_h[..., e],
                               torch.where(c2, nb_e, p_pp))
        # common final rule
        if rt_id == 2:  # rs
            upd = v & (sc_e >= sc_bm)
        else:
            upd = v & ((sc_e > sc_bm) | ((sc_e == sc_bm) & ng_e))
        bm = torch.where(upd, e, bm)
        sc_bm = torch.where(upd, sc_e, sc_bm)
        link_bm = torch.where(upd, ln_e, link_bm)
        p_pp = torch.where(upd, raiser, p_pp)

    for b in range(B):
        lb, n, sc_from, sc_base = (int(s.win[b, 0]), int(s.win[b, 1]),
                                   int(s.win[b, 4]), int(s.win[b, 5]))
        best_out[lb:lb + n] = bm[:n, b].to(torch.int8)
        sc_out[sc_base:sc_base + n - sc_from] = sc_bm[sc_from:n, b]
    return best_out, sc_out


def level_scan_plain(batch: ScanBatch, rt_id: int, cov_coef: int):
    """The same scan as the kernels in plain PyTorch ops, on any device:
    the chain half, then the winners half."""
    return level_winners_plain(
        batch, level_chain_plain(batch, rt_id, cov_coef), rt_id)
