"""Engine-2 level scan: the wrapper of the hand-written CUDA kernel
(csrc/level_scan.cu) and its plain PyTorch version.

Port of nextpolish_tpu/models/cns/pallas_scan.py (the TPU kernel
`_kernel` and its launch glue `get_level_scan`); the plain version follows
the lax.scan twin, nextpolish_tpu/models/cns/device_dp.py::_dp_level.

Launch form (ScanBatch), built by device_dp.pack_batch from B windows:
  ent_A    int32 [Et]  (link << 16) | (pp_idx << 8) | flags, level-major
  ent_M    int32 [Et]  match bits (bit n: pred slot n matches our ppp)
  ent_b    int8  [Et]  base cell 0..5
  ent_slot int8  [Et]  entry slot 0..E-1 (insertion order)
  lvl_off  int32 [Lt+1] first entry of every level (all windows, in order)
  meta     int32 [Lt]  (cov << 8) | ((vslot + 1) << 2) | (is_d0 << 1)
  win      int32 [B, 8] (lvl_base, n_levels, E, Vb, sc_from, sc_base, 0, 0)
Each window keeps its own E and Vb, so pp_idx needs no re-basing: an index
at or past Vb*6 names the previous level, any other a ring row.  Slot and
cell are separate fields, so every E <= MAX_E runs (the TPU's 20-slot cap
came from packing both into one 7-bit byte).

Outputs: best int8 [Lt, 6] (winning slot per level and cell) and sc int32
[n_sc_rows, 6], the winners' scores of each window's levels from sc_from
on (row sc_base + l - sc_from of the window's level l).

`level_scan` runs the kernel on CUDA tensors and the plain version on CPU
tensors, nothing else: on a card the kernel runs or the call raises.
Both refuse a negative link (a device-side assert on the card).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

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

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_PKG, "csrc", "level_scan.cu")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the level-scan kernel is built from "
                       f"{_SRC} at first use")


def build() -> dict:
    """Compile csrc/level_scan.cu for sm_90a into _build/ (once per source
    content, under a file lock).  Returns {"path", "seconds", "ptxas"}:
    seconds is 0.0 when an earlier build of the same source was reused."""
    src = open(_SRC, "rb").read()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(_BUILD, f"liblevel_scan.{digest[:12]}.so")
    log = so + ".log"
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "level_scan.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        seconds = 0.0
        if not os.path.exists(so):
            t0 = time.perf_counter()
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", so + ".tmp",
                                _SRC], capture_output=True, text=True,
                               timeout=600)
            seconds = time.perf_counter() - t0
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                                   f"{r.stdout}\n{r.stderr}")
            with open(log, "w") as fh:
                fh.write(r.stdout + r.stderr)
            os.replace(so + ".tmp", so)
    ptxas = open(log).read() if os.path.exists(log) else ""
    return dict(path=so, seconds=seconds, ptxas=ptxas)


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.npt_level_scan.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p, p]
        lib.npt_level_scan.restype = ctypes.c_int
        lib.npt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.npt_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

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


def level_scan(batch: ScanBatch, rt_id: int, cov_coef: int):
    """Scan every window of `batch`; returns (best int8 [Lt, 6],
    sc int32 [n_sc_rows, 6]) on the batch's device.  CUDA tensors go to
    the kernel (which runs or raises), CPU tensors to level_scan_plain.
    `level_scan.launches` counts kernel launches."""
    devs = {t.device for t in batch.tensors()}
    if len(devs) != 1:
        raise ValueError(f"batch tensors span devices {devs}")
    (dev,) = devs
    if dev.type == "cpu":
        return level_scan_plain(batch, rt_id, cov_coef)
    if dev.type != "cuda":
        raise ValueError(f"level_scan runs on cuda or cpu, not {dev}")
    _check(batch, dev)
    if rt_id not in (0, 1, 2, 3):
        raise ValueError(f"rt_id {rt_id}")
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
    with torch.cuda.device(dev):
        rc = lib.npt_level_scan(
            *(t.data_ptr() for t in batch.tensors()), B, rt_id, cov_coef,
            best.data_ptr(), sc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("level_scan kernel launch failed: "
                           + lib.npt_cuda_error_string(rc).decode())
    with _COUNT_LOCK:  # launches come from several producer threads
        level_scan.launches += 1
    return best, sc


level_scan.launches = 0
_COUNT_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def level_scan_plain(batch: ScanBatch, rt_id: int, cov_coef: int):
    """The same scan as the kernel in plain PyTorch ops, on any device.

    A Python loop over levels carries (prev [B, 6, E], ring [B, Vb*6, E])
    exactly as device_dp._dp_level does, vectorised over the B windows
    (windows past their last level are padding and leave the carry
    alone).  The winning-entry rules read nothing of the carry, so they run
    once after the loop over all levels at once; they still walk the E
    slots in insertion order."""
    if batch.ent_A.numel() and int(batch.ent_A.min()) < 0:
        raise ValueError("negative link in ent_A: C's division of the ONT "
                         "rules would differ from floor division")
    dev = batch.meta.device
    win = batch.win_host.astype(np.int64)
    B = len(win)
    Lt_all = batch.meta.numel()
    best_out = torch.zeros((Lt_all, 6), dtype=torch.int8, device=dev)
    sc_out = torch.zeros((batch.n_sc_rows, 6), dtype=torch.int32,
                         device=dev)
    if B == 0 or Lt_all == 0:
        return best_out, sc_out
    Lts = win[:, 1]
    E = int(win[:, 2].max())
    Vb = int(win[:, 3].max())
    L = int(Lts.max())
    i32 = torch.int32

    # ---- dense level-major slabs [L, B, 6, E] -------------------------
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
    A = torch.zeros(L * B * 6 * E, dtype=i32, device=dev)
    M = torch.zeros(L * B * 6 * E, dtype=i32, device=dev)
    A[flat] = batch.ent_A
    M[flat] = batch.ent_M
    A = A.view(L, B, 6, E)
    M = M.view(L, B, 6, E)
    meta = torch.ones(L * B, dtype=i32, device=dev)  # pad bit set
    meta[loc_of_lvl * B + w_of_lvl] = batch.meta
    meta = meta.view(L, B)

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
    vb6 = torch.as_tensor(win[:, 3] * 6, device=dev).view(1, B, 1, 1)
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
    rows = torch.arange(Vb + 1, device=dev)
    live = ~is_pad[:, :, None]
    take = live & (((rows == vslot[:, :, None]) & (rows < Vb))
                   | (rows == Vb))
    clear = live & is_d0[:, :, None] & (rows < Vb)
    # a score without a usable match: w at a head, 0, or NEG when invalid
    scored = valid & ~is_head
    sc_else = torch.where(valid, torch.where(is_head, w, 0), NEG).to(i32)

    # ---- sequential scan over levels -----------------------------------
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

    # ---- winning-entry selection, all levels at once --------------------
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
        cov3 = cov[:, :, None]
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
        lb, n, sc_from, sc_base = (int(win[b, 0]), int(win[b, 1]),
                                   int(win[b, 4]), int(win[b, 5]))
        best_out[lb:lb + n] = bm[:n, b].to(torch.int8)
        sc_out[sc_base:sc_base + n - sc_from] = sc_bm[sc_from:n, b]
    return best_out, sc_out
