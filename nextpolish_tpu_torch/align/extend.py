"""Batched banded affine-gap alignment: port of nextpolish_tpu/align/
extend.py (the extension stage of the built-in mappers).

Per read, one scan over the query rows with the band's B cells as a
vector; the within-row deletion recurrence is resolved exactly by a
cumulative max,

    F[c] = -(gapo+gape) - c*gape + cummax_{c'<c}(H'[c'] + c'*gape),

and every cell emits a traceback byte.  Cell (i, c) aligns read base i to
ref base j = i + c - off (off = 0 in local and extend modes, B//2 in
global mode); the ref window holds R + B bases.

Two device programs, each a hand-written CUDA kernel in
csrc/band_align.cu beside a plain PyTorch version here:
  band_align_core  the DP (extend.py::_band_align_core): tb [Bt, R, B]
                   uint8, the best score and its end cell per read;
                   kernel `band_align`, plain band_align_plain;
  band_traceback   the H/E/F state machine that walks tb back from the end
                   cell (extend.py::_traceback_device): 2-bit op+1 codes
                   packed 4 per byte, [Bt, S/4] uint8, and the final cell;
                   kernel `band_traceback`, plain band_traceback_plain.
Each runs its kernel on CUDA tensors and its plain version on CPU tensors,
nothing else: on a card the kernel runs or the call raises.
`band_align_core.launches` / `band_traceback.launches` count kernel
launches.  Both are int32/uint8 programs, so every output is byte-equal to
the JAX package's.

The numpy API is the JAX package's (band_align, band_align_ops,
traceback_batch, runs_to_cigar) plus a `device` argument.  Two
differences: the batch is not padded to a power of two (that only bounded
jit's shape set), and a batch whose traceback tensor would not fit the
device's free memory runs as sub-batches (reads are independent, so the
bytes do not change).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..runtime import nvcc

NEG = -(10 ** 7)

# traceback encoding: low 2 bits = H source, bit2 = E open, bit3 = F open
H_START, H_DIAG, H_E, H_F = 0, 1, 2, 3

# CIGAR op codes (BAM)
_M, _I, _D, _S = 0, 1, 2, 4

MODES = ("local", "global", "extend")

# bytes of traceback tensor one sub-batch may hold; None = a quarter of the
# device's free memory (torch.cuda.mem_get_info) or of the host's available
# memory for the CPU.  Tests lower it to force a split.
TB_BUDGET_BYTES = None


def steps_for(R: int, B: int) -> int:
    """Traceback steps S: 2R + B + 4 rounded up to a multiple of 4 (the
    packed ops hold S/4 bytes a read)."""
    return -(-(2 * R + B + 4) // 4) * 4


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels
# ---------------------------------------------------------------------------

def band_align_plain(q, t, qlen, tlen, match=1, mismatch=4, gapo=6, gape=1,
                     mode="local", clip5=0, clip3=0):
    """extend.py::_band_align_core, row for row: q [Bt, R] uint8 codes
    (4 = pad), t [Bt, R+B] uint8, qlen / tlen [Bt] int32 -> (tb [Bt, R, B]
    uint8, best int32, end row int32, end col int32), on q's device.

    local: Smith-Waterman, the best cell anywhere ends the alignment.
    global: Needleman-Wunsch of q[0:qlen) against the segment laid out as
    t[x] = ref[x - B//2]; the end cell is forced to (qlen-1,
    tlen - qlen + B//2).  extend: the path is pinned at the window corner
    (gap penalties decay from the clip5 pin), the end is free.  clip5 /
    clip3 are bwa mem's soft-clip penalties (local and extend modes): a
    +clip5 bonus for paths anchored at the query start, and the query end
    is preferred whenever its best cell is within clip3 of the best."""
    dev = q.device
    i32 = torch.int32
    Bt, R = q.shape
    B = t.shape[1] - R
    cidx = torch.arange(B, dtype=i32, device=dev)
    extend = mode == "extend"
    local = mode == "local" or extend
    off = 0 if local else B // 2
    qq = q.to(i32)
    tt = t.to(i32)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    neg1 = torch.full((Bt, 1), NEG, dtype=i32, device=dev)
    c_gape = cidx * gape
    if extend:
        H = torch.where(cidx == 0, clip5, clip5 - (gapo + c_gape))
    elif local:
        H = torch.full((B,), clip5, dtype=i32, device=dev)
    else:
        H = torch.where(cidx == off, 0,
                        torch.where(cidx > off, -(gapo + (cidx - off) * gape),
                                    NEG))
    H = H.to(i32).expand(Bt, B).contiguous()
    E = torch.full((Bt, B), NEG, dtype=i32, device=dev)
    Hfin = torch.full((Bt, B), NEG, dtype=i32, device=dev)
    tb = torch.empty((Bt, R, B), dtype=torch.uint8, device=dev)
    best_rows = torch.empty((R, Bt), dtype=i32, device=dev)
    argc_rows = torch.empty((R, Bt), dtype=torch.int64, device=dev)
    match_t = torch.tensor(match, dtype=i32, device=dev)
    mis_t = torch.tensor(-mismatch, dtype=i32, device=dev)
    neg_t = torch.tensor(NEG, dtype=i32, device=dev)
    for i in range(R):
        qi = qq[:, i:i + 1]
        tj = tt[:, i:i + B]
        valid_q = (qi < 4) & (i < qlen[:, None])
        j = (i + cidx - off)[None, :]
        valid_t = (tj < 4) & (j < tlen[:, None]) & (j >= 0)
        sub = torch.where(qi == tj, match_t, mis_t)
        sub = torch.where(valid_q & valid_t, sub, neg_t)
        Hup = torch.cat([H[:, 1:], neg1], dim=1)
        Eup = torch.cat([E[:, 1:], neg1], dim=1)
        e_open = Hup - gapo >= Eup
        E = torch.maximum(Hup - gapo, Eup) - gape
        diag = H + sub
        Hp = torch.maximum(diag, E)
        if local:
            Hp = Hp.clamp_min(0)
        decay = Hp + c_gape
        cm = torch.cummax(decay, dim=1).values
        cm_shift = torch.cat([neg1, cm[:, :-1]], dim=1)
        F = cm_shift - (gapo + gape) - c_gape
        f_open = torch.cat([neg1, decay[:, :-1]], dim=1) >= cm_shift
        H = torch.maximum(Hp, F)
        if local:
            src = torch.where(H == 0, H_START,
                              torch.where(H == F, H_F,
                                          torch.where(H == diag, H_DIAG,
                                                      H_E)))
            src = torch.where((H == diag) & (H > 0), H_DIAG, src)
        else:
            src = torch.where(H == F, H_F,
                              torch.where(H == diag, H_DIAG, H_E))
            src = torch.where(H == diag, H_DIAG, src)
        tb[:, i] = (src.to(torch.uint8) | (e_open.to(torch.uint8) << 2)
                    | (f_open.to(torch.uint8) << 3))
        if local:
            best_rows[i], argc_rows[i] = H.max(dim=1)
        Hfin = torch.where((qlen == i + 1)[:, None], H, Hfin)
    if local:
        # torch.max / argmax return the first maximum, as jnp.argmax
        best_i = torch.argmax(best_rows, dim=0)
        best = best_rows.gather(0, best_i[None])[0]
        best_c = argc_rows.gather(0, best_i[None])[0]
        if clip3:
            g_best, g_c = Hfin.max(dim=1)
            use_g = (g_best > 0) & (g_best + clip3 >= best)
            best = torch.where(use_g, g_best, best)
            best_i = torch.where(use_g, (qlen - 1).long(), best_i)
            best_c = torch.where(use_g, g_c, best_c)
        best_i, best_c = best_i.to(i32), best_c.to(i32)
    else:
        best_i = qlen - 1
        best_c = tlen - qlen + off
        # jnp.take_along_axis: negative indices wrap once, anything still
        # out of range reads the int32 minimum
        idx = torch.where(best_c < 0, best_c + B, best_c)
        inr = (idx >= 0) & (idx < B)
        best = Hfin.gather(1, idx.clamp(0, B - 1).long()[:, None])[:, 0]
        best = torch.where(inr, best, torch.iinfo(i32).min)
    return tb, best.to(i32), best_i, best_c


def band_traceback_plain(tb, end_i, end_c):
    """extend.py::_traceback_device: tb [Bt, R, B] uint8, end_i / end_c
    [Bt] int32 -> (ops [Bt, S/4] uint8, op+1 codes of 2 bits packed 4 per
    byte little-endian, step 0 first; final i, final c int32).  A read
    stops at START or at i < 0; one whose cell leaves the band emits
    zeros and keeps its cell, as the batched while_loop leaves it."""
    dev = tb.device
    Bt, R, B = tb.shape
    S = steps_for(R, B)
    i = end_i.to(torch.int64).clone()
    c = end_c.to(torch.int64).clone()
    state = torch.zeros(Bt, dtype=torch.int64, device=dev)
    done = torch.zeros(Bt, dtype=torch.bool, device=dev)
    ops = torch.zeros((Bt, S), dtype=torch.uint8, device=dev)
    rows = torch.arange(Bt, device=dev)
    flat = tb.reshape(-1)
    for step in range(S):
        done |= i < 0
        inb = (~done) & (c >= 0) & (c < B)
        if not bool(inb.any()):
            # nothing moves any more: every later step emits zeros
            break
        cell = torch.where(
            inb, flat[(rows * R + i.clamp(0, R - 1)) * B
                      + c.clamp(0, B - 1)].to(torch.int64), 0)
        hsrc = cell & 3
        mH = inb & (state == 0)
        start = mH & (hsrc == H_START)
        diag = mH & (hsrc == H_DIAG)
        toE = mH & (hsrc == H_E)
        toF = mH & (hsrc == H_F)
        mE = inb & (state == 1)
        mF = inb & (state == 2)
        ops[:, step] = torch.where(
            diag, _M + 1, torch.where(mE, _I + 1,
                                      torch.where(mF, _D + 1, 0)))
        i = i - diag.long() - mE.long()
        c = c + mE.long() - mF.long()
        state = torch.where(toE, 1, torch.where(toF, 2, state))
        state = torch.where(mE & (((cell >> 2) & 1) == 1), 0, state)
        state = torch.where(mF & (((cell >> 3) & 1) == 1), 0, state)
        done |= start
    packed = (ops[:, 0::4] | (ops[:, 1::4] << 2) | (ops[:, 2::4] << 4)
              | (ops[:, 3::4] << 6))
    return packed, i.to(torch.int32), c.to(torch.int32)


# ---------------------------------------------------------------------------
# the kernels: build + bind (csrc/band_align.cu -> ctypes)
# ---------------------------------------------------------------------------

_SRC = os.path.join(nvcc.CSRC_DIR, "band_align.cu")
_LIB = None
_COUNT_LOCK = threading.Lock()


def build() -> dict:
    """Compile csrc/band_align.cu for sm_90a into _build/ (see
    runtime/nvcc.py).  Returns {"path", "seconds", "ptxas"}."""
    return nvcc.build(_SRC, "band_align")


def bind(path: str):
    """Load a build of csrc/band_align.cu (any version with its C
    interface) and declare its entry points."""
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.npt_band_align.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                   i, i, p, p, p, p, p]
    lib.npt_band_align.restype = i
    lib.npt_band_traceback.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
    lib.npt_band_traceback.restype = i
    lib.npt_band_error_string.argtypes = [i]
    lib.npt_band_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "npt_band_step_cycles"):
        lib.npt_band_step_cycles.argtypes = [i, p, p]
        lib.npt_band_step_cycles.restype = i
    return lib


def _load():
    global _LIB
    if _LIB is None:
        _LIB = bind(build()["path"])
    return _LIB


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.npt_band_error_string(rc).decode())


def _check(name, x, dtype, shape, device):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} on {x.device};"
                         f" want contiguous {dtype} {shape} on {device}")


def band_align_core(q, t, qlen, tlen, match=1, mismatch=4, gapo=6, gape=1,
                    mode="local", clip5=0, clip3=0):
    """The banded DP on q's device (see band_align_plain for the
    arguments and outputs).  CUDA tensors go to the `band_align` kernel,
    which runs or raises; CPU tensors to band_align_plain."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    dev = q.device
    if all(x.device.type == "cpu" for x in (q, t, qlen, tlen)):
        return band_align_plain(q, t, qlen, tlen, match, mismatch, gapo,
                                gape, mode, clip5, clip3)
    if dev.type != "cuda":
        raise ValueError(f"q on {dev}: want cuda or cpu tensors")
    Bt, R = q.shape
    B = t.shape[1] - R
    if B < 1 or B > 2048:
        raise ValueError(f"band {B} outside the kernel's 1..2048")
    _check("q", q, torch.uint8, (Bt, R), dev)
    _check("t", t, torch.uint8, (Bt, R + B), dev)
    _check("qlen", qlen, torch.int32, (Bt,), dev)
    _check("tlen", tlen, torch.int32, (Bt,), dev)
    tb = torch.empty((Bt, R, B), dtype=torch.uint8, device=dev)
    best = torch.empty(Bt, dtype=torch.int32, device=dev)
    best_i = torch.empty(Bt, dtype=torch.int32, device=dev)
    best_c = torch.empty(Bt, dtype=torch.int32, device=dev)
    if Bt == 0 or R == 0:
        return tb, best, best_i, best_c
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.npt_band_align(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            Bt, R, B, MODES.index(mode), match, mismatch, gapo, gape, clip5,
            clip3, tb.data_ptr(), best.data_ptr(), best_i.data_ptr(),
            best_c.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "band_align kernel")
    with _COUNT_LOCK:
        band_align_core.launches += 1
    return tb, best, best_i, best_c


def band_traceback(tb, end_i, end_c):
    """The traceback walk on tb's device (see band_traceback_plain).
    CUDA tensors go to the `band_traceback` kernel, which runs or raises;
    CPU tensors to band_traceback_plain."""
    dev = tb.device
    if all(x.device.type == "cpu" for x in (tb, end_i, end_c)):
        return band_traceback_plain(tb, end_i, end_c)
    if dev.type != "cuda":
        raise ValueError(f"tb on {dev}: want cuda or cpu tensors")
    Bt, R, B = tb.shape
    _check("tb", tb, torch.uint8, (Bt, R, B), dev)
    _check("end_i", end_i, torch.int32, (Bt,), dev)
    _check("end_c", end_c, torch.int32, (Bt,), dev)
    S = steps_for(R, B)
    ops = torch.zeros((Bt, S // 4), dtype=torch.uint8, device=dev)
    fin_i = torch.empty(Bt, dtype=torch.int32, device=dev)
    fin_c = torch.empty(Bt, dtype=torch.int32, device=dev)
    if Bt == 0:
        return ops, fin_i, fin_c
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.npt_band_traceback(
            tb.data_ptr(), end_i.data_ptr(), end_c.data_ptr(), Bt, R, B, S,
            ops.data_ptr(), fin_i.data_ptr(), fin_c.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "band_traceback kernel")
    with _COUNT_LOCK:
        band_traceback.launches += 1
    return ops, fin_i, fin_c


band_align_core.launches = 0
band_traceback.launches = 0


def step_cycles(device, steps: int = 1 << 16) -> tuple[int, int]:
    """SM cycles of one shuffle-scan round (a __shfl_up_sync and a max)
    and of one traceback step (a dependent shared-memory byte load that
    picks the next address), measured on the card by a one-warp probe:
    the floors of band_align's row step and band_traceback's walk step.
    A measurement, not part of the alignment."""
    dev = torch.device(device)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.npt_band_step_cycles(
            steps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "band_step_probe")
    return int(out[0]), int(out[1])


# ---------------------------------------------------------------------------
# numpy API (the JAX package's, plus `device`)
# ---------------------------------------------------------------------------

def _sub_batches(n: int, R: int, B: int, dev: torch.device):
    """Row ranges whose traceback tensors fit the memory budget."""
    budget = TB_BUDGET_BYTES
    if budget is None:
        if dev.type == "cuda":
            budget = torch.cuda.mem_get_info(dev)[0] // 4
        else:
            from ..runtime.budget import host_available_bytes

            budget = host_available_bytes() // 4
    per = max(1, budget // max(R * B, 1))
    return [(lo, min(lo + per, n)) for lo in range(0, max(n, 1), per)]


def _to_dev(q_codes, t_codes, qlen, tlen, dev):
    return (torch.from_numpy(np.ascontiguousarray(q_codes, np.uint8)).to(dev),
            torch.from_numpy(np.ascontiguousarray(t_codes, np.uint8)).to(dev),
            torch.from_numpy(np.ascontiguousarray(qlen, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(tlen, np.int32)).to(dev))


def band_align_ops(q_codes: np.ndarray, t_codes: np.ndarray, qlen: np.ndarray,
                   tlen: np.ndarray, match=1, mismatch=4, gapo=6, gape=1,
                   mode="local", clip5=0, clip3=0, device=None):
    """Fused align + traceback: numpy in, numpy out, with the traceback run
    on the device so only the op stream (not the [Bt, R, B] tensor) comes
    back.

    Returns (ops [Bt, S] of op+1 codes end->start, score, i_lo, j_lo,
    i_hi, j_hi, lead_del) — the union of band_align + traceback_batch."""
    dev = resolve_device(device)
    n, R = q_codes.shape
    B = t_codes.shape[1] - R
    off = B // 2 if mode == "global" else 0
    parts = []
    for lo, hi in _sub_batches(n, R, B, dev):
        q, t, ql, tl = _to_dev(q_codes[lo:hi], t_codes[lo:hi], qlen[lo:hi],
                               tlen[lo:hi], dev)
        tb, best, best_i, best_c = band_align_core(
            q, t, ql, tl, match=match, mismatch=mismatch, gapo=gapo,
            gape=gape, mode=mode, clip5=clip5, clip3=clip3)
        packed, fin_i, fin_c = band_traceback(tb, best_i, best_c)
        del tb
        parts.append([x.cpu().numpy() for x in (packed, best, best_i,
                                                  best_c, fin_i, fin_c)])
    packed, sc, ei, ec, fi, fc = (np.concatenate(p) for p in zip(*parts))
    ops = ((packed[:, :, None] >> (2 * np.arange(4, dtype=np.uint8))) & 3
           ).astype(np.int8).reshape(n, 4 * packed.shape[1])
    ei = ei.astype(np.int64)
    ec = ec.astype(np.int64)
    fi = fi.astype(np.int64)
    fc = fc.astype(np.int64)
    i_hi = ei
    j_hi = ei + ec - off
    i_lo = fi + 1
    j_lo = fi + fc + 1 - off
    if mode == "global":
        lead_del = np.where((fi < 0) & (fc - off > 0), fc - off, 0)
        j_lo = j_lo - lead_del
    else:
        lead_del = np.zeros(n, dtype=np.int64)
    if mode in ("local", "extend") and clip5:
        # the +clip5 start-anchor bonus is not part of the real score
        sc = sc - np.where(i_lo == 0, clip5, 0)
    return ops, sc, i_lo, j_lo, i_hi, j_hi, lead_del


def band_align(q_codes: np.ndarray, t_codes: np.ndarray, qlen: np.ndarray,
               tlen: np.ndarray, match=1, mismatch=4, gapo=6, gape=1,
               mode="local", device=None):
    """Host wrapper; returns numpy (tb, score, end_i, end_c)."""
    dev = resolve_device(device)
    n, R = q_codes.shape
    B = t_codes.shape[1] - R
    parts = []
    for lo, hi in _sub_batches(n, R, B, dev):
        out = band_align_core(
            *_to_dev(q_codes[lo:hi], t_codes[lo:hi], qlen[lo:hi],
                     tlen[lo:hi], dev),
            match=match, mismatch=mismatch, gapo=gapo, gape=gape, mode=mode)
        parts.append([x.cpu().numpy() for x in out])
    return tuple(np.concatenate(p) for p in zip(*parts))


def traceback_batch(tb: np.ndarray, end_i: np.ndarray, end_c: np.ndarray,
                    qlen: np.ndarray, mode: str = "local"):
    """Vectorized host traceback over the whole batch.

    Returns (ops matrix [Bt, steps] of per-step op+1 codes, read_start,
    ref_start j_lo, read_end i_hi (inclusive), ref_end j_hi, lead_del).
    In global mode ref index j = i + c - B//2 and lead_del counts leading
    deletions implied by finishing left of the virtual origin."""
    Bt, R, B = tb.shape
    off = B // 2 if mode == "global" else 0
    i = end_i.astype(np.int64).copy()
    c = end_c.astype(np.int64).copy()
    state = np.zeros(Bt, dtype=np.int8)  # 0=H, 1=E, 2=F
    done = np.zeros(Bt, dtype=bool)
    max_steps = 2 * R + B + 4
    ops = np.full((Bt, max_steps), -1, dtype=np.int8)
    # record end coordinates
    i_hi = end_i.astype(np.int64)
    j_hi = end_i.astype(np.int64) + end_c.astype(np.int64) - off
    step = 0
    while not done.all() and step < max_steps:
        done |= i < 0
        inb = (~done) & (i >= 0) & (c >= 0) & (c < B)
        cell = np.zeros(Bt, dtype=np.uint8)
        cell[inb] = tb[np.nonzero(inb)[0], i[inb], c[inb]]
        hsrc = cell & 3
        act = np.zeros(Bt, dtype=np.int8)  # op emitted this step
        # H state
        mH = inb & (state == 0)
        start = mH & (hsrc == H_START)
        done |= start
        diag = mH & (hsrc == H_DIAG)
        act[diag] = _M + 1  # +1 so 0 = none
        toE = mH & (hsrc == H_E)
        toF = mH & (hsrc == H_F)
        state[toE] = 1
        state[toF] = 2
        # E state: consume read base (I), move to (i-1, c+1)
        mE = inb & (state == 1) & ~mH
        act[mE] = _I + 1
        eopen = (cell >> 2) & 1
        # F state: consume ref base (D), move to (i, c-1)
        mF = inb & (state == 2) & ~mH
        act[mF] = _D + 1
        fopen = (cell >> 3) & 1
        # apply moves
        i[diag] -= 1
        i[mE] -= 1
        c[mE] += 1
        c[mF] -= 1
        state[mE & (eopen == 1)] = 0
        state[mF & (fopen == 1)] = 0
        ops[:, step] = act
        step += 1
    # start coords: after traceback, (i, c) sits one move above the first
    # aligned cell for diag/E (i already decremented) -> read start = i + 1
    i_lo = i + 1
    j_lo = i + c + 1 - off
    if mode == "global":
        lead_del = np.where((i < 0) & (c - off > 0), c - off, 0)
        j_lo = j_lo - lead_del  # leading dels start at ref 0 of the segment
    else:
        lead_del = np.zeros(Bt, dtype=np.int64)
    return ops[:, :step], i_lo, j_lo, i_hi, j_hi, lead_del


def runs_to_cigar(op_row: np.ndarray, i_lo: int, i_hi: int, qlen: int
                  ) -> np.ndarray:
    """Convert one read's reversed op stream to a CIGAR uint32 array with
    soft clips."""
    ops = op_row[op_row > 0] - 1
    ops = ops[::-1]  # traceback emitted end->start
    cig = []
    if i_lo > 0:
        cig.append((int(i_lo) << 4) | _S)
    if ops.size:
        change = np.flatnonzero(np.diff(ops) != 0)
        bounds = np.concatenate([[-1], change, [ops.size - 1]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            cig.append((int(b - a) << 4) | int(ops[a + 1]))
    tail = qlen - 1 - i_hi
    if tail > 0:
        cig.append((int(tail) << 4) | _S)
    return np.array(cig, dtype=np.uint32)
