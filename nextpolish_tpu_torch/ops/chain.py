"""Task 1's chain DP — port of nextpolish_tpu/ops/tropical.py's slot-plane
path (the score chain, lib/contig.c:424-496, as a (max,+) matrix scan).

Host half (copied from tropical.py; see there for the derivation): the
u16 transfer buffer (`pack_chain_planes`, `pack_chain_planes_parts`), its
shape helpers, the coverage LUT, and the f64 oracle `slow_chain`.

Device half, on tensors of an explicit device:
  planes_decode          the buffer -> slot planes (tropical._planes_decode)
  chain_planes_core      emission, the [L, 64] transition lattice, then
                         per-slot scores, winners and the pointer table
                         (tropical._chain_planes_core)
  forward_states         the forward (max,+) scan (tropical._forward_states)
  traceback_batch        the pointer walk back (tropical._traceback_batch)
  chain_correct_planes_batch / chain_correct_planes
                         the whole DP: packed [B, L] int8 result bytes,
                         choice | FLAG_ZERO << 3 | FLAG_COVERAGE << 4

The dense chain over [B, L, 512] pileups (task 2's no-depth rescue and
the window route of models/score_chain.py, through parallel/shard.py):
  emission, build_transition, pointers
                         tropical.emission / build_transition / _pointers
  chain_correct_batch    tropical._chain_core + chain_correct_batch: the
                         choices [B, L] int8, no flag bits
  chain_pointers         the forward half of _chain_core (emission to
                         pointers), which parallel/shard.py shares
  run_chain_batch, dispatch_chain_sparse
                         the host wrappers (dispatch_chain_sparse takes the
                         planes path; the entries path is not ported)

forward_states and traceback_batch are the two hand-written CUDA kernels
of csrc/chain_scan.cu (`chain_forward`, `chain_traceback`).  Each wrapper
runs its kernel on CUDA tensors and its plain PyTorch version on CPU
tensors, nothing else: on a card the kernel runs or the call raises.
`forward_states.launches` / `traceback_batch.launches` count kernel
launches.  The decode, the lattice, the emission and the pointer steps
are PyTorch ops on the device, as the JAX package left them to XLA.

Exactness: every f32 value equals the JAX package's.  Additions are
single roundings and max is order-free, so what fixes the bits is the
association of the (max,+) products; the plain version and the kernel
both follow `_forward_states` (sequential compose within 128-cell chunks
with a renormalisation after every step, lax.associative_scan's tree over
the chunk products, an unrenormalised replay).  The lattice is built by
scatter-max over the <= 8 slots instead of JAX's [B, Emax, L, 64]
one-hot tensor (max is order-free, so the values are the same).  The
emission cn - dec - tot1 * rate rounds as XLA on the CPU rounds it in
the JAX package: once in the planes core (_emit), twice (the product,
then the difference) in the dense chain; at a dyadic rate such as the
sgs 0.5 the product is exact and both agree.

run_chain / run_chain_sparse are the host wrappers of one region on the
planes path (task 3's low-depth rescue, through
models/score_chain.run_chain_region).

Not ported: the entries path (chain_correct_packed*, pack_chain_sparse,
_chain_entries_core, NPT_CHAIN_IMPL=entries), the single dense
chain_correct, init_state_sparse (no caller in the JAX package either)
and start_host_copy.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..runtime import nvcc, trace
from .symbols import K3, S

# a numpy scalar, as in tropical.py
NEG = np.float32(-1e9)
CHUNK = 128
RANK_BIG = np.int32(1 << 20)  # > any real first-observation rank (< 512)

FLAGB_ZERO = 3   # bit of FLAG_ZERO (total == 1) in the packed result byte
FLAGB_COV = 4    # bit of FLAG_COVERAGE (low chosen-base support)

CNT_CAP = 127    # upper-plane count cap (7 bits of the kmer<<7|count word)
C0_CAP = 255     # slot-0 count cap (its own u8 plane)
TOT_MARK = 255   # u8 total-plane clamp marker; true value rides the escape

# totals beyond the LUT clamp to its last entry; per-kmer counts (and thus
# cov) saturate at 0xFFFF well before this anyway
TH_CAP = 1 << 16


# ---------------------------------------------------------------------------
# host half (copied from nextpolish_tpu/ops/tropical.py)
# ---------------------------------------------------------------------------

def pack_chain_planes(uk_in, cn_in, rk_in, refkmer, total, n_dp, rate,
                      cov_ratio: float = 0.8, chunk: int = CHUNK):
    """Host packing for chain_correct_planes from sorted sparse entries
    (the numpy fallback path and generic callers; the task-1 hot path
    gets the same parts straight from the native slot walker and calls
    pack_chain_planes_parts).  See pack_chain_planes_parts for the
    buffer layout and diversion rules."""
    n_dp = max(n_dp, 0)
    hi = int(np.searchsorted(uk_in, n_dp * K3))
    cells = (uk_in[:hi] // K3).astype(np.int64)
    kmers = (uk_in[:hi] % K3).astype(np.int64)
    cnc = np.minimum(cn_in[:hi], 0xFFFF).astype(np.int64)
    rkc = np.asarray(rk_in[:hi], dtype=np.int64)
    refk = np.asarray(refkmer[:n_dp], dtype=np.int64)
    is0 = rkc == 0
    divert = ((~is0 & (cnc > CNT_CAP)) | (is0 & (cnc > C0_CAP))
              | (is0 & (kmers != refk[cells])) | (rkc >= 8))
    upper = np.zeros((7, max(n_dp, 1)), dtype=np.uint16)
    c0 = np.zeros(max(n_dp, 1), dtype=np.uint8)
    keep = ~divert
    k0m = keep & is0
    c0[cells[k0m]] = cnc[k0m]
    kum = keep & ~is0
    upper.reshape(-1)[(rkc[kum] - 1) * max(n_dp, 1) + cells[kum]] = \
        (kmers[kum] << 7) | cnc[kum]
    stats = np.zeros(16, dtype=np.int32)
    if hi:
        hcnt = np.bincount(rkc[keep], minlength=9)[:9]
        stats[:9] = hcnt.astype(np.int32)
        kc0 = kmers[cells == 0]
        if len(kc0):
            stats[9] = int(np.bitwise_or.reduce(1 << ((kc0 >> 3) & 7)))
    ov = (cells[divert] * K3 + kmers[divert], cnc[divert], rkc[divert])
    return pack_chain_planes_parts(upper, c0, total, stats, ov, refkmer,
                                   n_dp, rate, cov_ratio, chunk)


def pack_chain_planes_parts(upper, c0, totals, stats, ov, refkmer, n_dp,
                            rate, cov_ratio: float = 0.8,
                            chunk: int = CHUNK):
    """Assemble the chain_correct_planes transfer buffer, ONE u16 array,
    as tight as exactness allows:

      [sym4(L/4)  — 4-bit draft symbols, 4 per u16 (FMT 0), or
       refk(L)    — full u16 refkmer row (FMT 1, arbitrary refkmer)
      | c0(L/2)   — slot-0 counts as u8 pairs (contig-as-read kmer
                    counts; the kmer itself is the refkmer)
      | p1 dense u16 plane: kmer<<7 | count (rank 1)
      | per rank j in [2, Emax): bitmap(L/16) + packed(P_j) u16 words
        (upper planes are 3-25% occupied — bitmap + packed words cost
        occupancy-proportional wire instead of 2 B/cell; the device
        re-densifies with a cumsum + gather)
      | tot(L/2)  — totals as u8 pairs, 255 = clamp marker
      | tesc(4*ET)— escaped totals: cell u32 + value u32 as lo/hi pairs
      | ovcell_lo, ovcell_hi, ovkmer, ovcn, ovrk (5*EOV) — overflow
                    entries
      | s0mask, rate, n_dp, nov, net (9 u16) | th(2*TH lo/hi pairs)]

    FMT 0 reconstructs refkmer on device from the rolling 3-mer of the
    4-bit symbol stream (rolling_kmers semantics, PAD=0 beyond the left
    edge) — the draft row costs 0.5 bytes/cell instead of 2; the pack
    falls back to FMT 1 when the given refkmer is not a rolling stream
    (synthetic inputs).  Inputs are the walker-shaped parts (the native
    slot walker emits them directly, native.pileup_planes): upper [7,
    n_dp] u16 rank-1..7 planes with caps already applied, c0 [n_dp] u8
    slot-0 counts, stats[0:9] = kept-entry histogram by rank + stats[9]
    = cell-0 prefix mask, ov = cap/mismatch/spill overflow entry arrays
    sorted by key.  A diverted entry's dense slot is empty (unobserved),
    so the slot-index-is-rank invariant holds for whatever stays dense.
    Emax minimizes wire bytes + a 4x overflow-byte penalty (overflow
    also costs host pack and device scatter time) over {2,3,4,6,8};
    planes at rank >= Emax move to the overflow list.  Returns
    (buf, L, Emax, EOV, ET, FMT, TH, PS) with PS = the packed-word
    bucket per sparse plane; EOV == ET == 0 in the common case — the
    launch then contains no scatter at all."""
    L = pad_to_chunk(max(n_dp, 1), chunk)
    refk = np.asarray(refkmer[:n_dp], dtype=np.int64)
    roll_ok = bool(n_dp) and int(refk[0]) == int(refk[0] & 7) and bool(
        np.all(refk[1:] == (((refk[:-1] & 63) << 3) | (refk[1:] & 7))))
    FMT = 0 if roll_ok else 1
    ovk, ovc, ovr = (np.asarray(a, dtype=np.int64) for a in ov)
    hist = np.asarray(stats[:9], dtype=np.int64)
    best = None
    for em in (2, 3, 4, 6, 8):
        nov = int(hist[em:8].sum()) + len(ovk)
        eov = 0 if nov == 0 else _pow2(max(nov, 512))
        cost = (2 * min(em - 1, 1) * L
                + sum(L // 8 + 2 * _pow2(max(int(hist[j]), 64))
                      for j in range(2, em))
                + 4 * 8 * eov)
        if best is None or cost < best[0]:
            best = (cost, em, eov, nov)
    _, Emax, EOV, nov = best
    PS = tuple(_pow2(max(int(hist[j]), 64)) for j in range(2, Emax))
    nd1 = max(n_dp, 1)
    if Emax < 8:
        left = upper[Emax - 1:]
        nz = np.flatnonzero(left)
        if len(nz):
            w = left.reshape(-1)[nz].astype(np.int64)
            lk = (nz % nd1) * K3 + (w >> 7)
            ovk = np.concatenate([ovk, lk])
            ovc = np.concatenate([ovc, w & CNT_CAP])
            ovr = np.concatenate([ovr, nz // nd1 + Emax])
            order = np.argsort(ovk, kind="stable")
            ovk, ovc, ovr = ovk[order], ovc[order], ovr[order]
    assert len(ovk) == nov
    tclamp = np.minimum(totals[:n_dp], 0xFFFF).astype(np.int64)
    esc = np.flatnonzero(tclamp > TOT_MARK)
    net = len(esc)
    ET = 0 if net == 0 else _pow2(max(net, 64))
    maxt = int(tclamp.max()) if n_dp else 1
    TH = _pow2(min(maxt + 1, TH_CAP))
    s0mask = 1 | int(stats[9])
    head = (L // 4) if FMT == 0 else L
    buf = np.zeros(head + L // 2 + min(Emax - 1, 1) * L
                   + sum(L // 16 + pj for pj in PS) + L // 2 + 4 * ET
                   + 5 * EOV + 9 + 2 * TH, dtype=np.uint16)
    if FMT == 0:
        sym = np.zeros(L, dtype=np.uint16)
        sym[:n_dp] = refk & 7
        buf[: L // 4] = (sym[0::4] | (sym[1::4] << 4) | (sym[2::4] << 8)
                         | (sym[3::4] << 12))
    else:
        buf[:n_dp] = refk.astype(np.uint16)
    o = head
    buf[o: o + L // 2].view(np.uint8)[:n_dp] = c0[:n_dp]
    o += L // 2
    if Emax > 1:
        buf[o: o + L][:n_dp] = upper[0, :n_dp]
        o += L
    for pi, pj in enumerate(PS):
        plane = np.zeros(L, dtype=np.uint16)
        plane[:n_dp] = upper[pi + 1, :n_dp]
        nzp = np.flatnonzero(plane)
        assert len(nzp) <= pj
        bits = np.packbits(plane.astype(bool), bitorder="little")
        buf[o: o + L // 16].view(np.uint8)[: L // 8] = bits
        o += L // 16
        buf[o: o + len(nzp)] = plane[nzp]
        o += pj
    buf[o: o + L // 2].view(np.uint8)[:n_dp] = \
        np.minimum(tclamp, TOT_MARK).astype(np.uint8)
    o += L // 2
    if ET:
        buf[o: o + net] = esc & 0xFFFF
        buf[o + ET: o + ET + net] = esc >> 16
        buf[o + 2 * ET: o + 2 * ET + net] = tclamp[esc] & 0xFFFF
        buf[o + 3 * ET: o + 3 * ET + net] = tclamp[esc] >> 16
        # pad escape cells redirect past the cell space
        buf[o + net: o + ET] = 0xFFFF
        buf[o + ET + net: o + 2 * ET] = 0xFFFF
        o += 4 * ET
    if EOV:
        # cell and kmer ride separately: a combined cell*K3+kmer key
        # overflows int32 at L = 2^22 cells (jax x64 is off), which a
        # 3 Mb contig reaches
        ovcell = (ovk // K3).astype(np.uint32)
        buf[o: o + nov] = ovcell & 0xFFFF
        buf[o + EOV: o + EOV + nov] = ovcell >> 16
        buf[o + 2 * EOV: o + 2 * EOV + nov] = (ovk % K3).astype(np.uint16)
        buf[o + 3 * EOV: o + 3 * EOV + nov] = ovc.astype(np.uint16)
        buf[o + 4 * EOV: o + 4 * EOV + nov] = ovr.astype(np.uint16)
        o += 5 * EOV
    buf[o] = s0mask
    r32 = np.float32(rate).view(np.uint32)
    buf[o + 1] = r32 & 0xFFFF
    buf[o + 2] = r32 >> 16
    buf[o + 3] = n_dp & 0xFFFF
    buf[o + 4] = n_dp >> 16
    buf[o + 5] = nov & 0xFFFF
    buf[o + 6] = nov >> 16
    buf[o + 7] = net & 0xFFFF
    buf[o + 8] = net >> 16
    thv = coverage_thresholds(TH - 1, cov_ratio).astype(np.uint32)
    buf[o + 9:o + 9 + 2 * TH:2] = thv & 0xFFFF
    buf[o + 10:o + 10 + 2 * TH:2] = thv >> 16
    return buf, L, Emax, EOV, ET, FMT, TH, PS


def pad_to_chunk(n: int, chunk: int = CHUNK) -> int:
    """Round up to a power-of-two number of chunks so jit shapes are drawn
    from a small bucket set (bounds recompilation across regions)."""
    nch = max(-(-n // chunk), 1)
    p = 1
    while p < nch:
        p *= 2
    return p * chunk


def init_state(counts0: np.ndarray) -> np.ndarray:
    """s0 from the first cell's observed kmers: every prefix base present
    gets score 0 (the C `temp` seed, lib/contig.c:459-464); state 0 is always
    live (it is the running max)."""
    s0 = np.full(S, float(NEG), dtype=np.float32)
    s0[0] = 0.0
    prefixes = np.flatnonzero(counts0.reshape(S, S, S).sum(axis=(0, 2)))
    s0[prefixes] = 0.0
    return s0


def _index_order_ranks(nz: np.ndarray) -> np.ndarray:
    """Ranks by kmer index within each cell (fallback when no observation
    order exists, e.g. synthetic tests)."""
    cell = nz // K3
    first = np.concatenate([[0], np.flatnonzero(np.diff(cell)) + 1])
    seg = np.zeros(len(nz), dtype=np.int64)
    seg[first] = 1
    segid = np.cumsum(seg) - 1
    return (np.arange(len(nz)) - first[segid]).astype(np.uint16)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def coverage_thresholds(maxt: int, ratio: float) -> np.ndarray:
    """Integer LUT th with `cov < ratio * max(t, 1)` (f64) ⟺ cov < th[t]
    for integer cov — the FLAG_COVERAGE decision (lib/contig.c:487) as pure
    integers, so the device needs no f64."""
    t = np.maximum(np.arange(maxt + 1, dtype=np.int64), 1)
    return np.ceil(ratio * t).astype(np.int32)


def slow_chain(counts: np.ndarray, refkmer: np.ndarray, total: np.ndarray,
               rate: float, rank: np.ndarray | None = None) -> np.ndarray:
    """Per-cell transcription of contig_region_score + contig_region_correct
    (f64, python loops) with the reference's exact tie rules: kmers iterate
    in first-observation rank order, per-base entries replace on strictly
    greater only, base_max_score keeps the first maximum in insertion order.
    """
    L = counts.shape[0]
    NEGI = -1e18
    score = np.full((L, S), NEGI)
    bestk = np.zeros((L, S), dtype=np.int32)
    # score-list insertion order per (cell, base) = min kmer rank
    ins_rank = np.full((L, S), 1 << 20, dtype=np.int64)
    prev = np.full(S, NEGI)
    prev[0] = 0.0
    prev[np.flatnonzero(counts[0].reshape(S, S, S).sum(axis=(0, 2)))] = 0.0
    prev_msel = 0

    def kmer_order(c):
        ks = np.flatnonzero(counts[c])
        if rank is not None:
            ks = ks[np.argsort(rank[c, ks], kind="stable")]
        return ks

    def max_sel(sc_row, ins_row):
        """base_max_score: first max in insertion order."""
        live = np.flatnonzero(sc_row > NEGI / 2)
        live = live[np.argsort(ins_row[live], kind="stable")]
        best = live[0]
        for b in live[1:]:
            if sc_row[b] > sc_row[best]:
                best = b
        return int(best)

    for c in range(L):
        tot = int(total[c])
        tot1 = tot - 1 if tot > 1 else tot
        cur = np.full(S, NEGI)
        curk = np.zeros(S, dtype=np.int32)
        cins = np.full(S, 1 << 20, dtype=np.int64)
        for r, k in enumerate(kmer_order(c)):
            b2 = (k >> 3) & 7
            b3 = k & 7
            if b2 == 0:
                base_score = prev[prev_msel] if c else 0.0
            else:
                base_score = prev[b2]
            if base_score <= NEGI / 2:
                continue
            cnt = int(counts[c, k])
            if k == refkmer[c] and tot > 1:
                cnt -= 1
            sc = base_score + cnt - tot1 * rate
            if cins[b3] == 1 << 20:
                cins[b3] = r
            if sc > cur[b3]:
                cur[b3] = sc
                curk[b3] = k
        score[c] = cur
        bestk[c] = curk
        ins_rank[c] = cins
        prev = cur
        prev_msel = max_sel(cur, cins)
    # backtrack (contig_region_correct :473-496)
    choice = np.zeros(L, dtype=np.int8)
    b = max_sel(score[L - 1], ins_rank[L - 1])
    k = bestk[L - 1, b]
    for c in range(L - 1, -1, -1):
        choice[c] = k & 7
        if c:
            b2 = (k >> 3) & 7
            if b2 == 0:
                b2 = max_sel(score[c - 1], ins_rank[c - 1])
            k = bestk[c - 1, b2]
    return choice


# ---------------------------------------------------------------------------
# the kernels: build + bind (csrc/chain_scan.cu -> ctypes)
# ---------------------------------------------------------------------------

_SRC = os.path.join(nvcc.CSRC_DIR, "chain_scan.cu")
_LIB = None
_COUNT_LOCK = threading.Lock()  # launches come from several prep threads


def build() -> dict:
    """Compile csrc/chain_scan.cu for sm_90a into _build/ (see
    runtime/nvcc.py).  Returns {"path", "seconds", "ptxas"}."""
    return nvcc.build(_SRC, "chain_scan")


def bind(path: str):
    """Load a build of csrc/chain_scan.cu (any version with its C
    interface) and declare its entry points."""
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.npt_chain_forward.argtypes = [p, p, i, i, p, p, p, p]
    lib.npt_chain_forward.restype = i
    lib.npt_chain_traceback.argtypes = [p, p, i, i, p, p, p, p]
    lib.npt_chain_traceback.restype = i
    lib.npt_chain_error_string.argtypes = [i]
    lib.npt_chain_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _LIB
    if _LIB is None:
        _LIB = bind(build()["path"])
    return _LIB


def traceback_scratch(B: int, nch: int, device):
    """chain_traceback's scratch (maps, ends): maps holds Q, a packed map a
    cell (B * nch * CHUNK words), S, a map a 4 cells, then H, a map a
    group of chunks (B * nch words at most); ends holds E, a base a group
    (a byte each; a word a chunk is the room that builds before the Q
    design took, so bench_chain drives both)."""
    return (torch.empty(B * nch * (CHUNK + CHUNK // 4 + 1),
                        dtype=torch.int32, device=device),
            torch.empty(B * nch, dtype=torch.int32, device=device))


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.npt_chain_error_string(rc).decode())


def _check_scan_shape(L: int, chunk: int) -> int:
    if chunk != CHUNK:
        raise ValueError(f"the chain kernels take chunk={CHUNK}, not {chunk}")
    nch = L // CHUNK
    if L % CHUNK or nch < 1 or nch & (nch - 1):
        raise ValueError(f"L={L} is not {CHUNK} x a power of two "
                         "(pad_to_chunk)")
    return nch


def forward_states(A: torch.Tensor, s0: torch.Tensor,
                   chunk: int = CHUNK) -> torch.Tensor:
    """All-prefix state vectors f[t] = s0 (x) A_0 (x) ... (x) A_t in
    (max,+): A [B, L, 8, 8] f32, s0 [B, 8] f32 -> f [B, L, 8] f32, with
    L = 128 x a power of two.  CUDA tensors go to the `chain_forward`
    kernel (which runs or raises), CPU tensors to forward_states_plain."""
    if A.device.type == "cpu" and s0.device.type == "cpu":
        return forward_states_plain(A, s0, chunk)
    if A.device.type != "cuda" or s0.device != A.device:
        raise ValueError(f"A on {A.device}, s0 on {s0.device}: both cuda "
                         "or both cpu")
    B, L = A.shape[0], A.shape[1]
    nch = _check_scan_shape(L, chunk)
    if (A.dtype != torch.float32 or s0.dtype != torch.float32
            or tuple(A.shape) != (B, L, S, S) or tuple(s0.shape) != (B, S)
            or not A.is_contiguous() or not s0.is_contiguous()):
        raise ValueError(f"A {A.dtype} {tuple(A.shape)}, s0 {s0.dtype} "
                         f"{tuple(s0.shape)}: want contiguous f32 "
                         f"[B, L, {S}, {S}] and [B, {S}]")
    f = torch.empty((B, L, S), dtype=torch.float32, device=A.device)
    if B == 0:
        return f
    # per row: the up-sweep levels (nch, nch/2, ..., 1 products) and the
    # down-sweep prefixes, 2*nch 8x8 matrices each
    scratch = torch.empty((2, B, 2 * nch, S * S), dtype=torch.float32,
                          device=A.device)
    lib = _load()
    with torch.cuda.device(A.device):
        rc = lib.npt_chain_forward(
            A.data_ptr(), s0.data_ptr(), B, nch, scratch[0].data_ptr(),
            scratch[1].data_ptr(), f.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(lib, rc, "chain_forward kernel")
    with _COUNT_LOCK:
        forward_states.launches += 1
    return f


def traceback_batch(P: torch.Tensor, b_end: torch.Tensor,
                    chunk: int = CHUNK) -> torch.Tensor:
    """b_{c-1} = P[c, b_c] walked back from b_end at each row's last
    cell: P [B, L, 8] int32 (entries 0..7), b_end [B] int32 -> choice
    [B, L] int8.  CUDA tensors go to the `chain_traceback` kernel (which
    runs or raises), CPU tensors to traceback_batch_plain."""
    if P.device.type == "cpu" and b_end.device.type == "cpu":
        return traceback_batch_plain(P, b_end, chunk)
    if P.device.type != "cuda" or b_end.device != P.device:
        raise ValueError(f"P on {P.device}, b_end on {b_end.device}: both "
                         "cuda or both cpu")
    B, L = P.shape[0], P.shape[1]
    nch = _check_scan_shape(L, chunk)
    if (P.dtype != torch.int32 or b_end.dtype != torch.int32
            or tuple(P.shape) != (B, L, S) or tuple(b_end.shape) != (B,)
            or not P.is_contiguous() or not b_end.is_contiguous()):
        raise ValueError(f"P {P.dtype} {tuple(P.shape)}, b_end "
                         f"{b_end.dtype} {tuple(b_end.shape)}: want "
                         f"contiguous int32 [B, L, {S}] and [B]")
    choice = torch.empty((B, L), dtype=torch.int8, device=P.device)
    if B == 0:
        return choice
    maps, ends = traceback_scratch(B, nch, P.device)
    lib = _load()
    with torch.cuda.device(P.device):
        rc = lib.npt_chain_traceback(
            P.data_ptr(), b_end.data_ptr(), B, nch, maps.data_ptr(),
            ends.data_ptr(), choice.data_ptr(),
            torch.cuda.current_stream(P.device).cuda_stream)
    _raise_on(lib, rc, "chain_traceback kernel")
    with _COUNT_LOCK:
        traceback_batch.launches += 1
    return choice


forward_states.launches = 0
traceback_batch.launches = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels (tropical._forward_states and
# tropical._traceback_batch, op for op)
# ---------------------------------------------------------------------------

def _eye(device) -> torch.Tensor:
    e = torch.full((S, S), float(NEG), dtype=torch.float32, device=device)
    return e.fill_diagonal_(0.0)


def tropical_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(max,+) matrix product over the last two axes."""
    return (a[..., :, :, None] + b[..., None, :, :]).amax(dim=-2)


def _associative_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive tropical_compose scan over axis -3, in the combination
    order of jax.lax.associative_scan: combine adjacent pairs, recurse on
    the pair results, then combine each odd result with the next even
    element."""
    n = x.shape[-3]
    if n < 2:
        return x
    odd = _associative_scan(tropical_compose(x[..., 0:n - 1:2, :, :],
                                             x[..., 1::2, :, :]))
    if n % 2 == 0:
        even = tropical_compose(odd[..., :-1, :, :], x[..., 2::2, :, :])
    else:
        even = tropical_compose(odd, x[..., 2::2, :, :])
    even = torch.cat([x[..., :1, :, :], even], dim=-3)
    out = torch.empty_like(x)
    out[..., 0::2, :, :] = even
    out[..., 1::2, :, :] = odd
    return out


def forward_states_plain(A: torch.Tensor, s0: torch.Tensor,
                         chunk: int = CHUNK) -> torch.Tensor:
    """forward_states in plain PyTorch ops, on any device: A [B, L, 8, 8],
    s0 [B, 8] -> f [B, L, 8]."""
    B, L = A.shape[0], A.shape[1]
    nch = L // chunk
    Ach = A.reshape(B, nch, chunk, S, S)
    eye = _eye(A.device).expand(B, nch, S, S)
    P = eye
    for t in range(chunk):
        P = tropical_compose(P, Ach[:, :, t])
        P = P - P.amax(dim=(-2, -1), keepdim=True)
    Pinc = _associative_scan(P)
    Pexc = torch.cat([eye[:, :1], Pinc[:, :-1]], dim=1)
    s_start = (s0[:, None, :, None] + Pexc).amax(dim=-2)
    s = s_start - s_start.amax(dim=-1, keepdim=True)
    f = torch.empty((B, nch, chunk, S), dtype=torch.float32, device=A.device)
    for t in range(chunk):
        s = (s[..., :, None] + Ach[:, :, t]).amax(dim=-2)
        f[:, :, t] = s
    return f.reshape(B, L, S)


# chunks a ticket of chain_forward (csrc/chain_scan.cu's kUnit)
FORWARD_UNIT = 4


def lookback_scan(x: list, op) -> list:
    """Inclusive prefixes of x (one row: a power-of-two count of
    elements) under op, combined in chain_forward's order, for a test
    against jax.lax.associative_scan with an op that is not associative.
    Units of FORWARD_UNIT elements (or the whole row, if shorter): the
    unit's tree, level l combining the level below pairwise; with 2^k the
    lowest set bit of u + 1, T(u) = T(u - 2^(k-1)) op ( ... op (T(u - 1)
    op N)), N the unit's tree, and Pinc(u) = Pinc(u - 2^k) op T(u), or
    T(u) when u + 1 = 2^k; inside a unit, element p's prefix is
    Pinc(p - 2^k) op T(p), 2^k the lowest set bit of p + 1, or Pinc(u - 1)
    op T(p) when p + 1 = 2^k (T(p) itself in the first unit), T(p) the
    unit's tree over the 2^k elements that end at p."""
    def lowbit(v):
        return (v & -v).bit_length() - 1

    n = len(x)
    m = min(n, FORWARD_UNIT)
    lm = m.bit_length() - 1
    T, Pinc, out = {}, {}, []
    for u in range(n // m):
        levels = [x[m * u:m * (u + 1)]]
        for _ in range(lm):
            below = levels[-1]
            levels.append([op(below[2 * g], below[2 * g + 1])
                           for g in range(len(below) // 2)])

        def tree(p):
            lv = min(lowbit(p + 1), lm)
            return levels[lv][p >> lv]

        pin = {}
        for p in range(m - 1):
            k = lowbit(p + 1)
            if p + 1 != 1 << k:
                pin[p] = op(pin[p - (1 << k)], tree(p))
            elif u == 0:
                pin[p] = tree(p)
            else:
                pin[p] = op(Pinc[u - 1], tree(p))
        acc = levels[lm][0]
        k = lowbit(u + 1)
        for j in range(k):
            acc = op(T[u - (1 << j)], acc)
        T[u] = acc
        if u + 1 != 1 << k:
            acc = op(Pinc[u - (1 << k)], acc)
        Pinc[u] = acc
        out += [pin[p] for p in range(m - 1)] + [acc]
    return out


def traceback_batch_plain(P: torch.Tensor, b_end: torch.Tensor,
                          chunk: int = CHUNK) -> torch.Tensor:
    """traceback_batch in plain PyTorch ops, on any device, as the JAX
    package computes it: the maps as 0/NEG relation matrices run back
    through forward_states_plain, then the argmax."""
    B, L, _ = P.shape
    onehot = torch.nn.functional.one_hot(P.long(), S) > 0
    Mt = torch.where(onehot, torch.tensor(0.0, device=P.device),
                     torch.tensor(float(NEG), device=P.device))
    eye = _eye(P.device).expand(B, 1, S, S)
    Mrev = torch.cat([torch.flip(Mt[:, 1:], dims=[1]), eye], dim=1)
    u = torch.where(torch.arange(S, device=P.device)[None, :]
                    == b_end[:, None].long(), 0.0, float(NEG)
                    ).to(torch.float32)
    frev = forward_states_plain(Mrev, u, chunk)
    bvals = torch.argmax(frev, dim=2).to(torch.int8)
    return torch.cat([torch.flip(bvals[:, :L - 1], dims=[1]),
                      b_end.to(torch.int8)[:, None]], dim=1)


# ---------------------------------------------------------------------------
# decode, lattice and pointers (PyTorch ops on the buffer's device)
# ---------------------------------------------------------------------------

def _unpack_u8(words: torch.Tensor) -> torch.Tensor:
    """[B, L/2] u16 words -> [B, L] little-endian byte lanes."""
    B, H = words.shape
    return torch.stack([words & 0xFF, words >> 8], dim=-1).reshape(B, 2 * H)


def _lohi(b32: torch.Tensor, lo, hi) -> torch.Tensor:
    """Two u16 lanes (int32 tensors 0..0xFFFF) as one int64 value."""
    return b32[..., lo].long() | (b32[..., hi].long() << 16)


def planes_decode(b32: torch.Tensor, B, L, Emax, EOV, ET, FMT, TH, PS):
    """The buffer decode (b32 [B, buflen] int32 holding the u16 words).
    See pack_chain_planes_parts for the layout.  Returns kpl/cpl [B,
    Emax*L] int32 (slot kmer / count lanes, plane-major), refk/total
    [B*L], ov = (cell, kmer, count, rank) [B, EOV] or None, s0mask [B],
    rate (0-dim f32), n_dp [B], nov [B], th [TH]."""
    dev = b32.device
    i32 = torch.int32
    if FMT == 0:
        w = b32[:, : L // 4]
        sym = torch.stack([w & 15, (w >> 4) & 15, (w >> 8) & 15,
                           (w >> 12) & 15], dim=-1).reshape(B, L)
        # rolling_kmers with PAD(=0) beyond the left edge
        z1 = torch.zeros((B, 1), dtype=i32, device=dev)
        prev1 = torch.cat([z1, sym[:, :-1]], dim=1)
        prev2 = torch.cat([z1, z1, sym[:, :-2]], dim=1)
        refk = (prev2 << 6) | (prev1 << 3) | sym
        o = L // 4
    else:
        refk = b32[:, :L]
        o = L
    c0 = _unpack_u8(b32[:, o: o + L // 2])
    o += L // 2
    ups = []
    if Emax > 1:
        ups.append(b32[:, o: o + L])
        o += L
    bit = torch.arange(16, dtype=i32, device=dev)
    for pj in PS:
        # re-densify a bitmap + packed-words plane: bit positions index
        # into the packed array via an exclusive running count
        words = b32[:, o: o + L // 16]
        o += L // 16
        packed = b32[:, o: o + pj]
        o += pj
        bits = ((words[:, :, None] >> bit) & 1).reshape(B, L)
        idx = torch.cumsum(bits, dim=1, dtype=i32) - 1
        w = torch.gather(packed, 1, idx.clamp(0, pj - 1).long())
        ups.append(torch.where(bits > 0, w, 0))
    up = (torch.cat(ups, dim=1) if ups
          else torch.zeros((B, 0), dtype=i32, device=dev))
    kpl = torch.cat([refk, up >> 7], dim=1)
    cpl = torch.cat([c0, up & CNT_CAP], dim=1)
    total = _unpack_u8(b32[:, o: o + L // 2]).reshape(B * L)
    o += L // 2
    if ET:
        ecell = _lohi(b32, slice(o, o + ET), slice(o + ET, o + 2 * ET))
        eval_ = _lohi(b32, slice(o + 2 * ET, o + 3 * ET),
                      slice(o + 3 * ET, o + 4 * ET)).to(i32)
        # pad escapes carry cell 0xFFFFFFFF -> redirect past B*L
        rows = (torch.arange(B, device=dev) * L)[:, None]
        idx = torch.where(ecell >= 2 ** 31, B * L,
                          torch.clamp_max(ecell + rows, B * L))
        total = torch.cat([total, total.new_zeros(1)])
        total[idx.reshape(-1)] = eval_.reshape(-1)
        total = total[: B * L]
        o += 4 * ET
    ov = None
    if EOV:
        ovcell = _lohi(b32, slice(o, o + EOV), slice(o + EOV, o + 2 * EOV))
        ovkm = b32[:, o + 2 * EOV: o + 3 * EOV]
        ovcn = b32[:, o + 3 * EOV: o + 4 * EOV]
        ovrk = b32[:, o + 4 * EOV: o + 5 * EOV]
        o += 5 * EOV
        ov = (ovcell, ovkm, ovcn, ovrk)
    s0mask = b32[:, o]
    rate = _lohi(b32[:1], o + 1, o + 2).to(i32).view(torch.float32)[0]
    n_dp = _lohi(b32, o + 3, o + 4).to(i32)
    nov = _lohi(b32, o + 5, o + 6).to(i32)
    th = _lohi(b32[0], slice(o + 9, o + 9 + 2 * TH, 2),
               slice(o + 10, o + 10 + 2 * TH, 2)).to(i32)
    return kpl, cpl, refk.reshape(B * L), total, ov, s0mask, rate, n_dp, \
        nov, th


def _emit(adj: torch.Tensor, tot1: torch.Tensor, rate) -> torch.Tensor:
    """The emission adj - tot1 * rate as f32, rounded ONCE, as XLA on the
    CPU computes it in the JAX package (it contracts the expression into
    one fused multiply-add).  adj (a count, below 2^16) and tot1 (a
    total, below 2^24) hold integers and rate is the f32 rate, so in f64
    the product (at most 48 significant bits) and, for rates above 2^-13,
    the difference (an integer multiple of the rate's last bit, below
    2^53 of them) are exact; the cast to f32 is then the single rounding.
    Two f32 operations would round the product first, and differ from
    the JAX package at rates off the dyadic grid (0.33, 0.47, 0.7; at
    0.5 the product is exact either way)."""
    x = adj.double()
    x -= tot1.double() * torch.as_tensor(rate, dtype=torch.float32).double()
    return x.float()


def _scatter_slots(n_out, index, vals, reduce, init):
    """out[..., s] = reduce over slots j of vals[:, j] where index[:, j] ==
    s, from `init`: index/vals [B, Emax, L] -> [B, L, n_out]."""
    B, E, L = index.shape
    out = torch.full((B, L, n_out), init, dtype=vals.dtype,
                     device=vals.device)
    for j in range(E):
        if reduce == "sum":
            out.scatter_add_(2, index[:, j, :, None], vals[:, j, :, None])
        else:
            out.scatter_reduce_(2, index[:, j, :, None], vals[:, j, :, None],
                                reduce=reduce)
    return out


def _segment(n, seg, vals, reduce, init):
    """A flat [n + 1] segment reduction (the last slot is the pad trash)."""
    out = torch.full((n + 1,), init, dtype=vals.dtype, device=vals.device)
    if reduce == "sum":
        return out.scatter_add_(0, seg, vals)
    return out.scatter_reduce_(0, seg, vals, reduce=reduce)


def chain_planes_core(kpl, cpl, refk, total, valid, rate, s0_all, ov, B, L,
                      Emax, chunk: int = CHUNK, plain: bool = False):
    """Slot-plane chain DP core (tropical._chain_planes_core).  kpl/cpl
    [B, Emax*L] int32 (kmer / count planes; count 0 = empty slot),
    refk/total [B*L] int32, valid [B*L] bool, rate 0-dim f32, s0_all
    [B, 8] f32, ov = (cell, kmer, count, rank) flat overflow entries with
    cells already offset into the global B*L cell space (pads redirected
    past it) or None.  Returns (P [B*L, 8] int32, msel [B*L] int32, cov2
    [B*L, 8] int32), equal to the JAX function's.  `plain` runs the
    forward scan's plain version on any device (a card's check of the
    kernel)."""
    dev = kpl.device
    f32, i32 = torch.float32, torch.int32
    neg = float(NEG)
    big = int(RANK_BIG)
    Ltot = B * L
    kd = kpl.reshape(B, Emax, L)
    cd = cpl.reshape(B, Emax, L)
    occ = cd > 0
    tot = total.reshape(B, 1, L)
    refq = refk.reshape(B, 1, L)
    dec = ((tot > 1) & (kd == refq)).to(f32)
    tot1 = torch.where(tot > 1, tot - 1, tot).to(f32)
    em = torch.where(occ, _emit(cd.to(f32) - dec, tot1, rate), neg)
    b2 = (kd >> 3) & 7
    b3 = kd & 7
    # transition lattice: max over the slots per (cell, b2*8+b3)
    A = _scatter_slots(64, (b2 * 8 + b3).long(), em, "amax", neg)
    if ov is not None:
        e_cell, e_kmer, ovcn, ovrk = ov
        is_pad = e_cell >= Ltot
        c_cl = torch.clamp_max(e_cell, Ltot - 1)
        tot_e = total[c_cl]
        dec_e = ((tot_e > 1) & (e_kmer == refk[c_cl])).to(f32)
        tot1_e = torch.where(tot_e > 1, tot_e - 1, tot_e).to(f32)
        em_e = torch.where(is_pad, neg,
                           _emit(ovcn.to(f32) - dec_e, tot1_e, rate))
        oe_b2 = (e_kmer >> 3) & 7
        oe_b3 = e_kmer & 7
        segA = torch.where(is_pad, Ltot * 64,
                           c_cl * 64 + oe_b2 * 8 + oe_b3)
        Ao = _segment(Ltot * 64, segA, em_e, "amax", neg)
        A = torch.maximum(A, Ao[: Ltot * 64].reshape(B, L, 64))
    A = A.reshape(Ltot, S, S)
    A[:, :, 0] = A.amax(dim=2)
    A = torch.where(valid[:, None, None], A, _eye(dev)[None])
    f = (forward_states_plain if plain else forward_states)(
        A.reshape(B, L, S, S), s0_all, chunk)
    del A
    fprev = torch.cat([s0_all[:, None, :], f[:, :-1]], dim=1)  # [B, L, S]
    # per-slot chain scores: fprev picked by b2
    fg = torch.gather(fprev[:, None].expand(B, Emax, L, S), 3,
                      b2.long()[..., None])[..., 0]
    sc = torch.where(occ, fg + em, neg)  # [B, Emax, L]
    b3l = b3.long()
    # the entry-space path's segment max initializes at NEG (floors V)
    V = _scatter_slots(S, b3l, torch.where(occ, sc, neg), "amax", neg)
    obs2 = _scatter_slots(S, b3l, occ.to(i32), "amax", 0) > 0
    cov2 = _scatter_slots(S, b3l, torch.where(occ, cd, 0), "sum", 0)
    # slot index IS the per-cell first-observation rank in the planes
    slot = torch.arange(Emax, dtype=i32, device=dev)[None, :, None]
    Rm = _scatter_slots(S, b3l, torch.where(occ, slot, big), "amin", big)
    if ov is not None:
        seg3 = torch.where(is_pad, Ltot * 8, c_cl * 8 + oe_b3)
        fg_o = fprev.reshape(Ltot, S)[c_cl, oe_b2.long()]
        sc_o = torch.where(is_pad, neg, fg_o + em_e)
        Vo = _segment(Ltot * 8, seg3, sc_o, "amax", neg)
        obs_o = _segment(Ltot * 8, seg3, (~is_pad).to(i32), "amax", 0)
        cov_o = _segment(Ltot * 8, seg3,
                         torch.where(is_pad, 0, ovcn), "sum", 0)
        Rm_o = _segment(Ltot * 8, seg3, torch.where(is_pad, big, ovrk),
                        "amin", big)
        V = torch.maximum(V, Vo[: Ltot * 8].reshape(B, L, S))
        obs2 = obs2 | (obs_o[: Ltot * 8].reshape(B, L, S) > 0)
        cov2 = cov2 + cov_o[: Ltot * 8].reshape(B, L, S)
        Rm = torch.minimum(Rm, Rm_o[: Ltot * 8].reshape(B, L, S))
    # winners per (cell, suffix) against the MERGED V, exact min-rank
    # tie rule (base_add_score / base_max_score, lib/base.c:159-197)
    Vg = torch.gather(V[:, None].expand(B, Emax, L, S), 3,
                      b3l[..., None])[..., 0]
    wkey = torch.where((sc == Vg) & occ, slot * 8 + b2, big)
    Wk = _scatter_slots(S, b3l, wkey, "amin", big)
    if ov is not None:
        Vm_o = torch.maximum(Vo, torch.cat([V.reshape(Ltot * 8),
                                            Vo.new_full((1,), neg)]))
        elig_o = (~is_pad) & (sc_o == Vm_o[seg3])
        wkey_o = torch.where(elig_o, ovrk * 8 + oe_b2, big)
        Wko = _segment(Ltot * 8, seg3, wkey_o, "amin", big)
        Wk = torch.minimum(Wk, Wko[: Ltot * 8].reshape(B, L, S))
    V2 = V.reshape(Ltot, S)
    obs2 = obs2.reshape(Ltot, S)
    wb2 = torch.where(obs2, Wk.reshape(Ltot, S) & 7, 0)
    Rm2 = Rm.reshape(Ltot, S)
    Vmax = torch.where(obs2, V2, neg).amax(dim=1)
    cand = (V2 == Vmax[:, None]) & obs2
    msel = torch.argmin(torch.where(cand, Rm2, big), dim=1).to(i32)
    msel_prev = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                           msel.reshape(B, L)[:, :-1]], dim=1).reshape(Ltot)
    P = torch.where(wb2 != 0, wb2, msel_prev[:, None])
    P = torch.where(valid[:, None], P,
                    torch.arange(S, dtype=i32, device=dev)[None])
    return P.to(i32), msel, cov2.reshape(Ltot, S)


def chain_correct_planes_batch(bufs: torch.Tensor, L, Emax, EOV, ET, FMT,
                               TH, PS=(), chunk: int = CHUNK,
                               plain: bool = False) -> torch.Tensor:
    """Batched slot-plane chain DP: bufs [B, buflen] u16 words (uint16, or
    int16 holding the same bits, or int32 0..0xFFFF), one contig per row
    of one shape bucket, on the device that runs the DP.  Each row keeps
    its own scan axis, s0 and traceback, so a row's bytes equal its
    single-row run.  Returns packed [B, L] int8 result bytes on that
    device.  `plain` runs both scans' plain versions on any device (a
    card's check of the kernels)."""
    if bufs.dtype == torch.int32:
        b32 = bufs
    else:
        b32 = bufs.view(torch.int16).to(torch.int32) & 0xFFFF
    B = b32.shape[0]
    dev = b32.device
    kpl, cpl, refk, total, ov, s0mask, rate, n_dp, nov, th = planes_decode(
        b32, B, L, Emax, EOV, ET, FMT, TH, PS)
    valid = (torch.arange(L, device=dev)[None, :]
             < n_dp[:, None]).reshape(B * L)
    lanes = torch.arange(S, dtype=torch.int32, device=dev)
    s0_all = torch.where((s0mask[:, None] >> lanes) & 1 != 0, 0.0,
                         float(NEG)).to(torch.float32)
    ovt = None
    if EOV:
        # one global entry list: each row's cells shift by its row
        # offset, per-row pad lanes redirect past B*L
        ovcell, ovkm, ovcn, ovrk = ov
        live = torch.arange(EOV, device=dev)[None, :] < nov[:, None]
        ovc_g = torch.where(live, ovcell + (torch.arange(B, device=dev)
                                            * L)[:, None], B * L)
        ovt = (ovc_g.reshape(-1), ovkm.reshape(-1), ovcn.reshape(-1),
               ovrk.reshape(-1))
    P, msel, cov2 = chain_planes_core(kpl, cpl, refk, total, valid, rate,
                                      s0_all, ovt, B, L, Emax, chunk, plain)
    lastidx = (torch.arange(B, device=dev) * L
               + torch.clamp_min(n_dp - 1, 0))
    b_ends = msel[lastidx].contiguous()
    choice = (traceback_batch_plain if plain else traceback_batch)(
        P.reshape(B, L, S).contiguous(), b_ends, chunk).reshape(B * L)
    cov = torch.gather(cov2, 1, choice.long()[:, None])[:, 0]
    zero = (total == 1).to(torch.int8) << FLAGB_ZERO
    low = (cov < th[torch.clamp_max(total, TH - 1).long()]).to(
        torch.int8) << FLAGB_COV
    return (choice | zero | low).reshape(B, L)


def chain_correct_planes(buf: torch.Tensor, L, Emax, EOV, ET, FMT, TH,
                         PS=(), chunk: int = CHUNK) -> torch.Tensor:
    """Single-contig slot-plane chain DP (one row of the batch)."""
    return chain_correct_planes_batch(buf[None], L, Emax, EOV, ET, FMT, TH,
                                      PS, chunk)[0]


# ---------------------------------------------------------------------------
# the dense chain (tropical.emission, build_transition, _pointers,
# _chain_core / chain_correct_batch): [B, L, 512] tensors, one row per
# region or window, PyTorch ops around the two scan kernels
# ---------------------------------------------------------------------------

def emission(counts: torch.Tensor, refkmer: torch.Tensor,
             total: torch.Tensor, rate) -> torch.Tensor:
    """Per-cell per-kmer emission scores em [B, L, 512] f32, NEG where
    unobserved (contig_calculate_score's adjustments, lib/contig.c:424-453):
    the draft's own kmer is decremented when the cell has real coverage,
    and the per-cell normalizer uses total-1 when total > 1.  counts
    [B, L, 512] and refkmer/total [B, L] of any integer dtype; rate a
    float, rounded to f32 once (a 0-dim CPU tensor mixes with tensors of
    any device).  The same f32 operations as the JAX function: the
    decrement added as -dec, then adj - tot1*rate as one multiply and one
    subtract, each rounded: unlike the planes core (_emit), XLA does not
    contract this one into a fused multiply-add (tests/test_torch_chain.py
    holds both to the JAX package at off-grid rates)."""
    f32 = torch.float32
    cnt = counts.to(f32)
    dec = (total > 1).to(f32)
    adj = cnt.scatter_add(2, refkmer.long()[..., None], -dec[..., None])
    tot1 = torch.where(total > 1, total - 1, total).to(f32)
    rate = torch.tensor(np.float32(rate))
    return torch.where(counts > 0, adj - tot1[..., None] * rate, float(NEG))


def build_transition(em: torch.Tensor) -> torch.Tensor:
    """Augmented transition matrices A [B, L, 8, 8] from em [B, L, 512]:
    the max over the first base, column 0 set to the row max."""
    B, L = em.shape[:2]
    M = em.reshape(B, L, S, S, S).amax(dim=2)  # [B, L, b2, b3]
    M[..., 0] = M.amax(dim=3)
    return M


def pointers(em: torch.Tensor, rank: torch.Tensor, fprev: torch.Tensor,
             valid: torch.Tensor):
    """Per-cell predecessor table + base_max_score selection
    (tropical._pointers, rows batched): em [B, L, 512] f32, rank
    [B, L, 512] int32 (first-observation rank; any value where
    unobserved), fprev [B, L, 8] f32 (the state before each cell), valid
    [B, L] bool.  Returns (P [B, L, 8] int32 — predecessor base at cell
    c-1 given base b at cell c; msel [B, L] int32 — base_max_score's pick
    at each cell, ties by min insertion rank).  torch.argmin returns the
    first minimum, as jnp.argmin does."""
    B, L = em.shape[:2]
    dev = em.device
    i32 = torch.int32
    neg, big = float(NEG), int(RANK_BIG)
    emr = em.reshape(B, L, S * S, S)
    obsr = emr > float(NEG * np.float32(0.5))
    pref_b2 = torch.arange(S * S, device=dev) % S
    gath = fprev[:, :, pref_b2]  # [B, L, 64]; fprev[..., 0] = running max
    sc = torch.where(obsr, gath[..., None] + emr, neg)
    V = sc.amax(dim=2)  # [B, L, S] per-base best score
    rkr = torch.where(obsr, rank.reshape(B, L, S * S, S).to(i32), big)
    # winning kmer per (cell, base): strictly-greater replacement in data
    # order keeps the min-rank kmer among score winners (base_add_score)
    winner = (sc == V[:, :, None, :]) & obsr
    del sc
    wp = torch.argmin(torch.where(winner, rkr, big), dim=2)
    del winner
    wb2 = (wp % S).to(i32)
    Rm = rkr.amin(dim=2)  # [B, L, S] score-list insertion rank per base
    del rkr
    lane_obs = obsr.any(dim=2)
    # base_max_score: first maximum in insertion order (lib/base.c:185-197)
    Vmax = torch.where(lane_obs, V, neg).amax(dim=2)
    cand = (V == Vmax[..., None]) & lane_obs
    msel = torch.argmin(torch.where(cand, Rm, big), dim=2).to(i32)
    msel_prev = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                           msel[:, :-1]], dim=1)
    P = torch.where(wb2 != 0, wb2, msel_prev[..., None])
    iota = torch.arange(S, dtype=i32, device=dev)
    return torch.where(valid[..., None], P, iota), msel


def chain_pointers(counts, rank, refkmer, total, valid, rate, s0,
                   chunk: int = CHUNK, plain: bool = False):
    """The forward half of the dense chain DP over B independent rows
    (tropical._chain_core up to its traceback; every row keeps its own scan
    axis and s0): counts/rank [B, L, 512] (int; rank 0xFFFF where
    unobserved), refkmer/total [B, L] int32, valid [B, L] bool, s0 [B, 8]
    f32, all on the device that runs the DP, L = 128 x a power of two.
    Runs the emission, the transitions (identity where not valid), the
    forward scan and the pointers; returns (f [B, L, 8] f32, the state
    after each cell; P [B, L, 8] int32; msel [B, L] int32).  `plain` runs
    the scan's plain version on any device (a card's check of the
    kernel)."""
    em = emission(counts, refkmer, total, rate)
    A = build_transition(em)
    A = torch.where(valid[..., None, None], A, _eye(em.device))
    s0 = s0.to(torch.float32).contiguous()
    f = (forward_states_plain if plain else forward_states)(
        A.contiguous(), s0, chunk)
    del A
    fprev = torch.cat([s0[:, None], f[:, :-1]], dim=1)
    P, msel = pointers(em, rank, fprev, valid)
    return f, P, msel


def chain_correct_batch(counts, rank, refkmer, total, valid, rate, s0,
                        chunk: int = CHUNK,
                        plain: bool = False) -> torch.Tensor:
    """The dense chain DP over B independent regions (tropical._chain_core
    under chain_correct_batch's vmap), chain_pointers' inputs: the choices
    [B, L] int8 (the running best score JAX's core also returns is unused
    by its callers and not computed).  `plain` runs both scans' plain
    versions on any device (a card's check of the kernels)."""
    _, P, msel = chain_pointers(counts, rank, refkmer, total, valid, rate,
                                s0, chunk, plain)
    lastidx = torch.clamp_min(valid.sum(dim=1) - 1, 0)
    b_end = torch.gather(msel, 1, lastidx[:, None])[:, 0].contiguous()
    return (traceback_batch_plain if plain else traceback_batch)(
        P.contiguous(), b_end, chunk)


def _u16(a: np.ndarray, device) -> torch.Tensor:
    """A uint16 array on `device` as int32 values 0..0xFFFF (moved as
    16-bit words)."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).to(device)
    return t.to(torch.int32) & 0xFFFF


def run_chain_batch(problems, rate, chunk: int = CHUNK, device=None,
                    plain: bool = False) -> list:
    """Run many small regions in one launch.  problems = list of
    (counts[n,K3] uint16, refkmer[n], total[n], rank[n,K3] uint16);
    returns list of choice[n] (numpy int8).  The DP runs on `device`
    (default cuda); `plain` runs the scans' plain versions there."""
    if not problems:
        return []
    dev = resolve_device(device)
    R = _pow2(len(problems))
    Lb = pad_to_chunk(max(c.shape[0] for c, *_ in problems), chunk)
    counts = np.zeros((R, Lb, K3), dtype=np.uint16)
    ranks = np.full((R, Lb, K3), 0xFFFF, dtype=np.uint16)
    rk = np.zeros((R, Lb), dtype=np.int32)
    tt = np.zeros((R, Lb), dtype=np.int32)
    vv = np.zeros((R, Lb), dtype=bool)
    s0 = np.full((R, S), float(NEG), dtype=np.float32)
    s0[:, 0] = 0.0
    for i, prob in enumerate(problems):
        c, r, t = prob[0], prob[1], prob[2]
        n = c.shape[0]
        counts[i, :n] = c
        if len(prob) > 3 and prob[3] is not None:
            ranks[i, :n] = prob[3]
        else:
            flat = c.reshape(-1)
            nz = np.flatnonzero(flat)
            ranks[i, :n].reshape(-1)[nz] = _index_order_ranks(nz)
        rk[i, :n] = r[:n]
        tt[i, :n] = t[:n]
        vv[i, :n] = True
        s0[i] = init_state(c[0])
    out = chain_correct_batch(
        _u16(counts, dev), _u16(ranks, dev), torch.from_numpy(rk).to(dev),
        torch.from_numpy(tt).to(dev), torch.from_numpy(vv).to(dev),
        float(rate), torch.from_numpy(s0).to(dev), chunk, plain)
    out = out.cpu().numpy()
    return [out[i, : p[0].shape[0]] for i, p in enumerate(problems)]


def run_chain(counts: np.ndarray, refkmer: np.ndarray, total: np.ndarray,
              n_dp: int, rate: float, rank: np.ndarray | None = None,
              chunk: int = CHUNK, device=None) -> np.ndarray:
    """Host wrapper of one region (tropical.run_chain): sparsify the dense
    counts [>= n_dp, K3], run the planes DP on `device` (default cuda),
    return choices[:n_dp] (numpy int8).  `rank` is the dense
    [>= n_dp, K3] first-observation table; when None the counts'
    kmer-index order stands in."""
    flat = counts[:n_dp].reshape(-1)
    nz = np.flatnonzero(flat)
    if rank is None:
        rk = _index_order_ranks(nz)
    else:
        rk = rank[:n_dp].reshape(-1)[nz]
    return run_chain_sparse(nz.astype(np.int64), flat[nz], rk, refkmer,
                            total, n_dp, rate, chunk, device)


def run_chain_sparse(uk_in: np.ndarray, cn_in: np.ndarray,
                     rk_in: np.ndarray, refkmer: np.ndarray,
                     total: np.ndarray, n_dp: int, rate: float,
                     chunk: int = CHUNK, device=None) -> np.ndarray:
    """Sparse-key host wrapper (tropical.run_chain_sparse): uk_in = sorted
    cell*K3+kmer keys (any cells >= n_dp are trimmed), cn_in = counts,
    rk_in = first-observation ranks; the choices [n_dp] (numpy int8)."""
    packed = dispatch_chain_sparse(uk_in, cn_in, rk_in, refkmer, total,
                                   n_dp, rate, chunk=chunk, device=device)
    return packed.cpu().numpy()[:n_dp] & 7


def dispatch_chain_sparse(uk_in: np.ndarray, cn_in: np.ndarray,
                          rk_in: np.ndarray, refkmer: np.ndarray,
                          total: np.ndarray, n_dp: int, rate: float,
                          cov_ratio: float = 0.8, chunk: int = CHUNK,
                          device=None) -> torch.Tensor:
    """Launch the chain DP on `device` (default cuda) and return the
    packed per-cell result byte (choice | FLAG_ZERO << 3 | FLAG_COVERAGE
    << 4) as a tensor there, without waiting for it: the planes buffer
    (pack_chain_planes) through chain_correct_planes."""
    dev = resolve_device(device)
    trace.count("task1.chain_cells", pad_to_chunk(max(n_dp, 1), chunk))
    trace.count("task1.chain_launches", 1)
    buf, *shape = pack_chain_planes(
        uk_in, cn_in, rk_in, refkmer, total, n_dp, rate, cov_ratio, chunk)
    host = torch.from_numpy(buf.view(np.int16))
    return chain_correct_planes(host.to(dev), *shape, chunk=chunk)
