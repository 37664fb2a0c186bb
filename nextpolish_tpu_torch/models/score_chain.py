"""Task 1 — short-read score-chain correction (lib/scorechain.c:3-15), port
of nextpolish_tpu/models/score_chain.py (the slot-plane path and the
window route).

Per contig:
  read filter level (contig_read_fliter1) -> insert-slot discovery -> the
  native pileup walk straight into the chain DP's transfer planes -> the
  chain DP on the device (ops/chain.py: PyTorch ops around the two CUDA
  scan kernels) -> corrected bases + flags -> FASTA emission with
  FLAG_ZERO|FLAG_COVERAGE lowercasing.

A launch runs one contig, or NPT_CHAIN_BATCH contigs of one shape bucket,
whole (the TPU's 1 Mb window threshold, NPT_CHAIN_WINDOW_BASES, is a
lane-padding limit and has no counterpart here).  A contig whose launch
would pass the device's free memory at LAUNCH_BYTES_PER_CELL, or whose
cells reach MAX_LAUNCH_CELLS (native/pileup.cpp's planes walker packs
overflow keys as (cell*512+kmer) << 28 in an int64), takes the window
route instead: score_chain_contig_windowed, the JAX package's
score_chain_contig_sharded on one reads shard, which walks with the
sparse walker and runs 2^19-cell windows (parallel/shard.py) with
byte-exact state chaining and backward stitch.

Also provides `score_correct_region`, the shared regional correction used
by the kmer_count no-depth rescue (contig_score_correct,
lib/contig.c:706-734), on the dense chain DP (ops/chain.py
run_chain_batch) and the planes launch (dispatch_chain_sparse); the long-
read chain variant `td_score_chain_contig` (td_score_chain1,
lib/scorechain.c:17-29) on it at filter level 1 and the lgs rate; and
`run_chain_region`, one region on the planes path (task 3's low-depth
rescue, models/snp_phase.py).

Not ported here: score_chain_pipeline_multichip, the several-shard route
and the round-robin over several devices (ROADMAP A6.2b).
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io.bam import AlnBatch
from ..io.fasta import ASCII_TO_NIB
from ..ops import pileup as pl
from ..ops.chain import (
    CHUNK,
    FLAGB_COV,
    FLAGB_ZERO,
    TH_CAP,
    _pow2,
    chain_correct_planes_batch,
    coverage_thresholds,
    dispatch_chain_sparse,
    pack_chain_planes,
    pack_chain_planes_parts,
    pad_to_chunk,
    run_chain,
    run_chain_batch,
)
from ..ops.symbols import K3, S
from ..parallel.shard import merge_traceback, reads_merge_fwd
from ..runtime import trace
from ..runtime.budget import device_free_bytes
from .contig_state import (ContigState, find_regions, maybe_trace,
                           merge_regions)
from .flags import FLAG_COVERAGE, FLAG_ZERO

# native/pileup.cpp:463 packs (cell*512 + kmer) << 28 into an int64
MAX_LAUNCH_CELLS = 1 << 26
# device bytes one cell of a launch may take at its peak (the decoded
# planes, the [L, 64] lattice twice, f, pointers and flags, with room);
# a launch must fit the free memory at this rate
LAUNCH_BYTES_PER_CELL = 2048
# cells per window of the window route (as the JAX package's
# SHARD_WINDOW_CELLS); the window's dense [Wc, 512] tensors (counts,
# observation keys, their argsort, emission, per-slot scores) take about
# WINDOW_BYTES_PER_CELL a cell at the peak, and a window is halved until
# it fits the free memory at that rate
SHARD_WINDOW_CELLS = 1 << 19
WINDOW_BYTES_PER_CELL = 1 << 15


@dataclass
class AlgoConfig:
    """Algorithm thresholds (C Configure defaults, lib/config.c:10-41).
    Copied from nextpolish_tpu/models/score_chain.py."""

    trim_len_edge: int = 2
    ext_len_edge: int = 2
    min_map_quality: int = 0
    indel_balance_factor_sgs: float = 0.5
    min_count_ratio_skip: float = 0.8
    min_len_ldr: int = 3
    min_len_inter_kmer: int = 5
    max_len_kmer: int = 50
    max_count_kmer: int = 50
    indel_balance_factor_lgs: float = 0.33
    max_clip_ratio_sgs: float = 0.15
    max_clip_ratio_lgs: float = 0.4
    max_ins_len_sgs: int = 10000
    max_ins_fold_sgs: int = 5
    count_read_ins_sgs: int = 10000
    min_depth_snp: int = 3
    min_count_snp: int = 5
    min_count_snp_link: int = 5
    ploidy: float = 2.0
    max_indel_factor_lgs: float = 0.21
    max_snp_factor_lgs: float = 0.53
    min_snp_factor_sgs: float = 0.34
    max_variant_count_lgs: int = 150000
    read_tlen: int = 0  # estimated insert size * max_ins_fold_sgs
    read_len: int = 0  # first read's length (Configure.read_len)
    # -debug (trace_polish_open, lib/config.c:40): when a list, engines
    # append (name, pos, index, curbase, draftbase) per changed base
    trace_sink: list | None = None


def estimate_read_tlen(batch: AlnBatch, cfg: AlgoConfig) -> int:
    """Mean insert size from the first ~10k proper pairs * max_ins_fold_sgs
    (bam_tlen, lib/config.c:80-101 — including its count-from-1 average)."""
    tl = batch.tlen
    sel = (tl > 0) & (tl < cfg.max_ins_len_sgs)
    take = np.flatnonzero(sel)[: cfg.count_read_ins_sgs - 1]
    count = len(take) + 1
    mean = int(tl[take].sum()) // count
    if len(batch):
        cfg.read_len = int(batch.lqseq[0])
    return mean * cfg.max_ins_fold_sgs


def _finish_correction_sparse(state: ContigState, n_dp: int, cell0: int,
                              packed: np.ndarray, cfg: AlgoConfig) -> None:
    """Unpack the device result byte: choice in bits 0-2, FLAG_ZERO /
    FLAG_COVERAGE decisions in bits 3-4 (computed on the device with the
    exact integer-threshold equivalent of the host's f64 compares)."""
    packed = np.asarray(packed)[:n_dp]
    cells = cell0 + np.arange(n_dp)
    state.base[cells] = packed & 7
    state.update_flags(cells, (packed >> FLAGB_ZERO) & 1 == 1, FLAG_ZERO)
    state.update_flags(cells, (packed >> FLAGB_COV) & 1 == 1, FLAG_COVERAGE)


# ---------------------------------------------------------------------------
# the regional correction (copied from nextpolish_tpu/models/score_chain.py,
# on the port's chain DP, with the device passed explicitly)
# ---------------------------------------------------------------------------

def _coverage_of(counts: np.ndarray, choice: np.ndarray) -> np.ndarray:
    """Per-cell count supporting the chosen base (base_get_coverage,
    lib/base.c:79-89) — sum of the chosen suffix lane only (gathering the
    lane first avoids reducing all S lanes of the big counts tensor)."""
    n = len(choice)
    lane = counts.reshape(n, S * S, S)[np.arange(n), :, choice.astype(np.int64)]
    return lane.sum(axis=1, dtype=np.int64)


def run_chain_region(counts: np.ndarray, refkmer: np.ndarray,
                     total: np.ndarray, n_dp: int, rate: float,
                     rank: np.ndarray | None = None,
                     device=None) -> np.ndarray:
    """One region's choices [n_dp] from its dense pileup, the chain DP on
    `device` (default cuda)."""
    return run_chain(counts, refkmer, total, n_dp, rate, rank=rank,
                     device=device)


def score_correct_region(state: ContigState, batch: AlnBatch,
                         levels: np.ndarray, tid: int,
                         contig_nib: np.ndarray, start: int, end: int,
                         filterlevel: int, rate: float, cfg: AlgoConfig,
                         device=None) -> None:
    """contig_score_correct (lib/contig.c:706-734) on [start, end], assuming
    insert slots already exist in state.index.  Mutates state in place.
    The chain DPs run on `device` (default cuda)."""
    view = state.index.region_view(start, end)
    cell0 = int(state.index.cell_of[start - state.index.start])
    p = pl.build_pileup_sparse(batch, levels, filterlevel, view, tid,
                               contig_nib, cfg.trim_len_edge)
    _apply_correction_sparse(state, p, cell0, rate, cfg, device)

    if filterlevel == 2:
        # no-depth rescue: re-parse FLAG_ZERO runs at filter level 1
        # (lib/contig.c:721-733); all regions run in one batched launch
        nodepth = find_regions(state, start, end, gap=0, con=0,
                               flag_bit=FLAG_ZERO, extend=False,
                               ext_len_edge=cfg.ext_len_edge)
        problems = []
        metas = []
        for rs, re in merge_regions(nodepth):
            sub = state.index.region_view(rs, re)
            sub_cell0 = int(state.index.cell_of[rs - state.index.start])
            lo = sub_cell0 - cell0
            hi = lo + sub.n_cells_dp
            ex = pl.expand_reads(batch, levels, 1, sub, tid,
                                 cfg.trim_len_edge)
            extra = pl.sparse_counts(ex.cells, ex.kmers(), sub.n_cells)
            counts = np.minimum(
                p.dense_window(lo, hi).astype(np.int32)
                + extra[: sub.n_cells_dp], 0xFFFF
            ).astype(np.uint16)
            total = p.total[lo:hi] + np.bincount(
                ex.cells, minlength=sub.n_cells
            )[: sub.n_cells_dp].astype(np.int32)
            # ranks: the level-2 parse's data lists persist; level-1 kmers
            # append after them (lib/contig.c:721-733, no base_clean_data)
            rank = pl.event_ranks(
                ex.cells[ex.cells < sub.n_cells_dp],
                ex.kmers()[ex.cells < sub.n_cells_dp].astype(np.int64),
                sub.n_cells_dp, base_ndistinct=p.ndistinct(lo, hi),
                base_rank=p.rank_window(lo, hi))
            problems.append((counts, p.refkmer[lo:hi], total, rank))
            metas.append((sub, sub_cell0, counts, total))
        for choice, (sub, sub_cell0, counts, total) in zip(
                run_chain_batch(problems, rate, device=device), metas):
            _apply_choice(state, sub.n_cells_dp, choice, counts, total,
                          sub_cell0, cfg)


def _apply_correction_sparse(state: ContigState, p, cell0: int, rate: float,
                             cfg: AlgoConfig, device=None) -> None:
    n_dp = p.index.n_cells_dp
    packed = dispatch_chain_sparse(p.uk, p.cn, p.rk, p.refkmer, p.total,
                                   n_dp, rate,
                                   cov_ratio=cfg.min_count_ratio_skip,
                                   device=device)
    _finish_correction_sparse(state, n_dp, cell0, packed.cpu().numpy(), cfg)


def _apply_choice(state: ContigState, n_dp: int, choice: np.ndarray,
                  counts: np.ndarray, total_arr: np.ndarray, cell0: int,
                  cfg: AlgoConfig) -> None:
    cells = cell0 + np.arange(n_dp)
    state.base[cells] = choice[:n_dp]
    total = total_arr[:n_dp].astype(np.int64)
    state.update_flags(cells, total == 1, FLAG_ZERO)
    cov = _coverage_of(counts[:n_dp], choice[:n_dp])
    low = cov < cfg.min_count_ratio_skip * np.maximum(total, 1)
    state.update_flags(cells, low, FLAG_COVERAGE)


class _Launch:
    """One dispatched chain DP: the result bytes (pinned host memory on a
    card, filled once `done` fires), the CUDA events around the device
    work, and what must stay alive until then."""

    def __init__(self, out, done=None, events=(), keep=()):
        self.out = out
        self.done = done
        self.events = events
        self.keep = keep

    def wait(self) -> np.ndarray:
        """The result bytes [B, L] (the finish thread calls this; the
        time between the launch's two CUDA events is added to
        task1.kernel once: the host's enqueue of the DP's ops plus their
        device time, so an upper bound on the device time, which
        chip_smoke.py measures apart as task1.dp_device_ms)."""
        if self.done is not None:
            self.done.synchronize()
            k0, k1 = self.events
            trace.add("task1.kernel", k0.elapsed_time(k1) / 1e3)
            self.done, self.keep = None, ()
        return self.out.numpy()


class _ChainHandle:
    """One contig staged between host prep and DP finish."""

    __slots__ = ("name", "state", "cell0", "cfg", "draft", "buf", "key",
                 "n_dp", "launch", "lane", "done", "batch", "levels")

    def __init__(self, name, state, cell0, cfg, draft, buf, key, n_dp,
                 done=None, batch=None, levels=None):
        self.name = name
        self.state = state
        self.cell0 = cell0
        self.cfg = cfg
        self.draft = draft
        self.buf = buf
        self.key = key  # shape bucket (L, Emax, EOV, ET, FMT, TH, PS)
        self.n_dp = n_dp
        self.launch = None  # _Launch, set at dispatch
        self.lane = None  # row in that launch
        self.done = done  # polished bytes of a contig the window route ran
        # the contig's reads until dispatch, for the window route should
        # the free memory have fallen below the launch by then
        self.batch = batch
        self.levels = levels


def launch_cap_cells(device) -> int:
    """Cells one launch may hold on `device`: the free memory at
    LAUNCH_BYTES_PER_CELL, and under MAX_LAUNCH_CELLS."""
    return min(device_free_bytes(device) // LAUNCH_BYTES_PER_CELL,
               MAX_LAUNCH_CELLS - 1)


def score_chain_contig_prep(name: str, draft: bytes, batch: AlnBatch,
                            cfg: AlgoConfig, levels=None,
                            device=None) -> _ChainHandle:
    """Host half of task 1 for one contig: cell index, the native pileup
    walk and the packed DP buffer, no device dispatch.  A contig over the
    single-launch cap on `device` (launch_cap_cells, MAX_LAUNCH_CELLS)
    runs the window route here instead; its handle carries the polished
    bytes in `done`."""
    tid = batch.header.name2id(name)
    L = len(draft)
    if levels is None:
        levels = pl.filter_sgs_chain(batch)
    with trace.timed("task1.walk"):
        index = pl.build_cell_index(batch, levels, tid, 0, L - 1)
    if (index.n_cells >= MAX_LAUNCH_CELLS
            or pad_to_chunk(max(index.n_cells_dp, 1))
            > launch_cap_cells(device)):
        done = score_chain_contig_windowed(name, draft, batch, cfg, device,
                                           levels=levels, index=index)
        return _ChainHandle(name, None, 0, cfg, draft, None, None, 0, done)
    with trace.timed("task1.walk"):
        state = ContigState.from_draft(name, draft, index)
        contig_nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]
        view = state.index.region_view(0, L - 1)
        cell0 = int(state.index.cell_of[0 - state.index.start])
        # the pipeline runs two prep threads; NPT_PILEUP_THREADS pins each
        # walker's width (0: every core)
        wt = int(os.environ.get("NPT_PILEUP_THREADS", "0"))
        fast = pl.build_pileup_planes(batch, levels, 1, view, tid,
                                      contig_nib, cfg.trim_len_edge,
                                      n_threads=wt)
        if fast is None:
            p = pl.build_pileup_sparse(batch, levels, 1, view, tid,
                                       contig_nib, cfg.trim_len_edge)
    with trace.timed("task1.pack"):
        if fast is not None:
            trace.count("task1.native_walks", 1)
            upper, c0, totals, stats, ov, refkmer = fast
            buf, *shape = pack_chain_planes_parts(
                upper, c0, totals, stats, ov, refkmer, view.n_cells_dp,
                cfg.indel_balance_factor_sgs,
                cov_ratio=cfg.min_count_ratio_skip)
        else:
            buf, *shape = pack_chain_planes(
                p.uk, p.cn, p.rk, p.refkmer, p.total, p.index.n_cells_dp,
                cfg.indel_balance_factor_sgs,
                cov_ratio=cfg.min_count_ratio_skip)
    return _ChainHandle(name, state, cell0, cfg, draft, buf, tuple(shape),
                        view.n_cells_dp, batch=batch, levels=levels)


# one launch's device work is enqueued whole before the next one's, so the
# CUDA events around it time that launch alone
_DISPATCH_LOCK = threading.Lock()


def dispatch_chain_group(handles: list, device=None) -> None:
    """ONE chain DP launch for handles of one shape bucket: the buffers go
    through pinned host memory to the device, the DP runs on the current
    stream, and the result bytes come back into pinned memory, closed by
    a CUDA event (returns at once on a card; on the CPU the DP runs
    here).  A contig whose launch no longer fits the free memory (it fell
    since the contig was routed) runs the window route here instead."""
    dev = resolve_device(device)
    h0 = handles[0]
    B, L = len(handles), h0.key[0]
    if B * L > launch_cap_cells(dev):
        if B > 1:  # each contig alone fitted when it was routed
            for h in handles:
                dispatch_chain_group([h], dev)
            return
        h0.done = score_chain_contig_windowed(
            h0.name, h0.draft, h0.batch, h0.cfg, dev, levels=h0.levels,
            index=h0.state.index)
        h0.state = h0.buf = h0.batch = h0.levels = None
        return
    with trace.timed("task1.dispatch"):
        host = torch.empty((B, len(h0.buf)), dtype=torch.int16,
                           pin_memory=dev.type == "cuda")
        hv = host.numpy()
        for i, h in enumerate(handles):
            hv[i] = h.buf.view(np.int16)
        if dev.type == "cpu":
            launch = _Launch(chain_correct_planes_batch(host, *h0.key))
        else:
            with _DISPATCH_LOCK, torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev)
                dbuf = host.to(dev, non_blocking=True)
                k0 = torch.cuda.Event(enable_timing=True)
                k1 = torch.cuda.Event(enable_timing=True)
                k0.record(stream)
                packed = chain_correct_planes_batch(dbuf, *h0.key)
                k1.record(stream)
                out = torch.empty(packed.shape, dtype=torch.int8,
                                  pin_memory=True)
                out.copy_(packed, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            launch = _Launch(out, done, (k0, k1), (host, dbuf, packed))
    for i, h in enumerate(handles):
        h.launch = launch
        h.lane = i
        h.buf = h.batch = h.levels = None  # the pack buffer is staged now
    trace.count("task1.chain_cells", L * B)
    trace.count("task1.chain_launches", 1)


def score_chain_contig_end(handle: _ChainHandle) -> bytes:
    """Stage 2: wait for the DP result, apply flags, emit the polished
    sequence."""
    h = handle
    if h.done is not None:  # the window route finished it in prep
        return h.done
    with trace.timed("task1.wait"):
        packed = h.launch.wait()[h.lane]
    with trace.timed("task1.host"):
        _finish_correction_sparse(h.state, h.n_dp, h.cell0, packed, h.cfg)
        maybe_trace(h.cfg, h.state.name, h.state, h.draft)
        return h.state.emit(FLAG_ZERO | FLAG_COVERAGE)


def score_chain_contig(name: str, draft: bytes, batch: AlnBatch,
                       cfg: AlgoConfig, device=None) -> bytes:
    """Task 1 entry for one contig: polished sequence bytes
    (score_chain, lib/scorechain.c:3-15)."""
    h = score_chain_contig_prep(name, draft, batch, cfg, device=device)
    if h.done is None:
        dispatch_chain_group([h], device)
    return score_chain_contig_end(h)


def score_chain_pipeline(names_seqs, batch, cfg: AlgoConfig, device=None):
    """Software-pipelined task 1 over contigs (the reference's
    multiprocessing Pool over contigs, lib/nextpolish1.py:223-224).
    Three overlapped stages per contig:

      prep (two worker threads): BAM fetch + cell index + native pileup
            walk + buffer packing (the walker releases the GIL); with
            NPT_CHAIN_BATCH=1 (the default) the prep thread also
            dispatches its contig's launch;
      device: contigs of one shape bucket batch NPT_CHAIN_BATCH to a
            launch; a launch returns at once;
      finish (main thread): wait for the result bytes, flags + FASTA.

    Yields (name, polished bytes) in order.  `batch` may be a region
    source (anything with .fetch / .header, e.g. io.bamregion.IndexedBam):
    each contig's reads are then fetched on demand, so peak RAM is a few
    contigs, not the whole BAM."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    dev = resolve_device(device)
    streaming = hasattr(batch, "fetch")
    shared_levels = None if streaming else pl.filter_sgs_chain(batch)
    G = max(1, int(os.environ.get("NPT_CHAIN_BATCH", "1")))

    def prep(name, seq):
        with trace.timed("task1.host"):
            if streaming:
                with trace.timed("task1.fetch"):
                    tid = batch.header.name2id(name)
                    cbatch = batch.fetch(tid, 0, max(len(seq) - 1, 0))
                    clevels = pl.filter_sgs_chain(cbatch)
            else:
                cbatch, clevels = batch, shared_levels
            h = score_chain_contig_prep(name, seq, cbatch, cfg,
                                        levels=clevels, device=dev)
            if G == 1 and h.done is None:
                dispatch_chain_group([h], dev)
            return h

    staged: dict = {}  # shape bucket -> [handle] awaiting dispatch

    def flush(bucket=None):
        for b in ([bucket] if bucket is not None else list(staged)):
            hs = staged.pop(b, [])
            if hs:
                with trace.timed("task1.host"):
                    dispatch_chain_group(hs, dev)

    def stage(h):
        if G == 1 or h.done is not None:
            return  # dispatched in the prep thread, or windowed there
        staged.setdefault(h.key, []).append(h)
        if len(staged[h.key]) >= G:
            flush(h.key)

    # two prep workers: finish-side host work is small, so the main thread
    # mostly waits, and a second walker keeps both cores busy
    with ThreadPoolExecutor(max_workers=2) as pool:
        it = iter(names_seqs)
        # a streaming source shares one file handle and block cache, so
        # its fetches run one at a time; in-memory batches keep enough
        # preps in flight to fill a launch
        prep_depth = 1 if streaming else max(2, G)
        futq: deque = deque()
        for nxt in it:
            futq.append((nxt[0], pool.submit(prep, *nxt)))
            if len(futq) >= prep_depth:
                break
        pending: deque = deque()  # handles in input order
        # results are fetched several contigs behind their dispatch; a
        # streaming source keeps the window tight (every pending handle
        # holds a contig's state in RAM)
        win = 2 if streaming else max(4, G)
        while futq:
            name, fut = futq.popleft()
            h = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                futq.append((nxt[0], pool.submit(prep, *nxt)))
            stage(h)
            pending.append((name, h))
            if len(pending) > win:
                pname, ph = pending.popleft()
                if ph.launch is None and ph.done is None:
                    flush(ph.key)
                yield pname, score_chain_contig_end(ph)
        flush()
        while pending:
            pname, ph = pending.popleft()
            yield pname, score_chain_contig_end(ph)


def score_chain_contig_windowed(name: str, draft: bytes, batch: AlnBatch,
                                cfg: AlgoConfig, device=None, levels=None,
                                index=None) -> bytes:
    """Task 1 for ONE contig past the single-launch cap, as a sequence of
    windows on one device (the JAX package's score_chain_contig_sharded on
    one reads shard).  The contig's sparse pileup walks once on the host
    (the native sparse walker, whose keys pack as (cell*512+kmer) << 9,
    so MAX_LAUNCH_CELLS does not bind it); each window of Wc cells
    (SHARD_WINDOW_CELLS, halved while free memory at WINDOW_BYTES_PER_CELL
    demands it) runs parallel/shard.py's forward
    half, whose state vector chains into the next window through s0
    (pointer decisions are shift-invariant, so windowing is byte-exact),
    and the traceback stitches backward from the contig end, resolving
    each window's first-cell running-max placeholder (b_prev == 0) to
    the previous window's msel.  Byte-equal to the single launch by test
    (including a boundary pinned on a divergence-prone cell).  `index`
    is the contig's cell index when the caller has built it.

    Trace: task1.windows (windows run), task1.window_kernel (per window,
    CUDA events around its forward and traceback on a card)."""
    dev = resolve_device(device)
    tid = batch.header.name2id(name)
    Lc = len(draft)
    if levels is None:
        levels = pl.filter_sgs_chain(batch)
    with trace.timed("task1.walk"):
        if index is None:
            index = pl.build_cell_index(batch, levels, tid, 0, Lc - 1)
        state = ContigState.from_draft(name, draft, index)
        contig_nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]
        view = state.index.region_view(0, Lc - 1)
        cell0 = int(state.index.cell_of[0])
        n_dp = view.n_cells_dp
        p = pl.build_pileup_sparse(batch, levels, 1, view, tid, contig_nib,
                                   cfg.trim_len_edge)
    maxt = int(p.total[:n_dp].max()) if n_dp else 1
    TH = _pow2(min(maxt + 1, TH_CAP))
    th = coverage_thresholds(TH - 1, cfg.min_count_ratio_skip
                             ).astype(np.int32)
    Wc = min(pad_to_chunk(max(n_dp, 1)), SHARD_WINDOW_CELLS)
    while (Wc > CHUNK and pad_to_chunk(Wc) * WINDOW_BYTES_PER_CELL
           > device_free_bytes(dev)):
        Wc //= 2
    # the scan kernels take 128 x a power of two cells; cells past a
    # window's end are identity transitions, which leave every value
    # before them unchanged
    Lw = pad_to_chunk(Wc)
    wlos = list(range(0, max(n_dp, 1), Wc))
    cuda = dev.type == "cuda"

    def events():
        if not cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(dev))
        return e

    rate = cfg.indel_balance_factor_sgs
    th_d = torch.from_numpy(th).to(dev)
    tbs = []  # per window: (Ptab, flags, msel, n_dp_w)
    spans = []  # per window: CUDA events around its forward
    s0 = None
    for w, wlo in enumerate(wlos):
        whi = min(wlo + Wc, n_dp)
        n_dp_w = whi - wlo
        a = int(np.searchsorted(p.uk, wlo * K3))
        b = int(np.searchsorted(p.uk, whi * K3))
        uk = torch.from_numpy(p.uk[a:b] - wlo * K3).to(dev)
        cn = torch.from_numpy(np.minimum(p.cn[a:b], 0xFFFF).astype(np.int32))
        key = torch.from_numpy(p.rk[a:b].astype(np.int32))
        total = np.zeros(Lw, dtype=np.int32)
        total[:n_dp_w] = p.total[wlo:whi]
        refkmer = np.zeros(Lw, dtype=np.int32)
        refkmer[:n_dp_w] = p.refkmer[wlo:whi]
        e0 = events()
        Ptab, flags, msel, fend = reads_merge_fwd(
            uk, cn.to(dev), key.to(dev), torch.from_numpy(total).to(dev),
            torch.from_numpy(refkmer).to(dev), th_d, rate, n_dp_w, s0,
            w == 0, Lw)
        spans.append([e0, events()])
        tbs.append((Ptab, flags, msel, n_dp_w))
        s0 = fend

    # backward stitch: the traceback seed of window w is the base its
    # successor's first-cell pointer demands
    last_P, last_flags, last_msel, last_n = tbs[-1]
    b_end = last_msel[last_n - 1]
    packs = [None] * len(tbs)
    for w in range(len(tbs) - 1, -1, -1):
        Ptab, flags, msel, n_dp_w = tbs[w]
        e0 = events()
        packed, b_prev = merge_traceback(Ptab, flags, b_end)
        spans[w] += [e0, events()]
        packs[w] = packed[:n_dp_w]
        if w:
            # P[0]'s wb2 branch never yields 0, so b_prev == 0 marks the
            # first-cell placeholder: the winning kmer chains through the
            # running max, whose true predecessor is the PREVIOUS window's
            # base_max_score pick at its last valid cell
            pmsel, pn = tbs[w - 1][2], tbs[w - 1][3]
            b_end = torch.where(b_prev == 0, pmsel[pn - 1], b_prev)
        tbs[w] = None
    packed = torch.cat(packs).cpu().numpy()
    if cuda:
        for f0, f1, t0, t1 in spans:
            trace.add("task1.window_kernel",
                      (f0.elapsed_time(f1) + t0.elapsed_time(t1)) / 1e3)
    trace.count("task1.windows", len(wlos))
    trace.count("task1.chain_cells", Lw * len(wlos))
    _finish_correction_sparse(state, n_dp, cell0, packed, cfg)
    maybe_trace(cfg, name, state, draft)
    return state.emit(FLAG_ZERO | FLAG_COVERAGE)


def td_score_chain_contig(name: str, draft: bytes, batch: AlnBatch,
                          cfg: AlgoConfig, device=None) -> bytes:
    """Legacy long-read chain variant (td_score_chain1, lib/scorechain.c:17-29):
    lgs filter, lgs balance factor, no lowercase flags in output.  The
    chain DP runs on `device` (default cuda), one launch for the contig."""
    tid = batch.header.name2id(name)
    L = len(draft)
    levels = pl.filter_lgs(batch, cfg.max_clip_ratio_lgs)
    index = pl.build_cell_index(batch, levels, tid, 0, L - 1)
    state = ContigState.from_draft(name, draft, index)
    contig_nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]
    score_correct_region(state, batch, levels, tid, contig_nib, 0, L - 1,
                         filterlevel=1, rate=cfg.indel_balance_factor_lgs,
                         cfg=cfg, device=device)
    maybe_trace(cfg, name, state, draft)
    return state.emit(0)
