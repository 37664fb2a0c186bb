"""Task 1 — short-read score-chain correction (lib/scorechain.c:3-15), port
of nextpolish_tpu/models/score_chain.py (the slot-plane path).

Per contig:
  read filter level (contig_read_fliter1) -> insert-slot discovery -> the
  native pileup walk straight into the chain DP's transfer planes -> the
  chain DP on the device (ops/chain.py: PyTorch ops around the two CUDA
  scan kernels) -> corrected bases + flags -> FASTA emission with
  FLAG_ZERO|FLAG_COVERAGE lowercasing.

A launch runs one contig, or NPT_CHAIN_BATCH contigs of one shape bucket,
whole: the TPU's 1 Mb window route (NPT_CHAIN_WINDOW_BASES, a lane-padding
limit) has no counterpart here.  A launch is capped by the device's free
memory and, because native/pileup.cpp packs overflow keys as
(cell*512+kmer) << 28 in an int64, by 2^26 cells; a contig past either
cap raises (the windowed multi-device route is ROADMAP A6).

Not ported here: score_correct_region, _apply_choice and the dense
batched chain (only task 2's no-depth rescue reaches them: ROADMAP A4),
score_chain_contig_sharded / score_chain_pipeline_multichip (A6) and the
round-robin over several devices.
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
    FLAGB_COV,
    FLAGB_ZERO,
    chain_correct_planes_batch,
    pack_chain_planes,
    pack_chain_planes_parts,
)
from ..runtime import trace
from ..runtime.budget import device_free_bytes
from .contig_state import ContigState, maybe_trace
from .flags import FLAG_COVERAGE, FLAG_ZERO

# native/pileup.cpp:463 packs (cell*512 + kmer) << 28 into an int64
MAX_LAUNCH_CELLS = 1 << 26
# device bytes one cell of a launch may take at its peak (the decoded
# planes, the [L, 64] lattice twice, f, pointers and flags, with room);
# a launch must fit the free memory at this rate
LAUNCH_BYTES_PER_CELL = 2048


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
        device time is added to task1.kernel once)."""
        if self.done is not None:
            self.done.synchronize()
            k0, k1 = self.events
            trace.add("task1.kernel", k0.elapsed_time(k1) / 1e3)
            self.done, self.keep = None, ()
        return self.out.numpy()


class _ChainHandle:
    """One contig staged between host prep and DP finish."""

    __slots__ = ("name", "state", "cell0", "cfg", "draft", "buf", "key",
                 "n_dp", "launch", "lane")

    def __init__(self, name, state, cell0, cfg, draft, buf, key, n_dp):
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


def launch_cap_cells(device) -> int:
    """Cells one launch may hold on `device`: the free memory at
    LAUNCH_BYTES_PER_CELL, and under MAX_LAUNCH_CELLS."""
    return min(device_free_bytes(device) // LAUNCH_BYTES_PER_CELL,
               MAX_LAUNCH_CELLS - 1)


def _refuse(what: str, cells: int, cap: int, why: str):
    raise RuntimeError(
        f"{what}: {cells} cells exceed the single-launch cap of {cap} cells "
        f"({why}); contigs this large need the windowed multi-device route "
        "(ROADMAP A6), which the port does not have yet")


def score_chain_contig_prep(name: str, draft: bytes, batch: AlnBatch,
                            cfg: AlgoConfig, levels=None) -> _ChainHandle:
    """Host half of task 1 for one contig: cell index, the native pileup
    walk and the packed DP buffer, no device dispatch."""
    tid = batch.header.name2id(name)
    L = len(draft)
    if levels is None:
        levels = pl.filter_sgs_chain(batch)
    with trace.timed("task1.walk"):
        index = pl.build_cell_index(batch, levels, tid, 0, L - 1)
        if index.n_cells >= MAX_LAUNCH_CELLS:
            _refuse(f"contig {name}", index.n_cells, MAX_LAUNCH_CELLS - 1,
                    "native/pileup.cpp packs cell*512+kmer << 28 in an int64")
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
                        view.n_cells_dp)


# one launch's device work is enqueued whole before the next one's, so the
# CUDA events around it time that launch alone
_DISPATCH_LOCK = threading.Lock()


def dispatch_chain_group(handles: list, device=None) -> None:
    """ONE chain DP launch for handles of one shape bucket: the buffers go
    through pinned host memory to the device, the DP runs on the current
    stream, and the result bytes come back into pinned memory, closed by
    a CUDA event (returns at once on a card; on the CPU the DP runs
    here)."""
    dev = resolve_device(device)
    h0 = handles[0]
    B, L = len(handles), h0.key[0]
    cap = launch_cap_cells(dev)
    if B * L > cap:
        _refuse(f"launch of {[h.name for h in handles]}", B * L, cap,
                f"free memory on {dev} at {LAUNCH_BYTES_PER_CELL} B a cell")
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
        h.buf = None  # the pack buffer is staged now
    trace.count("task1.chain_cells", L * B)
    trace.count("task1.chain_launches", 1)


def score_chain_contig_end(handle: _ChainHandle) -> bytes:
    """Stage 2: wait for the DP result, apply flags, emit the polished
    sequence."""
    h = handle
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
    h = score_chain_contig_prep(name, draft, batch, cfg)
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
                                        levels=clevels)
            if G == 1:
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
        if G == 1:
            return  # already dispatched in the prep thread
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
                if ph.launch is None:
                    flush(ph.key)
                yield pname, score_chain_contig_end(ph)
        flush()
        while pending:
            pname, ph = pending.popleft()
            yield pname, score_chain_contig_end(ph)
