"""Task 1's window route and its reads-sharded merge: port of
nextpolish_tpu/parallel/shard.py's make_reads_merge_fwd (its inner `fwd`)
and make_merge_traceback (its inner `tb`).

A contig too large for one chain launch, or one whose reads are sharded
over several devices, runs as a sequence of windows
(models/score_chain.py::score_chain_contig_sharded).  Per window,
`reads_merge_fwd` scatters each reads shard's sorted sparse pileup dense
on that shard's device (`scatter_shard`), merges the shards on the first
device (`merge_shards`: SUM of the counts and totals, MIN of the
first-observation keys, the u16 clamp after the sum; the JAX package's
psum/pmin over the 'reads' mesh axis, here peer copies and torch ops in
one process), and runs once, on that device, the ranks and
ops/chain.py's chain_pointers (the emission, the transitions, the forward
scan `chain_forward` and the pointer table), seeded by s0 from the first
cell's prefixes (window 0) or by the previous window's end state
(`window_forward`).  The JAX package computes the merged forward on
every chip (replicated outputs); the bytes are the same.
`merge_traceback` walks one window back (`chain_traceback`) from the
base its successor demands.

Not ported: make_sharded_polish_step, shard_inputs and make_mesh (only
the JAX package's dryrun uses them).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import chain as ch
from ..ops.chain import CHUNK, FLAGB_COV, FLAGB_ZERO, NEG, chain_pointers
from ..ops.symbols import K3, S

KBIG = np.int32(0x7FFFFFFF)  # first-observation key for unobserved slots


def scatter_shard(uk, cn, key, L: int):
    """One reads shard's window dense, on the shard's own device: uk [E]
    int64 sorted window-local keys cell*512+kmer (cells < L), cn [E]
    counts (each under 0x10000), key [E] int32 first-observation keys
    ((shard << 16) | per-cell rank).  Returns (counts [L*512] int32,
    keys [L*512] int32, KBIG where unobserved)."""
    i32 = torch.int32
    dense = torch.zeros(L * K3, dtype=i32, device=uk.device).index_add_(
        0, uk, cn.to(i32))
    kd = torch.full((L * K3,), int(KBIG), dtype=i32, device=uk.device)
    kd.scatter_reduce_(0, uk, key.to(i32), reduce="amin")
    return dense, kd


def merge_shards(scattered, totals, dev, events=None):
    """The reads shards' all-reduce on `dev`: SUM of the dense counts and
    of the totals [L], MIN of the first-observation keys, then the u16
    clamp (after the sum, as the JAX package clamps after its psum, so a
    count split over shards clamps as the whole count does).  Each
    shard's tensors come over by a peer copy (none when a shard already
    lies on `dev`); the first shard's become the result.  On a card, the
    CUDA events around the reduction are appended to `events` when it is
    a list.  Returns (counts [L, 512] int32, kmin [L, 512] int32, total
    [L] int32)."""
    timed = events is not None and dev.type == "cuda"
    if timed:
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record(torch.cuda.current_stream(dev))
    (counts, kmin), total = scattered[0], totals[0]
    counts, kmin = counts.to(dev), kmin.to(dev)
    total = total.to(dev, dtype=torch.int32, copy=True)
    for (dense, kd), tot in zip(scattered[1:], totals[1:]):
        counts.add_(dense.to(dev, non_blocking=True))
        torch.minimum(kmin, kd.to(dev, non_blocking=True), out=kmin)
        total.add_(tot.to(dev, non_blocking=True))
    counts.clamp_max_(0xFFFF)
    if timed:
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record(torch.cuda.current_stream(dev))
        events.append((e0, e1))
    L = total.shape[0]
    return counts.reshape(L, K3), kmin.reshape(L, K3), total


def window_forward(counts, kmin, total, refkmer, th, rate, n_dp: int,
                   s0_in, first: bool, chunk: int = CHUNK):
    """Forward half of one merged window on one device: counts / kmin [L,
    512] int32 from merge_shards, total / refkmer [L] int32 (zero past
    n_dp), th [TH] int32 coverage LUT, rate a float, s0_in [8] f32 (the
    previous window's end state; unused when `first`); L = 128 x a power
    of two.  Returns (P [L, 8] int8 predecessor table, flags [L] int16
    (zero bit 8 | per-base low-coverage bits 0-7), msel [L] int8, fend
    [8] f32 state at the window's last valid cell)."""
    dev = refkmer.device
    i32 = torch.int32
    L = counts.shape[0]
    obs = counts > 0
    # merged per-cell insertion order: rank of each observed kmer by its
    # min first-observation key (argsort, then the inverse permutation,
    # which is the second argsort of the JAX function; keys are unique
    # per cell among observed)
    order = torch.argsort(torch.where(obs, kmin, int(KBIG)), dim=1,
                          stable=True)
    del kmin
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(K3, device=dev).expand(L, K3))
    del order
    rank = torch.where(obs, rank, 0xFFFF).to(i32)
    valid = torch.arange(L, device=dev) < n_dp
    lanes = torch.arange(S, device=dev)
    if first:
        # window 0 seeds from the first cell's observed prefixes (the C
        # `temp` seed, lib/contig.c:456-464)
        pref = counts[0].reshape(S, S, S).sum(dim=(0, 2)) > 0
        s0 = torch.where(pref | (lanes == 0), 0.0, float(NEG)).to(
            torch.float32)
    else:
        s0 = s0_in.to(torch.float32)
    f, Ptab, msel = chain_pointers(counts[None], rank[None], refkmer[None],
                                   total[None], valid[None], rate, s0[None],
                                   chunk)
    del rank
    fend = f[0, max(n_dp - 1, 0)]
    covb = counts.reshape(L, S * S, S).sum(dim=1)  # [L, S]
    lowb = covb < th[torch.clamp_max(total, len(th) - 1).long()][:, None]
    flags = ((lowb.to(i32) << lanes.to(i32)).sum(dim=1)
             | ((total == 1).to(i32) << S)).to(torch.int16)
    return Ptab[0].to(torch.int8), flags, msel[0].to(torch.int8), fend


def reads_merge_fwd(shards, refkmer, th, rate, n_dp: int, s0_in,
                    first: bool, L: int, chunk: int = CHUNK, events=None):
    """Forward half of one window over its reads shards: `shards` holds
    per shard (uk, cn, key, total [L]) on that shard's device (see
    scatter_shard); refkmer, th and s0_in lie on the device the merged
    window runs on, which returns everything (see window_forward);
    `events` as merge_shards takes it.  Every shard scatters before the
    merge waits on any."""
    # the merged tensors pass straight on, so window_forward frees each
    # as soon as it is done with it
    return window_forward(
        *merge_shards([scatter_shard(uk, cn, key, L)
                       for uk, cn, key, _ in shards],
                      [s[3] for s in shards], refkmer.device, events),
        refkmer, th, rate, n_dp, s0_in, first, chunk)


def merge_traceback(Ptab, flags, b_end, chunk: int = CHUNK):
    """Traceback half of one window: given its predecessor table P [L, 8]
    int8, flags [L] int16 and the base chosen at its last cell (a 0-dim
    tensor: the next window's demand, or msel at the contig end), the
    packed per-cell result byte [L] int8 (choice | FLAG_ZERO bit 3 |
    FLAG_COVERAGE bit 4) and the base the PREVIOUS window must end with.
    b_prev == 0 is a PLACEHOLDER, not a real base: cell 0's pointer row
    uses msel_prev[0] = 0 when the winning kmer chains through the running
    max (wb2 == 0 — that branch never yields 0 itself), and the caller
    substitutes the previous window's msel at its last valid cell."""
    i32 = torch.int32
    choice = ch.traceback_batch(Ptab.to(i32)[None].contiguous(),
                                b_end.to(i32).reshape(1), chunk)[0]
    fl = flags.to(i32)
    low = (fl >> choice.to(i32)) & 1
    zero = (fl >> S) & 1
    packed = (choice.to(i32) | (zero << FLAGB_ZERO)
              | (low << FLAGB_COV)).to(torch.int8)
    b_prev = Ptab[0, choice[0].long()]
    return packed, b_prev
