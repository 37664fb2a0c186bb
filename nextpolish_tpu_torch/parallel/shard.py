"""Task 1's window route on one card: port of nextpolish_tpu/parallel/
shard.py's make_reads_merge_fwd (its inner `fwd`) and make_merge_traceback
(its inner `tb`) for a single reads shard.

A contig too large for one chain launch runs as a sequence of windows
(models/score_chain.py::score_chain_contig_windowed).  Per window,
`reads_merge_fwd` scatters the window's sorted sparse pileup dense on the
device, derives each cell's first-observation ranks, and runs
ops/chain.py's chain_pointers (the emission, the transitions, the forward
scan `chain_forward` and the pointer table), seeded by s0 from the first cell's prefixes (window 0) or
by the previous window's end state; `merge_traceback` walks one window
back (`chain_traceback`) from the base its successor demands.  With one
shard the JAX package's psum/pmin over the 'reads' axis are identities;
the places where several shards would all-reduce (SUM of the counts and
totals, MIN of the first-observation keys) are marked below.

Not ported: make_sharded_polish_step, shard_inputs and make_mesh (only
the JAX package's dryrun uses them) and the several-shard route.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import chain as ch
from ..ops.chain import CHUNK, FLAGB_COV, FLAGB_ZERO, NEG, chain_pointers
from ..ops.symbols import K3, S

KBIG = np.int32(0x7FFFFFFF)  # first-observation key for unobserved slots


def reads_merge_fwd(uk, cn, key, total, refkmer, th, rate, n_dp: int,
                    s0_in, first: bool, L: int, chunk: int = CHUNK):
    """Forward half of one window, one shard.  uk [E] int64 sorted
    window-local keys cell*512+kmer (cells < L), cn [E] int32 counts
    (clamped to 0xFFFF), key [E] int32 first-observation keys, total /
    refkmer [L] int32 (zero past n_dp), th [TH] int32 coverage LUT, rate
    a float, s0_in [8] f32 (the previous window's end state; unused
    when `first`), all on one device; L = 128 x a power of two.  Returns
    (P [L, 8] int8 predecessor table, flags [L] int16 (zero bit 8 |
    per-base low-coverage bits 0-7), msel [L] int8, fend [8] f32 state
    at the window's last valid cell)."""
    dev = refkmer.device
    i32 = torch.int32
    dense = torch.zeros(L * K3, dtype=i32, device=dev).index_add_(
        0, uk, cn.to(i32))
    kd = torch.full((L * K3,), int(KBIG), dtype=i32, device=dev)
    kd.scatter_reduce_(0, uk, key.to(i32), reduce="amin")
    # several shards: all_reduce SUM of dense and total, MIN of kd here
    counts = dense.clamp_max_(0xFFFF).reshape(L, K3)  # u16 clamp
    kmin = kd.reshape(L, K3)
    obs = counts > 0
    # merged per-cell insertion order: rank of each observed kmer by its
    # min first-observation key (argsort, then the inverse permutation,
    # which is the second argsort of the JAX function; keys are unique
    # per cell among observed)
    order = torch.argsort(torch.where(obs, kmin, int(KBIG)), dim=1,
                          stable=True)
    del kd, kmin
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
