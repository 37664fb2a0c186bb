"""Task 1's window route in the port (models/score_chain.py::
score_chain_contig_windowed on parallel/shard.py) on the CPU: a contig
split into at least 3 windows gives the bytes of the port's single launch
and of the JAX package's score_chain_contig_sharded on a one-device mesh,
also with a window boundary pinned on a divergence-prone cell (where the
backward stitch must resolve the first-cell placeholder)."""
import jax.numpy as jnp
import numpy as np
import pytest

import nextpolish_tpu.models.score_chain as jax_sc
from nextpolish_tpu.io import bam as jax_bam
from nextpolish_tpu.parallel.shard import reads_mesh
from nextpolish_tpu_torch.io.bam import read_bam
from nextpolish_tpu_torch.models import score_chain as tsc
from nextpolish_tpu_torch.runtime import trace
from util_sim import random_messy_records, records_to_batch


def _case(tmp_path, seed, L=6000, n_reads=500):
    """test_shard_merge.py's case: a random draft with messy reads, as the
    JAX package's batch and as the port's (read back from a BAM)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    draft = rng.choice(bases, L).tobytes()
    recs = random_messy_records(rng, L, n_reads=n_reads)
    path = str(tmp_path / f"c{seed}.bam")
    hdr = jax_bam.BamHeader("", ["ctg1"], [L])
    jax_bam.write_bam(path, hdr, sorted(recs, key=lambda r: r["pos"]))
    return draft, records_to_batch(recs, L), read_bam(path)


def _three_ways(draft, jbatch, tbatch, window, monkeypatch):
    cfg_j, cfg_t = jax_sc.AlgoConfig(), tsc.AlgoConfig()
    single = tsc.score_chain_contig("ctg1", draft, tbatch, cfg_t,
                                    device="cpu")
    trace.reset("task1")
    monkeypatch.setattr(tsc, "SHARD_WINDOW_CELLS", window)
    windowed = tsc.score_chain_contig_windowed("ctg1", draft, tbatch, cfg_t,
                                               device="cpu")
    n_win = trace.snapshot("task1.windows")["task1.windows"]["s"]
    monkeypatch.setattr(jax_sc, "SHARD_WINDOW_CELLS", window)
    jax_out = jax_sc.score_chain_contig_sharded("ctg1", draft, jbatch, cfg_j,
                                                reads_mesh(1))
    return single, windowed, jax_out, n_win


def test_windowed_contig_matches_single_launch_and_jax(tmp_path,
                                                       monkeypatch):
    draft, jbatch, tbatch = _case(tmp_path, 1)
    single, windowed, jax_out, n_win = _three_ways(draft, jbatch, tbatch,
                                                   2048, monkeypatch)
    assert n_win >= 3
    assert windowed == single
    assert windowed == jax_out


def _prone_cells(draft, jbatch):
    """128-aligned cells where the traceback-chosen base's winning kmer
    chains through the running max (wb2 == 0) while msel at the previous
    cell is nonzero (test_shard_merge.py's search, on the JAX package)."""
    import nextpolish_tpu.ops.pileup as pl
    from nextpolish_tpu.io.fasta import ASCII_TO_NIB
    from nextpolish_tpu.models.contig_state import ContigState
    from nextpolish_tpu.ops import tropical as tr
    from nextpolish_tpu.ops.symbols import K3, S

    cfg = jax_sc.AlgoConfig()
    tid = jbatch.header.name2id("ctg1")
    levels = pl.filter_sgs_chain(jbatch)
    index = pl.build_cell_index(jbatch, levels, tid, 0, len(draft) - 1)
    state = ContigState.from_draft("ctg1", draft, index)
    nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]
    view = state.index.region_view(0, len(draft) - 1)
    p = pl.build_pileup_sparse(jbatch, levels, 1, view, tid, nib,
                               cfg.trim_len_edge)
    n_dp = p.index.n_cells_dp
    Lp = tr.pad_to_chunk(n_dp)
    hi = int(np.searchsorted(p.uk, n_dp * K3))
    counts = np.zeros(Lp * K3, np.int32)
    counts[p.uk[:hi]] = np.minimum(p.cn[:hi], 0xFFFF)
    counts = counts.reshape(Lp, K3)
    rank = np.full(Lp * K3, 0xFFFF, np.uint16)
    rank[p.uk[:hi]] = p.rk[:hi]
    rank = rank.reshape(Lp, K3)
    refk = np.zeros(Lp, np.int32)
    refk[:n_dp] = p.refkmer[:n_dp]
    total = np.zeros(Lp, np.int32)
    total[:n_dp] = p.total[:n_dp]
    valid = np.arange(Lp) < n_dp
    s0 = tr.init_state_sparse(p.uk[:int(np.searchsorted(p.uk, K3))])
    rate = np.float32(cfg.indel_balance_factor_sgs)
    em = tr.emission(jnp.asarray(counts), jnp.asarray(refk),
                     jnp.asarray(total), rate)
    A = tr.build_transition(em)
    A = jnp.where(jnp.asarray(valid)[:, None, None], A, tr._eye()[None])
    f = tr._forward_states(A, jnp.asarray(s0), 128)
    fprev = jnp.concatenate([jnp.asarray(s0)[None], f[:-1]], axis=0)
    emr = em.reshape(Lp, S * S, S)
    obsr = emr > tr.NEG * 0.5
    gath = fprev[:, jnp.arange(S * S, dtype=jnp.int32) % S]
    sc_e = jnp.where(obsr, gath[:, :, None] + emr, tr.NEG)
    V = jnp.max(sc_e, axis=1)
    rkr = jnp.where(obsr, jnp.asarray(rank).reshape(Lp, S * S, S)
                    .astype(jnp.int32), tr.RANK_BIG)
    winner = (sc_e == V[:, None, :]) & obsr
    wb2 = np.asarray(jnp.argmin(jnp.where(winner, rkr, tr.RANK_BIG),
                                axis=1) % S)
    Rm = jnp.min(rkr, axis=1)
    lane_obs = jnp.any(obsr, axis=1)
    Vmax = jnp.max(jnp.where(lane_obs, V, tr.NEG), axis=1)
    cand = (V == Vmax[:, None]) & lane_obs
    msel = np.asarray(jnp.argmin(jnp.where(cand, Rm, tr.RANK_BIG), axis=1))
    packed = np.asarray(tr.dispatch_chain_sparse(
        p.uk, p.cn, p.rk, p.refkmer, p.total, n_dp, float(rate)))[:n_dp]
    choice = packed & 7
    return [c for c in range(128, n_dp - 1, 128)
            if wb2[c, choice[c]] == 0 and msel[c - 1] != 0], n_dp


def test_windowed_stitch_divergence_prone_boundary(tmp_path, monkeypatch):
    """A window boundary on a divergence-prone cell, with at least 3
    windows: the port's stitch substitutes the previous window's msel for
    the placeholder, as the JAX package's does."""
    draft, jbatch, tbatch = _case(tmp_path, 3)
    prone, n_dp = _prone_cells(draft, jbatch)
    fit = [c for c in prone if -(-n_dp // c) >= 3]
    assert fit, "case no longer has a divergence-prone cell for 3 windows"
    window = max(fit)
    single, windowed, jax_out, n_win = _three_ways(draft, jbatch, tbatch,
                                                   window, monkeypatch)
    assert n_win >= 3
    assert windowed == single
    assert windowed == jax_out


@pytest.mark.parametrize("free_bytes", [1 << 40, 3 << 24])
def test_window_shrinks_to_free_memory(tmp_path, monkeypatch, free_bytes):
    """With little free memory the window halves until it fits, and the
    bytes stay those of the single launch."""
    draft, _, tbatch = _case(tmp_path, 2, L=3000, n_reads=250)
    cfg = tsc.AlgoConfig()
    want = tsc.score_chain_contig("ctg1", draft, tbatch, cfg, device="cpu")
    monkeypatch.setattr(tsc, "device_free_bytes", lambda dev: free_bytes)
    trace.reset("task1")
    got = tsc.score_chain_contig_windowed("ctg1", draft, tbatch, cfg,
                                          device="cpu")
    n_win = trace.snapshot("task1.windows")["task1.windows"]["s"]
    assert got == want
    # 3 << 24 B at 2^15 B a cell: 1,024-cell windows over > 3,000 cells
    assert n_win == 1 if free_bytes == 1 << 40 else n_win >= 3


def test_launch_falls_back_to_windows_when_memory_falls(tmp_path,
                                                       monkeypatch):
    """A contig routed to one launch whose free memory has fallen below
    the launch by dispatch (a second prep thread took it) runs the window
    route on the same device instead, with the single launch's bytes."""
    draft, _, tbatch = _case(tmp_path, 2, L=3000, n_reads=250)
    cfg = tsc.AlgoConfig()
    want = tsc.score_chain_contig("ctg1", draft, tbatch, cfg, device="cpu")
    h = tsc.score_chain_contig_prep("ctg1", draft, tbatch, cfg,
                                    device="cpu")
    assert h.done is None  # routed to one launch
    # one cell short of the launch; windows of a 16th of it fit
    free = h.key[0] * tsc.LAUNCH_BYTES_PER_CELL - 1
    monkeypatch.setattr(tsc, "device_free_bytes", lambda dev: free)
    trace.reset("task1")
    tsc.dispatch_chain_group([h], "cpu")
    snap = trace.snapshot("task1")
    assert snap["task1.windows"]["s"] >= 3
    assert "task1.chain_launches" not in snap
    assert h.launch is None and h.batch is None
    assert tsc.score_chain_contig_end(h) == want
