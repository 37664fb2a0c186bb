"""The port's dense chain DP (nextpolish_tpu_torch/ops/chain.py: emission,
build_transition, pointers, run_chain_batch) and its window halves
(nextpolish_tpu_torch/parallel/shard.py: reads_merge_fwd, merge_traceback)
against the JAX package's (ops/tropical.py, parallel/shard.py on a
one-device mesh) on the CPU, on inputs drawn with numpy from fixed seeds:
emission and transitions bit-equal, pointers and msel equal, choices
equal, and the window's P, flags, msel and fend bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish_tpu.models import score_chain as jax_sc
from nextpolish_tpu.models.kmer_count import kmer_count_contig
from nextpolish_tpu.ops import tropical as tr
from nextpolish_tpu.parallel import shard as jax_shard
from nextpolish_tpu_torch.ops import chain as ch
from nextpolish_tpu_torch.parallel import shard as tsh
from util_sim import make_draft, rand_seq, records_to_batch, simulate_reads

K3, S = 512, 8


def _dense_case(seed, L, n_dp, per=3):
    """A random dense pileup: counts [L, 512] u16 with `per` observed kmers
    a cell on average (the draft kmer always), first-observation ranks,
    refkmer, totals (some 1, some 0 past n_dp), valid."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((L, K3), dtype=np.uint16)
    rank = np.full((L, K3), 0xFFFF, dtype=np.uint16)
    refk = rng.integers(0, K3, L).astype(np.int32)
    for c in range(n_dp):
        ks = [int(refk[c])] + [int(k) for k in rng.integers(
            0, K3, int(rng.integers(0, 2 * per)))]
        ks = list(dict.fromkeys(ks))
        for r, k in enumerate(ks):
            counts[c, k] = int(rng.integers(1, 40))
            rank[c, k] = r
    total = counts.astype(np.int64).sum(axis=1).astype(np.int32)
    total[rng.random(L) < 0.05] = 1
    total[n_dp:] = 0
    refk[n_dp:] = 0
    valid = np.arange(L) < n_dp
    return counts, rank, refk, total, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _u16(a):
    return _t(a.view(np.int16)).to(torch.int32) & 0xFFFF


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("rate", [0.5, 0.33])
def test_emission_transition_pointers_match_jax(rate):
    """emission and build_transition bit-equal; the pointer table and msel
    equal, from the same fprev (JAX's forward scan)."""
    L, n_dp = 512, 470
    counts, rank, refk, total, valid = _dense_case(1, L, n_dp)
    em_j = tr.emission(jnp.asarray(counts), jnp.asarray(refk),
                       jnp.asarray(total), np.float32(rate))
    em_t = ch.emission(_u16(counts)[None], _t(refk)[None], _t(total)[None],
                       rate)[0]
    assert np.array_equal(_bits(em_t.numpy()), _bits(em_j))
    A_j = tr.build_transition(em_j)
    A_t = ch.build_transition(em_t[None])[0]
    assert np.array_equal(_bits(A_t.numpy()), _bits(A_j))
    s0 = tr.init_state(counts[0])
    A_j = jnp.where(jnp.asarray(valid)[:, None, None], A_j, tr._eye()[None])
    f = tr._forward_states(A_j, jnp.asarray(s0), tr.CHUNK)
    fprev = jnp.concatenate([jnp.asarray(s0)[None], f[:-1]], axis=0)
    P_j, msel_j = tr._pointers(em_j, jnp.asarray(rank), fprev,
                               jnp.asarray(valid))
    P_t, msel_t = ch.pointers(em_t[None], _u16(rank)[None],
                              _t(np.array(fprev))[None], _t(valid)[None])
    assert np.array_equal(P_t[0].numpy(), np.asarray(P_j))
    assert np.array_equal(msel_t[0].numpy(), np.asarray(msel_j))
    # the port's own forward scan gives JAX's f, so the chain as a whole
    # agrees as well
    got = ch.chain_correct_batch(
        _u16(counts)[None], _u16(rank)[None], _t(refk)[None],
        _t(total)[None], _t(valid)[None], rate, _t(s0)[None])
    want = tr.chain_correct_batch(counts[None], rank[None], refk[None],
                                  total[None], valid[None], float(rate),
                                  s0[None])
    assert np.array_equal(got.numpy(), np.asarray(want))


def _random_problems(seed, ns):
    out = []
    for i, n in enumerate(ns):
        counts, rank, refk, total, _ = _dense_case(seed + i, n, n)
        out.append((counts, refk, total, rank if i % 2 == 0 else None))
    return out


def _rescue_problems():
    """The no-depth rescue batches JAX's score_correct_region builds on
    tests/test_kmer_count.py's uncovered-tail case (task 1, then task 2),
    captured with a spy on tropical.run_chain_batch."""
    rng = np.random.default_rng(9)
    true = rand_seq(rng, 900)
    draft, ops = make_draft(rng, true, n_edits=4)
    recs = [r for r in simulate_reads(rng, true, ops, read_len=100, step=3)
            if r["pos"] < 450]
    batch = records_to_batch(recs, len(draft))
    cfg = jax_sc.AlgoConfig()
    cfg.read_tlen = 300 * cfg.max_ins_fold_sgs
    polished1 = jax_sc.score_chain_contig("ctg1", draft, batch, cfg)
    seen = []
    orig = tr.run_chain_batch

    def spy(problems, rate, chunk=tr.CHUNK):
        seen.append((problems, rate))
        return orig(problems, rate, chunk)

    tr.run_chain_batch = spy
    try:
        kmer_count_contig("ctg1", polished1, batch, cfg)
    finally:
        tr.run_chain_batch = orig
    return seen


def test_run_chain_batch_matches_jax():
    """Choices equal to tropical.run_chain_batch on the rescue problems of
    a task-2 run (captured from the JAX package) and on R = 3 random
    problems of different n (with and without ranks)."""
    batches = _rescue_problems()
    assert batches and any(len(p) for p, _ in batches)
    batches.append((_random_problems(7, [300, 41, 129]), 0.5))
    for problems, rate in batches:
        want = tr.run_chain_batch(problems, rate)
        got = ch.run_chain_batch(problems, rate, device="cpu")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int8 and np.array_equal(g, np.asarray(w))


def _window_inputs(seed, L, n_dp):
    counts, rank, refk, total, _ = _dense_case(seed, L, n_dp)
    uk = np.flatnonzero(counts.reshape(-1)).astype(np.int64)
    cn = counts.reshape(-1)[uk].astype(np.int32)
    key = rank.reshape(-1)[uk].astype(np.int32)
    th = tr.coverage_thresholds(255, 0.8).astype(np.int32)
    return uk, cn, key, total, refk, th


@pytest.mark.parametrize("first", [True, False])
def test_window_halves_match_jax_on_one_device_mesh(first):
    """reads_merge_fwd / merge_traceback against make_reads_merge_fwd /
    make_merge_traceback on a one-device mesh: P, flags, msel and fend
    bit-equal; the packed bytes and b_prev equal."""
    L, n_dp = 384, 350  # three chunks: the JAX route's windows need not
    uk, cn, key, total, refk, th = _window_inputs(11, L, n_dp)  # be 2^k
    s0_in = np.where(np.arange(S) % 3 == 0, -7.5, -1.0).astype(np.float32)
    mesh = jax_shard.reads_mesh(1)
    E = ch._pow2(len(uk))
    ukp = np.full((1, E), L * K3, dtype=np.int32)
    cnp = np.zeros((1, E), dtype=np.int32)
    keyp = np.full((1, E), jax_shard.KBIG, dtype=np.int32)
    ukp[0, :len(uk)], cnp[0, :len(uk)], keyp[0, :len(uk)] = uk, cn, key
    fwd = jax_shard.make_reads_merge_fwd(mesh, L, E, len(th))
    P_j, fl_j, msel_j, fend_j = fwd(
        ukp, cnp, keyp, total[None], refk, th, np.float32(0.5),
        np.int32(n_dp), s0_in, np.bool_(first))
    # the port pads a window to 128 x a power of two
    Lp = ch.pad_to_chunk(L)
    tot_p, refk_p = np.zeros(Lp, np.int32), np.zeros(Lp, np.int32)
    tot_p[:L], refk_p[:L] = total, refk
    P_t, fl_t, msel_t, fend_t = tsh.reads_merge_fwd(
        [(_t(uk), _t(cn), _t(key), _t(tot_p))], _t(refk_p), _t(th), 0.5,
        n_dp, _t(s0_in), first, Lp)
    assert np.array_equal(P_t[:L].numpy(), np.asarray(P_j))
    assert np.array_equal(fl_t[:L].numpy().astype(np.int64),
                          np.asarray(fl_j).astype(np.int64))
    assert np.array_equal(msel_t[:L].numpy(), np.asarray(msel_j))
    assert np.array_equal(_bits(fend_t.numpy()), _bits(fend_j))
    tb = jax_shard.make_merge_traceback(mesh, L)
    for b_end in (int(msel_j[n_dp - 1]), 0, 5):
        pk_j, bp_j = tb(P_j, fl_j, jnp.int8(b_end))
        pk_t, bp_t = tsh.merge_traceback(P_t, fl_t,
                                         torch.tensor(b_end, dtype=torch.int8))
        # cells past the window's valid end take the seed base in both
        assert np.array_equal(pk_t[:L].numpy(), np.asarray(pk_j))
        assert int(bp_t) == int(bp_j)
