"""The port's task-1 chain DP (nextpolish_tpu_torch/ops/chain.py) against
the JAX package's (nextpolish_tpu/ops/tropical.py) on the CPU: the packed
transfer buffer byte for byte, the forward scan bit for bit, the
traceback and the whole DP's result bytes equal, and the f32 tie rule
against the f64 oracle.  Inputs are drawn with numpy from fixed seeds
(random pileups: sim.random_pileup, as tests/test_chain.py draws them)."""
import numpy as np
import pytest
import torch

from nextpolish_tpu.ops import tropical as tr
from nextpolish_tpu.ops.symbols import rolling_kmers
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.ops import chain as ch

K3 = 512


CASES = {  # name -> (n_dp, per, heavy_cells, big_counts, rolling)
    "plain_fmt1": (1500, 2, 0, False, False),
    "overflow_eov": (1500, 4, 40, False, False),
    "big_counts_et": (1500, 2, 0, True, False),
    "rolling_fmt0": (1500, 3, 0, False, True),
    "rolling_all": (2100, 4, 30, True, True),
}


def _packs(name, seed):
    n_dp, per, heavy, big, rolling = CASES[name]
    case = sim.random_pileup(seed, n_dp, per, heavy, big, rolling)
    want = tr.pack_chain_planes(*case, n_dp, 0.5)
    got = ch.pack_chain_planes(*case, n_dp, 0.5)
    return want, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_chain_planes_matches_jax(name):
    """Buffer and shape tuple byte-equal to tropical.pack_chain_planes
    (which builds pack_chain_planes_parts' inputs and calls it)."""
    (bj, *sj), (bt, *st) = _packs(name, 3)
    assert bt.dtype == bj.dtype and np.array_equal(bt, bj)
    assert tuple(st) == tuple(sj)
    L, Emax, EOV, ET, FMT, TH, PS = st
    n_dp, per, heavy, big, rolling = CASES[name]
    assert FMT == (0 if rolling else 1)
    assert (EOV > 0) == bool(heavy or big)
    assert (ET > 0) == big


def _jax_forward(A, s0):
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.jit(tr._forward_states, static_argnums=2)(
        jnp.asarray(A), jnp.asarray(s0), tr.CHUNK))


@pytest.mark.parametrize("nch,big", [(1, False), (2, False), (8, False),
                                     (64, False), (64, True)])
def test_forward_states_bit_equal_to_jax(nch, big):
    """The plain forward scan's f is bit-equal to _forward_states on
    random half-integer matrices with NEG entries, two rows with
    different s0 masks; and (`big`) on matrices whose chunk products pass
    2^24, where f32 rounds: the plain version associates the products as
    JAX does."""
    rng = np.random.default_rng(nch + 100 * big)
    if big:
        A = rng.integers(-1000, 1000, (2, 128 * nch, 8, 8)) * 1000.5
    else:
        A = rng.integers(-40, 40, (2, 128 * nch, 8, 8)) * 0.5
        A[rng.random(A.shape) < 0.3] = tr.NEG
    A = A.astype(np.float32)
    s0 = np.where(rng.random((2, 8)) < 0.5, 0.0, tr.NEG).astype(np.float32)
    s0[:, 0] = 0.0
    want = _jax_forward(A, s0)
    assert big == (np.abs(want[want > tr.NEG / 2]).max() > 2 ** 24)
    got = ch.forward_states(torch.from_numpy(A), torch.from_numpy(s0))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("nch", [1, 4])
def test_traceback_matches_jax(nch):
    """traceback_batch (plain) equals _traceback_batch on random pointer
    tables, rows padded with identity maps past their n_dp."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(40 + nch)
    B, L = 3, 128 * nch
    P = rng.integers(0, 8, (B, L, 8)).astype(np.int32)
    n_dp = rng.integers(1, L + 1, B)
    for b in range(B):
        P[b, n_dp[b]:] = np.arange(8)
    b_end = rng.integers(0, 8, B).astype(np.int32)
    want = np.asarray(jax.jit(tr._traceback_batch, static_argnums=2)(
        jnp.asarray(P), jnp.asarray(b_end), tr.CHUNK))
    got = ch.traceback_batch(torch.from_numpy(P), torch.from_numpy(b_end))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_correct_planes_matches_jax(name):
    """The whole DP on the CPU: result bytes equal to
    tropical.chain_correct_planes on the same buffer."""
    (bj, *sj), (bt, *st) = _packs(name, 5)
    want = np.asarray(tr.chain_correct_planes(bj, *sj))
    got = ch.chain_correct_planes(torch.from_numpy(bt), *st)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


def test_chain_correct_planes_batch_matches_jax():
    """B = 4 rows of one shape bucket with different n_dp and overflow
    entries: the batch equals JAX's batch and each row its single-row
    run."""
    bufs, key = [], None
    for b in range(4):
        n_dp = 1100 - 8 * b
        uk, cn, rk, refkmer, total = sim.random_pileup(12 + b, n_dp, 4, 10)
        total[0] = 97  # one TH bucket for every row
        buf, *shape = ch.pack_chain_planes(uk, cn, rk, refkmer, total,
                                           n_dp, 0.5)
        key = key or tuple(shape)
        assert tuple(shape) == key
        bufs.append(buf)
    stack = np.stack(bufs)
    want = np.asarray(tr.chain_correct_planes_batch(stack, *key))
    got = ch.chain_correct_planes_batch(torch.from_numpy(stack), *key)
    assert np.array_equal(got.numpy(), want)
    for b, buf in enumerate(bufs):
        one = ch.chain_correct_planes(torch.from_numpy(buf), *key)
        assert np.array_equal(one.numpy(), want[b])


def _tie_case():
    """tests/test_chain.py's chain-connected pileup: the draft kmer chain
    at depth plus noise kmers, the draft kmer at rank 0."""
    rng = np.random.default_rng(21)
    n_dp = 700
    syms = rng.integers(1, 6, n_dp).astype(np.uint8)
    refkmer = rolling_kmers(syms).astype(np.int32)
    counts = np.zeros((n_dp, K3), dtype=np.int64)
    total = np.zeros(n_dp, dtype=np.int32)
    for c in range(n_dp):
        counts[c, refkmer[c]] = int(rng.integers(5, 30))
        for _ in range(int(rng.integers(0, 3))):
            if rng.random() < 0.5:
                k = (int(refkmer[c]) & ~7) | int(rng.integers(1, 6))
            else:
                k = int(rng.integers(0, K3))
            counts[c, k] += int(rng.integers(1, 12))
        total[c] = counts[c].sum()
    flat = counts.reshape(-1)
    uk = np.flatnonzero(flat).astype(np.int64)
    cn = flat[uk]
    ucell = uk // K3
    rk = np.arange(len(uk)) - np.searchsorted(ucell, ucell)
    r_ref = rk[(uk % K3) == refkmer[ucell]][ucell]
    rk = np.where(rk == r_ref, 0, rk + (rk < r_ref)).astype(np.uint16)
    rankd = np.full((n_dp, K3), 0xFFFF, dtype=np.uint16)
    rankd.reshape(-1)[uk] = rk
    return counts, refkmer, total, uk, cn, rk, rankd


@pytest.mark.parametrize("rate,on_grid", [(0.5, True), (0.25, True),
                                          (0.375, True), (0.33, False),
                                          (0.47, False)])
def test_f32_tie_exactness_against_slow_chain(rate, on_grid):
    """On a dyadic rate every f32 compare is exact: the port's choices
    equal the f64 oracle byte for byte.  Off-grid rates round, so f32 and
    f64 may differ at true ties only: at most n_dp // 100 cells."""
    counts, refkmer, total, uk, cn, rk, rankd = _tie_case()
    n_dp = len(refkmer)
    want = ch.slow_chain(counts, refkmer, total, rate, rank=rankd)
    assert np.array_equal(want, tr.slow_chain(counts, refkmer, total, rate,
                                              rank=rankd))
    buf, *shape = ch.pack_chain_planes(uk, cn, rk, refkmer, total, n_dp,
                                       rate)
    got = ch.chain_correct_planes(torch.from_numpy(buf), *shape).numpy()
    got = got[:n_dp] & 7
    if on_grid:
        assert np.array_equal(got, want)
    else:
        assert np.count_nonzero(got != want) <= n_dp // 100


# (seed, rate, heavy cells of random_pileup(seed, 3000, 6, heavy, rolling)):
# at 0.33, 0.47 and 0.7 the planes DP ties where rounding the product
# tot1 * rate before the subtraction changes a choice (seeds 6, 11, 14, 21
# with 20 heavy cells; seeds 6 and 7 at 0.7 with 1,500, where the
# differing emissions are overflow entries'); 0.5 is the dyadic control
OFF_GRID = ([(seed, rate, 20) for seed in (6, 11, 14, 21)
             for rate in (0.33, 0.47, 0.5, 0.7)]
            + [(6, 0.7, 1500), (7, 0.7, 1500)])


@pytest.mark.parametrize("seed,rate,heavy", OFF_GRID)
def test_planes_dp_matches_jax_off_grid(seed, rate, heavy):
    """The planes DP through dispatch_chain_sparse (the CPU) against
    tropical.run_chain_sparse: the choices byte-equal at off-grid rates,
    where the emission must round once, as XLA's fused multiply-add does;
    run_chain_sparse, the wrapper task 3 reaches, gives the same."""
    n_dp = 3000
    case = sim.random_pileup(seed, n_dp, 6, heavy_cells=heavy, rolling=True)
    want = np.asarray(tr.run_chain_sparse(*case, n_dp, rate))
    got = ch.dispatch_chain_sparse(*case, n_dp, rate, device="cpu")
    assert np.array_equal(got.numpy()[:n_dp] & 7, want)
    assert np.array_equal(ch.run_chain_sparse(*case, n_dp, rate,
                                              device="cpu"), want)


@pytest.mark.parametrize("rate", [0.33, 0.47, 0.5, 0.7])
def test_dense_emission_bit_equal_to_jax(rate):
    """The dense emission against tropical.emission under jax.jit, bit
    for bit (here XLA rounds the product and the difference apart), and
    the dense chain (run_chain_batch) against JAX's on regions that tie
    at off-grid rates."""
    import jax

    rng = np.random.default_rng(0)
    L = 2048
    counts = (rng.integers(0, 3000, (L, K3))
              * (rng.random((L, K3)) < 0.05)).astype(np.uint16)
    refk = rng.integers(0, K3, L).astype(np.int32)
    total = rng.integers(1, 60000, L).astype(np.int32)
    want = np.asarray(jax.jit(tr.emission)(counts, refk, total, rate))
    got = ch.emission(torch.from_numpy(counts.astype(np.int32))[None],
                      torch.from_numpy(refk)[None],
                      torch.from_numpy(total)[None], rate)[0].numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    for seed in (6, 11, 14):
        uk, cn, rk, refkmer, tot = sim.random_pileup(seed, 1000, 6, 20,
                                                     rolling=True)
        dense = np.zeros((1000, K3), np.uint16)
        dense.reshape(-1)[uk] = cn
        rank = np.full((1000, K3), 0xFFFF, np.uint16)
        rank.reshape(-1)[uk] = rk
        probs = [(dense[i:i + 250], refkmer[i:i + 250], tot[i:i + 250],
                  rank[i:i + 250]) for i in range(0, 1000, 250)]
        for a, b in zip(ch.run_chain_batch(probs, rate, device="cpu"),
                        tr.run_chain_batch(probs, rate)):
            assert np.array_equal(a, np.asarray(b))


def test_lookback_order_is_jax_scan_order():
    """chain_forward's look-back order (ch.lookback_scan, the kernel's
    units and recurrence in numpy) against jax.lax.associative_scan with
    an operator that is not associative, a o b = 3a + 7b mod a prime, so
    that any other combination order gives other values: equal at every
    position for 1 to 4,096 elements."""
    import jax
    import jax.numpy as jnp

    prime = 1_000_003

    def op(a, b):
        return (3 * a + 7 * b) % prime

    scan = jax.jit(lambda v: jax.lax.associative_scan(op, v))
    rng = np.random.default_rng(11)
    for lg in range(13):
        x = rng.integers(0, prime, 1 << lg).astype(np.int32)
        want = np.asarray(scan(jnp.asarray(x)))
        got = ch.lookback_scan([int(v) for v in x], op)
        assert got == want.tolist(), 1 << lg
        if lg >= 3:  # the order matters: a left fold differs
            fold = [int(x[0])]
            for v in x[1:]:
                fold.append(op(fold[-1], int(v)))
            assert fold != want.tolist()
