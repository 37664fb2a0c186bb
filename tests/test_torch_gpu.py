"""Card-only tests of the port: the hand-written CUDA kernels against
their plain PyTorch versions (the engine-2 level scan: the chain and the
winners; task 1's chain DP: the forward scan and the traceback), the
pinned-buffer launch paths, the dense chain batch (task 2's no-depth
rescue), task 1's window route against its single launch, task 1's
reads-sharded route and engine 2's groups over [cuda:0, cuda:0], the
port's dry run over [cuda:0, cuda:0] and the stage profiler of task 1's
DP, the mappers' banded DP and traceback (band_align, band_traceback) with a
forced sub-batch split, engine calibration on the card, the planes DP at
off-grid rates and task 3's small launches, and worker2 / worker1 -t 1
/ -t 2 / -t 3 / -t 4 / -t 5 / td_score_chain_contig / map_short_batch /
the run.cfg pipeline (task 12, 5 and 1,2,3,4; task 6 and 1,2,3,4 through
the spill path) --device cuda against --device cpu.

Every test here is marked `gpu` and skips without a card; whether a card
is there is decided in a fixture, at run time.  The file imports nothing
of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.io.bam import read_bam
from nextpolish_tpu_torch.models.cns import device_dp as tdd
from nextpolish_tpu_torch.models.cns import level_scan as tls
from nextpolish_tpu_torch.models.cns.window import window_prep
from nextpolish_tpu_torch.ops import chain as tch
from torch_scan_cases import (
    max_level_entries,
    random_window,
    stale_ring_reads,
    truncate,
)

RTS = ["ont", "clr", "rs", "hifi"]


@pytest.fixture(scope="module")
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _windows(tmp_path, seed, lengths, depth, err, read_len, hotspot=None):
    case = sim.simulate_case(seed, len(lengths), lengths, depth, read_len,
                             sub=err, ins=err, dele=err, hotspot=hotspot)
    _, bam = sim.write_case(case, str(tmp_path / f"s{seed}"))
    batch = read_bam(bam)
    out = []
    for tid, draft in enumerate(case.drafts):
        ca = np.frombuffer(draft, dtype=np.uint8)
        w = window_prep(batch, tid, ca, 0, len(draft), "ont", None,
                        case.names[tid])
        _, dw = tdd.prepare_window(w.merged, w.coverage, w.L)
        assert dw is not None
        out.append(dw)
    return out


@pytest.fixture(scope="module")
def windows(tmp_path_factory, cuda_device):
    tmp_path = tmp_path_factory.mktemp("windows")
    return (_windows(tmp_path, 5, [900, 1600, 500, 3000], 30, 0.03,
                     (300, 900))
            + _windows(tmp_path, 0, [2000], 110, 0.05, (1000, 2000),
                       (1000, 1, False))
            + _windows(tmp_path, 1, [1600], 30, 0.03, (800, 1600),
                       (800, 12, True))
            + _windows(tmp_path, 2, [1600], 8, 0.03, (800, 1600),
                       (800, 300, True)))


def _launches():
    return (tls.level_chain.launches, tls.level_winners.launches)


def _hold(dws, rt, dev):
    """Both kernels against their plain versions on one batch: the
    chain's per-entry results and the winners, byte for byte; one
    level_scan call is one launch of each kernel."""
    b = tdd.pack_batch(dws).to(dev)
    rt_id, c = tdd.READ_TYPE_ID[rt], tdd.COV_COEF[rt]
    before = _launches()
    kb, ks = tls.level_scan(b, rt_id, c)
    assert _launches() == (before[0] + 1, before[1] + 1)
    ki = tls.level_chain(b, rt_id, c)
    pi = tls.level_chain_plain(b, rt_id, c)
    pb, ps = tls.level_scan_plain(b, rt_id, c)
    torch.cuda.synchronize(dev)
    assert torch.equal(ki, pi)
    assert torch.equal(kb, pb) and torch.equal(ks, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("rt", RTS)
def test_kernel_matches_plain_on_card(windows, rt, cuda_device):
    """The CUDA kernels equal the plain versions byte for byte (E up to
    24, Vb > 8, a deep insertion chain), and one call is one launch of
    each."""
    assert max(dw.E for dw in windows) > 20
    assert max(dw.Vb for dw in windows) > 8
    _hold(windows, rt, cuda_device)


def _risky(case, windows):
    """Batches for what the chain kernel's design makes risky."""
    if case == "wide_level":  # a level over 32 entries: lanes loop
        dws = [windows[4], random_window(3, 300, 24, 6, density=0.9)]
        assert max(max_level_entries(dw) for dw in dws) > 128
    elif case == "lengths_100x":  # blocks finish at very different levels
        dws = [windows[3], random_window(4, 20, 9, 3), windows[6]]
        n = [dw.n_levels for dw in dws]
        assert max(n) > 100 * min(n)
    elif case == "single_level":
        dws = [truncate(windows[0], 1), random_window(5, 1, 24, 24, 0.5),
               windows[1]]
        assert min(dw.n_levels for dw in dws) == 1
    elif case == "chunk_edges":  # the chain stages 32-level chunks
        dws = [random_window(10 + n, n, 12, 4) for n in (31, 32, 33, 64, 65)]
    else:  # delta-0 levels only: ring rows reused after every reset
        dws = [random_window(6, 3000, 16, 8, d0_frac=1.0),
               random_window(9, 500, 24, 24, density=0.3, d0_frac=1.0,
                             ring_frac=0.9)]
        assert all(stale_ring_reads(dw) > 0 for dw in dws)
    return dws


@pytest.mark.gpu
@pytest.mark.parametrize("rt", RTS)
@pytest.mark.parametrize("case", ["wide_level", "lengths_100x",
                                  "single_level", "chunk_edges",
                                  "d0_ring_reuse"])
def test_risky_shapes_on_card(windows, case, rt, cuda_device):
    """Levels over one warp's lanes, windows 100x apart in length, a
    one-level window, windows ending at and around the chain's chunk
    boundaries, and runs of delta-0 levels whose stale ring cells must
    read NEG: both kernels byte-equal to the plain versions."""
    _hold(_risky(case, windows), rt, cuda_device)


@pytest.mark.gpu
def test_launch_path_on_card_matches_cpu(windows, cuda_device):
    """dispatch/collect through pinned buffers, full scores and score
    tails, give the CPU path's results."""
    for sc_tail in (False, True):
        got = tdd._run_batch(windows, "ont", devices=[cuda_device],
                             sc_tail=sc_tail)
        ref = tdd._run_batch(windows, "ont", devices=["cpu"], sc_tail=sc_tail)
        for (gb, gs), (rb, rs) in zip(got, ref):
            assert np.array_equal(gb, rb) and np.array_equal(gs, rs)


@pytest.mark.gpu
def test_run_batch_over_two_entries_on_card_matches_cpu(windows,
                                                        cuda_device):
    """Engine 2's groups round-robin over [cuda:0, cuda:0] (groups of 8,
    8 and 5 on entries 0, 1, 0) give the CPU path's results."""
    from nextpolish_tpu_torch.runtime import trace
    dws = windows * 3
    devs = [cuda_device, cuda_device]
    before = _launches()
    trace.reset("cns.groups")
    got = tdd._run_batch(dws, "ont", devices=devs)
    assert _launches() == (before[0] + 3, before[1] + 3)
    assert {k: v["s"] for k, v in trace.snapshot("cns.groups").items()} \
        == {"cns.groups.entry0": 2, "cns.groups.entry1": 1}
    ref = tdd._run_batch(dws, "ont", devices=["cpu"])
    assert len(got) == len(ref) == len(dws)
    for (gb, gs), (rb, rs) in zip(got, ref):
        assert np.array_equal(gb, rb) and np.array_equal(gs, rs)


@pytest.mark.gpu
def test_kernel_refuses_bad_input(windows, cuda_device):
    """Tensors on two devices, a wrong dtype, an unknown read type or a
    chain result of the wrong shape are refused before anything
    launches."""
    b = tdd.pack_batch(windows[:1]).to(cuda_device)
    before = _launches()
    with pytest.raises(ValueError):
        tls.level_scan(dataclasses.replace(b, meta=b.meta.cpu()), 0, 3)
    with pytest.raises(TypeError):
        tls.level_scan(dataclasses.replace(b, meta=b.meta.long()), 0, 3)
    with pytest.raises(ValueError):
        tls.level_scan(b, 7, 3)
    inter = tls.level_chain(b, 0, 3)
    with pytest.raises(ValueError):
        tls.level_winners(b, inter[:2], 0)  # ONT needs n_last
    assert _launches() == (before[0] + 1, before[1])


@pytest.mark.gpu
def test_worker2_cuda_matches_cpu(tmp_path, cuda_device, monkeypatch):
    """The whole slice on the card writes the CPU run's bytes."""
    from nextpolish_tpu_torch import worker2

    case = sim.simulate_case(31, 2, [12000, 9000], 12, read_len=(2000, 5000))
    fa, bam = sim.write_case(case, str(tmp_path))
    monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    before = _launches()
    assert worker2.main(["-g", fa, "-l", bam, "-r", "ont", "-o",
                         str(tmp_path / "gpu.fa"), "--device", "cuda"]) == 0
    after = _launches()
    assert after[0] > before[0] and after[0] - before[0] == \
        after[1] - before[1]
    assert worker2.main(["-g", fa, "-l", bam, "-r", "ont", "-o",
                         str(tmp_path / "cpu.fa"), "--device", "cpu"]) == 0
    assert (tmp_path / "gpu.fa").read_bytes() == \
        (tmp_path / "cpu.fa").read_bytes()


# ---------------------------------------------------------------------------
# task 1: the chain DP's kernels (ops/chain.py, csrc/chain_scan.cu)
# ---------------------------------------------------------------------------

def _chain_launches():
    return (tch.forward_states.launches, tch.traceback_batch.launches)


def _scan_inputs(seed, B, L, live, big=False):
    """Random (max,+) scan inputs: half-integer matrices with NEG entries
    (or, with `big`, magnitudes whose products pass 2^24), s0 with `live`
    live states, pointer tables, and rows that are all padding (identity
    matrices and maps) past a random n_dp, one row with n_dp = 0."""
    rng = np.random.default_rng(seed)
    if big:
        A = (rng.integers(-1000, 1000, (B, L, 8, 8)) * 1000.5)
    else:
        A = rng.integers(-40, 40, (B, L, 8, 8)) * 0.5
        A[rng.random(A.shape) < 0.3] = tch.NEG
    A = A.astype(np.float32)
    eye = np.full((8, 8), tch.NEG, np.float32)
    np.fill_diagonal(eye, 0.0)
    P = rng.integers(0, 8, (B, L, 8)).astype(np.int32)
    n_dp = rng.integers(1, L + 1, B)
    if B > 1:
        n_dp[1] = 0
    for b in range(B):
        A[b, n_dp[b]:] = eye
        P[b, n_dp[b]:] = np.arange(8)
    s0 = np.full((B, 8), tch.NEG, np.float32)
    for b in range(B):
        s0[b, rng.permutation(8)[:live]] = 0.0
    b_end = rng.integers(0, 8, B).astype(np.int32)
    return A, s0, P, b_end


def _scan_inputs_on_card(seed, B, L, live, dev, big=False):
    """_scan_inputs' kinds of inputs drawn on the card (large rows)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape, lo=None, hi=None, dtype=torch.int32):
        if lo is None:
            return torch.rand(shape, generator=g, device=dev)
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    if big:
        A = draw(B, L, 8, 8, lo=-1000, hi=1000, dtype=torch.int16).float()
        A *= 1000.5
    else:
        A = draw(B, L, 8, 8, lo=-40, hi=40, dtype=torch.int8).float() * 0.5
        A[draw(B, L, 8, 8) < 0.3] = float(tch.NEG)
    eye = torch.full((8, 8), float(tch.NEG), device=dev).fill_diagonal_(0.0)
    P = draw(B, L, 8, lo=0, hi=8)
    n_dp = draw(B, lo=1, hi=L + 1, dtype=torch.int64).tolist()
    if B > 1:
        n_dp[1] = 0
    for b in range(B):
        A[b, n_dp[b]:] = eye
        P[b, n_dp[b]:] = torch.arange(8, device=dev, dtype=torch.int32)
    s0 = torch.full((B, 8), float(tch.NEG), device=dev)
    for b in range(B):
        s0[b, torch.randperm(8, generator=g, device=dev)[:live]] = 0.0
    return A, s0, P, draw(B, lo=0, hi=8)


def _hold_chain(dev, A, s0, P, b_end):
    """Both chain kernels against their plain versions on the card: f bit
    for bit, the choices byte for byte; one call is one launch."""
    A, s0, P, b_end = (torch.as_tensor(x, device=dev) for x in (A, s0, P,
                                                                b_end))
    before = _chain_launches()
    f = tch.forward_states(A, s0)
    assert _chain_launches() == (before[0] + 1, before[1])
    choice = tch.traceback_batch(P, b_end)
    assert _chain_launches() == (before[0] + 1, before[1] + 1)
    fp = tch.forward_states_plain(A, s0)
    cp = tch.traceback_batch_plain(P, b_end)
    torch.cuda.synchronize(dev)
    assert torch.equal(f.view(torch.int32), fp.view(torch.int32))
    assert torch.equal(choice, cp)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,big", [
    (1, 128, False), (8, 128, False), (1, 1 << 15, False),
    (8, 1 << 15, False), (64, 128, False), (128, 256, False),
    (1, 1 << 19, False), (1, 1 << 23, False), (1, 1 << 19, True),
    (1, 1 << 23, True)])
@pytest.mark.parametrize("live", [1, 8])
def test_chain_kernels_match_plain_on_card(cuda_device, B, L, big, live):
    """L = 128 (one chunk, no tree) and 2^15 cells (256 chunks), one row
    and eight rows in one launch; many rows of one and two chunks (the
    traceback's walk takes a block of one warp a row, most threads idle;
    the forward scan's units of four chunks span rows); a window of the
    window route (2^19 cells, 4,096 chunks: several chunk maps a walk
    thread) and task 1's largest launch (2^23 cells, 65,536 chunks,
    inputs drawn on the card), also with `big` matrices whose products
    pass 2^24 (the forward scan's look-back order shows in the bits); s0
    with one and with eight live states, rows all padding past n_dp."""
    seed = B * L + live + big
    if B * L >= 1 << 19:
        _hold_chain(cuda_device, *_scan_inputs_on_card(seed, B, L, live,
                                                       cuda_device, big))
    else:
        _hold_chain(cuda_device, *_scan_inputs(seed, B, L, live, big))


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", [(2, 128 * 64), (1, 128 * 4096),
                                 (1, 128 * 65536)])
def test_chain_forward_past_2_pow_24_on_card(cuda_device, B, L):
    """Chunk products past 2^24 round: the kernel's association of the
    products is the plain version's, so f stays bit-equal, at 64 chunks a
    row and at 4,096 and 65,536 (a window, task 1's largest launch)."""
    if B * L >= 1 << 19:
        _hold_chain(cuda_device, *_scan_inputs_on_card(24, B, L, 8,
                                                       cuda_device, True))
    else:
        _hold_chain(cuda_device, *_scan_inputs(24, B, L, 8, big=True))


@pytest.mark.gpu
def test_chain_forward_repeats_bit_equal_on_card(cuda_device):
    """Twenty launches at task 1's largest shape (65,536 chunks, products
    past 2^24) each give the plain version's f bit for bit: the units'
    look-back waits on flags other warps raise, and a race between them
    would show as a launch that differs."""
    A, s0, _, _ = _scan_inputs_on_card(20, 1, 1 << 23, 8, cuda_device, True)
    want = tch.forward_states_plain(A, s0).view(torch.int32)
    before = tch.forward_states.launches
    for _ in range(20):
        got = tch.forward_states(A, s0)
        torch.cuda.synchronize(cuda_device)
        assert torch.equal(got.view(torch.int32), want)
    assert tch.forward_states.launches == before + 20


@pytest.mark.gpu
def test_chain_kernels_refuse_bad_input(cuda_device):
    """A length that is not 128 x a power of two, a wrong dtype and
    tensors on two devices are refused before anything launches."""
    A, s0, P, b_end = (torch.from_numpy(x).to(cuda_device)
                       for x in _scan_inputs(3, 2, 384, 8))
    before = _chain_launches()
    with pytest.raises(ValueError):
        tch.forward_states(A, s0)  # 3 chunks
    with pytest.raises(ValueError):
        tch.forward_states(A[:, :256].double(), s0)
    with pytest.raises(ValueError):
        tch.traceback_batch(P[:, :256].contiguous(), b_end.cpu())
    with pytest.raises(ValueError):
        tch.traceback_batch(P[:, :256].contiguous().long(), b_end)
    assert _chain_launches() == before


@pytest.mark.gpu
@pytest.mark.parametrize("heavy,big,rolling", [(0, False, True),
                                               (40, True, False)])
def test_chain_dp_on_card_matches_cpu(cuda_device, heavy, big, rolling):
    """The whole DP from one buffer (overflow entries and escaped totals
    in the second case): result bytes on the card equal the CPU's."""
    from nextpolish_tpu_torch import sim as tsim

    uk, cn, rk, refkmer, total = tsim.random_pileup(9, 5000, 4, heavy, big,
                                                    rolling)
    buf, *shape = tch.pack_chain_planes(uk, cn, rk, refkmer, total, 5000,
                                        0.5)
    host = torch.from_numpy(buf.view(np.int16))
    got = tch.chain_correct_planes(host.to(cuda_device), *shape)
    want = tch.chain_correct_planes(host, *shape)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_worker1_cuda_matches_cpu(tmp_path, cuda_device):
    """Task 1 on the card writes the CPU run's bytes, through both
    kernels."""
    from nextpolish_tpu_torch import worker1

    case = sim.simulate_short_case(41, [30000, 8000], 30)
    fa, bam = sim.write_case(case, str(tmp_path))
    before = _chain_launches()
    assert worker1.main(["-g", fa, "-s", bam, "-t", "1", "-o",
                         str(tmp_path / "gpu.fa"), "--device", "cuda"]) == 0
    after = _chain_launches()
    assert after == (before[0] + 2, before[1] + 2)
    assert worker1.main(["-g", fa, "-s", bam, "-t", "1", "-o",
                         str(tmp_path / "cpu.fa"), "--device", "cpu"]) == 0
    assert (tmp_path / "gpu.fa").read_bytes() == \
        (tmp_path / "cpu.fa").read_bytes()


def _dense_problems(seed, ns):
    """Random dense chain problems (counts [n, 512] u16 with the draft kmer
    and a few others per cell, refkmer, totals, first-observation ranks)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in ns:
        counts = np.zeros((n, 512), dtype=np.uint16)
        rank = np.full((n, 512), 0xFFFF, dtype=np.uint16)
        refk = rng.integers(0, 512, n).astype(np.int32)
        for c in range(n):
            ks = list(dict.fromkeys([int(refk[c])] + [
                int(k) for k in rng.integers(0, 512, int(rng.integers(0, 5)))]))
            for r, k in enumerate(ks):
                counts[c, k] = int(rng.integers(1, 40))
                rank[c, k] = r
        total = counts.astype(np.int64).sum(axis=1).astype(np.int32)
        out.append((counts, refk, total, rank))
    return out


@pytest.mark.gpu
def test_dense_chain_batch_on_card_matches_plain(cuda_device):
    """run_chain_batch on the card (both kernels, one launch each) against
    its plain versions on the card and against the CPU."""
    problems = _dense_problems(5, [700, 33, 129, 1000, 256])
    before = _chain_launches()
    got = tch.run_chain_batch(problems, 0.5, device=cuda_device)
    assert _chain_launches() == (before[0] + 1, before[1] + 1)
    plain = tch.run_chain_batch(problems, 0.5, device=cuda_device,
                                plain=True)
    cpu = tch.run_chain_batch(problems, 0.5, device="cpu")
    for g, p, c in zip(got, plain, cpu):
        assert np.array_equal(g, p) and np.array_equal(g, c)


@pytest.mark.gpu
def test_windowed_route_on_card_matches_single_launch(tmp_path, cuda_device,
                                                      monkeypatch):
    """Task 1's window route on the card (4,096-cell windows, one launch
    of each kernel per window) writes the single launch's bytes."""
    from nextpolish_tpu_torch.models import score_chain as tsc
    from nextpolish_tpu_torch.runtime import trace

    case = sim.simulate_short_case(43, [20000], 30)
    _, bam = sim.write_case(case, str(tmp_path))
    batch = read_bam(bam)
    cfg = tsc.AlgoConfig()
    want = tsc.score_chain_contig("ctg0", case.drafts[0], batch, cfg,
                                  device=cuda_device)
    trace.reset("task1")
    monkeypatch.setattr(tsc, "SHARD_WINDOW_CELLS", 4096)
    before = _chain_launches()
    got = tsc.score_chain_contig_windowed("ctg0", case.drafts[0], batch, cfg,
                                          device=cuda_device)
    n_win = int(trace.snapshot("task1.windows")["task1.windows"]["s"])
    assert n_win >= 5
    assert _chain_launches() == (before[0] + n_win, before[1] + n_win)
    assert got == want
    assert got == tsc.score_chain_contig_windowed(
        "ctg0", case.drafts[0], batch, cfg, device="cpu")


@pytest.mark.gpu
def test_sharded_route_over_two_entries_on_card_matches_cpu(
        tmp_path, cuda_device, monkeypatch):
    """Task 1's reads-sharded route over [cuda:0, cuda:0] (4,096-cell
    windows, one launch of each chain kernel a window, the merge timed)
    writes the single launch's bytes and those of the route over [cpu,
    cpu]."""
    from nextpolish_tpu_torch.models import score_chain as tsc
    from nextpolish_tpu_torch.runtime import trace

    case = sim.simulate_short_case(44, [20000], 30)
    _, bam = sim.write_case(case, str(tmp_path))
    batch = read_bam(bam)
    cfg = tsc.AlgoConfig()
    draft = case.drafts[0]
    want = tsc.score_chain_contig("ctg0", draft, batch, cfg,
                                  device=cuda_device)
    monkeypatch.setattr(tsc, "SHARD_WINDOW_CELLS", 4096)
    devs = [cuda_device, cuda_device]
    trace.reset("task1")
    before = _chain_launches()
    got = tsc.score_chain_contig_sharded("ctg0", draft, batch, cfg, devs)
    snap = trace.snapshot("task1")
    n_win = int(snap["task1.windows"]["s"])
    assert n_win >= 5
    assert _chain_launches() == (before[0] + n_win, before[1] + n_win)
    assert snap["task1.window_merge"]["n"] == n_win
    assert got == want
    assert got == tsc.score_chain_contig_sharded("ctg0", draft, batch, cfg,
                                                 ["cpu", "cpu"])


@pytest.mark.gpu
def test_worker1_task2_cuda_matches_cpu(tmp_path, cuda_device):
    """Task 2 on the card writes the CPU run's bytes, on task 1's output
    for reads that leave the contig's last 8 kb uncovered (a no-depth
    region: a planes launch and a rescue batch)."""
    from nextpolish_tpu_torch import worker1

    case = sim.simulate_short_case(47, [20000, 6000], 30)
    case.records = [r for r in case.records
                    if r["tid"] == 1 or r["pos"] < 12000]
    fa, bam = sim.write_case(case, str(tmp_path))
    t1 = str(tmp_path / "t1.fa")
    assert worker1.main(["-g", fa, "-s", bam, "-t", "1", "-o", t1,
                         "--device", "cpu"]) == 0
    before = _chain_launches()
    assert worker1.main(["-g", t1, "-s", bam, "-t", "2", "-o",
                         str(tmp_path / "gpu.fa"), "--device", "cuda"]) == 0
    after = _chain_launches()
    assert after[0] >= before[0] + 2 and after[1] >= before[1] + 2
    assert worker1.main(["-g", t1, "-s", bam, "-t", "2", "-o",
                         str(tmp_path / "cpu.fa"), "--device", "cpu"]) == 0
    assert (tmp_path / "gpu.fa").read_bytes() == \
        (tmp_path / "cpu.fa").read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.33, 0.47, 0.7])
def test_planes_dp_off_grid_on_card_matches_cpu(cuda_device, rate):
    """The planes DP at off-grid rates (task 3's rescue and
    td_score_chain_contig run at 0.33): the card's result bytes equal the
    CPU's, on pileups whose ties need the emission rounded once (the CPU
    run equals the JAX package's there, tests/test_torch_chain.py)."""
    for seed, heavy in ((11, 20), (21, 20), (6, 1500)):
        case = sim.random_pileup(seed, 3000, 6, heavy, rolling=True)
        buf, *shape = tch.pack_chain_planes(*case, 3000, rate)
        host = torch.from_numpy(buf.view(np.int16))
        got = tch.chain_correct_planes(host.to(cuda_device), *shape)
        want = tch.chain_correct_planes(host, *shape)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [256, 512, 1024, 2048, 4096])
def test_chain_kernels_small_launches_on_card(cuda_device, L):
    """Task 3's launches: one row of a few hundred to a few thousand
    cells (2 to 32 chunks, one or a few units of the forward scan's
    look-back), kernels against their plain versions."""
    _hold_chain(cuda_device, *_scan_inputs(L + 3, 1, L, 8))
    _hold_chain(cuda_device, *_scan_inputs(L + 4, 1, L, 1, big=True))


@pytest.fixture(scope="module")
def diploid(tmp_path_factory):
    """Two diploid contigs with short and long reads: genome.fa and both
    sorted, indexed BAMs."""
    from nextpolish_tpu_torch.io import bam as bamio

    d = tmp_path_factory.mktemp("diploid")
    c = sim.simulate_diploid_case(61, [30_000, 8_000], 40, 0.001, 3, 400,
                                  long_depth=30)
    fa, bam = sim.write_case(c, str(d))
    lbam = str(d / "long.sort.bam")
    hdr = bamio.BamHeader("", list(c.names), [len(x) for x in c.drafts])
    bamio.write_bam(lbam, hdr, c.long_records, index=True)
    return c, fa, bam, lbam


@pytest.mark.gpu
def test_worker1_tasks_3_4_5_cuda_matches_cpu(tmp_path, cuda_device,
                                               diploid):
    """worker1 -t 3, -t 4 on its output and -t 5 on the card write the
    CPU runs' bytes; task 3 launches both chain kernels."""
    from nextpolish_tpu_torch import worker1

    _, fa, bam, lbam = diploid
    runs = (("3", fa, ["-s", bam, "-l", lbam]),
            ("4", str(tmp_path / "t3.cuda.fa"), ["-s", bam, "-l", lbam]),
            ("5", fa, ["-l", lbam]))
    for task, genome, reads in runs:
        out = {}
        for dev in ("cuda", "cpu"):
            path = tmp_path / f"t{task}.{dev}.fa"
            before = _chain_launches()
            assert worker1.main(["-g", genome, *reads, "-t", task, "-o",
                                 str(path), "--device", dev]) == 0
            if task == "3" and dev == "cuda":
                after = _chain_launches()
                assert after[0] > before[0] and after[1] > before[1]
            out[dev] = path.read_bytes()
        assert out["cuda"] == out["cpu"], task


@pytest.mark.gpu
def test_td_score_chain_cuda_matches_cpu(cuda_device, diploid):
    """td_score_chain_contig (one planes launch over the contig at the lgs
    rate) on the card gives the CPU's bytes."""
    from nextpolish_tpu_torch.models import score_chain as tsc

    c, _, _, lbam = diploid
    batch = read_bam(lbam)
    cfg = tsc.AlgoConfig()
    before = _chain_launches()
    got = tsc.td_score_chain_contig("ctg0", c.drafts[0], batch, cfg,
                                    device=cuda_device)
    assert _chain_launches() == (before[0] + 1, before[1] + 1)
    assert got == tsc.td_score_chain_contig("ctg0", c.drafts[0], batch, cfg,
                                            device="cpu")


# ---------------------------------------------------------------------------
# the aligner: band_align / band_traceback (align/extend.py,
# csrc/band_align.cu), the mapper and the run.cfg pipeline
# ---------------------------------------------------------------------------

def _band_launches():
    from nextpolish_tpu_torch.align import extend as text

    return (text.band_align_core.launches, text.band_traceback.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["local", "global", "extend"])
@pytest.mark.parametrize("R,B,Bt", [
    (150, 32, 300), (150, 1150, 9), (300, 64, 40),
    # the routes' edges: the widest band the warp route always takes, the
    # widest warp-route band at the read count from which bands over 256
    # take it, and one read fewer (block route), the same band with few
    # reads and the first band always on the block route, bands that are
    # not a multiple of 32, a read count that is not a multiple of the
    # reads a block, four reads a traceback block (>= 1,024 reads), rows
    # past one staged chunk in each route, and a walk across many
    # traceback tiles
    (150, 256, 37), (150, 512, 256), (150, 512, 255), (120, 300, 256),
    (150, 512, 40), (150, 544, 37), (120, 100, 37), (150, 32, 1037),
    (1100, 600, 5), (1100, 256, 5), (4096, 512, 3)])
@pytest.mark.parametrize("case", ["band_case", "band_indel_case"])
def test_band_kernels_match_plain_on_card(cuda_device, mode, R, B, Bt, case):
    """Both aligner kernels against their plain versions on the card, byte
    for byte (tb, scores, end cells; ops and final cells), one launch
    each; sim.band_indel_case's long indels move the walk across many
    band columns (past the traceback's column window on wide bands)."""
    from nextpolish_tpu_torch.align import extend as text

    q, t, qlen, tlen = (torch.from_numpy(x).to(cuda_device) for x in
                        getattr(sim, case)(B + R, Bt, R, B, mode))
    kw = sim.BAND_SCORES[mode]
    before = _band_launches()
    got = text.band_align_core(q, t, qlen, tlen, mode=mode, **kw)
    ops = text.band_traceback(*got[:1], got[2], got[3])
    assert _band_launches() == (before[0] + 1, before[1] + 1)
    want = text.band_align_plain(q, t, qlen, tlen, mode=mode, **kw)
    ops_p = text.band_traceback_plain(want[0], want[2], want[3])
    torch.cuda.synchronize(cuda_device)
    for g, w in zip(got + ops, want + ops_p):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
def test_band_step_probe_on_card(cuda_device):
    """The dependent-step probe behind the aligner kernels' dependency
    bounds reads a positive cycle count for each chain."""
    from nextpolish_tpu_torch.align import extend as text

    scan_round, walk_step = text.step_cycles(cuda_device)
    assert 0 < scan_round < 1000 and 0 < walk_step < 1000


@pytest.mark.gpu
def test_band_sub_batch_split_on_card(cuda_device, monkeypatch):
    """A traceback budget of 64 reads splits 300 reads into 5 launches of
    each kernel; the outputs equal the CPU's unsplit run."""
    from nextpolish_tpu_torch.align import extend as text

    q, t, qlen, tlen = sim.band_case(7, 300, 150, 32, "local")
    kw = sim.BAND_SCORES["local"]
    want = text.band_align_ops(q, t, qlen, tlen, device="cpu", **kw)
    monkeypatch.setattr(text, "TB_BUDGET_BYTES", 64 * 150 * 32)
    before = _band_launches()
    got = text.band_align_ops(q, t, qlen, tlen, device=cuda_device, **kw)
    assert _band_launches() == (before[0] + 5, before[1] + 5)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.gpu
def test_band_kernels_refuse_bad_input(cuda_device):
    from nextpolish_tpu_torch.align import extend as text

    q, t, qlen, tlen = (torch.from_numpy(x).to(cuda_device)
                        for x in sim.band_case(1, 4, 50, 32, "local"))
    with pytest.raises(ValueError):
        text.band_align_core(q.long(), t, qlen, tlen)
    with pytest.raises(ValueError):
        text.band_align_core(q, t.cpu(), qlen, tlen)
    wide = torch.zeros((4, 50 + 2049), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        text.band_align_core(q, wide, qlen, tlen)


@pytest.mark.gpu
def test_map_short_batch_cuda_matches_cpu(cuda_device):
    from nextpolish_tpu_torch.align import mapper
    from nextpolish_tpu_torch.align.index import GenomeIndex

    case = sim.simulate_short_case(51, [20000, 5000], 10)
    idx = GenomeIndex.build(list(zip(case.names, case.truths)), k=17, w=7)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    nib = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
    seqs = []
    for r in case.records:
        s = nib[r["seq_nib"]].tobytes()
        seqs.append(s.translate(comp)[::-1] if r["flag"] & 16 else s)
    seqs = seqs[: len(seqs) // 2 * 2]
    before = _band_launches()
    got = mapper.map_short_batch(idx, seqs, paired=True, device=cuda_device)
    assert _band_launches()[0] > before[0]
    want = mapper.map_short_batch(idx, seqs, paired=True, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


@pytest.mark.gpu
@pytest.mark.parametrize("project", ["task12", "task5", "task1234",
                                     "task6_hifi_spill",
                                     "task1234_diploid_spill"])
def test_run_cfg_cuda_matches_cpu(tmp_path, cuda_device, project,
                                  monkeypatch):
    """python -m nextpolish_tpu_torch run.cfg --device cuda writes the
    --device cpu run's genome.nextpolish.fasta and .stat.  The _spill
    projects run --device cuda through the spill path (NPT_SPILL_BAM=1,
    the read chunks lowered so that several parts merge) and --device
    cpu in memory: task = best with only HiFi reads (6, 6) on engine 2's
    device route, and tests/test_torch_pipeline.py's diploid task =
    1,2,3,4 project (short and long reads spilled, tasks 3 and 4 on
    spilled parts)."""
    from nextpolish_tpu_torch import pipeline as tpipe
    from nextpolish_tpu_torch.__main__ import main

    spill_chunk, spilled = None, ()
    if project == "task12":
        case = sim.simulate_short_case(53, [15000, 4000], 30)
        kw = dict(task="12", sgs=case.records)
    elif project == "task1234":
        case = sim.simulate_diploid_case(57, [15000, 4000], 40, 0.001, 2,
                                         400, long_depth=30)
        kw = dict(task="1,2,3,4", sgs=case.records, lgs=case.long_records)
    elif project == "task6_hifi_spill":
        case = sim.simulate_case(41, 2, [4000, 3000], 15,
                                 read_len=(500, 5000), sub=0.002, ins=0.002,
                                 dele=0.002)
        kw = dict(task="best", hifi=case.records,
                  hifi_options="-min_read_len 1k -max_depth 100")
        spill_chunk, spilled = 16, ("spill.hifi",)
        monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    elif project == "task1234_diploid_spill":
        case = sim.simulate_diploid_case(9, [8000], 40, 0.001, 2, 400,
                                         long_depth=30)
        kw = dict(task="1,2,3,4", sgs=case.records, lgs=case.long_records)
        spill_chunk, spilled = 512, ("spill.sgs",)
    else:
        case = sim.simulate_case(55, 2, [9000, 5000], 15,
                                 read_len=(1500, 4000))
        kw = dict(task="5", lgs=case.records)
    out = {}
    for dev in ("cuda", "cpu"):
        if spill_chunk is not None:
            spill = dev == "cuda"
            monkeypatch.setenv("NPT_SPILL_BAM", "1" if spill else "0")
            monkeypatch.setattr(tpipe.Pipeline, "CHUNK_READS",
                                spill_chunk if spill else 200_000)
        cfg = sim.write_project(str(tmp_path / dev), case.names,
                                case.drafts, **kw)
        before = _band_launches()
        assert main([cfg, "--device", dev]) == 0
        work = tmp_path / dev / "work"
        if dev == "cuda":
            assert _band_launches()[0] > before[0]
            for d in spilled:
                assert len(list((work / d).glob("part*.bam"))) >= 2, d
        out[dev] = ((work / "genome.nextpolish.fasta").read_bytes(),
                    (work / "genome.nextpolish.fasta.stat").read_bytes())
    assert out["cuda"] == out["cpu"]


@pytest.mark.gpu
def test_calib_on_card(cuda_device, tmp_path, monkeypatch):
    """choose_engine measures both engines on the card, returns one of
    them and caches it; an error of the device probe raises."""
    from nextpolish_tpu_torch.models.cns import calib

    monkeypatch.setenv("NPT_CNS_CALIB", str(tmp_path / "calib.json"))
    monkeypatch.setattr(calib, "_CHOSEN", {})
    eng = calib.choose_engine("ont", cuda_device)
    assert eng in ("device", "native")
    key = calib._cache_key("ont", cuda_device)
    assert key.startswith(f"v{calib.CALIB_VERSION}/cuda/")
    import json

    rec = json.loads((tmp_path / "calib.json").read_text())[key]
    assert rec["engine"] == eng and rec["device_bases_per_s"] > 0
    assert calib.choose_engine("ont", cuda_device) == eng

    def broken(*a, **k):
        raise RuntimeError("probe launch failed")

    monkeypatch.setattr(tdd, "_run_batch", broken)
    monkeypatch.setattr(calib, "_CHOSEN", {})
    (tmp_path / "calib.json").unlink()
    with pytest.raises(RuntimeError, match="probe launch failed"):
        calib.choose_engine("ont", cuda_device)


@pytest.mark.gpu
def test_two_ranks_cuda_match_one_process(tmp_path, cuda_device):
    """`python -m nextpolish_tpu_torch.launch --nprocs 2 run.cfg --device
    cuda` (both ranks on this card, task = 5,1 with the device engine)
    writes the one-process --device cuda run's FASTA and .stat; each rank
    polished a non-empty block and launched the hand kernels."""
    import os
    import pathlib
    import subprocess
    import sys

    from nextpolish_tpu_torch.__main__ import rank_lines

    root = pathlib.Path(__file__).resolve().parents[1]
    case = sim.simulate_short_case(59, [9000, 5000, 4000], 30)
    cfg = sim.write_project(str(tmp_path), case.names, case.drafts, "5,1",
                            sgs=case.records,
                            lgs=sim.long_reads(61, case.truths, 15))
    env = dict(os.environ, NPT_CNS_ENGINE="device", PYTHONPATH=os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")]))
    out = {}
    for label, cmd in (
            ("one", ["-m", "nextpolish_tpu_torch", cfg, "--device", "cuda"]),
            ("two", ["-m", "nextpolish_tpu_torch.launch", "--nprocs", "2",
                     cfg, "--device", "cuda"])):
        r = subprocess.run([sys.executable, *cmd], env=env, cwd=tmp_path,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        work = tmp_path / "work"
        out[label] = ((work / "genome.nextpolish.fasta").read_bytes(),
                      (work / "genome.nextpolish.fasta.stat").read_bytes())
        if label == "two":
            for step in ("01.lgs_polish", "02.score_chain"):
                for rank in range(2):
                    part = (work / step /
                            f"genome.nextpolish.part.fasta.rank{rank}")
                    assert part.stat().st_size > 0
            ranks = rank_lines(r.stderr)
            assert sorted(ranks) == [0, 1]
            for nproc, dev, card, launches, _ in ranks.values():
                assert nproc == 2 and dev.startswith("cuda")
                assert card == torch.cuda.get_device_name(0)
                assert launches["chain_forward"] > 0
                assert launches["level_chain"] > 0
        work.rename(tmp_path / f"work.{label}")
    assert out["two"] == out["one"]


@pytest.mark.gpu
def test_dryrun_over_two_entries_on_card_matches_cpu(cuda_device):
    """The port's dry run over [cuda:0, cuda:0] (each route held to one
    entry inside) writes the bytes and winners of the run over [cpu, cpu]
    (the task-1 case's length follows the entries), and entry's choices
    on the card equal those on the CPU; both run the chain and level
    kernels."""
    from nextpolish_tpu_torch import dryrun

    before = (_chain_launches(), tls.level_chain.launches,
              tls.level_winners.launches)
    card = dryrun.dryrun_multichip(2, cuda_device)
    assert _chain_launches()[0] > before[0][0]
    assert _chain_launches()[1] > before[0][1]
    assert tls.level_chain.launches > before[1]
    assert tls.level_winners.launches > before[2]
    cpu = dryrun.dryrun_multichip(2, "cpu")
    assert card["task1"] == cpu["task1"] and card["windows"] == 2
    for (bc, sc), (bp, sp) in zip(card["task5"], cpu["task5"]):
        assert np.array_equal(bc, bp) and np.array_equal(sc, sp)
    fn, args = dryrun.entry(cuda_device)
    fc, ac = dryrun.entry("cpu")
    assert torch.equal(fn(*args).cpu(), fc(*ac))


@pytest.mark.gpu
def test_stage_profiler_on_card(cuda_device):
    """The stage profiler at a small length on the card: every chain.*
    stage has device time, the seven stages hold 95% of the whole or
    more (a kernel the attribution misses goes to `other`), the hand
    kernels sit in their stages, and the profiled bytes equal the
    CPU's."""
    from nextpolish_tpu_torch import profile_chain as pc

    bufs, key = pc.build_case(20_000, cuda_device)
    report, got = pc.profile_stages(bufs, key, cuda_device)
    stages, whole = report["stages"], report["whole_ms"]
    assert whole > 0
    for s in pc.STAGES:
        assert stages[s]["ms"] > 0, s
    assert sum(stages[s]["ms"] for s in pc.STAGES) >= 0.95 * whole
    assert any("fwd_" in n for n in stages["chain.forward"]["kernels"])
    assert any("tb_" in n for n in stages["chain.traceback"]["kernels"])
    for s, v in stages.items():
        for n in v["kernels"]:
            assert not ("fwd_" in n and s != "chain.forward"), (s, n)
            assert not ("tb_" in n and s != "chain.traceback"), (s, n)
    cpu = tch.chain_correct_planes_batch(
        torch.from_numpy(bufs.view(np.int16)), *key).numpy()
    assert np.array_equal(got, cpu)
