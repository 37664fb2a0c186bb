"""Card-only tests of the port: the hand-written CUDA level-scan kernels
(the chain and the winners) against their plain PyTorch versions, the
pinned-buffer launch path, and worker2 --device cuda against --device cpu.

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
        got = tdd._run_batch(windows, "ont", device=cuda_device,
                             sc_tail=sc_tail)
        ref = tdd._run_batch(windows, "ont", device="cpu", sc_tail=sc_tail)
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
