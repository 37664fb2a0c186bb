"""Card-only tests of the port: the hand-written CUDA level-scan kernel
against its plain PyTorch version, the pinned-buffer launch path, and
worker2 --device cuda against --device cpu.

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

RTS = ["ont", "clr", "rs", "hifi"]


@pytest.fixture
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


@pytest.fixture
def windows(tmp_path, cuda_device):
    return (_windows(tmp_path, 5, [900, 1600, 500, 3000], 30, 0.03,
                     (300, 900))
            + _windows(tmp_path, 0, [2000], 110, 0.05, (1000, 2000),
                       (1000, 1, False))
            + _windows(tmp_path, 1, [1600], 30, 0.03, (800, 1600),
                       (800, 12, True))
            + _windows(tmp_path, 2, [1600], 8, 0.03, (800, 1600),
                       (800, 300, True)))


@pytest.mark.gpu
@pytest.mark.parametrize("rt", RTS)
def test_kernel_matches_plain_on_card(windows, rt, cuda_device):
    """The CUDA kernel equals the plain version byte for byte (E up to
    24, Vb > 8, a deep insertion chain), and one call is one launch."""
    assert max(dw.E for dw in windows) > 20
    assert max(dw.Vb for dw in windows) > 8
    b = tdd.pack_batch(windows).to(cuda_device)
    rt_id, c = tdd.READ_TYPE_ID[rt], tdd.COV_COEF[rt]
    before = tls.level_scan.launches
    kb, ks = tls.level_scan(b, rt_id, c)
    assert tls.level_scan.launches == before + 1
    pb, ps = tls.level_scan_plain(b, rt_id, c)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(kb, pb) and torch.equal(ks, ps)


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
    """Tensors on two devices, a wrong dtype or an unknown read type are
    refused before anything launches."""
    b = tdd.pack_batch(windows[:1]).to(cuda_device)
    before = tls.level_scan.launches
    with pytest.raises(ValueError):
        tls.level_scan(dataclasses.replace(b, meta=b.meta.cpu()), 0, 3)
    with pytest.raises(TypeError):
        tls.level_scan(dataclasses.replace(b, meta=b.meta.long()), 0, 3)
    with pytest.raises(ValueError):
        tls.level_scan(b, 7, 3)
    assert tls.level_scan.launches == before


@pytest.mark.gpu
def test_worker2_cuda_matches_cpu(tmp_path, cuda_device, monkeypatch):
    """The whole slice on the card writes the CPU run's bytes."""
    from nextpolish_tpu_torch import worker2

    case = sim.simulate_case(31, 2, [12000, 9000], 12, read_len=(2000, 5000))
    fa, bam = sim.write_case(case, str(tmp_path))
    monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    before = tls.level_scan.launches
    assert worker2.main(["-g", fa, "-l", bam, "-r", "ont", "-o",
                         str(tmp_path / "gpu.fa"), "--device", "cuda"]) == 0
    assert tls.level_scan.launches > before
    assert worker2.main(["-g", fa, "-l", bam, "-r", "ont", "-o",
                         str(tmp_path / "cpu.fa"), "--device", "cpu"]) == 0
    assert (tmp_path / "gpu.fa").read_bytes() == \
        (tmp_path / "cpu.fa").read_bytes()
