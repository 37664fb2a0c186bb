"""The port's level scan (nextpolish_tpu_torch/models/cns/level_scan.py)
against the JAX package's engine-2 device scan.

Windows are simulated with numpy from fixed seeds, prepared ONCE by the
JAX package (window_prep + prepare_window) and carried to the port with
device_dp.dense_window_from_arrays, so both sides scan identical levels.
The port's plain PyTorch version must equal, exactly (all integer
arithmetic), the JAX lax.scan path for every read type and every window,
and the Pallas kernel (interpret mode on the CPU) wherever that kernel
takes the window (E <= 20).  The hand-written CUDA kernel is held to the
plain version by tests/test_torch_gpu.py, which needs a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from nextpolish_tpu.io.bam import read_bam as jax_read_bam
from nextpolish_tpu.models.cns import device_dp as jdd
from nextpolish_tpu.models.cns.window import window_prep as jax_window_prep
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.models.cns import device_dp as tdd
from nextpolish_tpu_torch.models.cns import level_scan as tls

RTS = ["ont", "clr", "rs", "hifi"]


def jax_prepared_windows(outdir, seed, lengths, depth, err, read_len,
                         hotspot=None):
    """Simulate one whole-contig window per length and prepare each with
    the JAX package; returns [(jax DenseWindow, port DenseWindow)]."""
    case = sim.simulate_case(seed, len(lengths), lengths, depth, read_len,
                             sub=err, ins=err, dele=err, hotspot=hotspot)
    _, bam = sim.write_case(case, str(outdir))
    batch = jax_read_bam(bam)
    out = []
    for tid, draft in enumerate(case.drafts):
        ca = np.frombuffer(draft, dtype=np.uint8)
        work = jax_window_prep(batch, tid, ca, 0, len(draft), "ont", None,
                               case.names[tid])
        _, jdw = jdd.prepare_window(work.merged, work.coverage, work.L)
        assert jdw is not None
        out.append((jdw, tdd.dense_window_from_arrays(
            dataclasses.asdict(jdw))))
    return out


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """B>1 windows of different lengths, then the special shapes."""
    d = tmp_path_factory.mktemp("level_scan")
    ws = {}
    ws["batch"] = jax_prepared_windows(d / "b", 5, [900, 1600, 500], 30,
                                       0.03, (300, 900))
    ws["e20"] = jax_prepared_windows(d / "t", 2, [1200], 70, 0.05,
                                     (500, 1200), (600, 1, False))
    ws["wide_e"] = jax_prepared_windows(d / "e", 0, [2000], 110, 0.05,
                                        (1000, 2000), (1000, 1, False))
    ws["deep_ring"] = jax_prepared_windows(d / "v", 1, [1600], 30, 0.03,
                                           (800, 1600), (800, 12, True))
    ws["chain"] = jax_prepared_windows(d / "c", 2, [1600], 8, 0.03,
                                       (800, 1600), (800, 300, True))
    return ws


def _all(windows):
    return [p for k in ("batch", "e20", "wide_e", "deep_ring", "chain")
            for p in windows[k]]


def test_windows_cover_the_shapes(windows):
    """The fixture really has B>1 lengths, 17<=E<=20, 21<=E<=24, Vb>8 and
    a deep insertion chain (so the comparisons below exercise them)."""
    lens = {dw.n_levels for dw, _ in windows["batch"]}
    assert len(lens) == 3
    (t,) = windows["e20"]
    assert 17 <= t[0].E <= 20
    (e,) = windows["wide_e"]
    assert 21 <= e[0].E <= 24
    (v,) = windows["deep_ring"]
    assert v[0].Vb > 8
    (c,) = windows["chain"]
    _, counts = np.unique(c[0].level_pos, return_counts=True)
    assert counts.max() >= 200
    assert max(dw.E for dw, _ in windows["batch"]) <= 20


def test_dense_window_from_arrays(windows):
    for jdw, pdw in _all(windows):
        for f in dataclasses.fields(jdw):
            a, b = getattr(jdw, f.name), getattr(pdw, f.name)
            if f.name == "edges":
                for g in dataclasses.fields(a):
                    assert np.array_equal(getattr(a, g.name),
                                          getattr(b, g.name))
            elif isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


@pytest.mark.parametrize("rt", RTS)
def test_plain_matches_lax_scan(windows, rt, monkeypatch):
    """Every window, every read type: best and sc equal the lax.scan path
    in full, and with sc_tail from each window's last position on."""
    monkeypatch.setenv("NPT_CNS_PALLAS", "0")
    pairs = _all(windows)
    ref = jdd._run_batch([j for j, _ in pairs], rt)
    got = tdd._run_batch([p for _, p in pairs], rt, device="cpu")
    tail = tdd._run_batch([p for _, p in pairs], rt, device="cpu",
                          sc_tail=True)
    for (_, pdw), (rb, rs), (gb, gs), (tb, ts) in zip(pairs, ref, got,
                                                      tail):
        assert gb.dtype == np.int8 and gs.dtype == np.int32
        assert np.array_equal(rb, gb)
        assert np.array_equal(rs, gs)
        l0 = tdd.tail_start(pdw)
        assert np.array_equal(rb, tb)
        assert np.array_equal(rs[l0:], ts[l0:])
        assert (ts[:l0] == tls.NEG).all()


@pytest.mark.parametrize("rt", RTS)
def test_plain_matches_pallas_interpret(windows, rt):
    """The B>1 batch and the 17<=E<=20 window against the Pallas kernel
    itself (interpret mode), full scores and score tails."""
    pairs = windows["batch"] + windows["e20"]
    for sc_tail in (False, True):
        ref = jdd._run_batch_pallas([j for j, _ in pairs], rt,
                                    sc_tail=sc_tail)
        got = tdd._run_batch([p for _, p in pairs], rt, device="cpu",
                             sc_tail=sc_tail)
        for (_, pdw), (rb, rs), (gb, gs) in zip(pairs, ref, got):
            assert np.array_equal(rb, gb)
            l0 = tdd.tail_start(pdw) if sc_tail else 0
            assert np.array_equal(rs[l0:], gs[l0:])


def test_plain_is_per_window_exact(windows):
    """Batching is invisible: each window scanned alone equals the same
    window inside a batch with wider E / Vb neighbours."""
    pairs = _all(windows)
    batched = tdd._run_batch([p for _, p in pairs], "ont", device="cpu")
    for (_, pdw), (bb, bs) in zip(pairs, batched):
        ((ab, as_),) = tdd._run_batch([pdw], "ont", device="cpu")
        assert np.array_equal(ab, bb) and np.array_equal(as_, bs)


def test_wrapper_routes_and_checks(windows):
    """CPU tensors take the plain version (no kernel launch is counted);
    tensors on two devices, or a negative link, are refused by the
    wrapper."""
    pairs = windows["batch"]
    b = tdd.pack_batch([p for _, p in pairs])
    before = tls.level_scan.launches
    best, sc = tls.level_scan(b, 0, 3)
    assert tls.level_scan.launches == before
    pb, ps = tls.level_scan_plain(b, 0, 3)
    assert torch.equal(best, pb) and torch.equal(sc, ps)
    meta_dev = torch.empty(0, device="meta")
    bad = dataclasses.replace(b, meta=meta_dev)
    with pytest.raises(ValueError):
        tls.level_scan(bad, 0, 3)
    _, pdw = pairs[0]
    neg = dataclasses.replace(pdw, ent_A=pdw.ent_A | np.int32(-2 ** 31))
    with pytest.raises(ValueError):
        tls.level_scan(tdd.pack_batch([neg]), 0, 3)
