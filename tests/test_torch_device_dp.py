"""The port's engine-2 device path around the level scan: window
preparation against the JAX package, the cross-contig batcher against the
port's native engine, and the host services the path leans on (device
choice, memory budget, thread-safe region fetch)."""
import threading

import numpy as np
import pytest
import torch

from nextpolish_tpu.io.bam import read_bam as jax_read_bam
from nextpolish_tpu.models.cns import device_dp as jdd
from nextpolish_tpu.models.cns import msa as jmsa
from nextpolish_tpu.models.cns import window as jwin
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.io.bam import read_bam
from nextpolish_tpu_torch.models.cns import device_dp as tdd
from nextpolish_tpu_torch.models.cns import msa as tmsa
from nextpolish_tpu_torch.models.cns import window as twin


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("device_dp")
    c = sim.simulate_case(21, 4, [4000, 2500, 3000, 2000], 30,
                          read_len=(800, 2500))
    fa, bam = sim.write_case(c, str(d))
    return c, fa, bam


def _assert_same(a, b, name):
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert np.array_equal(a, b), name


@pytest.mark.parametrize("rt", ["ont", "hifi"])
def test_prepare_window_matches_jax(case, rt):
    """window_prep + prepare_window (native preparer) and the numpy
    build_edges + densify_window pair give the JAX package's arrays."""
    c, _, bam = case
    jb, tb = jax_read_bam(bam), read_bam(bam)
    for tid, draft in enumerate(c.drafts):
        ca = np.frombuffer(draft, dtype=np.uint8)
        jw = jwin.window_prep(jb, tid, ca, 0, len(draft), rt, None,
                              c.names[tid])
        tw = twin.window_prep(tb, tid, ca, 0, len(draft), rt, None,
                              c.names[tid])
        _assert_same(jw.coverage, tw.coverage, "coverage")
        for f in ("t_pos", "delta", "q_base", "row_off"):
            _assert_same(getattr(jw.merged, f), getattr(tw.merged, f), f)
        je, jd = jdd.prepare_window(jw.merged, jw.coverage, jw.L)
        te, td = tdd.prepare_window(tw.merged, tw.coverage, tw.L)
        ne = tmsa.build_edges(tw.merged)
        nd = tdd.densify_window(ne, tw.coverage, tw.L)
        jnd = jdd.densify_window(jmsa.build_edges(jw.merged), jw.coverage,
                                 jw.L)
        for f in ("cur", "pp", "ppp", "link", "ins", "tag_key", "tag_off"):
            _assert_same(getattr(je, f), getattr(te, f), f)
            _assert_same(getattr(jnd.edges, f), getattr(ne, f), f)
        for f in ("ent_lvl", "ent_b", "ent_slot", "ent_A", "ent_M",
                  "ent_same", "meta", "eorder", "level_pos"):
            _assert_same(getattr(jd, f), getattr(td, f), f)
            _assert_same(getattr(jnd, f), getattr(nd, f), f)
        for f in ("n_levels", "Vb", "E", "length"):
            assert getattr(jd, f) == getattr(td, f) == getattr(nd, f), f


def test_device_link_dp_matches_numpy(case):
    """The scan, mapped back onto the EdgeTable, picks the numpy link_dp's
    winners and scores for every read type."""
    from nextpolish_tpu_torch.models.cns.dp import link_dp

    c, _, bam = case
    tb = read_bam(bam)
    ca = np.frombuffer(c.drafts[0], dtype=np.uint8)
    w = twin.window_prep(tb, 0, ca, 0, len(c.drafts[0]), "ont", None, "c")
    edges, dw = tdd.prepare_window(w.merged, w.coverage, w.L)
    for rt in ("ont", "clr", "rs", "hifi"):
        s_np, b_np = link_dp(edges, w.coverage, rt)
        ((best, sc),) = tdd._run_batch([dw], rt, devices=["cpu"])
        s_dev, b_dev = tdd._to_edge_outputs(dw, best, sc)
        assert np.array_equal(b_np, b_dev)
        assert np.array_equal(s_np[b_np], s_dev[b_dev])


def test_shared_batcher_matches_native(case, monkeypatch):
    """Contigs polished concurrently through ONE shared batcher (windows
    of different contigs in one launch) equal the native engine."""
    from nextpolish_tpu_torch.io.bamregion import RegionFetcher
    from nextpolish_tpu_torch.models.cns.batcher import CnsBatcher
    from nextpolish_tpu_torch.models.ctg_cns import ctg_cns_contig
    from nextpolish_tpu_torch.runtime import trace
    from nextpolish_tpu_torch.runtime.overlap import pipelined_map

    c, _, bam = case
    fetcher = RegionFetcher([bam])
    items = list(zip(c.names, c.drafts))
    monkeypatch.setenv("NPT_CNS_ENGINE", "native")
    want = [ctg_cns_contig(n, d, fetcher, "ont", device="cpu")
            for n, d in items]
    monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    trace.reset("cns.")
    bat = CnsBatcher("ont", max_batch=4, device="cpu")
    got = list(pipelined_map(
        lambda nd: ctg_cns_contig(nd[0], nd[1], fetcher, "ont",
                                  batcher=bat, device="cpu"),
        items, depth=4))
    assert got == want
    assert bat.prepping == 0 and not bat.pending
    snap = trace.snapshot("cns.")
    assert snap["cns.windows"]["s"] == len(items)
    assert snap["cns.launches"]["s"] < len(items)  # windows were grouped


def test_batcher_partial_flush(case):
    """A single producer with fewer windows than a batch must not wait
    forever — partial groups flush when every producer is blocked."""
    from nextpolish_tpu_torch.models.cns.batcher import CnsBatcher
    from nextpolish_tpu_torch.models.cns.dp import link_dp

    c, _, bam = case
    tb = read_bam(bam)
    ca = np.frombuffer(c.drafts[3], dtype=np.uint8)
    work = twin.window_prep(tb, 3, ca, 0, len(c.drafts[3]), "ont", None,
                            "c")
    edges, dw = tdd.prepare_window(work.merged, work.coverage, work.L)
    assert dw is not None
    bat = CnsBatcher("ont", max_batch=8, device="cpu")
    with bat.contig():
        fut = bat.submit(dw)
        host = bat.submit(None)
    assert host.result() is None  # a refused window goes to the host
    done = []
    t = threading.Thread(target=lambda: done.append(fut.result()))
    t.start()
    t.join(timeout=60)
    assert done and done[0] is not None
    score, best = done[0]
    s_ref, b_ref = link_dp(edges, work.coverage, "ont")
    assert np.array_equal(best, b_ref)


def test_region_fetch_is_thread_safe(case):
    """Windows of several contigs fetched from more threads than cores at
    once (as worker2 does) read the same records as one thread."""
    import os
    import sys

    from nextpolish_tpu_torch.io.bamregion import RegionFetcher

    c, _, bam = case
    fetcher = RegionFetcher([bam])
    fetcher.bams[0].CACHE_BLOCKS = 2  # force re-reads under contention
    regions = [(t, s, s + 700) for t in range(4) for s in (0, 500, 1200)]
    regions *= max(1, (2 * (os.cpu_count() or 1)) // len(regions) + 1)
    want = [fetcher.fetch(*r) for r in regions]
    got = [None] * len(regions)

    def work(i):
        for _ in range(3):
            got[i] = fetcher.fetch(*regions[i])

    ts = [threading.Thread(target=work, args=(i,))
          for i in range(len(regions))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    for w, g in zip(want, got):
        assert np.array_equal(w.pos, g.pos)
        assert np.array_equal(w.cigar, g.cigar)
        assert np.array_equal(w.seq, g.seq)


@pytest.mark.parametrize("seed", range(3))
def test_poa_copies_match(seed):
    """The LQ repair's POA: the port's native copy equals its Python DAG
    (the oracle), and both POA modules equal the JAX package's."""
    from nextpolish_tpu import native as jax_native
    from nextpolish_tpu.models.cns import poa as jpoa
    from nextpolish_tpu_torch import native
    from nextpolish_tpu_torch.models.cns import poa as tpoa
    from nextpolish_tpu_torch.models.cns.poadag import poa_to_consensus

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, int(rng.integers(40, 150)))
    seqs = []
    for _ in range(int(rng.integers(3, 7))):
        s = base.copy()
        for _ in range(int(rng.integers(0, 8))):
            p = int(rng.integers(0, len(s)))
            r = rng.random()
            if r < 0.4:
                s[p] = rng.integers(0, 4)
            elif r < 0.7:
                s = np.delete(s, p)
            else:
                s = np.insert(s, p, rng.integers(0, 4))
        seqs.append(bytes(b"ATGC"[int(c)] for c in s) or b"A")
    got = native.poa_consensus(seqs)
    assert got == poa_to_consensus(seqs) == jax_native.poa_consensus(seqs)
    assert tpoa.poa_consensus(seqs) == jpoa.poa_consensus(seqs)


def test_default_engine_and_device(monkeypatch):
    """NPT_CNS_ENGINE wins; otherwise the CPU runs the native engine, a
    card the engine calib measures faster, and asking for cuda without a
    card raises instead of falling back."""
    from nextpolish_tpu_torch.device import resolve_device
    from nextpolish_tpu_torch.runtime.budget import (
        device_free_bytes,
        host_available_bytes,
    )

    monkeypatch.setenv("NPT_CNS_ENGINE", "numpy")
    assert twin.default_engine("cpu") == "numpy"
    monkeypatch.delenv("NPT_CNS_ENGINE")
    assert twin.default_engine("cpu") == "native"
    assert resolve_device("cpu") == torch.device("cpu")
    assert device_free_bytes("cpu") > 0
    assert abs(device_free_bytes("cpu") - host_available_bytes()) < 2 ** 30
    if torch.cuda.is_available():
        assert twin.default_engine("cuda") in ("device", "native")
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            twin.default_engine()
