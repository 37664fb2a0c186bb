"""Several devices inside one process in the port, on the CPU: the
reads-sharded merge of task 1 (parallel/shard.py::reads_merge_fwd) over
R shards against the JAX package's make_reads_merge_fwd on a mesh of R
virtual devices, bit for bit, with a count that passes 65,535 only after
the sum; score_chain_contig_sharded over [cpu] * R against the JAX
package's sharded route and the port's single launch (several windows,
and a boundary pinned on a divergence-prone cell); the router
score_chain_pipeline_multichip against the JAX router; the contig
round-robin of score_chain_pipeline against one device and the JAX
package's NPT_MULTIDEV run; engine 2's group round-robin (_run_batch);
resolve_devices with a mocked card count; and the launcher's split of a
host's cards over its local ranks.  Byte equality is the tolerance
throughout."""
import subprocess

import numpy as np
import pytest
import torch

import nextpolish_tpu.models.score_chain as jax_sc
import nextpolish_tpu.parallel.shard as jax_shard
from nextpolish_tpu.io import bam as jax_bam
from nextpolish_tpu_torch import device as tdevice
from nextpolish_tpu_torch import launch, sim
from nextpolish_tpu_torch.io.bam import read_bam
from nextpolish_tpu_torch.io.fasta import ASCII_TO_NIB
from nextpolish_tpu_torch.models import score_chain as tsc
from nextpolish_tpu_torch.models.cns import device_dp as tdd
from nextpolish_tpu_torch.models.cns.window import window_prep
from nextpolish_tpu_torch.models.contig_state import ContigState
from nextpolish_tpu_torch.ops import chain as tch
from nextpolish_tpu_torch.ops import pileup as tpl
from nextpolish_tpu_torch.ops.symbols import K3, S
from nextpolish_tpu_torch.parallel import shard as tsh
from nextpolish_tpu_torch.runtime import trace
from test_torch_windowed import _case, _prone_cells


def _cpus(n):
    """A device list that names the CPU n times."""
    return [torch.device("cpu")] * n


def _indexed_cpus(n):
    """n CPU devices that differ only in their index (cpu:0, cpu:1, ...):
    every tensor still lands on the CPU, but the entries compare unequal,
    so a record of each group's device names its entry."""
    return [torch.device("cpu", k) for k in range(n)]


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _shard_pileups(draft, tbatch, R):
    """The port's sparse walks of ctg1's reads in R contiguous BAM-order
    blocks, as score_chain_contig_sharded splits them."""
    levels = tpl.filter_sgs_chain(tbatch)
    tid = tbatch.header.name2id("ctg1")
    index = tpl.build_cell_index(tbatch, levels, tid, 0, len(draft) - 1)
    state = ContigState.from_draft("ctg1", draft, index)
    nib = ASCII_TO_NIB[np.frombuffer(draft, dtype=np.uint8)]
    view = state.index.region_view(0, len(draft) - 1)
    qual = np.flatnonzero(levels >= 1)
    out = []
    for r in range(R):
        lr = np.zeros_like(levels)
        sel = qual[len(qual) * r // R:len(qual) * (r + 1) // R]
        lr[sel] = levels[sel]
        out.append(tpl.build_pileup_sparse(tbatch, lr, 1, view, tid, nib,
                                           2, include_ref=(r == 0)))
    return out, view.n_cells_dp


@pytest.mark.parametrize("R,first", [(2, True), (4, False)])
def test_reads_merge_fwd_matches_jax(tmp_path, R, first):
    """One window over R shards: P, flags, msel and fend bit-equal to the
    JAX package's psum/pmin merge, with one (cell, kmer) counted 40,000
    times in every shard (added where a shard lacks it), so that only the
    sum passes the u16 clamp."""
    draft, _, tbatch = _case(tmp_path, 5, L=4000, n_reads=400)
    shards, n_dp = _shard_pileups(draft, tbatch, R)
    L = tch.pad_to_chunk(n_dp)
    cut = [int(np.searchsorted(p.uk, n_dp * K3)) for p in shards]
    heavy = int(shards[0].uk[cut[0] // 2])
    uks, cns, keys = [], [], []
    for r, (p, m) in enumerate(zip(shards, cut)):
        uk = p.uk[:m].astype(np.int64)
        cn = np.minimum(p.cn[:m], 0xFFFF).astype(np.int32)
        key = (r << 16) | p.rk[:m].astype(np.int32)
        i = int(np.searchsorted(uk, heavy))
        if i == len(uk) or uk[i] != heavy:
            uk, cn = np.insert(uk, i, heavy), np.insert(cn, i, 0)
            key = np.insert(key, i, (r << 16) | 1000)
        cn[i] = 40_000
        uks.append(uk)
        cns.append(cn)
        keys.append(key)
    assert 40_000 * R > 0xFFFF
    th = tch.coverage_thresholds(255, 0.8).astype(np.int32)
    refk = np.zeros(L, np.int32)
    refk[:n_dp] = shards[0].refkmer[:n_dp]
    totals = np.zeros((R, L), np.int32)
    for r, p in enumerate(shards):
        totals[r, :n_dp] = p.total[:n_dp]
    s0_in = np.where(np.arange(S) % 3 == 0, -7.5, -1.0).astype(np.float32)

    E = tch._pow2(max(map(len, uks)))
    uk = np.full((R, E), L * K3, np.int32)
    cn = np.zeros((R, E), np.int32)
    key = np.full((R, E), jax_shard.KBIG, np.int32)
    for r, m in enumerate(map(len, uks)):
        uk[r, :m], cn[r, :m], key[r, :m] = uks[r], cns[r], keys[r]
    fwd = jax_shard.make_reads_merge_fwd(jax_shard.reads_mesh(R), L, E,
                                         len(th))
    want = fwd(uk, cn, key, totals, refk, th, np.float32(0.5),
               np.int32(n_dp), s0_in, np.bool_(first))

    parts = [(torch.from_numpy(uks[r]), torch.from_numpy(cns[r]),
              torch.from_numpy(keys[r]), torch.from_numpy(totals[r]))
             for r in range(R)]
    got = tsh.reads_merge_fwd(parts, torch.from_numpy(refk),
                              torch.from_numpy(th), 0.5, n_dp,
                              torch.from_numpy(s0_in), first, L)
    for name, g, w in zip(("P", "flags", "msel"), got[:3], want[:3]):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64)), name
    assert np.array_equal(_bits(got[3].numpy()), _bits(want[3]))
    # the clamp came after the sum: the heavy cell's merged count is 0xFFFF
    counts, _, _ = tsh.merge_shards(
        [tsh.scatter_shard(*p[:3], L) for p in parts],
        [p[3] for p in parts], torch.device("cpu"))
    assert int(counts.reshape(-1)[heavy]) == 0xFFFF


@pytest.mark.parametrize("R", [2, 8])
def test_sharded_contig_matches_jax_and_single_launch(tmp_path, R):
    draft, jbatch, tbatch = _case(tmp_path, 0, L=4000, n_reads=400)
    single = tsc.score_chain_contig("ctg1", draft, tbatch, tsc.AlgoConfig(),
                                    device="cpu")
    got = tsc.score_chain_contig_sharded("ctg1", draft, tbatch,
                                         tsc.AlgoConfig(), _cpus(R))
    want = jax_sc.score_chain_contig_sharded(
        "ctg1", draft, jbatch, jax_sc.AlgoConfig(), jax_shard.reads_mesh(R))
    assert got == want
    assert got == single


def _sharded_windows(draft, jbatch, tbatch, R, window, monkeypatch):
    monkeypatch.setattr(tsc, "SHARD_WINDOW_CELLS", window)
    monkeypatch.setattr(jax_sc, "SHARD_WINDOW_CELLS", window)
    trace.reset("task1")
    got = tsc.score_chain_contig_sharded("ctg1", draft, tbatch,
                                         tsc.AlgoConfig(), _cpus(R))
    snap = trace.snapshot("task1")
    want = jax_sc.score_chain_contig_sharded(
        "ctg1", draft, jbatch, jax_sc.AlgoConfig(), jax_shard.reads_mesh(R))
    single = tsc.score_chain_contig("ctg1", draft, tbatch, tsc.AlgoConfig(),
                                    device="cpu")
    assert got == want
    assert got == single
    assert all(f"task1.shard{r}.walk" in snap for r in range(R))
    return int(snap["task1.windows"]["s"])


def test_sharded_windows_match_jax(tmp_path, monkeypatch):
    """2,048-cell windows over four shards: the state chaining and the
    backward stitch over the merged windows stay byte-exact."""
    draft, jbatch, tbatch = _case(tmp_path, 1, L=6000, n_reads=500)
    assert _sharded_windows(draft, jbatch, tbatch, 4, 2048,
                            monkeypatch) >= 3


def test_sharded_stitch_divergence_prone_boundary(tmp_path, monkeypatch):
    """A window boundary on a divergence-prone cell over four shards, at
    least 3 windows."""
    draft, jbatch, tbatch = _case(tmp_path, 3)
    prone, n_dp = _prone_cells(draft, jbatch)
    fit = [c for c in prone if -(-n_dp // c) >= 3]
    assert fit, "case no longer has a divergence-prone cell for 3 windows"
    assert _sharded_windows(draft, jbatch, tbatch, 4, max(fit),
                            monkeypatch) >= 3


@pytest.mark.parametrize("shard_min", [1000, 10 ** 9])
def test_router_matches_jax(tmp_path, shard_min):
    """score_chain_pipeline_multichip over [cpu] * 4 against the JAX
    router on a mesh of 4: the contig takes the sharded route at
    shard_min 1,000 and the pipeline at 10^9."""
    draft, jbatch, tbatch = _case(tmp_path, 2, L=5000, n_reads=400)
    pairs = [("ctg1", draft)]
    trace.reset("task1")
    got = list(tsc.score_chain_pipeline_multichip(
        pairs, tbatch, tsc.AlgoConfig(), devices=_cpus(4),
        shard_min=shard_min))
    snap = trace.snapshot("task1")
    want = list(jax_sc.score_chain_pipeline_multichip(
        pairs, jbatch, jax_sc.AlgoConfig(), mesh=jax_shard.reads_mesh(4),
        shard_min=shard_min))
    assert got == want
    if shard_min == 1000:
        assert "task1.shard3.walk" in snap
        assert "task1.chain_launches" not in snap
    else:
        assert snap["task1.chain_launches"]["s"] == 1
        assert "task1.windows" not in snap


@pytest.fixture(scope="module")
def five_contigs(tmp_path_factory):
    """Five 3 kb contigs, PE150 at 20x, in one sorted BAM read by both
    packages."""
    c = sim.simulate_short_case(31, [3000, 2600, 3000, 2200, 2800], 20)
    d = tmp_path_factory.mktemp("five")
    fa, bam = sim.write_case(c, str(d))
    return c, jax_bam.read_bam(bam), read_bam(bam)


def test_pipeline_round_robin_matches_one_device_and_jax(five_contigs,
                                                         monkeypatch):
    """score_chain_pipeline over four device entries sends contig k's
    launch to entry k mod 4, and writes the bytes of one device and of
    the JAX package's round-robin over its eight virtual devices."""
    c, jbatch, tbatch = five_contigs
    pairs = list(zip(c.names, c.drafts))
    one = list(tsc.score_chain_pipeline(pairs, tbatch, tsc.AlgoConfig(),
                                        devices="cpu"))
    devs = _indexed_cpus(4)
    seen = []
    dispatch = tsc.dispatch_chain_group

    def spy(handles, device=None):
        seen.append(([h.name for h in handles], devs.index(device)))
        dispatch(handles, device)

    monkeypatch.setattr(tsc, "dispatch_chain_group", spy)
    trace.reset("task1")
    four = list(tsc.score_chain_pipeline(pairs, tbatch, tsc.AlgoConfig(),
                                         devices=devs))
    assert sorted(seen) == [([n], k % 4) for k, n in enumerate(c.names)]
    snap = trace.snapshot("task1.groups")
    assert {k: v["s"] for k, v in snap.items()} == {
        "task1.groups.entry0": 2, "task1.groups.entry1": 1,
        "task1.groups.entry2": 1, "task1.groups.entry3": 1}
    monkeypatch.setenv("NPT_MULTIDEV", "1")
    jax_out = list(jax_sc.score_chain_pipeline(pairs, jbatch,
                                               jax_sc.AlgoConfig()))
    assert four == one
    assert four == jax_out


def test_run_batch_round_robin_matches_one_device(tmp_path, monkeypatch):
    """Engine 2's 17 windows over two device entries: groups of 8, 8 and
    1 on entries 0, 1, 0, with the winners and scores of one device."""
    case = sim.simulate_case(23, 17, 400, 8, read_len=(150, 400))
    _, bam = sim.write_case(case, str(tmp_path))
    batch = read_bam(bam)
    dws = []
    for tid, draft in enumerate(case.drafts):
        w = window_prep(batch, tid, np.frombuffer(draft, dtype=np.uint8),
                        0, len(draft), "ont", None, case.names[tid])
        _, dw = tdd.prepare_window(w.merged, w.coverage, w.L)
        assert dw is not None
        dws.append(dw)
    one = tdd._run_batch(dws, "ont", devices=["cpu"])
    devs = _indexed_cpus(2)
    seen = []
    dispatch = tdd.dispatch_group

    def spy(group, read_type, device=None, *a):
        seen.append((len(group), devs.index(device)))
        return dispatch(group, read_type, device, *a)

    monkeypatch.setattr(tdd, "dispatch_group", spy)
    trace.reset("cns")
    two = tdd._run_batch(dws, "ont", devices=devs)
    assert seen == [(8, 0), (8, 1), (1, 0)]
    snap = trace.snapshot("cns.groups")
    assert {k: v["s"] for k, v in snap.items()} == {
        "cns.groups.entry0": 2, "cns.groups.entry1": 1}
    assert len(two) == len(one) == 17
    for (b2, s2), (b1, s1) in zip(two, one):
        assert np.array_equal(b2, b1) and np.array_equal(s2, s1)


@pytest.mark.parametrize("spec,want", [
    ("cuda", ["cuda:0", "cuda:1", "cuda:2"]),
    (None, ["cuda:0", "cuda:1", "cuda:2"]),
    ("cuda:2", ["cuda:2"]),
    ("cpu", ["cpu"]),
    (["cpu", "cuda:1"], ["cpu", "cuda:1"]),
])
def test_resolve_devices_with_three_cards(monkeypatch, spec, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert [str(d) for d in tdevice.resolve_devices(spec)] == want


def test_resolve_devices_refuses(monkeypatch):
    """`cuda` without a usable card raises, as resolve_device does, and
    so do other backends and an empty list."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("cuda", "cuda:1", None, ["cpu", "cuda"]):
        with pytest.raises(RuntimeError, match="is_available"):
            tdevice.resolve_devices(spec)
    for spec in ("meta", []):
        with pytest.raises(ValueError):
            tdevice.resolve_devices(spec)


@pytest.mark.parametrize("cards,env,want", [
    (4, None, ["0,2", "1,3"]),
    (2, None, ["0", "1"]),
    (1, None, ["0", "0"]),
    (0, "3,5,6,7", ["3,6", "5,7"]),
])
def test_launch_local_splits_the_cards(monkeypatch, cards, env, want):
    """Two local ranks of --device cuda see disjoint cards (rank r the
    cards r, r+2, ... of the launcher's), and share card r mod k when
    there are fewer cards than ranks; CUDA_VISIBLE_DEVICES, where set,
    names the cards."""
    seen = []

    class FakeProc:
        def wait(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, env=None: seen.append(env) or FakeProc())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    base = {} if env is None else {"CUDA_VISIBLE_DEVICES": env}
    assert launch.launch_local("run.cfg", 2, base, "cuda") == 0
    assert [e["CUDA_VISIBLE_DEVICES"] for e in seen] == want
    seen.clear()
    assert launch.launch_local("run.cfg", 2, base, "cpu") == 0
    assert all(e.get("CUDA_VISIBLE_DEVICES") == env for e in seen)
