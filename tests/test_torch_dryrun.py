"""The port's dry run (nextpolish_tpu_torch/dryrun.py) against the JAX
package's (__graft_entry__.py), and the benchmark fixtures it runs
(sim.make_task1_case, sim.make_task5_case) against bench.py's: entry()'s
choices byte-equal to the JAX step's under jax.jit on the CPU; the
fixtures' arrays and bytes equal for the same seed; dryrun_multichip over
[cpu, cpu] passing, its task-1 bytes equal to the JAX package's
score_chain_contig and its engine-2 winners to the JAX package's
_run_batch on the windows the JAX dry run builds.  Byte equality is the
tolerance throughout."""
import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import __graft_entry__ as graft  # noqa: E402
import bench  # noqa: E402
from nextpolish_tpu_torch import dryrun, sim  # noqa: E402

TASK1 = dict(L=1024, depth=12, n_contigs=1, p_indel=0.0, clip_frac=0.0,
             p_sub=0.02)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU work here is many small torch ops (the plain level
    scan steps a level at a time); on a host whose cores are all busy,
    one intra-op thread a process runs it about 60 times faster than
    one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_jax():
    fn, args = graft.entry()
    want = np.asarray(jax.jit(fn)(*args)[0])
    tfn, targs = dryrun.entry("cpu")
    got = tfn(*targs)
    assert got.shape == (1, 512) and got.dtype == torch.int8
    assert np.array_equal(got[0].numpy(), want)
    assert torch.equal(tfn(*targs, plain=True), got)


def _same_batch(a, b):
    assert a.header.names == b.header.names
    assert list(a.header.lengths) == list(b.header.lengths)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name


@pytest.mark.parametrize("kw", [TASK1, dict(L=3000, n_contigs=2)])
def test_make_task1_case_matches_bench(kw):
    want = bench.make_task1_case(np.random.default_rng(5), **kw)
    got = sim.make_task1_case(np.random.default_rng(5), **kw)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    _same_batch(got[2], want[2])


def test_make_task5_case_matches_bench():
    kw = dict(L=5000, n_contigs=2, depth=8)
    want = bench.make_task5_case(np.random.default_rng(5), **kw)
    got = sim.make_task5_case(np.random.default_rng(5), **kw)
    assert got[0] == want[0] and got[1] == want[1]
    _same_batch(got[2], want[2])


def _jax_windows(names, drafts, batch):
    """The engine-2 windows as __graft_entry__.py builds them."""
    from nextpolish_tpu.models.cns.device_dp import densify_window
    from nextpolish_tpu.models.cns.msa import build_edges
    from nextpolish_tpu.models.cns.tags import (
        WindowAccum,
        read_columns,
        trim_read_columns,
    )
    from nextpolish_tpu.ops import pileup as pl

    dws = []
    for nm, dr in zip(names, drafts):
        tid = batch.header.name2id(nm)
        accum = WindowAccum(np.frombuffer(dr.upper(), np.uint8), 0,
                            len(dr), 3)
        for rr in np.flatnonzero(pl.region_overlap_mask(
                batch, tid, 0, len(dr) - 1)):
            if int(batch.flag[rr]) & 0xD04:
                continue
            tr = trim_read_columns(*read_columns(batch, int(rr)),
                                   accum.ref_cns, 0, len(dr))
            if tr is not None:
                accum.add_row(tr[0], tr[1], tr[2], int(rr))
        merged = accum.finish()
        dws.append(densify_window(build_edges(merged),
                                  accum.coverage[:len(dr)] + 1, len(dr)))
    return dws


def test_dryrun_multichip_matches_jax(capsys):
    from nextpolish_tpu.models.cns.device_dp import _run_batch
    from nextpolish_tpu.models.score_chain import (
        AlgoConfig,
        score_chain_contig,
    )

    got = dryrun.dryrun_multichip(2, "cpu")
    assert "dryrun_multichip OK" in capsys.readouterr().out
    rng = np.random.default_rng(1)
    names, trues, batch, _ = bench.make_task1_case(rng, **TASK1)
    assert got["task1"] == score_chain_contig(names[0], trues[0], batch,
                                              AlgoConfig())
    assert got["bases"] == len(got["task1"]) >= 1024
    n5, d5, b5 = bench.make_task5_case(rng, L=6000, n_contigs=2, depth=25)
    want5 = _run_batch(_jax_windows(n5, d5, b5), "ont")
    assert got["windows"] == len(want5) == 2
    for (bt, st), (bj, sj) in zip(got["task5"], want5):
        assert np.array_equal(bt, bj) and np.array_equal(st, sj)


def test_dryrun_cli_and_device_lists(capsys, monkeypatch):
    """The CLI's device entries (the routes themselves run in the test
    above)."""
    seen = []
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device: seen.append((n, device)))
    assert dryrun.main(["--device", "cpu", "--devices", "3"]) == 0
    assert dryrun.main(["--device", "cpu"]) == 0
    assert seen == [(3, "cpu"), (2, "cpu")]
    assert capsys.readouterr().out.count("entry: (1, 512)") == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            dryrun.entry("cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            dryrun.main([])
