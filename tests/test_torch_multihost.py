"""Several processes on the CPU (gloo): `launch_local(..., device="cpu")`
runs two real `python -m nextpolish_tpu_torch` ranks on
tests/test_multihost.py's project (3 contigs of 5-7 kb, 40x PE150,
task = 1).  The gathered genome.nextpolish.fasta and .stat are
byte-equal to the JAX package's one-process Pipeline run, both ranks'
part files are non-empty, and a second launch on the same workdir skips
every rank's finished stage and writes the same bytes; with rewrite = 1
one rank rotates the workdir and each rank spills into its own
directory (ROADMAP C8).  A rank that exits makes the other's next
barrier raise at once.

Children run with OMP_NUM_THREADS=1, and every wait on them is bounded,
so a hang fails the test instead of holding the suite."""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from nextpolish_tpu.config import load_config as j_load
from nextpolish_tpu.pipeline import Pipeline as JPipeline
from nextpolish_tpu_torch import launch
from nextpolish_tpu_torch.__main__ import rank_lines
from test_multihost import _make_project, _write_cfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
WAIT_S = 240  # one rank's whole run here takes a few seconds


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(ROOT), os.environ.get("PYTHONPATH", "")]))


def _bounded_popen(logs):
    """subprocess.Popen for launch_local: each rank's output goes to a
    file of `logs`, and each wait is bounded (on expiry every rank
    started is killed and the wait raises)."""
    started = []

    class Popen(subprocess.Popen):
        def __init__(self, cmd, env=None, **kw):
            path = logs / f"rank{env['NPT_PROC_ID']}.log"
            with open(path, "ab") as fh:
                super().__init__(cmd, env=env, stdout=fh,
                                 stderr=subprocess.STDOUT, **kw)
            started.append(self)

        def wait(self, timeout=None):
            try:
                return super().wait(WAIT_S if timeout is None else timeout)
            except subprocess.TimeoutExpired:
                for p in started:
                    p.kill()
                    super(Popen, p).wait(30)
                raise

    return Popen


def _launch(monkeypatch, tmp_path, cfg, nprocs=2):
    logs = tmp_path / "logs"
    logs.mkdir(exist_ok=True)
    for f in logs.iterdir():
        f.unlink()
    monkeypatch.setattr(subprocess, "Popen", _bounded_popen(logs))
    rc = launch.launch_local(cfg, nprocs, _env(), device="cpu")
    return rc, [(logs / f"rank{r}.log").read_text() for r in range(nprocs)]


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """The project, and the JAX package's one-process run into ./work1."""
    d = tmp_path_factory.mktemp("multihost")
    _make_project(d, np.random.default_rng(33))
    want = JPipeline(j_load(_write_cfg(d, "work1"))).run()
    return d, want


def test_two_ranks_match_jax(project, monkeypatch):
    d, want = project
    rc, logs = _launch(monkeypatch, d, _write_cfg(d, "work2"))
    assert rc == 0, logs
    got = d / "work2" / "genome.nextpolish.fasta"
    assert got.read_bytes() == open(want, "rb").read()
    assert (pathlib.Path(str(got) + ".stat").read_text()
            == open(want + ".stat").read())
    part = d / "work2" / "01.score_chain" / "genome.nextpolish.part.fasta"
    names = []
    for rank, log in enumerate(logs):
        rp = pathlib.Path(f"{part}.rank{rank}")
        assert rp.stat().st_size > 0
        names.append([x.split()[0] for x in rp.read_text().split(">")[1:]])
        assert f"multi-host run: rank {rank} of 2" in log
        nproc, dev, card, launches, _ = rank_lines(log)[rank]
        assert (nproc, dev, card) == (2, "cpu", None)
        assert not any(launches.values())  # plain versions on the CPU
    assert names == [["ctg0", "ctg1"], ["ctg2"]]  # blc_genome's blocks
    assert part.read_bytes() == b"".join(
        pathlib.Path(f"{part}.rank{r}").read_bytes() for r in range(2))


def test_two_ranks_resume(project, monkeypatch):
    """A second launch on test_two_ranks_match_jax's workdir skips each
    rank's finished stage and writes the same bytes as .v1."""
    d, want = project
    rc, logs = _launch(monkeypatch, d, _write_cfg(d, "work2"))
    assert rc == 0, logs
    for rank, log in enumerate(logs):
        assert f"Skip finished stage: 01.score_chain.rank{rank}" in log
        assert "Run stage" not in log
    again = d / "work2" / "genome.nextpolish.v1.fasta"
    assert again.read_bytes() == open(want, "rb").read()


def test_two_ranks_rewrite_and_spill(project, monkeypatch):
    """rewrite = 1 on test_two_ranks_resume's workdir: rank 0 alone
    rotates it (one backup, holding the earlier runs), every rank runs
    its stage again and, with NPT_SPILL_BAM=1, spills into a directory of
    its own; the bytes stay the JAX package's."""
    d, want = project
    cfg = d / "rewrite.cfg"
    cfg.write_text((d / "work2.cfg").read_text() + "rewrite = 1\n")
    monkeypatch.setenv("NPT_SPILL_BAM", "1")
    rc, logs = _launch(monkeypatch, d, str(cfg))
    assert rc == 0, logs
    assert sorted(p.name for p in d.glob("work2.backup*")) == [
        "work2.backup1"]
    assert (d / "work2.backup1" / "genome.nextpolish.v1.fasta").exists()
    for rank, log in enumerate(logs):
        assert f"Run stage: 01.score_chain.rank{rank}" in log
    spills = sorted(p.name for p in (d / "work2").glob("spill.*"))
    assert spills == ["spill.sgs.rank0", "spill.sgs.rank1"]
    got = d / "work2" / "genome.nextpolish.fasta"
    assert got.read_bytes() == open(want, "rb").read()


EXIT_SCRIPT = r'''
import os, sys, time
sys.path.insert(0, sys.argv[1])
from nextpolish_tpu_torch.parallel import hosts
assert hosts.init_distributed() == 2
hosts.barrier("both up")
if hosts.process_index() == 1:
    os._exit(3)
t0 = time.monotonic()
try:
    hosts.barrier("after exit")
except RuntimeError as e:
    print(f"raised after {time.monotonic() - t0:.2f} s: {e}", flush=True)
    sys.exit(7)
'''


def test_a_rank_that_exits_ends_the_barrier(tmp_path, monkeypatch):
    """Rank 1 exits after a first barrier: rank 0's next barrier raises
    at once (its gloo connection closes), not after the barrier timeout,
    and launch_local returns the first nonzero code."""
    monkeypatch.setattr(launch, "_worker_cmd", lambda cfg, device: [
        sys.executable, "-c", EXIT_SCRIPT, str(ROOT)])
    t0 = time.monotonic()
    rc, logs = _launch(monkeypatch, tmp_path, "unused.cfg")
    assert rc == 7, logs
    assert "raised after" in logs[0] and "barrier after exit" in logs[0]
    assert time.monotonic() - t0 < 60
