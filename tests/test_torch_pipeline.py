"""The port's run.cfg pipeline (nextpolish_tpu_torch.pipeline, --device
cpu) against the JAX package's: genome.nextpolish.fasta and its .stat
byte-equal for task 12 on tests/test_pipeline.py's project (6 kb, 40x
PE150), for task 5 on a small long-read project (two contigs, about
15x ONT-like reads from nextpolish_tpu_torch.sim) and for task 1,2,3,4
on a diploid contig with long reads; resume writes .v1 as in JAX.  Also
NPT_NUM_PROCS without a coordinator (one process, as in JAX) and the
port's repaired spill estimate on a truncated .gz."""
import gzip
import os

import numpy as np
import pytest

from nextpolish_tpu.config import load_config as j_load
from nextpolish_tpu.pipeline import Pipeline as JPipeline
from nextpolish_tpu_torch import pipeline as tpipe
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.__main__ import main as t_main
from nextpolish_tpu_torch.config import load_config as t_load
from test_pipeline import _make_project


def _long_project(d):
    case = sim.simulate_case(3, 2, [5000, 3000], 15, read_len=(1000, 3000))
    sim.write_project(str(d), case.names, case.drafts, "5",
                      lgs=case.records)


def _diploid_project(d):
    """task = 1,2,3,4 on a diploid 8 kb contig (a het SNP a kb, 40x PE150
    from both haplotypes, two 400 bp stretches without read starts) with
    30x long reads: tasks 3 and 4 map both."""
    case = sim.simulate_diploid_case(9, [8000], 40, 0.001, 2, 400,
                                     long_depth=30)
    sim.write_project(str(d), case.names, case.drafts, "1,2,3,4",
                      sgs=case.records, lgs=case.long_records)


def _both(d):
    """(JAX assembly, port assembly) of the project in d: JAX into
    ./work, the port (through its CLI, --device cpu) into ./work_t."""
    want = JPipeline(j_load(str(d / "run.cfg"))).run()
    (d / "run_t.cfg").write_text(
        (d / "run.cfg").read_text().replace("./work", "./work_t"))
    assert t_main([str(d / "run_t.cfg"), "--device", "cpu"]) == 0
    got = str(d / "work_t" / "genome.nextpolish.fasta")
    return want, got


@pytest.mark.parametrize("project", ["task12_pe150", "task5_ont",
                                     "task1234_diploid"])
def test_pipeline_matches_jax(tmp_path, project):
    if project == "task12_pe150":
        _make_project(tmp_path, np.random.default_rng(21))
    elif project == "task5_ont":
        _long_project(tmp_path)
    else:
        _diploid_project(tmp_path)
    want, got = _both(tmp_path)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert open(got + ".stat").read() == open(want + ".stat").read()
    # resume: every stage is skipped and the assembly is versioned
    cfg = t_load(str(tmp_path / "run_t.cfg"))
    again = tpipe.Pipeline(cfg, device="cpu").run()
    assert again.endswith("genome.nextpolish.v1.fasta")
    assert open(again, "rb").read() == open(got, "rb").read()


def test_pipeline_num_procs_without_coordinator_is_one_process(
        tmp_path, monkeypatch):
    """NPT_NUM_PROCS=2 without a coordinator runs as one process, as in
    the JAX package, with no .rank file and the JAX pipeline's FASTA
    (several processes need a coordinator, launch.py)."""
    _make_project(tmp_path, np.random.default_rng(3), L=2000, depth=5)
    cfg = tmp_path / "run.cfg"
    cfg.write_text(cfg.read_text().replace("task = 12", "task = 1"))
    for k in ("NPT_COORDINATOR", "SLURM_JOB_NODELIST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NPT_NUM_PROCS", "2")
    want, got = _both(tmp_path)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert open(got + ".stat").read() == open(want + ".stat").read()
    ranked = [f for _, _, fs in os.walk(tmp_path / "work_t") for f in fs
              if ".rank" in f]
    assert not ranked, ranked


def test_spill_estimate_survives_a_truncated_gz(tmp_path):
    """A truncated .gz falls back to the 3.0 ratio (JAX raises EOFError
    there); a corrupt one too (zlib.error)."""
    raw = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, b"ACGT" * 40, b"I" * 160)
                   for i in range(4000))
    data = gzip.compress(raw)
    cut = tmp_path / "cut.fq.gz"
    cut.write_bytes(data[: len(data) // 2])
    bad = tmp_path / "bad.fq.gz"
    bad.write_bytes(data[:20] + bytes(200) + data[220:])
    good = tmp_path / "good.fq.gz"
    good.write_bytes(data)
    assert tpipe._gz_expansion(str(cut)) == 3.0
    assert tpipe._gz_expansion(str(bad)) == 3.0
    assert tpipe._gz_expansion(str(good)) > 3.0
    (tmp_path / "sgs.fofn").write_text("cut.fq.gz\nbad.fq.gz\n")
    p = tpipe.Pipeline.__new__(tpipe.Pipeline)
    assert p._spill_enabled(str(tmp_path / "sgs.fofn")) is False
