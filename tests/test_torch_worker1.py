"""The task-1 slice as a whole: the port's worker1 -t 1 (--device cpu, the
plain scans) against the JAX package's worker1 -t 1 on the same genome.fa
and sorted, indexed BAM (written by the JAX package's own writer).  The
FASTA files must be byte-equal."""
import numpy as np
import pytest
import torch

from nextpolish_tpu import worker1 as jax_worker1
from nextpolish_tpu.io import bam as jax_bam
from nextpolish_tpu_torch import native as torch_native
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch import worker1 as torch_worker1
from nextpolish_tpu_torch.models import score_chain as torch_sc
from nextpolish_tpu_torch.runtime import trace
from util_sim import make_draft, rand_seq, random_messy_records, \
    simulate_reads


def _messy(rng):
    """One 3 kb contig: tiled reads over a draft with edits, plus reads
    with arbitrary CIGARs (clips, indels everywhere)."""
    true = rand_seq(rng, 3000)
    draft, ops = make_draft(rng, true, n_edits=10)
    recs = (simulate_reads(rng, true, ops, read_len=100, step=4)
            + random_messy_records(rng, len(draft), n_reads=300))
    return ["ctg1"], [draft], recs


def _zero_coverage(rng):
    """Reads over the first third only, and a lowercase run in the
    covered part of the draft: uncovered cells stay lowercase."""
    true = rand_seq(rng, 900)
    draft, ops = make_draft(rng, true, n_edits=3)
    recs = [r for r in simulate_reads(rng, true, ops, read_len=100, step=4)
            if r["pos"] < 250]
    draft = draft[:100] + draft[100:140].lower() + draft[140:]
    return ["ctg1"], [draft], recs


def _short(seed, lens, depth):
    def make(rng):
        c = sim.simulate_short_case(seed, lens, depth)
        return c.names, c.drafts, c.records
    return make


CASES = {
    "messy": _messy,
    "short_3x20kb": _short(7, [20_000] * 3, 30),
    "zero_coverage": _zero_coverage,
}


def _write(tmp_path, names, drafts, recs):
    fa = tmp_path / "genome.fa"
    fa.write_bytes(b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                            for n, d in zip(names, drafts)))
    bam = tmp_path / "reads.sort.bam"
    hdr = jax_bam.BamHeader("", list(names), [len(d) for d in drafts])
    recs = sorted(recs, key=lambda r: (r["tid"], r["pos"]))
    jax_bam.write_bam(str(bam), hdr, recs, index=True)
    return str(fa), str(bam)


def _run_both(tmp_path, fa, bam):
    out_j, out_t = tmp_path / "jax.fa", tmp_path / "torch.fa"
    assert jax_worker1.main(["-g", fa, "-s", bam, "-t", "1",
                             "-o", str(out_j)]) == 0
    trace.reset("task1")
    assert torch_worker1.main(["-g", fa, "-s", bam, "-t", "1", "-o",
                               str(out_t), "--device", "cpu"]) == 0
    return out_j.read_bytes(), out_t.read_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_worker1_matches_jax(tmp_path, case):
    names, drafts, recs = CASES[case](np.random.default_rng(3))
    fa, bam = _write(tmp_path, names, drafts, recs)
    want, got = _run_both(tmp_path, fa, bam)
    assert got == want
    seqs = got.split(b"\n")[1::2]
    assert len(seqs) == len(names)
    # every contig went through the native walker
    walks = trace.snapshot("task1.native_walks")
    assert walks["task1.native_walks"]["s"] == len(names)
    if case == "zero_coverage":
        assert seqs[0][-300:] == seqs[0][-300:].lower()
        assert seqs[0][20:90] == seqs[0][20:90].upper()


def test_worker1_single_launch_matches_jax_windows(tmp_path, monkeypatch):
    """A contig that the JAX package splits into 2 kb windows (its route
    for contigs over NPT_CHAIN_WINDOW_BASES) runs as one launch in the
    port, with the same bytes."""
    c = sim.simulate_short_case(11, [6000, 1500], 30)
    fa, bam = _write(tmp_path, c.names, c.drafts, c.records)
    monkeypatch.setenv("NPT_CHAIN_WINDOW_BASES", "2000")
    want, got = _run_both(tmp_path, fa, bam)
    assert got == want
    assert trace.snapshot("task1.chain_launches")[
        "task1.chain_launches"]["n"] == 2


def test_worker1_python_pileup_matches_jax(tmp_path, monkeypatch):
    """With the native library out of reach, the port's numpy pileup and
    packer give the JAX package's (native) bytes."""
    names, drafts, recs = _messy(np.random.default_rng(5))
    fa, bam = _write(tmp_path, names, drafts, recs)
    monkeypatch.setattr(torch_native, "_load", lambda: None)
    want, got = _run_both(tmp_path, fa, bam)
    assert got == want
    assert "task1.native_walks" not in trace.snapshot("task1")


def test_worker1_refuses_a_missing_card(tmp_path):
    """--device cuda (the default) without a card raises instead of
    running on the CPU, for every task."""
    c = sim.simulate_short_case(2, [2000], 10)
    fa, bam = _write(tmp_path, c.names, c.drafts, c.records)
    if torch.cuda.is_available():
        return  # the cuda run is the gpu tests' job
    for task in ("1", "2", "3", "4", "5"):
        with pytest.raises(RuntimeError, match="cuda"):
            torch_worker1.main(["-g", fa, "-s", bam, "-t", task,
                                "-o", str(tmp_path / "y.fa")])
        assert not (tmp_path / "y.fa").exists()


@pytest.fixture(scope="module")
def diploid(tmp_path_factory):
    """Two diploid contigs (12 kb and 5 kb; a het SNP a kb, 40x PE150
    from both haplotypes, two 400 bp stretches without read starts
    each) with 30x long reads: genome.fa, the short- and the long-read
    BAMs, and JAX worker1 -t 3's output."""
    d = tmp_path_factory.mktemp("diploid")
    c = sim.simulate_diploid_case(8, [12_000, 5_000], 40, 0.001, 2, 400,
                                  long_depth=30)
    fa, bam = _write(d, c.names, c.drafts, c.records)
    lbam = d / "long.sort.bam"
    hdr = jax_bam.BamHeader("", list(c.names), [len(x) for x in c.drafts])
    jax_bam.write_bam(str(lbam), hdr, c.long_records, index=True)
    t3 = d / "t3.fa"
    assert jax_worker1.main(["-g", fa, "-s", bam, "-l", str(lbam), "-t",
                             "3", "-o", str(t3)]) == 0
    return fa, bam, str(lbam), str(t3)


@pytest.mark.parametrize("run", ["3", "4", "5", "5_sgs"])
def test_worker1_tasks_3_4_5_match_jax(tmp_path, diploid, run,
                                       monkeypatch):
    """worker1 -t 3 (-s, -l), -t 4 on -t 3's output, -t 5 with -l and
    with -s in its place: the port's FASTA (--device cpu) byte-equal to
    the JAX worker1's; task 3 reaches the low-depth chain rescue."""
    from nextpolish_tpu_torch.models import snp_phase as t_phase

    fa, bam, lbam, t3 = diploid
    task = run[0]
    args = {"3": ["-g", fa, "-s", bam, "-l", lbam],
            "4": ["-g", t3, "-s", bam, "-l", lbam],
            "5": ["-g", fa, "-l", lbam],
            "5_sgs": ["-g", fa, "-s", lbam]}[run] + ["-t", task]
    calls = []
    run_region = t_phase.run_chain_region
    monkeypatch.setattr(t_phase, "run_chain_region",
                        lambda *a, **k: calls.append(1) or run_region(
                            *a, **k))
    out_j, out_t = tmp_path / "jax.fa", tmp_path / "torch.fa"
    assert jax_worker1.main(args + ["-o", str(out_j)]) == 0
    assert torch_worker1.main(args + ["-o", str(out_t), "--device",
                                      "cpu"]) == 0
    got = out_t.read_bytes()
    assert got == out_j.read_bytes()
    assert len(got.split(b"\n")[1::2]) == 2
    if task == "3":
        assert calls
        assert any(c >= 97 for c in got.split(b"\n")[1])


def test_worker1_refuses_a_launch_over_its_caps(tmp_path, monkeypatch):
    """A contig past the 2^26-cell cap of the planes walker's key packing
    (here lowered to 1,100 cells), or a launch past the device's free
    memory (here at 2^40 B a cell), no longer raises: it takes the window
    route (here 1,024-cell windows, so at least 3), and the FASTA is
    byte-equal to the JAX worker1's; a contig under the caps keeps its
    single launch."""
    c = sim.simulate_short_case(4, [3000, 600], 10)
    fa, bam = _write(tmp_path, c.names, c.drafts, c.records)
    monkeypatch.setattr(torch_sc, "SHARD_WINDOW_CELLS", 1024)
    with monkeypatch.context() as m:
        m.setattr(torch_sc, "MAX_LAUNCH_CELLS", 1100)
        want, got = _run_both(tmp_path, fa, bam)
    assert got == want
    snap = trace.snapshot("task1")
    assert snap["task1.windows"]["s"] >= 3
    assert snap["task1.windows"]["n"] == 1  # the 600 bp contig: one launch
    assert snap["task1.chain_launches"]["n"] == 1
    monkeypatch.setattr(torch_sc, "LAUNCH_BYTES_PER_CELL", 1 << 40)
    (tmp_path / "mem").mkdir()
    want, got = _run_both(tmp_path / "mem", fa, bam)
    assert got == want
    snap = trace.snapshot("task1")
    assert snap["task1.windows"]["n"] == 2
    assert "task1.chain_launches" not in snap


def test_worker1_splits_a_group_over_the_cap(tmp_path, monkeypatch):
    """With NPT_CHAIN_BATCH=2, two contigs of one shape bucket that each
    fit the free memory but not together launch one by one, with the JAX
    worker1's bytes."""
    c = sim.simulate_short_case(6, [2000, 1900], 10)
    fa, bam = _write(tmp_path, c.names, c.drafts, c.records)
    monkeypatch.setenv("NPT_CHAIN_BATCH", "2")
    monkeypatch.setattr(torch_sc, "device_free_bytes",
                        lambda dev: 3000 * torch_sc.LAUNCH_BYTES_PER_CELL)
    sizes = []
    dispatch = torch_sc.dispatch_chain_group

    def spy(handles, device=None):
        sizes.append(len(handles))
        return dispatch(handles, device)

    monkeypatch.setattr(torch_sc, "dispatch_chain_group", spy)
    want, got = _run_both(tmp_path, fa, bam)
    assert got == want
    assert sizes == [2, 1, 1]
    snap = trace.snapshot("task1")
    assert snap["task1.chain_launches"]["n"] == 2
    assert snap["task1.chain_cells"]["s"] == 2 * 2048
    assert "task1.windows" not in snap
