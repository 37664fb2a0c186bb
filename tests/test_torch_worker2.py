"""The slice as a whole: the port's worker2 (--device cpu, the plain level
scan) against the JAX package's worker2 with NPT_CNS_ENGINE=device, on
simulated contigs whose BAM and .bai are written by the JAX package's own
writer, for each read type's rules (ont, hifi, and the indel-heavy clr
and rs profiles of sim.PROFILES).  The FASTA files must be byte-equal."""
import pytest
import torch

from nextpolish_tpu import worker2 as jax_worker2
from nextpolish_tpu.io import bam as jax_bam
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch import worker2 as torch_worker2

CASES = {  # read type -> (seed, contig lengths, depth, simulate_case's
    #                         error rates and read lengths)
    "ont": (31, [12000, 9000], 12, dict(sub=0.03, ins=0.03, dele=0.03,
                                        read_len=(2000, 5000))),
    "hifi": (32, [12000], 12, dict(sub=0.002, ins=0.002, dele=0.002,
                                   read_len=(2000, 5000))),
    "clr": (33, [9000], 12, sim.PROFILES["clr"]),
    "rs": (34, [9000], 12, sim.PROFILES["rs"]),
}


def _write_inputs(tmp_path, rt):
    seed, lens, depth, profile = CASES[rt]
    c = sim.simulate_case(seed, len(lens), lens, depth, **profile)
    fa = tmp_path / "genome.fa"
    fa.write_bytes(b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                            for n, d in zip(c.names, c.drafts)))
    bam = tmp_path / "reads.sort.bam"
    hdr = jax_bam.BamHeader("", list(c.names), [len(d) for d in c.drafts])
    jax_bam.write_bam(str(bam), hdr, c.records, index=True)
    return c, str(fa), str(bam)


@pytest.mark.parametrize("rt", ["ont", "hifi", "clr", "rs"])
def test_worker2_matches_jax(tmp_path, rt, monkeypatch):
    c, fa, bam = _write_inputs(tmp_path, rt)
    monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    # The JAX worker2 fetches contigs from pipelined_map threads that share
    # one IndexedBam, whose block reads are not thread-safe there (the
    # port's copy locks them), so its run here is serial: the FASTA does
    # not depend on the depth.  The port's side keeps its threads.
    from nextpolish_tpu.runtime import overlap as jax_overlap
    serial = jax_overlap.pipelined_map
    monkeypatch.setattr(jax_overlap, "pipelined_map",
                        lambda fn, items, depth=2: serial(fn, items, 1))
    out_j = tmp_path / "jax.fa"
    out_t = tmp_path / "torch.fa"
    assert jax_worker2.main(["-g", fa, "-l", bam, "-r", rt,
                             "-o", str(out_j)]) == 0
    assert torch_worker2.main(["-g", fa, "-l", bam, "-r", rt,
                               "-o", str(out_t), "--device", "cpu"]) == 0
    got = out_t.read_bytes()
    assert got == out_j.read_bytes()
    # and the polish did real work: every contig came back near its length
    seqs = got.split(b"\n")[1::2]
    assert len(seqs) == len(c.names)
    for s, t in zip(seqs, c.truths):
        assert abs(len(s) - len(t)) < 0.01 * len(t)


def test_worker2_resume_and_bam_list(tmp_path, monkeypatch):
    """A file-of-filenames BAM list and a resumed output give the same
    FASTA as a fresh run (the last, possibly truncated record is redone)."""
    c, fa, bam = _write_inputs(tmp_path, "ont")
    monkeypatch.setenv("NPT_CNS_ENGINE", "native")
    fresh = tmp_path / "fresh.fa"
    assert torch_worker2.main(["-g", fa, "-l", bam, "-r", "ont",
                               "-o", str(fresh), "--device", "cpu"]) == 0
    fofn = tmp_path / "bams.list"
    fofn.write_text("reads.sort.bam\n")
    part = tmp_path / "part.fa"
    part.write_bytes(fresh.read_bytes()[:-100])
    assert torch_worker2.main(["-g", fa, "-l", str(fofn), "-r", "ont",
                               "-o", str(part), "--device", "cpu"]) == 0
    assert part.read_bytes() == fresh.read_bytes()


def test_worker2_cuda_without_card_raises(tmp_path, monkeypatch):
    """--device cuda (the default) never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda run is the gpu tests' job")
    _, fa, bam = _write_inputs(tmp_path, "hifi")
    monkeypatch.delenv("NPT_CNS_ENGINE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_worker2.main(["-g", fa, "-l", bam, "-r", "hifi",
                            "-o", str(tmp_path / "x.fa")])
    assert not (tmp_path / "x.fa").exists()
