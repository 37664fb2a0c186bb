"""Task 2 as a whole: the port's worker1 -t 2 (--device cpu, the plain
scans) against the JAX package's worker1 -t 2 on the same genome.fa and
sorted, indexed BAM.  The cases are tests/test_kmer_count.py's three
scenarios, and task 2 run on task 1's output for the messy, zero-coverage
and short-read cases of tests/test_torch_worker1.py, as task=default
chains the two.  The FASTA files must be byte-equal, and at least one
case runs the dense no-depth rescue batch (run_chain_batch)."""
import numpy as np
import pytest

from nextpolish_tpu import worker1 as jax_worker1
from nextpolish_tpu_torch import worker1 as torch_worker1
from nextpolish_tpu_torch.models import score_chain as torch_sc
from test_torch_worker1 import CASES, _write
from util_sim import make_draft, rand_seq, simulate_reads


def _lowercase_region(rng):
    """A lowercase window of wrong bases (substitutions, so the reads stay
    all-M): test_kmer_count_repairs_lowercase_region."""
    rng = np.random.default_rng(5)
    true = rand_seq(rng, 1200)
    lo, hi = 400, 420
    wrong = bytes((b"ACGT"[(b"ACGT".index(bytes([c])) + 1) % 4])
                  for c in true[lo:hi])
    draft = true[:lo] + wrong.lower() + true[hi:]
    recs = simulate_reads(rng, true, [("M", len(true))], read_len=100,
                          step=3)
    return ["ctg1"], [draft], recs


def _deletion_with_inserts(rng):
    """A draft missing 3 bases inside a lowercase window, the reads
    carrying an I op: test_kmer_count_repairs_deletion_with_inserts."""
    rng = np.random.default_rng(17)
    true = rand_seq(rng, 1000)
    cut = 500
    draft = (true[:cut - 10] + true[cut - 10: cut].lower()
             + true[cut + 3: cut + 13].lower() + true[cut + 13:])
    ops = [("M", cut), ("I", 3), ("M", len(true) - cut - 3)]
    recs = simulate_reads(rng, true, ops, read_len=100, step=3)
    return ["ctg1"], [draft], recs


def _no_coverage(rng):
    """No reads over the back half: test_kmer_count_no_coverage_keeps_
    lowercase (task 2 runs on task 1's output)."""
    rng = np.random.default_rng(9)
    true = rand_seq(rng, 900)
    draft, ops = make_draft(rng, true, n_edits=4)
    recs = [r for r in simulate_reads(rng, true, ops, read_len=100, step=3)
            if r["pos"] < 450]
    return ["ctg1"], [draft], recs


# name -> (case, run task 1 first)
TASK2_CASES = {
    "lowercase_region": (_lowercase_region, False),
    "deletion_with_inserts": (_deletion_with_inserts, False),
    "no_coverage": (_no_coverage, True),
    "messy": (CASES["messy"], True),
    "zero_coverage": (CASES["zero_coverage"], True),
    "short_3x20kb": (CASES["short_3x20kb"], True),
}


@pytest.mark.parametrize("case", sorted(TASK2_CASES))
def test_worker1_task2_matches_jax(tmp_path, case, monkeypatch):
    make, task1_first = TASK2_CASES[case]
    names, drafts, recs = make(np.random.default_rng(3))
    fa, bam = _write(tmp_path, names, drafts, recs)
    if task1_first:
        # task 1's output (the port's equals the JAX package's by
        # tests/test_torch_worker1.py) is task 2's draft
        t1 = tmp_path / "t1.fa"
        assert jax_worker1.main(["-g", fa, "-s", bam, "-t", "1",
                                 "-o", str(t1)]) == 0
        fa = str(t1)
    seen = []
    orig = torch_sc.run_chain_batch

    def spy(problems, rate, *a, **k):
        seen.append(len(problems))
        return orig(problems, rate, *a, **k)

    monkeypatch.setattr(torch_sc, "run_chain_batch", spy)
    out_j, out_t = tmp_path / "jax.fa", tmp_path / "torch.fa"
    assert jax_worker1.main(["-g", fa, "-s", bam, "-t", "2",
                             "-o", str(out_j)]) == 0
    assert torch_worker1.main(["-g", fa, "-s", bam, "-t", "2", "-o",
                               str(out_t), "--device", "cpu"]) == 0
    got = out_t.read_bytes()
    assert got == out_j.read_bytes()
    assert len(got.split(b"\n")[1::2]) == len(names)
    if case == "no_coverage":
        # the uncovered tail reaches the dense rescue batch
        assert any(seen)
        seq = got.split(b"\n")[1]
        assert seq[-100:] == seq[-100:].lower()
