"""Tasks 3, 4 and legacy 5 (snp_phase, snp_valid, lgspolish) and the
long-read chain variant td_score_chain_contig: the port's functions
(--device cpu where they run a chain DP) against the JAX package's on
the same BAMs, the polished bytes equal.  The cases are
tests/test_snp.py's three, rebuilt here, and a 20 kb diploid contig from
sim.simulate_diploid_case (a het SNP a kb, 40x PE150 from both
haplotypes, three 400 bp stretches without read starts), with and
without 30x long reads; task 4 runs on task 3's output, as the pipeline
chains them, and tasks 5 and td_score_chain_contig take the long reads,
or the short ones in their place.  run_chain_region is also held to
JAX's alone, at the lgs rate on pileups whose ties need the emission
rounded once."""
import functools

import numpy as np
import pytest

from nextpolish_tpu.io import bam as jax_bam
from nextpolish_tpu.models import lgs_polish as j_lgs
from nextpolish_tpu.models import score_chain as j_sc
from nextpolish_tpu.models import snp_phase as j_phase
from nextpolish_tpu.models import snp_valid as j_valid
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.io import bam as torch_bam
from nextpolish_tpu_torch.models import lgs_polish as t_lgs
from nextpolish_tpu_torch.models import score_chain as t_sc
from nextpolish_tpu_torch.models import snp_phase as t_phase
from nextpolish_tpu_torch.models import snp_valid as t_valid
from util_sim import rand_seq, simulate_reads


def _phases(rng):
    """test_snp_phase_detects_and_phases: two nearby SNPs, reads tiled
    from both haplotypes in turn."""
    rng = np.random.default_rng(31)
    true = rand_seq(rng, 1500)
    h1, h2 = bytearray(true), bytearray(true)
    p1, p2 = 700, 760
    h2[p1] = b"A"[0] if h1[p1] != b"A"[0] else b"C"[0]
    h2[p2] = b"G"[0] if h1[p2] != b"G"[0] else b"T"[0]
    recs = []
    for i, start in enumerate(range(0, len(true) - 120, 3)):
        src = bytes(h1) if i % 2 == 0 else bytes(h2)
        recs.append(dict(
            name=f"r{i}", flag=0, tid=0, pos=start, mapq=60,
            cigar=np.array([(120 << 4) | 0], dtype=np.uint32),
            seq_nib=jax_bam.seq_to_nib(src[start:start + 120]),
            qual=np.full(120, 35, np.uint8), mtid=0, mpos=0,
            tlen=300 if i % 2 == 0 else -300))
    return bytes(h1), recs, None


def _identity(rng):
    """test_snp_phase_no_snps_identity."""
    rng = np.random.default_rng(33)
    true = rand_seq(rng, 800)
    return true, simulate_reads(rng, true, [("M", len(true))],
                                read_len=100, step=3), None


def _revotes(rng):
    """test_snp_valid_revotes_lowercase: a lowercase window of wrong
    bases."""
    rng = np.random.default_rng(32)
    true = rand_seq(rng, 900)
    lo, hi = 400, 415
    wrong = bytes((b"ACGT"[(b"ACGT".index(bytes([c])) + 1) % 4])
                  for c in true[lo:hi])
    draft = true[:lo] + wrong.lower() + true[hi:]
    return draft, simulate_reads(rng, true, [("M", len(true))],
                                 read_len=100, step=3), None


def _diploid(long_reads):
    def make(rng):
        c = sim.simulate_diploid_case(
            5, [20_000], 40, 0.001, 3, 400,
            long_depth=30 if long_reads else None)
        return c.drafts[0], c.records, c.long_records or None
    return make


CASES = {
    "phases": _phases,
    "identity": _identity,
    "revotes": _revotes,
    "diploid": _diploid(False),
    "diploid_long": _diploid(True),
}


def _write(path, draft, recs):
    hdr = jax_bam.BamHeader("", ["ctg1"], [len(draft)])
    recs = [dict(r, tid=0) for r in recs]
    recs.sort(key=lambda r: r["pos"])
    jax_bam.write_bam(str(path), hdr, recs, index=True)
    return jax_bam.read_bam(str(path)), torch_bam.read_bam(str(path))


@functools.lru_cache(maxsize=None)
def _case(name, tmp):
    """(draft, (JAX, port) short-read batches, (JAX, port) long-read
    batches or the short ones in their place, whether long reads exist,
    (JAX, port) configs with read_tlen set)."""
    import pathlib

    tmp = pathlib.Path(tmp)
    draft, recs, long_recs = CASES[name](np.random.default_rng(0))
    sgs = _write(tmp / f"{name}.sgs.bam", draft, recs)
    lgs = _write(tmp / f"{name}.lgs.bam", draft, long_recs) if long_recs \
        else sgs
    cfgs = (j_sc.AlgoConfig(), t_sc.AlgoConfig())
    for cfg in cfgs:
        cfg.read_tlen = 300 * cfg.max_ins_fold_sgs
    return draft, sgs, lgs, long_recs is not None, cfgs


@pytest.fixture(scope="module")
def tmpdir_str(tmp_path_factory):
    return str(tmp_path_factory.mktemp("snp"))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("task", ["phase", "valid", "lgspolish", "td"])
def test_engine_matches_jax(case, task, tmpdir_str, monkeypatch):
    draft, (js, ts), (jl, tl), has_long, (jc, tc) = _case(case, tmpdir_str)
    calls = []
    run = t_phase.run_chain_region

    def spy(*a, **k):
        calls.append(a[3])
        return run(*a, **k)

    monkeypatch.setattr(t_phase, "run_chain_region", spy)
    jl_or_none = jl if has_long else None
    tl_or_none = tl if has_long else None
    if task in ("phase", "valid"):
        want = j_phase.snp_phase_contig("ctg1", draft, js, jl_or_none, jc)
        got = t_phase.snp_phase_contig("ctg1", draft, ts, tl_or_none, tc,
                                       device="cpu")
        assert got == want
        if case.startswith("diploid"):
            # the holes reach the low-depth chain rescue
            assert calls
        if task == "valid":
            if case.startswith("diploid"):
                draft = want  # task 4 reads task 3's lowercase
            want = j_valid.snp_valid_contig("ctg1", draft, js, jl_or_none,
                                            jc)
            got = t_valid.snp_valid_contig("ctg1", draft, ts, tl_or_none,
                                           tc)
    elif task == "lgspolish":
        want = j_lgs.lgspolish_contig("ctg1", draft, jl, jc)
        got = t_lgs.lgspolish_contig("ctg1", draft, tl, tc)
    else:
        want = j_sc.td_score_chain_contig("ctg1", draft, jl, jc)
        got = t_sc.td_score_chain_contig("ctg1", draft, tl, tc,
                                         device="cpu")
    assert got == want
    assert len(got) > 0.9 * len(draft)


@pytest.mark.parametrize("seed,rate", [(11, 0.33), (21, 0.33), (6, 0.47)])
@pytest.mark.parametrize("ranked", [True, False])
def test_run_chain_region_matches_jax(seed, rate, ranked):
    """One region's dense pileup through run_chain_region (the planes DP
    on the CPU) against JAX's, with the first-observation ranks given and
    with the kmer-index order standing in."""
    n_dp = 3000
    uk, cn, rk, refkmer, total = sim.random_pileup(seed, n_dp, 6, 20,
                                                   rolling=True)
    counts = np.zeros((n_dp + 100, 512), np.uint16)
    counts.reshape(-1)[uk] = cn
    rank = None
    if ranked:
        rank = np.full((n_dp + 100, 512), 0xFFFF, np.uint16)
        rank.reshape(-1)[uk] = rk
    want = j_sc.run_chain_region(counts, refkmer, total, n_dp, rate,
                                 rank=rank)
    got = t_sc.run_chain_region(counts, refkmer, total, n_dp, rate,
                                rank=rank, device="cpu")
    assert got.dtype == np.int8 and len(got) == n_dp
    assert np.array_equal(got, np.asarray(want))
