"""nextpolish_tpu_torch/sim.py's paired-end simulation and the port's BAM
writer (io/bam.py, io/bgzf.py), both built in bulk: the same bytes as the
record-at-a-time versions they replaced.  simulate_short_case against a
copy of its earlier per-read build (below), record for record; write_bam
and its index against the JAX package's writer (the port's writer's
origin), byte for byte, on short reads, long reads with an insertion
hotspot, and records with qualities, tags and no CIGAR."""
import filecmp

import numpy as np
import pytest

from nextpolish_tpu.io import bam as jbam
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.io import bam as pb


def _short_case_per_read(seed: int, contig_lens, depth: float,
                         read_len: int = 150, insert=(350, 35),
                         sub=0.01, ins=0.002, dele=0.002,
                         draft_sub=0.005) -> sim.SimCase:
    """sim.simulate_short_case as it was built before its reads with an
    indel were built in bulk: simulate_read a read, one record at a time."""
    rng = np.random.default_rng(seed)
    names, truths, drafts, records = [], [], [], []
    p_indel = ins + dele
    for tid, L in enumerate(np.atleast_1d(contig_lens)):
        L = int(L)
        truth = rng.choice(sim.BASES, L)
        names.append(f"ctg{tid}")
        truths.append(truth.tobytes())
        drafts.append(sim._mutate(rng, truth, draft_sub).tobytes())
        n_frag = int(round(depth * L / (2 * read_len)))
        flen = np.clip(np.rint(rng.normal(insert[0], insert[1], n_frag)),
                       read_len, min(2 * insert[0], L)).astype(np.int64)
        fstart = rng.integers(0, L - flen + 1)
        # mate 1 at the fragment's start, mate 2 at its end
        starts = np.concatenate([fstart, fstart + flen - read_len])
        mate = np.repeat([0, 1], n_frag)
        frag = np.tile(np.arange(n_frag), 2)
        r = rng.random((2 * n_frag, read_len))
        r[:, 0] = r[:, -1] = 1.0
        gapless = ~np.any(r < p_indel, axis=1)
        codes = np.searchsorted(sim.BASES, truth)[
            starts[:, None] + np.arange(read_len)]
        is_sub = (r >= p_indel) & (r < p_indel + sub)
        codes = np.where(is_sub, (codes + rng.integers(1, 4, codes.shape))
                         % 4, codes)
        seq_g = sim.BASES[codes]
        cig_g = np.array([read_len << 4 | sim.OP_M], dtype=np.uint32)
        for k in range(2 * n_frag):
            if gapless[k]:
                seq, cigar = seq_g[k], cig_g
            else:
                seq, cigar = sim.simulate_read(rng, truth, int(starts[k]),
                                           read_len, sub, ins, dele, r=r[k])
            m, f = int(mate[k]), int(frag[k])
            records.append(dict(
                name=f"p{tid}_{f}", tid=tid, pos=int(starts[k]), mapq=60,
                flag=0x3 | (0x60 if m == 0 else 0x90), cigar=cigar,
                seq_nib=pb.seq_to_nib(seq.tobytes()), mtid=tid,
                mpos=int(starts[k + n_frag if m == 0 else k - n_frag]),
                tlen=int(flen[f]) if m == 0 else -int(flen[f])))
    records.sort(key=lambda rec: (rec["tid"], rec["pos"]))
    return sim.SimCase(names, truths, drafts, records)



def _same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype, k
                assert np.array_equal(x[k], y[k]), k
            else:
                assert x[k] == y[k], k


@pytest.mark.parametrize("seed,lens,depth", [(1, (3000, 1200), 20),
                                             (5, (2500,), 35)])
def test_short_case_matches_per_read_build(seed, lens, depth):
    got = sim.simulate_short_case(seed, lens, depth)
    want = _short_case_per_read(seed, lens, depth)
    assert (got.names, got.truths, got.drafts) == (want.names, want.truths,
                                                   want.drafts)
    _same_records(got.records, want.records)
    assert sum(len(r["cigar"]) > 1 for r in got.records) > 10  # indels


def _cases():
    short = sim.simulate_short_case(3, (20000, 3000), 30)
    long_ = sim.simulate_case(4, 2, 20000, 10, hotspot=(5000, 30, True))
    odd = [dict(name="u1", tid=-1, pos=-1, mapq=0, flag=4,
                cigar=np.zeros(0, np.uint32), seq_nib=pb.seq_to_nib(b"ACGTN"),
                qual=np.arange(5, dtype=np.uint8),
                tags=b"NMi\x01\x00\x00\x00"),
           dict(name="e", tid=-1, pos=-1, cigar=np.zeros(0, np.uint32),
                seq_nib=np.zeros(0, np.uint8))]
    return {"short": (short, short.records),
            "long+odd": (long_, long_.records + odd)}


@pytest.mark.parametrize("name", ["short", "long+odd"])
def test_write_bam_matches_record_writer(tmp_path, name):
    case, recs = _cases()[name]
    lens = [len(d) for d in case.drafts]
    got, want = str(tmp_path / "got.bam"), str(tmp_path / "want.bam")
    pb.write_bam(got, pb.BamHeader("", list(case.names), lens), recs,
                 index=True)
    jbam.write_bam(want, jbam.BamHeader("", list(case.names), lens), recs,
                   index=True)
    assert filecmp.cmp(got, want, shallow=False)
    assert filecmp.cmp(got + ".bai", want + ".bai", shallow=False)
    assert len(pb.read_bam(got)) == len(recs)
