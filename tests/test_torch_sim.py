"""nextpolish_tpu_torch/sim.py's paired-end simulation and the port's BAM
writer (io/bam.py, io/bgzf.py), both built in bulk: the same bytes as the
record-at-a-time versions they replaced.  simulate_short_case against a
copy of its earlier per-read build (below), record for record; write_bam
and its index against the JAX package's writer (the port's writer's
origin), byte for byte, on short reads, long reads with an insertion
hotspot, and records with qualities, tags and no CIGAR."""
import filecmp
import struct

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


def _edge_record(**kw):
    """One mapped record of 16 bases, with fields of `kw` replaced."""
    rec = dict(name="r", tid=0, pos=100, mapq=60, flag=0,
               cigar=np.array([16 << 4], np.uint32),
               seq_nib=pb.seq_to_nib(b"ACGTACGTACGTACGT"))
    rec.update(kw)
    return rec


_OUT_OF_RANGE = {  # the fixed fields' types: "<iiBBHHHiiii"
    "cigar_70000_ops": dict(cigar=np.full(70_000, 1 << 4, np.uint32)),
    "name_300_chars": dict(name="n" * 300),
    "mapq_256": dict(mapq=256),
    "flag_70000": dict(flag=70_000),
    "flag_negative": dict(flag=-1),
    "pos_past_int32": dict(pos=1 << 31),
    "tlen_past_int32": dict(tlen=-(1 << 31) - 1),
}


@pytest.mark.parametrize("case", sorted(_OUT_OF_RANGE))
def test_write_bam_refuses_fields_out_of_range(tmp_path, case):
    """A record whose fixed fields do not fit their types (more CIGAR ops
    than a u16 holds, a read name past a u8's length, a mapq, flag or
    int32 out of range) makes both packages' write_bam raise struct.error,
    where a bulk encoding would wrap the value into a corrupt record."""
    recs = [_edge_record(), _edge_record(**_OUT_OF_RANGE[case])]
    for mod, name in ((pb, "got.bam"), (jbam, "want.bam")):
        with pytest.raises(struct.error):
            mod.write_bam(str(tmp_path / name),
                          mod.BamHeader("", ["c"], [1 << 20]), recs)


def test_write_bam_fields_at_their_limits_match(tmp_path):
    """Records at the limits (65,535 CIGAR ops, a 254-character name, mapq
    255, flag 65,535) stay byte-equal to the JAX package's writer."""
    recs = [_edge_record(cigar=np.full(65_535, 1 << 4, np.uint32),
                         seq_nib=np.zeros(65_535, np.uint8)),
            _edge_record(name="n" * 254, mapq=255, flag=65_535, pos=200)]
    got, want = str(tmp_path / "got.bam"), str(tmp_path / "want.bam")
    pb.write_bam(got, pb.BamHeader("", ["c"], [1 << 20]), recs)
    jbam.write_bam(want, jbam.BamHeader("", ["c"], [1 << 20]), recs)
    assert filecmp.cmp(got, want, shallow=False)


def test_simulate_diploid_case():
    """simulate_diploid_case: hap2 is hap1 with about het_rate
    substitutions; no read starts inside a hole (both mates of a fragment
    with one inside are dropped), so reads from both haplotypes leave
    each hole's far end uncovered; the draft is hap1 with substitutions;
    long reads come from both haplotypes; the same seed gives the same
    case."""
    c = sim.simulate_diploid_case(3, [20_000, 8_000], 40, 0.002, 3, 400,
                                  long_depth=20)
    for tid, (h1, h2, draft, holes) in enumerate(zip(
            c.truths, c.hap2s, c.drafts, c.holes)):
        a1, a2 = (np.frombuffer(x, np.uint8) for x in (h1, h2))
        assert 0 < np.count_nonzero(a1 != a2) < 0.004 * len(a1)
        assert 0 < np.count_nonzero(np.frombuffer(draft, np.uint8) != a1)
        recs = [r for r in c.records if r["tid"] == tid]
        cover = np.zeros(len(h1) + 1, np.int64)
        for r in recs:
            cover[r["pos"]] += 1
            cover[r["pos"] + 150] -= 1
        cover = np.cumsum(cover)
        assert len(holes) == 3
        for h0, h1_ in holes:
            assert not any(h0 <= r["pos"] < h1_ for r in recs)
            assert cover[h0 + 200:h1_].max() == 0
        names = {r["name"][0] for r in recs}
        assert names == {"a", "b"}
        assert sum(r["flag"] & 0x40 != 0 for r in recs) * 2 == len(recs)
        longs = {r["name"].split("_")[1] for r in c.long_records
                 if r["tid"] == tid}
        assert longs == {"1", "2"}
    again = sim.simulate_diploid_case(3, [20_000, 8_000], 40, 0.002, 3, 400,
                                      long_depth=20)
    assert again.drafts == c.drafts and again.hap2s == c.hap2s
    assert [r["pos"] for r in again.records] == [r["pos"] for r in c.records]


def _write_project_before(outdir, names, drafts, task, sgs=None, lgs=None):
    """sim.write_project as it was before it took HiFi reads and free-form
    run.cfg lines."""
    import os

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "draft.fa"), "wb") as fh:
        for name, seq in zip(names, drafts):
            fh.write(b">" + name.encode() + b"\n" + seq + b"\n")
    cfg = [f"task = {task}", "genome = ./draft.fa", "workdir = ./work"]
    if sgs is not None:
        sim.write_reads(sgs, [os.path.join(outdir, "r1.fq.gz"),
                              os.path.join(outdir, "r2.fq.gz")])
        with open(os.path.join(outdir, "sgs.fofn"), "w") as fh:
            fh.write("r1.fq.gz\nr2.fq.gz\n")
        cfg.append("sgs_fofn = ./sgs.fofn")
    if lgs is not None:
        sim.write_reads(lgs, [os.path.join(outdir, "lgs.fa.gz")],
                        fastq=False)
        with open(os.path.join(outdir, "lgs.fofn"), "w") as fh:
            fh.write("lgs.fa.gz\n")
        cfg.append("lgs_fofn = ./lgs.fofn")
    path = os.path.join(outdir, "run.cfg")
    with open(path, "w") as fh:
        fh.write("\n".join(cfg) + "\n")
    return path


def _project_files(d) -> dict:
    """A project's files by name, .gz files decompressed (gzip writes the
    time into its header)."""
    import gzip

    return {p.name: (gzip.decompress(p.read_bytes()) if p.suffix == ".gz"
                     else p.read_bytes()) for p in sorted(d.iterdir())}


def test_write_project_read_types(tmp_path):
    """write_project's HiFi reads and extra run.cfg lines parse through
    the port's load_config: task = best with only HiFi reads is tasks 6,
    6 with hifi_options' filters; -x map-pb makes the long reads clr.
    Projects of the earlier callers (short reads, long reads, both) stay
    byte-identical, and the ONT profile is simulate_case's default."""
    from nextpolish_tpu_torch.config import load_config

    case = sim.simulate_case(5, 2, [3000, 2000], 8, **sim.PROFILES["hifi"])
    cfg = load_config(sim.write_project(
        str(tmp_path / "hifi"), case.names, case.drafts, "best",
        hifi=case.records, hifi_options="-min_read_len 1k -max_depth 100"))
    assert cfg.task == [6, 6]
    assert cfg.sgs_fofn is None and cfg.lgs_fofn is None
    assert cfg.hifi_min_read_len == 1000 and cfg.hifi_max_depth == 100
    assert (tmp_path / "hifi" / "hifi.fofn").read_text() == "hifi.fa.gz\n"
    cfg = load_config(sim.write_project(
        str(tmp_path / "clr"), case.names, case.drafts, "5",
        lgs=case.records, extra=["lgs_minimap2_options = -x map-pb"]))
    assert cfg.task == [5] and cfg.lgs_read_type == "clr"

    short = sim.simulate_short_case(6, [2000], 10)
    for k, (sgs, lgs) in enumerate([(short.records, None),
                                    (None, case.records),
                                    (short.records, case.records)]):
        got, want = tmp_path / f"got{k}", tmp_path / f"want{k}"
        sim.write_project(str(got), case.names, case.drafts, "default",
                          sgs=sgs, lgs=lgs)
        _write_project_before(str(want), case.names, case.drafts,
                              "default", sgs=sgs, lgs=lgs)
        assert _project_files(got) == _project_files(want)
    a = sim.simulate_case(7, 1, 20_000, 5)
    b = sim.simulate_case(7, 1, 20_000, 5, **sim.PROFILES["ont"])
    assert a.drafts == b.drafts and [r["seq_nib"].tobytes() for r in
                                     a.records] == [r["seq_nib"].tobytes()
                                                    for r in b.records]
