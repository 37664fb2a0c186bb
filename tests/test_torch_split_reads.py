"""Engine 2 on a draft with structural errors, as the benchmark's cell
`lgs_ont_30x_sv.chrom` draws it (npbench/gens/long_sv.py): draft-only
segments and a misjoin, split and chimeric reads written as minimap2
-ax map-ont writes them, with SA tags.

- The generator's records come back from the BAM it writes through the
  port's reader as they were: flag, CIGAR (hard clips kept), stored SEQ,
  tag bytes; a split read's SA tags are reciprocal.
- With INS_MIN_CHECK_LEN lowered in the port and in the benchmark's
  reference (monkeypatch), the port's worker2 writes, contig by contig,
  the bytes of the reference that reads the SA tags (the job kind
  `worker2_sv`), with the structural layer past its first check: gap
  clusters, supplementary rows, split points.
- The reference that reads no tags (job kind `worker2`) does not: on
  split reads it is not NextPolish's result."""
import copy
import json
import os

import numpy as np
import pytest

from npbench import harness
from npbench.jobs import worker2 as tagless_job
from npbench.jobs import worker2_sv as job
from npbench.ref.cns import structural as ref_st
from nextpolish_tpu_torch.io.bam import read_bam
from nextpolish_tpu_torch.models.cns import structural as st
from nextpolish_tpu_torch.runtime import trace

CHECK_LEN = 10_000  # INS_MIN_CHECK_LEN in the tests
SEED = 2**33 + 17


def _config():
    """The cell's configuration at a test's size: shorter reads (so the
    structural errors fit 60 kb contigs) and segments."""
    with open(os.path.join(harness.ROOT, "npbench", "configs",
                           "lgs_ont_30x_sv.json")) as fh:
        cfg = json.load(fh)
    cfg = copy.deepcopy(cfg)
    cfg["reads"]["read_len"] = [3000, 6000]
    cfg["sv"].update(segments=2, segment_len=[1000, 3000])
    return cfg


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    return harness.make_block(_config(), [60_000, 55_000], SEED,
                              str(tmp_path_factory.mktemp("sv")), "b")


def _split_reads(records):
    by = {}
    for r in records:
        by.setdefault(r["name"], []).append(r)
    return {n: rs for n, rs in by.items() if len(rs) > 1}


def test_records_round_trip(block):
    """Every record as the port's reader returns it from the BAM, and the
    case holds what the tests below need: primaries and hard-clipped
    supplementaries of split reads on one contig and strand."""
    batch = read_bam(block.bam, with_names=True)
    recs = block.records
    assert len(batch) == len(recs)
    for i, r in enumerate(recs):
        assert batch.names[i] == r["name"]
        assert (int(batch.tid[i]), int(batch.pos[i])) == (r["tid"],
                                                         r["pos"])
        assert int(batch.flag[i]) == r["flag"]
        assert np.array_equal(batch.rec_cigar(i), r["cigar"])
        assert np.array_equal(batch.rec_seq_nib(i), r["seq_nib"])
        assert batch.rec_tags(i) == r["tags"]
    sup = [r for r in recs if r["flag"] & 0x800]
    assert len(sup) >= 20
    for r in recs:
        ops, lens = r["cigar"] & 0xF, r["cigar"] >> 4
        clip = 5 if r["flag"] & 0x800 else 4
        assert set(ops.tolist()) <= {0, 1, 2, clip}
        # the stored SEQ is what the CIGAR consumes: hard clips store none
        assert lens[np.isin(ops, (0, 1, 4))].sum() == len(r["seq_nib"])
        assert r["tags"].startswith(b"NM")
    same = [rs for rs in _split_reads(recs).values()
            if len({(x["tid"], x["flag"] & 0x10) for x in rs}) == 1]
    assert len(same) >= 20
    # no two supplementaries of a contig share (position, leading clip),
    # the pair NextPolish finds a split read's supplementary by
    keys = [(r["tid"], r["pos"], int(r["cigar"][0] >> 4)
             if r["cigar"][0] & 0xF == 5 else 0) for r in sup]
    assert len(set(keys)) == len(keys)


def test_generator_repeats_per_seed(block, tmp_path):
    """The same seed gives the same files, another seed another case."""
    def files(b):
        return [open(p, "rb").read() for p in (b.fa, b.bam, b.bam + ".bai")]

    again = harness.make_block(_config(), [60_000, 55_000], SEED,
                               str(tmp_path), "a")
    other = harness.make_block(_config(), [60_000, 55_000], SEED + 1,
                               str(tmp_path), "o")
    assert files(again) == files(block)
    assert other.drafts != block.drafts


def test_sa_tags_reciprocal(block):
    """Each record of a split read lists every other record of the read
    in its SA tag, the primary first: contig, 1-based position, strand,
    leading clip, reference span, MAPQ and NM as the record holds them."""
    names = block.names
    n = 0
    for rs in _split_reads(block.records).values():
        prim = [r for r in rs if not r["flag"] & 0x800]
        assert len(prim) == 1
        for r in rs:
            sa = ref_st.find_sa_tag(r["tags"])
            assert sa is not None and sa.endswith(";")
            ents = [e.split(",") for e in sa[:-1].split(";")]
            others = [x for x in rs if x is not r]
            others.sort(key=lambda x: x["flag"] & 0x800)  # primary first
            assert len(ents) == len(others)
            for e, x in zip(ents, others):
                ops, lens = x["cigar"] & 0xF, x["cigar"] >> 4
                lead = int(lens[0]) if ops[0] in (4, 5) else 0
                nm = int.from_bytes(
                    x["tags"][3:3 + {67: 1, 83: 2}[x["tags"][2]]],
                    "little")
                assert e[0] == names[x["tid"]]
                assert int(e[1]) == x["pos"] + 1
                assert e[2] == ("-" if x["flag"] & 0x10 else "+")
                assert ref_st.cigarstr2ul(e[3], 0) == lead
                assert ref_st.cigarstr2rlen(e[3]) == int(
                    lens[np.isin(ops, (0, 2))].sum())
                assert (int(e[4]), int(e[5])) == (x["mapq"], nm)
                n += 1
    assert n >= 40


@pytest.fixture(scope="module")
def polished(block, tmp_path_factory):
    """The port's worker2 on the block with the structural layer on
    (INS_MIN_CHECK_LEN lowered), its output and its cns.struct
    counters."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(st, "INS_MIN_CHECK_LEN", CHECK_LEN)
        mp.setattr(ref_st, "INS_MIN_CHECK_LEN", CHECK_LEN)
        mp.setenv("NPT_CNS_ENGINE", "native")
        out = str(tmp_path_factory.mktemp("sv_out") / "out.fa")
        trace.reset()
        job.run(block, out, "cpu", _config())
        counts = {k: v["s"] for k, v in trace.snapshot("cns.struct.")
                  .items()}
        trace.reset()
        yield harness.read_fasta(out), counts, mp
    finally:
        mp.undo()


def _mine(block, got, i):
    cname = block.names[i]
    return harness.serialize([(g[0], g[2]) for g in got
                              if harness.contig_of(block, g[0]) == cname])


@pytest.mark.parametrize("i", [0, 1])
def test_worker2_matches_tagged_reference(block, polished, i):
    got, counts, _ = polished
    ref = harness.serialize(job.reference(block, i, "cpu", _config()))
    assert _mine(block, got, i) == ref
    assert harness.bad_records(block, got) == 0
    # the structural layer past its first check in every window
    assert counts["cns.struct.clusters"] > 0
    assert counts["cns.struct.sup_rows"] > 0
    assert counts["cns.struct.split_points"] > 0
    assert "cns.struct.off_windows" not in counts


def test_tagless_reference_differs(block, polished):
    """The reference that reads no SA tags finds no split read: it is not
    the program's result, so it cannot check this traffic."""
    got, _, _ = polished
    cfg = _config()
    mm = sum(harness.mismatches(
        _mine(block, got, i),
        harness.serialize(tagless_job.reference(block, i, "cpu", cfg)))
        for i in range(len(block.names)))
    assert mm > 0
