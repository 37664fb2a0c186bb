"""Engine 2's structural layer past its first check, and the read pass
that feeds it, on a contig with split reads.

The contig holds a 6 kb segment that the truth lacks (the construction of
tests/test_torch_align.py::test_map_long_batch_matches_jax): reads over
it map as a primary plus a supplementary record with SA tags (the port's
long-read mapper), the other reads carry the alignments they were drawn
with.  With INS_MIN_CHECK_LEN lowered in both packages (monkeypatch),
the structural pass gets past its first check: 150 rows and more, 150
random reads and more, supplementary alignments; it clusters the split
reads' gaps and realigns their supplementary segments as extra rows.

- The port's worker2 against the JAX package's worker2, byte for byte.
- `window_prep` through the native tag walker against the Python read
  loop (the port's path where the native library is not built), for ont
  and hifi: reads without SA tags, split reads, a window 0 whose fetch
  reaches past its end (reads that feed only the depth track), and the
  structural layer off; every WindowWork field, the clusters, the
  structural state and the counters of the path each window took."""
import dataclasses

import numpy as np
import pytest

from nextpolish_tpu import worker2 as jax_worker2
from nextpolish_tpu.io import bam as jax_bam
from nextpolish_tpu.models.cns import structural as jax_st
from nextpolish_tpu_torch import native, sim
from nextpolish_tpu_torch import worker2 as torch_worker2
from nextpolish_tpu_torch.align.index import GenomeIndex
from nextpolish_tpu_torch.align.longread import map_long_batch
from nextpolish_tpu_torch.io.bam import read_bam, seq_to_nib
from nextpolish_tpu_torch.models.cns import structural as st
from nextpolish_tpu_torch.models.cns import window as twin
from nextpolish_tpu_torch.runtime import trace

_COMP = bytes.maketrans(b"ACGT", b"TGCA")
JUNCTION, SEGMENT = 24_000, 6_000  # the draft-only segment g[J:J+S]
CHECK_LEN = 10_000  # INS_MIN_CHECK_LEN in the tests


def _split_case(seed: int = 21, length: int = 56_000, depth: float = 30):
    """(name, draft, records): a draft with substitutions at 0.5% and the
    segment the truth lacks; reads at `depth`x of 2-5 kb, 3% each of
    substitutions, insertions and deletions, half of them reversed.  A
    read over the junction goes through map_long_batch (its records carry
    SA tags where it splits); any other keeps its drawn alignment,
    moved past the segment on the right."""
    rng = np.random.default_rng(seed)
    g = sim.BASES[rng.integers(0, 4, length)]
    draft = g.copy()
    hit = np.flatnonzero(rng.random(length) < 0.005)
    draft[hit] = sim.BASES[(np.searchsorted(sim.BASES, g[hit])
                            + rng.integers(1, 4, len(hit))) % 4]
    truth = np.concatenate([g[:JUNCTION], g[JUNCTION + SEGMENT:]])
    records, over = [], []
    n_reads = int(depth * len(truth) / 3500)
    for k in range(n_reads):
        ln = int(rng.integers(2000, 5001))
        s = int(rng.integers(0, len(truth) - ln + 1))
        seq, cig = sim.simulate_read(rng, truth, s, ln, 0.03, 0.03, 0.03)
        rev = k % 2 == 1
        if s < JUNCTION < s + ln:
            b = seq.tobytes()
            over.append(b.translate(_COMP)[::-1] if rev else b)
            continue
        records.append(dict(
            name=f"r{k}", tid=0, pos=s if s < JUNCTION else s + SEGMENT,
            mapq=60, flag=16 if rev else 0, cigar=cig,
            seq_nib=seq_to_nib(seq.tobytes())))
    idx = GenomeIndex.build([("ctg", draft.tobytes())], k=15, w=10)
    for i, r in enumerate(map_long_batch(idx, over, device="cpu")):
        if r["tid"] < 0:
            continue
        records.append(dict(name=f"j{i}_{r['flag']}", tid=0, pos=r["pos"],
                            mapq=r["mapq"], flag=r["flag"],
                            cigar=r["cigar"], seq_nib=r["seq_nib"],
                            tags=r.get("tags", b"")))
    records.sort(key=lambda r: (r["tid"], r["pos"]))
    return "ctg", draft.tobytes(), records


def _write(tmp, name, draft, records):
    fa = tmp / "genome.fa"
    fa.write_bytes(b">" + name.encode() + b"\n" + draft + b"\n")
    bam = tmp / "reads.sort.bam"
    hdr = jax_bam.BamHeader("", [name], [len(draft)])
    jax_bam.write_bam(str(bam), hdr, records, index=True)
    return str(fa), str(bam)


@pytest.fixture(scope="module")
def split_bam(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("split")
    name, draft, records = _split_case()
    fa, bam = _write(tmp, name, draft, records)
    return name, draft, fa, bam


def test_split_case_has_split_reads(split_bam):
    """The case holds what the tests below rely on: supplementary
    records, SA tags on primaries and supplementaries alike."""
    batch = read_bam(split_bam[3])
    sup = np.flatnonzero(batch.flag & 0x800)
    assert len(sup) >= 8
    sa = [r for r in range(len(batch)) if b"SAZ" in batch.rec_tags(r)]
    assert set(sup) < set(sa)


def test_worker2_split_reads_match_jax(split_bam, tmp_path, monkeypatch):
    """The port's worker2 byte-equal to the JAX package's with the
    structural layer on, and its pass past the first check: gap
    clusters, realigned supplementary rows."""
    name, draft, fa, bam = split_bam
    monkeypatch.setattr(st, "INS_MIN_CHECK_LEN", CHECK_LEN)
    monkeypatch.setattr(jax_st, "INS_MIN_CHECK_LEN", CHECK_LEN)
    monkeypatch.setenv("NPT_CNS_ENGINE", "native")
    # the JAX worker2's threads share an IndexedBam whose block reads are
    # not thread-safe there (tests/test_torch_worker2.py): run it serially
    from nextpolish_tpu.runtime import overlap as jax_overlap
    serial = jax_overlap.pipelined_map
    monkeypatch.setattr(jax_overlap, "pipelined_map",
                        lambda fn, items, depth=2: serial(fn, items, 1))
    passes = []
    struct_pass = twin._struct_pass

    def spy(ctx, accum, gaps, sups, s, e):
        n = accum.n_rows()
        clusters = struct_pass(ctx, accum, gaps, sups, s, e)
        passes.append((len(gaps), len(sups), len(clusters),
                       accum.n_rows() - n))
        return clusters

    monkeypatch.setattr(twin, "_struct_pass", spy)
    out_j, out_t = tmp_path / "jax.fa", tmp_path / "torch.fa"
    assert jax_worker2.main(["-g", fa, "-l", bam, "-r", "ont",
                             "-o", str(out_j)]) == 0
    assert torch_worker2.main(["-g", fa, "-l", bam, "-r", "ont",
                               "-o", str(out_t), "--device", "cpu"]) == 0
    assert out_t.read_bytes() == out_j.read_bytes()
    (gaps, sups, clusters, sup_rows), = passes
    assert gaps >= 8 and sups >= 8 and clusters >= 1 and sup_rows >= 1


@pytest.fixture(scope="module")
def plain_bam(tmp_path_factory):
    """A contig whose reads carry no aux data (npbench's generator writes
    none either): the benchmark cell's case."""
    c = sim.simulate_case(22, 1, 30_000, 20, read_len=(2000, 5000))
    _, bam = sim.write_case(c, str(tmp_path_factory.mktemp("plain")))
    return c.names[0], c.drafts[0], None, bam


# case -> (its BAM, the window's end: None for the contig's, the
# structural layer on)
WINDOWS = {
    "no_sa": ("plain_bam", None, True),
    "split": ("split_bam", None, True),
    "reach": ("split_bam", 40_000, True),
    # the supplementaries right of the junction start past the end
    "reach_cut": ("split_bam", 28_000, True),
    "off_split": ("split_bam", None, False),
    "off_no_sa": ("plain_bam", None, False),
}


def _clusters(clusters):
    return [(c.median, c.r_s, c.r_e,
             [(g.gap_s, g.gap_e, g.p_id, g.p_s, g.s_id, g.s_s, g.l,
               g.dseq.tobytes()) for g in c.gaps]) for c in clusters]


def _state(ctx):
    if ctx is None:
        return None
    d = ctx.depth
    return (ctx.brk_g, d.rreads, d.rreads_w, d.ref_ds.tobytes(), ctx.ref_d,
            ctx.split_ps)


def _prep(monkeypatch, batch, name, draft, e, rt, brk_g):
    """window_prep's WindowWork, structural state, counters, and the
    split reads' gaps and supplementary alignments as the structural
    pass received them."""
    trace.reset("cns.prep")
    ctx = (twin.StructState(brk_g=True, depth=st.DepthTrack(len(draft)),
                            qv=[]) if brk_g else None)
    given = []
    struct_pass = twin._struct_pass

    def spy(ctx, accum, gaps, sups, s, e):
        given.append(([(g.gap_s, g.gap_e, g.p_id, g.p_s, g.s_id, g.s_s,
                        g.l, g.dseq.tobytes()) for g in gaps],
                      [(a.fs, a.ds, a.cigar.tobytes()) for a in sups]))
        return struct_pass(ctx, accum, gaps, sups, s, e)

    monkeypatch.setattr(twin, "_struct_pass", spy)
    work = twin.window_prep(batch, 0, np.frombuffer(draft, np.uint8), 0,
                            e or len(draft), rt, ctx, name)
    monkeypatch.setattr(twin, "_struct_pass", struct_pass)
    counts = {k: v["n"] for k, v in trace.snapshot("cns.prep.").items()
              if k.endswith("_windows")}
    trace.reset("cns.prep")
    return work, ctx, counts, given


@pytest.mark.parametrize("rt", ["ont", "hifi"])
@pytest.mark.parametrize("case", list(WINDOWS))
def test_window_prep_walker_matches_loop(request, monkeypatch, case, rt):
    """The native tag walker's window against the Python read loop's:
    every WindowWork field (dtype and bytes), the clusters with their
    gaps, the structural state, and each path's counter."""
    fixture, e, brk_g = WINDOWS[case]
    name, draft, _, bam = request.getfixturevalue(fixture)
    batch = read_bam(bam)
    if case.startswith("reach"):
        # records that store no sequence: two primaries past the window's
        # end (the depth track only) and a supplementary inside it
        lq = batch.lqseq.copy()
        past = np.flatnonzero((batch.pos >= e) & (batch.flag == 0))[:2]
        sup = np.flatnonzero((batch.pos < e)
                             & (batch.flag & 0x800 > 0))[:1]
        assert len(past) == 2 and len(sup) == 1
        lq[np.concatenate([past, sup])] = 0
        batch = dataclasses.replace(batch, lqseq=lq)
    assert native.available()
    fast, fast_ctx, fast_n, fast_in = _prep(monkeypatch, batch, name,
                                            draft, e, rt, brk_g)
    monkeypatch.setattr(native, "available", lambda: False)
    slow, slow_ctx, slow_n, slow_in = _prep(monkeypatch, batch, name,
                                            draft, e, rt, brk_g)
    assert fast_n == {"cns.prep.walker_windows": 1}
    assert slow_n == {"cns.prep.loop_windows": 1}
    assert fast_in == slow_in
    for f in dataclasses.fields(slow.merged):
        a, b = getattr(fast.merged, f.name), getattr(slow.merged, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    for f in ("coverage", "l_ins", "l_del"):
        a, b = getattr(fast, f), getattr(slow, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert fast.L == slow.L
    assert _clusters(fast.clusters) == _clusters(slow.clusters)
    assert _state(fast_ctx) == _state(slow_ctx)
    # each case reaches what it is there for
    if case == "split" and rt == "ont":
        assert fast_ctx.brk_g and fast.clusters
        assert (fast.merged.ridx == -2).any()  # realigned supplementaries
    if case.startswith("reach"):
        assert max(p for p, _ in fast_ctx.depth.rreads) >= e
    if case == "reach_cut":
        (gaps, sups), = fast_in
        assert sups and not gaps
        assert (read_bam(bam).pos[read_bam(bam).flag & 0x800 > 0] >= e).any()
    if case == "no_sa":
        assert fast_ctx.brk_g is False


def test_depth_track_add_reads_matches_jax(monkeypatch):
    """DepthTrack.add_reads over arrays against the JAX package's
    add_read one read at a time, over windows that fill the random-read
    sample, cross its size within one call (INS_RADOM_COUNT lowered) and
    bin reads past the track's cap."""
    monkeypatch.setattr(st, "INS_RADOM_COUNT", 300)
    monkeypatch.setattr(jax_st, "INS_RADOM_COUNT", 300)
    rng = np.random.default_rng(23)
    port, ref = st.DepthTrack(60_000), jax_st.DepthTrack(60_000)
    for win_s, n in ((0, 120), (50_000, 260), (1_000_000, 400)):
        lo = max(win_s - 20_000, 0)
        rf_s = np.sort(rng.integers(lo, win_s + 2_500_000, n))
        rf_e = rf_s + rng.integers(1, 40_000, n)
        port.reset_window(200_000)
        ref.reset_window(200_000)
        port.add_reads(rf_s, rf_e, win_s)
        for a, b in zip(rf_s.tolist(), rf_e.tolist()):
            ref.add_read(a, b, win_s)
        assert port.rreads == ref.rreads
        assert port.rreads_w == ref.rreads_w
        assert np.array_equal(port.ref_ds, ref.ref_ds)
    assert port.rreads_w and port.ref_ds[-1]  # filled, and at the cap
    # and the port's own add_read, which the read loop calls
    one = st.DepthTrack(60_000)
    one.reset_window(200_000)
    for a, b in zip(rf_s.tolist(), rf_e.tolist()):
        one.add_read(a, b, 1_000_000)
    ref = jax_st.DepthTrack(60_000)
    ref.reset_window(200_000)
    for a, b in zip(rf_s.tolist(), rf_e.tolist()):
        ref.add_read(a, b, 1_000_000)
    assert one.rreads_w == ref.rreads_w
    assert np.array_equal(one.ref_ds, ref.ref_ds)


@pytest.mark.parametrize("case", ["split", "no_sa"])
def test_struct_pass_spans_and_counters(request, monkeypatch, case):
    """The structural pass's spans nest under cns.prep.struct, and its
    counters count what the pass received and did: the split reads'
    gaps and supplementary alignments, the clusters, the rows added with
    read id -2, the split points; a window where the layer turns itself
    off counts in cns.struct.off_windows and opens no inner span."""
    fixture, _, _ = WINDOWS[case]
    name, draft, _, bam = request.getfixturevalue(fixture)
    ctx = twin.StructState(brk_g=True, depth=st.DepthTrack(len(draft)),
                           qv=[])
    given = []
    struct_pass = twin._struct_pass

    def spy(ctx, accum, gaps, sups, s, e):
        given.append((len(gaps), len(sups)))
        return struct_pass(ctx, accum, gaps, sups, s, e)

    monkeypatch.setattr(twin, "_struct_pass", spy)
    trace.reset()
    try:
        with trace.timed("cns.prep"):
            work = twin.window_prep(read_bam(bam), 0,
                                    np.frombuffer(draft, np.uint8), 0,
                                    len(draft), "ont", ctx, name)
        recs = trace.spans("cns.prep.struct")
        counts = {k: v["s"] for k, v in trace.snapshot("cns.struct.")
                  .items()}
    finally:
        trace.reset()
    (gaps, sups), = given
    outer = recs[-1]
    assert outer.name == "cns.prep.struct" and outer.parent == "cns.prep"
    if case == "no_sa":
        assert [r.name for r in recs] == ["cns.prep.struct"]
        assert counts == {"cns.struct.gaps": 0, "cns.struct.sup_alns": 0,
                          "cns.struct.off_windows": 1}
        return
    assert [r.name for r in recs] == [
        "cns.prep.struct.cluster", "cns.prep.struct.realign",
        "cns.prep.struct.gapseq", "cns.prep.struct"]
    for r in recs[:-1]:
        assert r.parent == "cns.prep.struct"
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    assert counts == {
        "cns.struct.gaps": gaps, "cns.struct.sup_alns": sups,
        "cns.struct.clusters": len(work.clusters),
        "cns.struct.sup_rows": int((work.merged.ridx == -2).sum()),
        "cns.struct.split_points": len(ctx.split_ps)}
    assert gaps and sups and work.clusters and counts["cns.struct.sup_rows"]
