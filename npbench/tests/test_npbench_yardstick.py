"""The yardstick: the generators repeat per seed, are found by name and
do not move, the device trace's union and gaps, the roofline's bytes and
operations."""
import hashlib
import os

import numpy as np
import pytest

from npbench import devtrace, harness, roofline, simgen
from npbench.tests import stub


def _files_digest(fa, bam):
    h = hashlib.sha256()
    for p in (fa, bam, bam + ".bai"):
        h.update(open(p, "rb").read())
    return h.hexdigest()


def _digest(case, tmp):
    return _files_digest(*simgen.write_case(case, str(tmp)))


# configurations whose generators (npbench/gens/) draw what the frozen
# cases below draw through simgen's own defaults
SHORT = {"reads": dict(stub.SHORT, depth=20), "draft_sub": 0.005}
LONG = {"reads": {"kind": "long", "depth": 8, "read_len": [3000, 12000],
                  "sub": 0.03, "ins": 0.03, "del": 0.03, "rev_frac": 0.5},
        "draft_sub": 0.005}
DIPLOID = {"reads": dict(SHORT["reads"], kind="paired_end_diploid",
                         het_sub=0.001),
           "draft_sub": 0.001, "draft_ins": 0.0006, "draft_del": 0.0006}


def _block_digest(config, lens, seed, tmp):
    b = harness.make_block(config, lens, seed, str(tmp), "b")
    return _files_digest(b.fa, b.bam)


def test_generator_repeats_per_seed(tmp_path):
    a = simgen.simulate_short_case(7, [3000, 2000], 20)
    b = simgen.simulate_short_case(7, [3000, 2000], 20)
    c = simgen.simulate_short_case(8, [3000, 2000], 20)
    assert _digest(a, tmp_path / "a") == _digest(b, tmp_path / "b")
    assert a.drafts != c.drafts
    assert [len(d) for d in a.drafts] == [len(d) for d in c.drafts]


# sha256 of simulate_short_case(7, [3000, 2000], 20) and of
# simulate_case(7, 2, [6000, 5000], 8) written by write_case: the frozen
# generator's output, which no later change may move
FROZEN = {
    "short": "1ec13e426169aa9a3d1fa5d0c03a6df05fec7bd9f5e008ae6020ab2a1b1768f9",
    "long": "5a7c3fc698811e5accdb467836a03aa08aaed77928fdfc605dde42f31d7ea61a",
}


@pytest.mark.parametrize("via", ["simgen", "make_block"])
@pytest.mark.parametrize("kind", ["short", "long"])
def test_generator_frozen(tmp_path, kind, via):
    """The frozen cases, drawn by simgen and through make_block's
    generator files (npbench/gens/paired_end.py, long.py)."""
    if via == "make_block":
        config, lens = ((SHORT, [3000, 2000]) if kind == "short"
                        else (LONG, [6000, 5000]))
        assert _block_digest(config, lens, 7, tmp_path) == FROZEN[kind]
        return
    case = (simgen.simulate_short_case(7, [3000, 2000], 20) if kind ==
            "short" else simgen.simulate_case(7, 2, [6000, 5000], 8))
    assert _digest(case, tmp_path) == FROZEN[kind]


def test_generator_found_by_name(tmp_path):
    """A read kind added as a file under npbench/gens/ is found by the
    configuration's `reads.kind`, with no edit to the harness."""
    root = stub.scratch_root(tmp_path / "root", "stub_gen", [[2000]])
    with open(os.path.join(root, "npbench", "gens", "short_twice.py"),
              "w") as fh:
        fh.write("from npbench import simgen\n\n\n"
                 "def simulate(seed, lens, config):\n"
                 "    return simgen.simulate_short_case(\n"
                 "        seed, list(lens) * 2, config['reads']['depth'])\n")
    config = {"reads": {"kind": "short_twice", "depth": 5}}
    b = harness.make_block(config, [3000], 4, str(tmp_path), "b", root)
    assert b.names == ["ctg0", "ctg1"]
    assert b.drafts == simgen.simulate_short_case(4, [3000, 3000], 5).drafts


def test_unknown_read_kind_raises(tmp_path):
    with pytest.raises(ValueError) as e:
        harness.make_block({"reads": {"kind": "no_such_kind"}}, [2000], 1,
                           str(tmp_path), "b")
    assert "no_such_kind" in str(e.value)
    assert os.path.join(harness.ROOT, "npbench", "gens") in str(e.value)


# sha256 of make_block(DIPLOID, [3000, 2000], 7, ...): the diploid
# generator's output, which no later change may move
FROZEN_DIPLOID = (
    "c135fb80c73c2a22287ec9525ba0e647498ca96b695e1de68f04352fb0ca622c")


def test_diploid_generator_frozen_and_repeats(tmp_path):
    a = _block_digest(DIPLOID, [3000, 2000], 7, tmp_path / "a")
    assert a == _block_digest(DIPLOID, [3000, 2000], 7, tmp_path / "b")
    assert a == FROZEN_DIPLOID
    assert a != _block_digest(DIPLOID, [3000, 2000], 8, tmp_path / "c")


def test_diploid_haplotypes_differ_by_substitutions():
    """hap2 is hap1 with substitutions only (same length, every base in
    ACGT), at het_sub within four standard deviations."""
    gen = harness.load_file("gens", "paired_end_diploid")
    n, rate = 200000, DIPLOID["reads"]["het_sub"]
    hap1, hap2 = gen.haplotypes(np.random.default_rng(5), n, rate)
    assert len(hap1) == len(hap2) == n
    assert set(np.unique(hap2).tolist()) <= set(b"ACGT")
    k = int((hap1 != hap2).sum())
    assert abs(k - n * rate) < 4 * (n * rate) ** 0.5


def test_diploid_reads_split_between_haplotypes(tmp_path):
    """Reads named a... come from hap1 and b... from hap2, each at about
    half the depth: at the heterozygous sites, a gapless read's base is
    its own haplotype's allele but for its error rate (the draft without
    indels here, so draft and haplotype positions agree)."""
    depth, length, seed = 20, 30000, 11
    config = dict(DIPLOID, reads=dict(DIPLOID["reads"], depth=depth),
                  draft_ins=0.0, draft_del=0.0)
    b = harness.make_block(config, [length], seed, str(tmp_path), "b")
    gen = harness.load_file("gens", "paired_end_diploid")
    hap1, hap2 = gen.haplotypes(np.random.default_rng(seed), length,
                                config["reads"]["het_sub"])
    assert b.truths == [hap1.tobytes()]
    het = np.flatnonzero(hap1 != hap2)
    assert len(het) > 10
    for tag, hap in (("a", hap1), ("b", hap2)):
        recs = [r for r in b.records if r["name"].startswith(tag)]
        cov = sum(len(r["seq_nib"]) for r in recs) / length
        assert abs(cov - depth / 2) < 0.05 * depth, tag
        own = seen = 0
        for r in recs:
            if len(r["cigar"]) != 1:
                continue
            seq = bytes(NIB[n] for n in r["seq_nib"])
            for p in het[(het >= r["pos"])
                         & (het < r["pos"] + len(seq))].tolist():
                seen += 1
                own += seq[p - r["pos"]] == hap[p]
        assert seen > 50 and own / seen > 0.95, tag
    assert all(r["name"][0] in "ab" for r in b.records)


def test_block_seeds_take_large_seeds():
    s = harness.seeds_of(2**31 + 17, 4)
    assert len(set(s)) == 4 and all(0 <= v < 2**63 for v in s)
    assert s == harness.seeds_of(2**31 + 17, 4)
    order = harness.replay_order(s[2], 2)
    first = [next(order) for _ in range(6)]
    assert sorted(first[:2]) == [0, 1] and sorted(first[2:4]) == [0, 1]


def _iv(s, e, name="k"):
    return devtrace.Interval(name, s, e)


def test_busy_union_and_idle_share():
    ops = [_iv(0.1, 0.3), _iv(0.2, 0.4), _iv(0.9, 1.2), _iv(-1, -0.5)]
    assert devtrace.union_seconds(ops, 0.0, 1.0) == pytest.approx(0.4)
    jobs = [_iv(0.0, 0.6, "job0:a"), _iv(0.6, 1.0, "job1:b")]
    tr = devtrace.DeviceTrace(ops, jobs, 0.0, 1.0)
    assert tr.busy_s == pytest.approx(0.4)
    read = harness.load_reader("device_idle_share")
    assert read({"trace": tr}) == pytest.approx(60.0)
    assert read({"trace": devtrace.DeviceTrace([], jobs, 0.0, 1.0)}) is None
    gaps = devtrace.idle_gaps(ops, 0.0, 1.0)
    assert [(round(a, 6), round(b, 6)) for a, b in gaps] == [
        (0.4, 0.9), (0.0, 0.1)]
    bd = tr.breakdown()
    # the gap is named by the job that holds its middle
    assert bd["idle_gaps"][0][0] == "job1:b: before its first device op"
    assert bd["idle_gaps"][1][0] == "job0:a: before its first device op"
    assert bd["device_ops"] == [["k", pytest.approx(0.5)]]


def test_kernel_seconds_leave_out_copies():
    ops = [_iv(0, 1, "(anonymous namespace)::fwd_scan(float const*, int)"),
           _iv(1, 3, "Memcpy HtoD (Pinned -> Device)"),
           _iv(3, 3.5, "void at::native::reduce_kernel<512, 1>(int)")]
    tr = devtrace.DeviceTrace(ops, [], 0, 4)
    assert tr.kernel_seconds() == pytest.approx(1.5)
    assert tr.kernel_seconds(lambda n: n.startswith("fwd_")) == 1
    assert tr.kernel_seconds(lambda n: n == "reduce_kernel") == 0.5
    assert [o[0] for o in tr.breakdown()["device_ops"]] == [
        "Memcpy HtoD", "fwd_scan", "reduce_kernel"]
    assert tr.busy_s == pytest.approx(3.5)


def test_chain_forward_bound_known_shape():
    """chip_smoke.py's bound at phase 5's launch (1, 8,388,608): 0.7212 ms
    by bytes (PERF.md)."""
    nbytes, ops = roofline.chain_forward_work(1, 8388608)
    assert nbytes == 8388608 * 288 + 32
    assert ops == 8388608 * 1207 + 2 * 65536 * 960
    t, by = roofline.least_seconds(nbytes, ops)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.7212, abs=5e-5)


def test_chain_forward_roofline_reader():
    read = harness.load_reader("chain_forward_roofline")
    cells = 1 << 20
    tr = devtrace.DeviceTrace([_iv(0, 1e-3, "fwd_scan"),
                               _iv(1e-3, 2e-3, "elementwise")], [], 0, 1)
    ctx = {"trace": tr, "buckets": {
        "task1.chain_cells": {"s": cells, "n": 1},
        "task1.chain_launches": {"s": 1, "n": 1}}}
    least = (cells * 288 + 32) / roofline.H100_BYTES_PER_S
    assert read(ctx) == pytest.approx(100 * least / 1e-3)
    ctx["trace"] = devtrace.DeviceTrace([_iv(0, 1, "other")], [], 0, 1)
    assert read(ctx) is None


NIB = b"=ACMGRSVTWYHKDBN"


def _aligned(case):
    """(M bases, mismatches against the draft) over every read's CIGAR
    walked along the draft; asserts each CIGAR's query length is its
    read's and that it starts and ends with M or a soft clip."""
    tot = mm = 0
    for rec in case.records:
        draft = case.drafts[rec["tid"]]
        seq = bytes(NIB[n] for n in rec["seq_nib"])
        ops = [(int(w) & 0xF, int(w) >> 4) for w in rec["cigar"]]
        assert ops[0][0] in (0, 4) and ops[-1][0] in (0, 4)
        rp, qp = rec["pos"], 0
        for op, n in ops:
            if op == 0:
                tot += n
                mm += sum(a != b for a, b in zip(seq[qp:qp + n],
                                                 draft[rp:rp + n]))
            rp += n if op in (0, 2) else 0
            qp += n if op in (0, 1, 4) else 0
        assert qp == len(seq) and rp <= len(draft)
    return tot, mm


@pytest.mark.parametrize("kind", ["short", "long", "diploid"])
def test_draft_indels_alignments_hold(kind, tmp_path):
    """With indels in the draft the reads' composed alignments still
    hold: walked along the draft, their M bases differ at about the
    reads' and the draft's substitution rates together (and, for hap2's
    reads, the heterozygous rate), not at the 3/4 of a shifted
    alignment."""
    if kind == "diploid":
        config = dict(DIPLOID, draft_sub=0.001, draft_ins=0.003,
                      draft_del=0.003)
        b = harness.make_block(config, [20000], 3, str(tmp_path), "b")
        case = simgen.SimCase(b.names, b.truths, b.drafts, b.records)
        assert len(case.drafts[0]) != len(case.truths[0])
        for tag, rate in (("a", 0.01 + 0.001),
                          ("b", 0.01 + 0.001 + 0.001)):
            tot, mm = _aligned(simgen.SimCase(
                b.names, b.truths, b.drafts,
                [r for r in b.records if r["name"].startswith(tag)]))
            assert 0.7 * rate < mm / tot < 1.3 * rate, tag
        assert [r["pos"] for r in case.records] == sorted(
            r["pos"] for r in case.records)
        return
    if kind == "short":
        case = simgen.simulate_short_case(3, [20000], 20, draft_sub=0.001,
                                          draft_ins=0.003, draft_del=0.003)
        rate = 0.01 + 0.001
    else:
        case = simgen.simulate_case(3, 1, [30000], 8, draft_sub=0.05,
                                    draft_ins=0.02, draft_del=0.02)
        rate = 0.03 + 0.05
    assert len(case.drafts[0]) != len(case.truths[0])
    tot, mm = _aligned(case)
    assert 0.7 * rate < mm / tot < 1.3 * rate
    assert [r["pos"] for r in case.records] == sorted(
        r["pos"] for r in case.records)


# sha256 of the same two cases with indels in the draft
FROZEN_INDELS = {
    "short": "3b514f88d05a3a41eacc85382f043cad1fdc096de135cffd61a06d3ce674c154",
    "long": "91b8aaedbe67121ee011b8fbb47cc5d6fbb68fc0854796dc80003089ab29829d",
}


@pytest.mark.parametrize("via", ["simgen", "make_block"])
@pytest.mark.parametrize("kind", ["short", "long"])
def test_generator_with_draft_indels_frozen(tmp_path, kind, via):
    if via == "make_block":
        config, lens = ((dict(SHORT, draft_ins=0.002, draft_del=0.002),
                         [3000, 2000]) if kind == "short" else
                        (dict(LONG, draft_sub=0.05, draft_ins=0.02,
                              draft_del=0.02), [6000, 5000]))
        assert _block_digest(config, lens, 7, tmp_path) == \
            FROZEN_INDELS[kind]
        return
    case = (simgen.simulate_short_case(7, [3000, 2000], 20,
                                       draft_ins=0.002, draft_del=0.002)
            if kind == "short" else
            simgen.simulate_case(7, 2, [6000, 5000], 8, draft_sub=0.05,
                                 draft_ins=0.02, draft_del=0.02))
    assert _digest(case, tmp_path) == FROZEN_INDELS[kind]
