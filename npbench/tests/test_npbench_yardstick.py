"""The yardstick: the generator repeats per seed and does not move, the
device trace's union and gaps, the roofline's bytes and operations."""
import hashlib

import pytest

from npbench import devtrace, harness, roofline, simgen


def _digest(case, tmp):
    fa, bam = simgen.write_case(case, str(tmp))
    h = hashlib.sha256()
    for p in (fa, bam, bam + ".bai"):
        h.update(open(p, "rb").read())
    return h.hexdigest()


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


@pytest.mark.parametrize("kind", ["short", "long"])
def test_generator_frozen(tmp_path, kind):
    case = (simgen.simulate_short_case(7, [3000, 2000], 20) if kind ==
            "short" else simgen.simulate_case(7, 2, [6000, 5000], 8))
    assert _digest(case, tmp_path) == FROZEN[kind]


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


@pytest.mark.parametrize("kind", ["short", "long"])
def test_draft_indels_alignments_hold(kind):
    """With indels in the draft the reads' composed alignments still
    hold: walked along the draft, their M bases differ at about the
    reads' and the draft's substitution rates together, not at the 3/4
    of a shifted alignment."""
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


@pytest.mark.parametrize("kind", ["short", "long"])
def test_generator_with_draft_indels_frozen(tmp_path, kind):
    case = (simgen.simulate_short_case(7, [3000, 2000], 20,
                                       draft_ins=0.002, draft_del=0.002)
            if kind == "short" else
            simgen.simulate_case(7, 2, [6000, 5000], 8, draft_sub=0.05,
                                 draft_ins=0.02, draft_del=0.02))
    assert _digest(case, tmp_path) == FROZEN_INDELS[kind]
