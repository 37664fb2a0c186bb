"""The port's aligner (nextpolish_tpu_torch/align) against the JAX
package's, on the CPU, exactly: the banded DP (tb, scores, end cells) and
the fused align + traceback (all seven outputs) in local, global and
extend modes at bands 32, 64 and 1,150; a forced sub-batch split; the
short-read mapper (paired, with mate rescue) and the long-read mapper
(split reads, SA tags) on the toy genomes of tests/test_align.py and
tests/test_longread.py.  Inputs come from numpy with fixed seeds
(nextpolish_tpu_torch.sim.band_case); the JAX functions run on the CPU as
the JAX package's own tests run them."""
import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish_tpu.align import extend as jext
from nextpolish_tpu.align.index import GenomeIndex as JIndex
from nextpolish_tpu.align.longread import map_long_batch as j_map_long
from nextpolish_tpu.align.mapper import map_short_batch as j_map_short
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.align import extend as text
from nextpolish_tpu_torch.align import mapper as tmapper
from nextpolish_tpu_torch.align.index import GenomeIndex as TIndex
from nextpolish_tpu_torch.align.longread import map_long_batch as t_map_long
from util_sim import rand_seq

_COMP = bytes.maketrans(b"ACGT", b"TGCA")

# (mode, R, B, Bt): every mode at bands 32, 64 and 1,150; Bt is
# not a power of two, and Bt >= 8 where it is cheap so the case holds
# tandem-repeat references, repeat-unit indels and an unrelated read
CASES = [(m, R, B, Bt) for m in ("local", "global", "extend")
         for R, B, Bt in ((150, 32, 9), (100, 64, 9), (150, 1150, 3))]


def _case(mode, R, B, Bt):
    q, t, qlen, tlen = sim.band_case(R * 7 + B + Bt, Bt, R, B, mode)
    if mode == "global" and B == 32:
        # forced end cells past the band's right edge, left of it by more
        # than B, and at -1 (take_along_axis wraps it to B-1)
        off = B // 2
        qlen[:3] = (78, 145, 100)
        tlen[:3] = (R + B - off, 1, 100 - 1 - off)
    return q, t, qlen, tlen


@pytest.fixture(scope="module")
def jax_out():
    """JAX's core DP (with the main path's clip5/clip3) and fused ops, per
    case; shared by the tests below."""
    out = {}
    for case in CASES:
        mode = case[0]
        q, t, qlen, tlen = _case(*case)
        kw = sim.BAND_SCORES[mode]
        core = jext._band_align(jnp.asarray(q), jnp.asarray(t),
                                jnp.asarray(qlen), jnp.asarray(tlen),
                                mode=mode, **kw)
        ops = jext.band_align_ops(q, t, qlen, tlen, mode=mode, **kw)
        out[case] = ([np.asarray(x) for x in core], ops)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-R{c[1]}-B{c[2]}")
def test_band_align_plain_matches_jax(jax_out, case):
    """B10: tb, the best score, the end row and the end column, byte for
    byte."""
    mode = case[0]
    q, t, qlen, tlen = _case(*case)
    got = text.band_align_core(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(qlen),
        torch.from_numpy(tlen), mode=mode, **sim.BAND_SCORES[mode])
    want = jax_out[case][0]
    assert (qlen < case[1]).any()  # rows past qlen
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert text.band_align_core.launches == 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-R{c[1]}-B{c[2]}")
def test_band_align_ops_matches_jax(jax_out, case):
    """B11: the port's band_align_ops equals JAX's on all seven outputs
    (op streams, score, start and end cells, leading deletions)."""
    mode = case[0]
    got = text.band_align_ops(*_case(*case), mode=mode, device="cpu",
                              **sim.BAND_SCORES[mode])
    for g, w in zip(got, jax_out[case][1]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert text.band_traceback.launches == 0


@pytest.mark.parametrize("mode", ["local", "global", "extend"])
def test_band_indel_case_matches_jax(mode):
    """Reads with one long indel each (sim.band_indel_case: walks that
    move across many band columns) at a band wider
    than the traceback's 64-column window: the fused align + traceback
    equals JAX's on all seven outputs."""
    R, B, Bt = 120, 100, 6
    q, t, qlen, tlen = sim.band_indel_case(17, Bt, R, B, mode)
    kw = sim.BAND_SCORES[mode]
    got = text.band_align_ops(q, t, qlen, tlen, mode=mode, device="cpu",
                              **kw)
    want = jext.band_align_ops(q, t, qlen, tlen, mode=mode, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # some walk crosses more than half the window: a run of 33 or more
    # insertions or deletions
    longest = {2: 0, 3: 0}  # op + 1 of I and D
    for row in got[0]:
        run, prev = 0, 0
        for op in row[row > 0]:
            run = run + 1 if op == prev else 1
            prev = op
            if op in longest:
                longest[op] = max(longest[op], run)
    assert max(longest.values()) > 32


def _full_h(q, t, qlen, tlen, mode, match, mismatch, gapo, gape, clip5=0,
            clip3=0):
    """Every row's H of the banded DP (local or extend mode), [Bt, R, B],
    by a small numpy DP of the same recurrence."""
    Bt, R = q.shape
    B = t.shape[1] - R
    c = np.arange(B, dtype=np.int64)
    neg = np.full((Bt, 1), text.NEG, dtype=np.int64)
    if mode == "extend":
        H = np.where(c == 0, clip5, clip5 - (gapo + c * gape))
    else:
        H = np.full(B, clip5)
    H = np.broadcast_to(H.astype(np.int64), (Bt, B))
    E = np.full((Bt, B), text.NEG, dtype=np.int64)
    out = np.empty((Bt, R, B), dtype=np.int64)
    for i in range(R):
        qi = q[:, i:i + 1].astype(np.int64)
        tj = t[:, i:i + B].astype(np.int64)
        ok = ((qi < 4) & (i < qlen[:, None]) & (tj < 4)
              & (i + c < tlen[:, None]))
        sub = np.where(ok, np.where(qi == tj, match, -mismatch), text.NEG)
        Hup = np.concatenate([H[:, 1:], neg], axis=1)
        Eup = np.concatenate([E[:, 1:], neg], axis=1)
        E = np.maximum(Hup - gapo, Eup) - gape
        Hp = np.maximum(np.maximum(H + sub, E), 0)
        cm = np.maximum.accumulate(Hp + c * gape, axis=1)
        F = (np.concatenate([neg, cm[:, :-1]], axis=1) - (gapo + gape)
             - c * gape)
        H = np.maximum(Hp, F)
        out[:, i] = H
    return out


@pytest.mark.parametrize("mode", ["local", "extend"])
def test_best_cell_is_lexicographic(mode):
    """With clip3 = 0 the end cell of local and extend modes (jnp.argmax
    over the row maxima, then over that row's cells) is the lexicographic
    best of the whole H matrix: the largest H, then the smallest row, then
    the smallest cell.  The card's band_align keeps that key per lane and
    reduces it once after the last row, so this pins the equivalence on
    inputs with ties (tandem repeats) across rows and within a row."""
    R, B, Bt = 90, 32, 30
    q, t, qlen, tlen = sim.band_case(5, Bt, R, B, mode)
    kw = dict(sim.BAND_SCORES[mode], clip3=0)
    H = _full_h(q, t, qlen, tlen, mode, **kw)
    _, best, bi, bc = (x.numpy() for x in text.band_align_plain(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(qlen),
        torch.from_numpy(tlen), mode=mode, **kw))
    row_ties = cell_ties = 0
    for b in range(Bt):
        top = H[b].max()
        rows, cells = np.nonzero(H[b] == top)
        r0 = rows.min()
        assert (best[b], bi[b], bc[b]) == (top, r0, cells[rows == r0].min())
        row_ties += len(set(rows)) > 1
        cell_ties += (rows == r0).sum() > 1
    assert row_ties and cell_ties


def test_numpy_band_align_matches_jax():
    """The numpy band_align (no clip arguments, as in JAX) on a batch
    that JAX pads to a power of two."""
    q, t, qlen, tlen = sim.band_case(3, 6, 80, 32, "local")
    want = jext.band_align(q, t, qlen, tlen)
    got = text.band_align(q, t, qlen, tlen, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_sub_batch_split_matches_jax(monkeypatch):
    """A traceback budget of a few reads splits the batch; the bytes do
    not change."""
    mode, R, B, Bt = "local", 150, 32, 9
    q, t, qlen, tlen = _case(mode, R, B, Bt)
    kw = sim.BAND_SCORES[mode]
    monkeypatch.setattr(text, "TB_BUDGET_BYTES", 2 * R * B)
    assert len(text._sub_batches(Bt, R, B, torch.device("cpu"))) == 5
    got = text.band_align_ops(q, t, qlen, tlen, mode=mode, device="cpu",
                              **kw)
    want = jext.band_align_ops(q, t, qlen, tlen, mode=mode, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    got_tb = text.band_align(q, t, qlen, tlen, device="cpu")
    for g, w in zip(got_tb, jext.band_align(q, t, qlen, tlen)):
        assert np.array_equal(g, w)


def test_device_traceback_case_matches_jax():
    """tests/test_align.py::test_device_traceback_matches_host's inputs,
    both modes: the port's seven outputs equal JAX's."""
    rng = np.random.default_rng(11)
    for mode, band in (("local", 32), ("global", 32)):
        Bt, R = 5, 80
        W = R + band
        off = 0 if mode == "local" else band // 2
        q = np.full((Bt, R), 4, np.uint8)
        t = np.full((Bt, W), 4, np.uint8)
        qlen = np.zeros(Bt, np.int32)
        tlen = np.zeros(Bt, np.int32)
        for b in range(Bt):
            ref = rng.integers(0, 4, R).astype(np.uint8)
            read = ref.copy()
            read[rng.integers(0, R, 3)] = rng.integers(0, 4, 3)
            if b % 2:
                read = np.delete(read, 10)
            ql = read.size - (5 if mode == "local" else 0)
            q[b, :ql] = read[:ql]
            t[b, off:off + R] = ref
            qlen[b] = ql
            tlen[b] = R
        kw = dict(match=2, mismatch=4, gapo=4, gape=2, mode=mode)
        want = jext.band_align_ops(q, t, qlen, tlen, **kw)
        got = text.band_align_ops(q, t, qlen, tlen, device="cpu", **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                assert np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


def test_map_short_batch_matches_jax():
    """Paired reads with mate rescue (tests/test_align.py::
    test_pe_mate_rescue's genome: a third of the second mates carry an
    error in every seed k-mer) and single-end reads with errors on the
    two-contig toy genome."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    true = rng.choice(bases, 30000).tobytes()
    seqs = []
    for i in range(60):
        s = int(rng.integers(0, 30000 - 500))
        r1 = true[s:s + 150]
        r2 = true[s + 300:s + 450].translate(_COMP)[::-1]
        if i % 3 == 0:
            arr = bytearray(r2)
            for j in range(0, 150, 11):
                arr[j] = b"ACGT"[(arr[j] + 1) % 4]
            r2 = bytes(arr)
        seqs += [r1, r2]
    args = ([("ctg", true)],)
    want = j_map_short(JIndex.build(*args, k=15, w=10), seqs, paired=True)
    got = tmapper.map_short_batch(TIndex.build(*args, k=15, w=10), seqs,
                                  paired=True, device="cpu")
    _same_records(got, want)
    rescued = [r for i, r in enumerate(got)
               if i % 6 == 1 and not r["flag"] & 4]
    assert len(rescued) >= 16  # the mate rescue ran

    rng = np.random.default_rng(9)
    g = rand_seq(rng, 20000)
    contigs = [("c1", g[:12000]), ("c2", g[12000:])]
    reads = []
    for i in range(100):
        p = int(rng.integers(0, 19800))
        r = bytearray(g[p:p + 150])
        for _ in range(3):
            j = int(rng.integers(0, len(r)))
            r[j] = b"ACGT"[int(rng.integers(0, 4))]
        reads.append(bytes(r) if i % 2 else bytes(r).translate(_COMP)[::-1])
    want = j_map_short(JIndex.build(contigs, k=17, w=7), reads)
    got = tmapper.map_short_batch(TIndex.build(contigs, k=17, w=7), reads,
                                  device="cpu")
    _same_records(got, want)


def _noisy(rng, s: bytes, sub=0.03, ins=0.03, dele=0.03) -> bytes:
    out = bytearray()
    for ch in s:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(b"ACGT"[int(rng.integers(0, 4))])
        if r < dele + ins + sub:
            out.append(b"ACGT"[int(rng.integers(0, 4))])
        else:
            out.append(ch)
    return bytes(out)


def test_map_long_batch_matches_jax():
    """tests/test_longread.py's genome: a read across a 6 kb draft-only
    segment (a primary and a supplementary with SA tags), noisy reads of
    both strands (segments in several buckets, end extensions)."""
    rng = np.random.default_rng(5)
    g = rand_seq(rng, 60000)
    rng = np.random.default_rng(9)
    true = g[:20000] + g[26000:]
    reads = [_noisy(rng, true[12000:30000], 0.02, 0.02, 0.02),
             _noisy(rng, g[40000:50000], 0.02, 0.02, 0.02)]
    for i in range(4):
        p = int(rng.integers(0, 50000))
        r = _noisy(rng, g[p:p + int(rng.integers(3000, 8000))])
        reads.append(r.translate(_COMP)[::-1] if i % 2 else r)
    want = j_map_long(JIndex.build([("ctg", g)], k=15, w=10), reads)
    got = t_map_long(TIndex.build([("ctg", g)], k=15, w=10), reads,
                     device="cpu")
    _same_records(got, want)
    assert sum(1 for r in got if r["flag"] & 0x800) == 1
    assert all(b"SAZ" in r["tags"] for r in got[:1] + got[-1:])


def test_mapper_imports_at_module_level():
    """No import statement inside the mapper's per-record loops (JAX's
    mapper imports left_align_cigar inside them)."""
    for fn in (tmapper.map_short_batch, tmapper._mate_rescue):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, (ast.Import, ast.ImportFrom))], fn
    assert tmapper.left_align_cigar.__module__.endswith("align.leftalign")
