"""The port's level scan (nextpolish_tpu_torch/models/cns/level_scan.py)
against the JAX package's engine-2 device scan.

Windows are simulated with numpy from fixed seeds, prepared ONCE by the
JAX package (window_prep + prepare_window) and carried to the port with
device_dp.dense_window_from_arrays, so both sides scan identical levels.
The port's plain PyTorch version must equal, exactly (all integer
arithmetic), the JAX lax.scan path for every read type and every window,
and the Pallas kernel (interpret mode on the CPU) wherever that kernel
takes the window (E <= 20).  Each half of the plain version is also held
to the JAX package on its own, on these windows and on random level
streams (tests/torch_scan_cases.py): the chain's per-entry scores to
_dp_level run level by level, the winners to _dp_level's winners.  The
hand-written CUDA kernels are held to the plain versions by
tests/test_torch_gpu.py, which needs a card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scan_cases import (
    max_level_entries,
    random_window,
    stale_ring_reads,
)

from nextpolish_tpu.io.bam import read_bam as jax_read_bam
from nextpolish_tpu.models.cns import device_dp as jdd
from nextpolish_tpu.models.cns.window import window_prep as jax_window_prep
from nextpolish_tpu_torch import sim
from nextpolish_tpu_torch.models.cns import device_dp as tdd
from nextpolish_tpu_torch.models.cns import level_scan as tls

RTS = ["ont", "clr", "rs", "hifi"]


def jax_prepared_windows(outdir, seed, lengths, depth, err, read_len,
                         hotspot=None):
    """Simulate one whole-contig window per length and prepare each with
    the JAX package; returns [(jax DenseWindow, port DenseWindow)]."""
    case = sim.simulate_case(seed, len(lengths), lengths, depth, read_len,
                             sub=err, ins=err, dele=err, hotspot=hotspot)
    _, bam = sim.write_case(case, str(outdir))
    batch = jax_read_bam(bam)
    out = []
    for tid, draft in enumerate(case.drafts):
        ca = np.frombuffer(draft, dtype=np.uint8)
        work = jax_window_prep(batch, tid, ca, 0, len(draft), "ont", None,
                               case.names[tid])
        _, jdw = jdd.prepare_window(work.merged, work.coverage, work.L)
        assert jdw is not None
        out.append((jdw, tdd.dense_window_from_arrays(
            dataclasses.asdict(jdw))))
    return out


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """B>1 windows of different lengths, then the special shapes."""
    d = tmp_path_factory.mktemp("level_scan")
    ws = {}
    ws["batch"] = jax_prepared_windows(d / "b", 5, [900, 1600, 500], 30,
                                       0.03, (300, 900))
    ws["e20"] = jax_prepared_windows(d / "t", 2, [1200], 70, 0.05,
                                     (500, 1200), (600, 1, False))
    ws["wide_e"] = jax_prepared_windows(d / "e", 0, [2000], 110, 0.05,
                                        (1000, 2000), (1000, 1, False))
    ws["deep_ring"] = jax_prepared_windows(d / "v", 1, [1600], 30, 0.03,
                                           (800, 1600), (800, 12, True))
    ws["chain"] = jax_prepared_windows(d / "c", 2, [1600], 8, 0.03,
                                       (800, 1600), (800, 300, True))
    return ws


def _all(windows):
    return [p for k in ("batch", "e20", "wide_e", "deep_ring", "chain")
            for p in windows[k]]


def test_windows_cover_the_shapes(windows):
    """The fixture really has B>1 lengths, 17<=E<=20, 21<=E<=24, Vb>8 and
    a deep insertion chain (so the comparisons below exercise them)."""
    lens = {dw.n_levels for dw, _ in windows["batch"]}
    assert len(lens) == 3
    (t,) = windows["e20"]
    assert 17 <= t[0].E <= 20
    (e,) = windows["wide_e"]
    assert 21 <= e[0].E <= 24
    (v,) = windows["deep_ring"]
    assert v[0].Vb > 8
    (c,) = windows["chain"]
    _, counts = np.unique(c[0].level_pos, return_counts=True)
    assert counts.max() >= 200
    assert max(dw.E for dw, _ in windows["batch"]) <= 20


def test_dense_window_from_arrays(windows):
    for jdw, pdw in _all(windows):
        for f in dataclasses.fields(jdw):
            a, b = getattr(jdw, f.name), getattr(pdw, f.name)
            if f.name == "edges":
                for g in dataclasses.fields(a):
                    assert np.array_equal(getattr(a, g.name),
                                          getattr(b, g.name))
            elif isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


@pytest.mark.parametrize("rt", RTS)
def test_plain_matches_lax_scan(windows, rt, monkeypatch):
    """Every window, every read type: best and sc equal the lax.scan path
    in full, and with sc_tail from each window's last position on."""
    monkeypatch.setenv("NPT_CNS_PALLAS", "0")
    pairs = _all(windows)
    ref = jdd._run_batch([j for j, _ in pairs], rt)
    got = tdd._run_batch([p for _, p in pairs], rt, devices=["cpu"])
    tail = tdd._run_batch([p for _, p in pairs], rt, devices=["cpu"],
                          sc_tail=True)
    for (_, pdw), (rb, rs), (gb, gs), (tb, ts) in zip(pairs, ref, got,
                                                      tail):
        assert gb.dtype == np.int8 and gs.dtype == np.int32
        assert np.array_equal(rb, gb)
        assert np.array_equal(rs, gs)
        l0 = tdd.tail_start(pdw)
        assert np.array_equal(rb, tb)
        assert np.array_equal(rs[l0:], ts[l0:])
        assert (ts[:l0] == tls.NEG).all()


@pytest.mark.parametrize("rt", RTS)
def test_plain_matches_pallas_interpret(windows, rt):
    """The B>1 batch and the 17<=E<=20 window against the Pallas kernel
    itself (interpret mode), full scores and score tails."""
    pairs = windows["batch"] + windows["e20"]
    for sc_tail in (False, True):
        ref = jdd._run_batch_pallas([j for j, _ in pairs], rt,
                                    sc_tail=sc_tail)
        got = tdd._run_batch([p for _, p in pairs], rt, devices=["cpu"],
                             sc_tail=sc_tail)
        for (_, pdw), (rb, rs), (gb, gs) in zip(pairs, ref, got):
            assert np.array_equal(rb, gb)
            l0 = tdd.tail_start(pdw) if sc_tail else 0
            assert np.array_equal(rs[l0:], gs[l0:])


def test_plain_is_per_window_exact(windows):
    """Batching is invisible: each window scanned alone equals the same
    window inside a batch with wider E / Vb neighbours."""
    pairs = _all(windows)
    batched = tdd._run_batch([p for _, p in pairs], "ont", devices=["cpu"])
    for (_, pdw), (bb, bs) in zip(pairs, batched):
        ((ab, as_),) = tdd._run_batch([pdw], "ont", devices=["cpu"])
        assert np.array_equal(ab, bb) and np.array_equal(as_, bs)


def test_wrapper_routes_and_checks(windows):
    """CPU tensors take the plain versions (no kernel launch is counted);
    tensors on two devices, or a negative link, are refused by the
    wrappers."""
    pairs = windows["batch"]
    b = tdd.pack_batch([p for _, p in pairs])
    before = (tls.level_chain.launches, tls.level_winners.launches)
    best, sc = tls.level_scan(b, 0, 3)
    assert (tls.level_chain.launches, tls.level_winners.launches) == before
    pb, ps = tls.level_scan_plain(b, 0, 3)
    assert torch.equal(best, pb) and torch.equal(sc, ps)
    meta_dev = torch.empty(0, device="meta")
    bad = dataclasses.replace(b, meta=meta_dev)
    with pytest.raises(ValueError):
        tls.level_scan(bad, 0, 3)
    _, pdw = pairs[0]
    neg = dataclasses.replace(pdw, ent_A=pdw.ent_A | np.int32(-2 ** 31))
    with pytest.raises(ValueError):
        tls.level_scan(tdd.pack_batch([neg]), 0, 3)


# ---------------------------------------------------------------------------
# the two halves of the plain version, each against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_levels_fn(rt_id, cov_coef):
    """_dp_level over a window's levels at E = Vb = 24 (vmapped over
    windows): per level the scores it carries out (its sc), n_best and
    n_last gathered from the carry entering it as _dp_level gathers them,
    and its winners."""
    E, Vb = tls.MAX_E, tls.MAX_VB
    slot_ids = jnp.arange(E, dtype=jnp.int32)

    def step(carry, xs):
        a, m, mt = xs
        prev, bnd = carry
        pred = jnp.concatenate([bnd, prev], axis=0)[
            ((a >> 8) & 0xFF).reshape(6, E)]
        mbits = ((m.reshape(6, E)[..., None] >> slot_ids) & 1) != 0
        n_best = jnp.where(mbits, pred, tls.NEG).max(axis=-1)
        last = jnp.maximum(jnp.where(mbits, slot_ids, -1).max(axis=-1), 0)
        n_last = jnp.take_along_axis(pred, last[..., None], axis=-1)[..., 0]
        carry, (best, sc_bm) = jdd._dp_level(
            carry, a, m, mt, E=E, Vb=Vb, rt_id=rt_id, cov_coef=cov_coef)
        return carry, (carry[0], n_best, n_last, best, sc_bm)

    init = (jnp.full((6, E), tls.NEG, jnp.int32),
            jnp.full((Vb * 6, E), tls.NEG, jnp.int32))
    return jax.jit(jax.vmap(
        lambda A, M, meta: jax.lax.scan(step, init, (A, M, meta))[1]))


def _jax_halves(dws, rt):
    """Per window: the JAX package's per-entry (sc, n_best, n_last) in the
    window's entry order, and its (best, sc_bm) per level."""
    E, Vb = tls.MAX_E, tls.MAX_VB
    L = max(dw.n_levels for dw in dws)
    A = np.zeros((len(dws), L, 6 * E), dtype=np.int32)
    M = np.zeros_like(A)
    meta = np.ones((len(dws), L), dtype=np.int32)  # pad levels
    cols = []
    for i, dw in enumerate(dws):
        col = dw.ent_b.astype(np.int64) * E + dw.ent_slot
        # same-position pred rows move past the wider ring
        a = dw.ent_A + ((dw.ent_same.astype(np.int32)
                         * ((Vb - dw.Vb) * 6)) << 8)
        A[i, dw.ent_lvl, col] = a
        M[i, dw.ent_lvl, col] = dw.ent_M
        meta[i, :dw.n_levels] = dw.meta
        cols.append(col)
    fn = _jax_levels_fn(tdd.READ_TYPE_ID[rt], tdd.COV_COEF[rt])
    sc, nb, nl, best, sc_bm = (np.asarray(x) for x in fn(A, M, meta))
    out = []
    for i, (dw, col) in enumerate(zip(dws, cols)):
        ent = [x[i].reshape(L, 6 * E)[dw.ent_lvl, col] for x in (sc, nb, nl)]
        out.append((np.stack(ent),
                    best[i, :dw.n_levels], sc_bm[i, :dw.n_levels]))
    return out


@pytest.fixture(scope="module")
def halves_windows(windows):
    """Simulated windows of several E and Vb, a random stream, and a
    random stream of delta-0 levels only (ring rows reused after every
    reset), dense enough for levels over 32 entries."""
    rnd = [random_window(7, 300, 13, 5),
           random_window(8, 200, 24, 24, density=0.4, d0_frac=1.0)]
    return [p for _, p in windows["batch"] + windows["deep_ring"]] + rnd


def test_random_streams_reach_the_risky_states(halves_windows):
    """The random streams read ring rows that a reset made stale, and hold
    levels with more entries than a warp has lanes."""
    rnd = halves_windows[-2:]
    assert all(stale_ring_reads(dw) > 0 for dw in rnd)
    assert max_level_entries(rnd[1]) > 64


@pytest.mark.parametrize("rt", RTS)
def test_chain_half_matches_dp_level(halves_windows, rt):
    """level_chain_plain over one batch of all the windows: every entry's
    sc equals the score _dp_level carries out of its level, and its n_best
    (and n_last for ONT) equal those gathered from _dp_level's carry."""
    dws = halves_windows
    rt_id = tdd.READ_TYPE_ID[rt]
    b = tdd.pack_batch(dws)
    inter = tls.level_chain_plain(b, rt_id, tdd.COV_COEF[rt]).numpy()
    assert inter.shape == (tls.inter_rows(rt_id), b.ent_A.numel())
    lo = 0
    for dw, (ref, _, _) in zip(dws, _jax_halves(dws, rt)):
        n = len(dw.ent_A)
        got = inter[:, lo:lo + n]
        lo += n
        assert np.array_equal(got, ref[:len(got)])


@pytest.mark.parametrize("rt", RTS)
def test_winners_half_matches_jax(halves_windows, rt):
    """level_winners_plain, fed the JAX package's per-entry results,
    gives _dp_level's winners and winning scores at every level."""
    dws = halves_windows
    rt_id = tdd.READ_TYPE_ID[rt]
    ref = _jax_halves(dws, rt)
    inter = np.concatenate([r[0][:tls.inter_rows(rt_id)] for r in ref],
                           axis=1)
    b = tdd.pack_batch(dws)
    best, sc = tls.level_winners_plain(b, torch.from_numpy(inter), rt_id)
    for dw, row, (_, rb, rs) in zip(dws, b.win_host, ref):
        lb, n = int(row[0]), int(row[1])
        assert np.array_equal(best[lb:lb + n].numpy(), rb)
        assert np.array_equal(sc[lb:lb + n].numpy(), rs)


def test_pack_batch_checks_the_stream(halves_windows):
    """pack_batch refuses what the kernels do not take: entries out of
    (cell, slot) order, a match bit at or past E, a pred row past the
    window's carry, a ring slot past Vb."""
    dw = halves_windows[-2]
    tdd.pack_batch([dw])
    lvl0 = int(np.sum(dw.ent_lvl == 0))
    assert lvl0 > 1
    swap = np.arange(len(dw.ent_A))
    swap[[0, 1]] = [1, 0]
    bad = [
        dataclasses.replace(dw, ent_b=dw.ent_b[swap],
                            ent_slot=dw.ent_slot[swap]),
        dataclasses.replace(dw, ent_M=dw.ent_M | np.int32(1 << dw.E)),
        dataclasses.replace(dw, ent_A=dw.ent_A | np.int32(0xFF << 8)),
        dataclasses.replace(dw, meta=dw.meta | np.int32(0x3F << 2)),
    ]
    for x in bad:
        with pytest.raises(ValueError):
            tdd.pack_batch([x])
