"""ctypes loader for the native host substrate (libnpt.so).

Builds on demand with `make` if the shared object is missing; every entry
point has a pure-Python fallback in io/, so `available()` gating is enough.
The library is built into the package's `_build/` directory (not tracked
by git); a file lock keeps concurrent processes from building it twice.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD, "libnpt.so")
_LIB = None
_TRIED = False


def build() -> str:
    """Build libnpt.so (if missing) under a lock; returns its path."""
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "libnpt.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(_SO):
            subprocess.run(["make", "-C", _DIR, f"OUT={_SO}"], check=True,
                           capture_output=True, timeout=300)
    return _SO


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        build()
    except Exception:
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.npt_bgzf_size.restype = ctypes.c_longlong
    lib.npt_bgzf_size.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.npt_bgzf_decompress.restype = ctypes.c_int
    lib.npt_bgzf_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int,
    ]
    lib.npt_bam_count.restype = ctypes.c_int
    lib.npt_bam_fill.restype = ctypes.c_int
    if hasattr(lib, "npt_cns_dp"):
        lib.npt_cns_dp.restype = ctypes.c_longlong
        lib.npt_cns_free.restype = None
    if hasattr(lib, "npt_poa_consensus"):
        lib.npt_poa_consensus.restype = ctypes.c_longlong
    if hasattr(lib, "npt_cns_prepare"):
        lib.npt_cns_prepare.restype = ctypes.POINTER(_NptCnsPrep)
        lib.npt_cns_prep_free.restype = None
    if hasattr(lib, "npt_cns_tags"):
        lib.npt_cns_tags.restype = ctypes.c_longlong
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def bgzf_decompress(data: bytes, n_threads: int = 0) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    size = lib.npt_bgzf_size(data, len(data))
    if size < 0:
        return None
    out = np.empty(size, dtype=np.uint8)
    rc = lib.npt_bgzf_decompress(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), size,
        n_threads,
    )
    if rc != 0:
        return None
    return out.tobytes()


def bam_scan(data: bytes, off: int):
    """Parse BAM records starting at `off` into columnar numpy arrays.
    Returns a dict of arrays or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nr = ctypes.c_longlong()
    nc = ctypes.c_longlong()
    nb = ctypes.c_longlong()
    nt = ctypes.c_longlong()
    lib.npt_bam_count(data, len(data), off, ctypes.byref(nr),
                      ctypes.byref(nc), ctypes.byref(nb), ctypes.byref(nt))
    n = nr.value

    def arr(dtype, size):
        return np.zeros(size, dtype=dtype)

    cols = dict(
        tid=arr(np.int32, n), pos=arr(np.int32, n), mapq=arr(np.uint8, n),
        flag=arr(np.uint16, n), tlen=arr(np.int32, n),
        lqseq=arr(np.int32, n), mtid=arr(np.int32, n), mpos=arr(np.int32, n),
        cigar=arr(np.uint32, nc.value), cigar_off=arr(np.int64, n),
        cigar_len=arr(np.int32, n), seq=arr(np.uint8, nb.value),
        seq_off=arr(np.int64, n), qual=arr(np.uint8, nb.value),
        tags=arr(np.uint8, max(nt.value, 1)), tags_off=arr(np.int64, n),
        tags_len=arr(np.int32, n),
    )
    qnames = np.zeros(max(len(data) - off, 1), dtype=np.uint8)
    qused = ctypes.c_longlong()

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.npt_bam_fill(
        data, len(data), off,
        p(cols["tid"]), p(cols["pos"]), p(cols["mapq"]), p(cols["flag"]),
        p(cols["tlen"]), p(cols["lqseq"]), p(cols["mtid"]), p(cols["mpos"]),
        p(cols["cigar"]), p(cols["cigar_off"]), p(cols["cigar_len"]),
        p(cols["seq"]), p(cols["seq_off"]), p(cols["qual"]),
        p(cols["tags"]), p(cols["tags_off"]), p(cols["tags_len"]),
        p(qnames), len(qnames), ctypes.byref(qused),
    )
    if rc != 0:
        return None
    cols["tags"] = cols["tags"][: nt.value]
    cols["qnames"] = qnames[: qused.value].tobytes()
    cols["n"] = n
    return cols


READ_TYPE_CODE = {"ont": 0, "clr": 1, "rs": 2, "hifi": 3}


class _NptCnsPrep(ctypes.Structure):
    """Mirror of struct NptCnsPrep in cns_prep.cpp (field order matters)."""

    _fields_ = [
        ("n_entries", ctypes.c_int64),
        ("n_tags", ctypes.c_int64),
        ("cur", ctypes.POINTER(ctypes.c_int64)),
        ("pp", ctypes.POINTER(ctypes.c_int64)),
        ("ppp", ctypes.POINTER(ctypes.c_int64)),
        ("ins", ctypes.POINTER(ctypes.c_int64)),
        ("tag_key", ctypes.POINTER(ctypes.c_int64)),
        ("tag_off", ctypes.POINTER(ctypes.c_int64)),
        ("link", ctypes.POINTER(ctypes.c_int32)),
        ("dense_ok", ctypes.c_int32),
        ("E", ctypes.c_int32),
        ("Vb", ctypes.c_int32),
        ("n_levels", ctypes.c_int64),
        ("ent_lvl", ctypes.POINTER(ctypes.c_int64)),
        ("eorder", ctypes.POINTER(ctypes.c_int64)),
        ("ent_b", ctypes.POINTER(ctypes.c_int8)),
        ("ent_slot", ctypes.POINTER(ctypes.c_int8)),
        ("ent_same", ctypes.POINTER(ctypes.c_uint8)),
        ("ent_A", ctypes.POINTER(ctypes.c_int32)),
        ("ent_M", ctypes.POINTER(ctypes.c_int32)),
        ("meta", ctypes.POINTER(ctypes.c_int32)),
        ("level_pos", ctypes.POINTER(ctypes.c_int32)),
    ]


def cns_prepare(t_pos, delta, q_base, row_off, coverage, length: int,
                max_e: int, max_vb: int):
    """Native EdgeTable + DenseWindow preparation (cns_prep.cpp).  Returns
    (edge_dict, dense_dict | None) of numpy copies, or None when the native
    lib is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "npt_cns_prepare"):
        return None
    t_pos = np.ascontiguousarray(t_pos, dtype=np.int32)
    delta = np.ascontiguousarray(delta, dtype=np.int16)
    q_base = np.ascontiguousarray(q_base, dtype=np.uint8)
    row_off = np.ascontiguousarray(row_off, dtype=np.int64)
    coverage = np.ascontiguousarray(coverage, dtype=np.int32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    ptr = lib.npt_cns_prepare(
        p(t_pos), p(delta), p(q_base), p(row_off),
        ctypes.c_longlong(len(row_off) - 1), p(coverage),
        ctypes.c_longlong(length), ctypes.c_int(max_e), ctypes.c_int(max_vb))
    if not ptr:
        return None
    s = ptr.contents
    try:
        def arr(field, n, copy=True):
            a = np.ctypeslib.as_array(field, shape=(n,))
            return a.copy() if copy else a

        Et, Tn, Lt = s.n_entries, s.n_tags, s.n_levels
        edges = dict(
            cur=arr(s.cur, Et), pp=arr(s.pp, Et), ppp=arr(s.ppp, Et),
            ins=arr(s.ins, Et), link=arr(s.link, Et),
            tag_key=arr(s.tag_key, Tn), tag_off=arr(s.tag_off, Tn + 1))
        dense = None
        if s.dense_ok:
            dense = dict(
                ent_lvl=arr(s.ent_lvl, Et), eorder=arr(s.eorder, Et),
                ent_b=arr(s.ent_b, Et), ent_slot=arr(s.ent_slot, Et),
                ent_same=arr(s.ent_same, Et).astype(bool),
                ent_A=arr(s.ent_A, Et), ent_M=arr(s.ent_M, Et),
                meta=arr(s.meta, Lt), level_pos=arr(s.level_pos, Lt),
                n_levels=int(Lt), E=int(s.E), Vb=int(s.Vb))
    finally:
        lib.npt_cns_prep_free(ptr)
    return edges, dense


def cns_dp(t_pos, delta, q_base, row_off, coverage, length: int,
           read_type: str, min_cov: int, lq_min_qv: int):
    """Native per-window consensus DP (cns_dp.cpp); returns
    (pos[int32], base[uint8], qv[int32]) or None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "npt_cns_dp"):
        return None
    t_pos = np.ascontiguousarray(t_pos, dtype=np.int32)
    delta = np.ascontiguousarray(delta, dtype=np.int16)
    q_base = np.ascontiguousarray(q_base, dtype=np.uint8)
    row_off = np.ascontiguousarray(row_off, dtype=np.int64)
    coverage = np.ascontiguousarray(coverage, dtype=np.int32)
    out_pos = ctypes.POINTER(ctypes.c_int32)()
    out_base = ctypes.POINTER(ctypes.c_uint8)()
    out_qv = ctypes.POINTER(ctypes.c_int32)()
    n = lib.npt_cns_dp(
        t_pos.ctypes.data_as(ctypes.c_void_p),
        delta.ctypes.data_as(ctypes.c_void_p),
        q_base.ctypes.data_as(ctypes.c_void_p),
        row_off.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_longlong(len(row_off) - 1),
        coverage.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_longlong(length),
        READ_TYPE_CODE[read_type], min_cov, lq_min_qv,
        ctypes.byref(out_pos), ctypes.byref(out_base), ctypes.byref(out_qv),
    )
    if n < 0:
        return None
    try:
        pos = np.ctypeslib.as_array(out_pos, shape=(n,)).copy() if n else \
            np.empty(0, np.int32)
        base = np.ctypeslib.as_array(out_base, shape=(n,)).copy() if n else \
            np.empty(0, np.uint8)
        qv = np.ctypeslib.as_array(out_qv, shape=(n,)).copy() if n else \
            np.empty(0, np.int32)
    finally:
        for ptr in (out_pos, out_base, out_qv):
            if ptr:
                lib.npt_cns_free(ptr)
    return pos, base, qv


def cns_tags(sel, rpos, cigar, cigar_off, cigar_len, seq_nib, seq_off,
             lqseq, rd_s, rd_e, ref_cns_win, win_s: int, win_e: int,
             anchor_k: int = 8, min_span: int = 500, gap_min_len: int = 3):
    """Native per-window tag expansion (cns_tags.cpp): the selected reads'
    bam2aln + anchor trim + accumulation in one pass.  Returns a dict of
    row/track arrays or None when the native lib is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "npt_cns_tags"):
        return None
    L = win_e - win_s
    sel = np.ascontiguousarray(sel, dtype=np.int64)
    rpos = np.ascontiguousarray(rpos, dtype=np.int32)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    cigar_off = np.ascontiguousarray(cigar_off, dtype=np.int64)
    cigar_len = np.ascontiguousarray(cigar_len, dtype=np.int32)
    seq_nib = np.ascontiguousarray(seq_nib, dtype=np.uint8)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    lqseq = np.ascontiguousarray(lqseq, dtype=np.int32)
    rd_s = np.ascontiguousarray(rd_s, dtype=np.int32)
    rd_e = np.ascontiguousarray(rd_e, dtype=np.int32)
    ref_cns_win = np.ascontiguousarray(ref_cns_win, dtype=np.uint8)
    keep = np.zeros(max(len(sel), 1), dtype=np.uint8)
    q_s = np.zeros(max(len(sel), 1), dtype=np.int32)
    coverage = np.zeros(L + 1, dtype=np.int32)
    l_ins = np.zeros(L, dtype=np.int32)
    l_del = np.zeros(L, dtype=np.int32)
    max_delta = np.zeros(L, dtype=np.int32)
    out_t = ctypes.POINTER(ctypes.c_int32)()
    out_d = ctypes.POINTER(ctypes.c_int16)()
    out_q = ctypes.POINTER(ctypes.c_uint8)()
    out_roff = ctypes.POINTER(ctypes.c_int64)()
    out_as = ctypes.POINTER(ctypes.c_int32)()
    out_ae = ctypes.POINTER(ctypes.c_int32)()

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    n_rows = lib.npt_cns_tags(
        p(sel), ctypes.c_longlong(len(sel)), p(rpos), p(cigar), p(cigar_off),
        p(cigar_len), p(seq_nib), p(seq_off), p(lqseq), p(rd_s), p(rd_e),
        p(ref_cns_win), ctypes.c_longlong(win_s), ctypes.c_longlong(win_e),
        ctypes.c_int(anchor_k), ctypes.c_int(min_span),
        ctypes.c_int(gap_min_len), p(keep), p(q_s), p(coverage), p(l_ins),
        p(l_del), p(max_delta), ctypes.byref(out_t), ctypes.byref(out_d),
        ctypes.byref(out_q), ctypes.byref(out_roff), ctypes.byref(out_as),
        ctypes.byref(out_ae))
    if n_rows < 0:
        return None
    try:
        roff = np.ctypeslib.as_array(out_roff, shape=(n_rows + 1,)).copy()
        T = int(roff[-1])
        t = np.ctypeslib.as_array(out_t, shape=(T,)).copy() if T else \
            np.empty(0, np.int32)
        d = np.ctypeslib.as_array(out_d, shape=(T,)).copy() if T else \
            np.empty(0, np.int16)
        q = np.ctypeslib.as_array(out_q, shape=(T,)).copy() if T else \
            np.empty(0, np.uint8)
        aln_s = (np.ctypeslib.as_array(out_as, shape=(n_rows,)).copy()
                 if n_rows else np.empty(0, np.int32))
        aln_e = (np.ctypeslib.as_array(out_ae, shape=(n_rows,)).copy()
                 if n_rows else np.empty(0, np.int32))
    finally:
        for ptr in (out_t, out_d, out_q, out_roff, out_as, out_ae):
            if ptr:
                lib.npt_cns_free(ptr)
    return dict(t_pos=t, delta=d, q_base=q, row_off=roff, aln_s=aln_s,
                aln_e=aln_e, keep=keep[: len(sel)].astype(bool),
                q_s=q_s[: len(sel)], coverage=coverage, l_ins=l_ins,
                l_del=l_del, max_delta=max_delta)


def poa_consensus(seqs):
    """Native POA (poa.cpp); returns consensus bytes or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "npt_poa_consensus"):
        return None
    blob = b"".join(seqs)
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.npt_poa_consensus(blob, offs.ctypes.data_as(ctypes.c_void_p),
                              ctypes.c_longlong(len(seqs)),
                              ctypes.byref(out))
    if n < 0:
        return None
    try:
        return ctypes.string_at(out, n)
    finally:
        if out:
            lib.npt_cns_free(out)
