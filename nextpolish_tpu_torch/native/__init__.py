"""ctypes loader for the native host substrate (libnpt.so).

Builds on demand with `make`; every entry point has a pure-Python fallback
(io/, ops/pileup.py), so `available()` gating is enough.  The library is
built into the package's `_build/` directory (not tracked by git) under a
name that hashes its sources, its Makefile (hence its flags) and the host
CPU's identity: an edited source, or a checkout carried to a machine with
another CPU (the Makefile builds with -march=native), builds a new library
instead of loading a stale or foreign one.  A file lock keeps concurrent
processes from building it twice.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import re
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_MAKEFILE = os.path.join(_DIR, "Makefile")
_LIB = None
_TRIED = False
# threads that ask for the library while the first caller loads it wait
# for that load, and do not read the half-done state as "no library"
_LOAD_LOCK = threading.Lock()


def _makefile_sources() -> list:
    """The Makefile's SRCS, as absolute paths."""
    text = open(_MAKEFILE).read().replace("\\\n", " ")
    m = re.search(r"^SRCS\s*=(.*)$", text, re.M)
    return [os.path.join(_DIR, s) for s in m.group(1).split()]


# the sources the Makefile builds the library from (the hash reads these)
SOURCES = _makefile_sources()


def cpu_identity() -> str:
    """The host CPU's model name and feature flags (/proc/cpuinfo), or the
    platform's processor string where that file does not exist."""
    try:
        lines = open("/proc/cpuinfo").read().splitlines()
    except OSError:
        return platform.machine() + " " + platform.processor()
    keep = []
    for key in ("model name", "flags", "Features", "CPU part"):
        hit = next((ln for ln in lines if ln.split(":")[0].strip() == key),
                   None)
        if hit is not None:
            keep.append(hit)
    return "\n".join(keep) or platform.machine()


def library_path() -> str:
    """Where the library for this source content, Makefile and CPU lives."""
    h = hashlib.sha1()
    for src in [*SOURCES, _MAKEFILE]:
        h.update(os.path.basename(src).encode() + b"\0")
        h.update(open(src, "rb").read())
    h.update(cpu_identity().encode())
    return os.path.join(_BUILD, f"libnpt.{h.hexdigest()[:12]}.so")


def build() -> str:
    """Build the library (if this content has none yet) under a lock;
    returns its path.  Raises if the build fails."""
    so = library_path()
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "libnpt.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(so):
            subprocess.run(["make", "-C", _DIR, f"OUT={so}"], check=True,
                           capture_output=True, timeout=300)
    return so


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if not _TRIED:
            _LIB = _open()
            _TRIED = True
    return _LIB


def _open():
    """Build and open the library, with its entry points typed; None
    where it cannot be built or opened."""
    try:
        so = build()
    except Exception:
        return None
    try:
        lib = ctypes.CDLL(so)
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
    if hasattr(lib, "npt_pileup_sgs"):
        lib.npt_pileup_sgs.restype = ctypes.c_longlong
    if hasattr(lib, "npt_pileup_planes"):
        lib.npt_pileup_planes.restype = ctypes.c_longlong
    if hasattr(lib, "npt_cns_prepare"):
        lib.npt_cns_prepare.restype = ctypes.POINTER(_NptCnsPrep)
        lib.npt_cns_prep_free.restype = None
    if hasattr(lib, "npt_cns_tags"):
        lib.npt_cns_tags.restype = ctypes.c_longlong
    return lib


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


# --- task-1 pileup walker (pileup.cpp); bindings copied from
# nextpolish_tpu/native/__init__.py ---

# dense count-table budget for the native pileup path (bytes); beyond this
# the caller falls back to the numpy event-expansion path
PILEUP_DENSE_BYTES = int(os.environ.get("NPT_PILEUP_DENSE_BYTES",
                                        8 << 30))

# persistent all-zero count tables (grow-only), checked out under a lock:
# the task-1 pipeline preps two contigs concurrently, and per-thread
# storage would die with each pipeline's thread pool (re-faulting ~100 MB
# per run)
_PILEUP_POOL: list = []
_PILEUP_LOCK = threading.Lock()


def pileup_sgs(ridx, rpos, cigar, cigar_off, cigar_len, seq_nib, seq_off,
               lqseq, start: int, end: int, cell_of, ins_len, n_cells: int,
               n_dp: int, refkmer, trim_len_edge: int,
               max_span: int = 1 << 40, n_threads: int = 0):
    """Single-pass native pileup (pileup.cpp), multithreaded over cell
    ranges.  `max_span` bounds any read's reference span (tightens the
    per-thread read subranges; the default disables the bound).  Returns
    sorted sparse (uk int64, cn int64, rk uint16 first-observation ranks,
    totals int32) or None when unavailable / too big."""
    lib = _load()
    if lib is None or not hasattr(lib, "npt_pileup_sgs"):
        return None
    if n_cells * 1024 > PILEUP_DENSE_BYTES:
        return None

    def c64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    ridx = c64(ridx)
    cell_of = c64(cell_of)
    ins_len = c64(ins_len)
    rpos = np.ascontiguousarray(rpos, dtype=np.int32)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    cigar_off = c64(cigar_off)
    cigar_len = np.ascontiguousarray(cigar_len, dtype=np.int32)
    seq_nib = np.ascontiguousarray(seq_nib, dtype=np.uint8)
    seq_off = c64(seq_off)
    lqseq = np.ascontiguousarray(lqseq, dtype=np.int32)
    if refkmer is not None:
        refkmer = np.ascontiguousarray(refkmer, dtype=np.int32)
    with _PILEUP_LOCK:
        scratch = _PILEUP_POOL.pop() if _PILEUP_POOL else None
    if scratch is None or len(scratch) < n_cells * 512:
        scratch = np.zeros(n_cells * 512, dtype=np.uint16)
    counts = scratch
    totals = np.zeros(n_cells, dtype=np.int32)
    out_uk = ctypes.POINTER(ctypes.c_int64)()
    out_cn = ctypes.POINTER(ctypes.c_int64)()
    out_rk = ctypes.POINTER(ctypes.c_int64)()

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    nnz = lib.npt_pileup_sgs(
        p(ridx), ctypes.c_longlong(len(ridx)), p(rpos), p(cigar),
        p(cigar_off), p(cigar_len), p(seq_nib), p(seq_off), p(lqseq),
        ctypes.c_longlong(start), ctypes.c_longlong(end), p(cell_of),
        p(ins_len), ctypes.c_longlong(n_cells), ctypes.c_longlong(n_dp),
        p(refkmer) if refkmer is not None else None,
        ctypes.c_int(trim_len_edge), ctypes.c_longlong(max_span),
        ctypes.c_int(n_threads), p(counts), p(totals),
        ctypes.byref(out_uk), ctypes.byref(out_cn), ctypes.byref(out_rk),
    )
    if nnz < 0:
        return None
    try:
        uk = np.ctypeslib.as_array(out_uk, shape=(nnz,)).copy() if nnz else \
            np.empty(0, np.int64)
        cn = np.ctypeslib.as_array(out_cn, shape=(nnz,)).copy() if nnz else \
            np.empty(0, np.int64)
        rk = np.ctypeslib.as_array(out_rk, shape=(nnz,)).copy() if nnz else \
            np.empty(0, np.int64)
    finally:
        for ptr in (out_uk, out_cn, out_rk):
            if ptr:
                lib.npt_cns_free(ptr)
        with _PILEUP_LOCK:
            _PILEUP_POOL.append(counts)
    return uk, cn, rk.astype(np.uint16), totals


_SLOT_POOL: list = []


def pileup_planes(ridx, rpos, cigar, cigar_off, cigar_len, seq_nib, seq_off,
                  lqseq, start: int, end: int, cell_of, ins_len,
                  n_cells: int, n_dp: int, refkmer, trim_len_edge: int,
                  max_span: int = 1 << 40, n_threads: int = 0):
    """Slot-walker pileup emitting the chain-DP plane format directly
    (pileup.cpp npt_pileup_planes): per-cell 8-slot cache lines instead
    of the dense [cells*512] table, slot index == insertion rank, no
    dirty-list sort.  Returns (upper [7, n_dp] u16 planes, c0 [n_dp] u8,
    totals [n_cells] i32, stats [16] i32, (ov_key, ov_cn, ov_rk)) or
    None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "npt_pileup_planes"):
        return None

    def c64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    ridx = c64(ridx)
    cell_of = c64(cell_of)
    ins_len = c64(ins_len)
    rpos = np.ascontiguousarray(rpos, dtype=np.int32)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    cigar_off = c64(cigar_off)
    cigar_len = np.ascontiguousarray(cigar_len, dtype=np.int32)
    seq_nib = np.ascontiguousarray(seq_nib, dtype=np.uint8)
    seq_off = c64(seq_off)
    lqseq = np.ascontiguousarray(lqseq, dtype=np.int32)
    refkmer = np.ascontiguousarray(refkmer, dtype=np.int32)
    with _PILEUP_LOCK:
        slots = _SLOT_POOL.pop() if _SLOT_POOL else None
    if slots is None or len(slots) < n_cells * 8:
        slots = np.zeros(n_cells * 8, dtype=np.uint32)
    totals = np.zeros(n_cells, dtype=np.int32)
    upper = np.zeros(7 * n_dp, dtype=np.uint16)
    c0 = np.zeros(n_dp, dtype=np.uint8)
    stats = np.zeros(16, dtype=np.int32)
    out_k = ctypes.POINTER(ctypes.c_int64)()
    out_c = ctypes.POINTER(ctypes.c_int64)()
    out_r = ctypes.POINTER(ctypes.c_int64)()

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    nov = lib.npt_pileup_planes(
        p(ridx), ctypes.c_longlong(len(ridx)), p(rpos), p(cigar),
        p(cigar_off), p(cigar_len), p(seq_nib), p(seq_off), p(lqseq),
        ctypes.c_longlong(start), ctypes.c_longlong(end), p(cell_of),
        p(ins_len), ctypes.c_longlong(n_cells), ctypes.c_longlong(n_dp),
        p(refkmer), ctypes.c_int(trim_len_edge),
        ctypes.c_longlong(max_span), ctypes.c_int(n_threads), p(slots),
        p(totals), p(upper), p(c0), p(stats),
        ctypes.byref(out_k), ctypes.byref(out_c), ctypes.byref(out_r),
    )
    if nov < 0:
        with _PILEUP_LOCK:
            _SLOT_POOL.append(slots)
        return None
    try:
        ovk = np.ctypeslib.as_array(out_k, shape=(nov,)).copy() if nov \
            else np.empty(0, np.int64)
        ovc = np.ctypeslib.as_array(out_c, shape=(nov,)).copy() if nov \
            else np.empty(0, np.int64)
        ovr = np.ctypeslib.as_array(out_r, shape=(nov,)).copy() if nov \
            else np.empty(0, np.int64)
    finally:
        for ptr in (out_k, out_c, out_r):
            if ptr:
                lib.npt_cns_free(ptr)
        with _PILEUP_LOCK:
            _SLOT_POOL.append(slots)
    return upper.reshape(7, n_dp), c0, totals, stats, (ovk, ovc, ovr)


def cell_index(ridx, rpos, cigar, cigar_off, cigar_len, start: int,
               end: int):
    """Native insertion-slot discovery (pileup.cpp npt_cell_index).
    Returns ins_len int64[end-start+1] or None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "npt_cell_index"):
        return None
    ridx = np.ascontiguousarray(ridx, dtype=np.int64)
    rpos = np.ascontiguousarray(rpos, dtype=np.int32)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    cigar_off = np.ascontiguousarray(cigar_off, dtype=np.int64)
    cigar_len = np.ascontiguousarray(cigar_len, dtype=np.int32)
    ins_len = np.zeros(end - start + 1, dtype=np.int64)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.npt_cell_index(p(ridx), ctypes.c_longlong(len(ridx)), p(rpos),
                       p(cigar), p(cigar_off), p(cigar_len),
                       ctypes.c_longlong(start), ctypes.c_longlong(end),
                       p(ins_len))
    return ins_len


def chain_dp(qp, rp, k: int, bw: int, max_dist: int, max_iter: int,
             max_skip: int, avg_qspan: float):
    """Native anchor-chaining DP (chain.cpp, mm_chain_dp semantics).
    Anchors must be sorted by (rp, qp).  Returns (f int32 scores,
    p int32 predecessors) or None when the native lib is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "npt_chain_dp"):
        return None
    qp = np.ascontiguousarray(qp, dtype=np.int64)
    rp = np.ascontiguousarray(rp, dtype=np.int64)
    n = len(qp)
    f = np.zeros(n, dtype=np.int32)
    p = np.zeros(n, dtype=np.int32)
    lib.npt_chain_dp(
        qp.ctypes.data_as(ctypes.c_void_p),
        rp.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_longlong(n), ctypes.c_int(k), ctypes.c_int(bw),
        ctypes.c_int(max_dist), ctypes.c_int(max_iter),
        ctypes.c_int(max_skip), ctypes.c_float(avg_qspan),
        f.ctypes.data_as(ctypes.c_void_p),
        p.ctypes.data_as(ctypes.c_void_p))
    return f, p
