"""(w, k)-minimizer computation, vectorized in numpy.

Minimizers are the standard seeding scheme of minimap2 (used here by both
the short-read and long-read mappers; the reference shells out to bwa mem /
minimap2 instead — util/bwa, util/minimap2).
"""
from __future__ import annotations

import numpy as np

# 2-bit codes; N and friends get 4 (invalid)
_CODE = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate(b"ACGT"):
    _CODE[c] = i
    _CODE[c + 32] = i


def seq_codes(seq: bytes | np.ndarray) -> np.ndarray:
    a = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return _CODE[a]


def _mix64(x: np.ndarray) -> np.ndarray:
    """Invertible 64-bit hash (splitmix64 finalizer) for minimizer ordering."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def kmer_hashes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer hashes at every position (len-k+1).

    Returns (hash, strand): strand 1 where the reverse complement was the
    canonical form.  Positions containing invalid bases hash to UINT64_MAX.
    """
    n = codes.size - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint8)
    c = codes.astype(np.uint64)
    valid = codes < 4
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    okay = np.ones(n, dtype=bool)
    for i in range(k):
        fwd = (fwd << np.uint64(2)) | c[i : i + n]
        rev |= ((np.uint64(3) - c[i : i + n])) << np.uint64(2 * i)
        okay &= valid[i : i + n]
    strand = (rev < fwd).astype(np.uint8)
    canon = np.minimum(fwd, rev)
    h = _mix64(canon)
    h[~okay] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return h, strand


def minimizers(seq: bytes | np.ndarray, k: int, w: int,
               chunk: int = 1 << 20) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(w,k)-minimizers of a sequence.

    Returns (hash u64, pos i64, strand u8) of window minima, deduplicated.
    """
    codes = seq_codes(seq) if not isinstance(seq, np.ndarray) or seq.dtype != np.uint8 \
        else seq
    if not isinstance(seq, np.ndarray):
        codes = seq_codes(seq)
    n = codes.size - k + 1
    if n < w:
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.uint8))
    out_h, out_p, out_s = [], [], []
    step = max(chunk, 4 * w)
    for lo in range(0, n, step):
        hi = min(lo + step + w - 1, n)
        h, s = kmer_hashes(codes[lo : hi + k - 1], k)
        if h.size < w:
            continue
        win = np.lib.stride_tricks.sliding_window_view(h, w)
        arg = win.argmin(axis=1)
        pos = np.arange(win.shape[0]) + arg
        keep = np.ones(pos.size, dtype=bool)
        keep[1:] = pos[1:] != pos[:-1]
        pos = pos[keep]
        hh = h[pos]
        ok = hh != np.uint64(0xFFFFFFFFFFFFFFFF)
        out_h.append(hh[ok])
        out_p.append(pos[ok] + lo)
        out_s.append(s[pos[ok]])
    if not out_h:
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.uint8))
    h = np.concatenate(out_h)
    p = np.concatenate(out_p).astype(np.int64)
    s = np.concatenate(out_s)
    # chunk seams can duplicate a minimizer
    keep = np.ones(p.size, dtype=bool)
    keep[1:] = p[1:] != p[:-1]
    return h[keep], p[keep], s[keep]
