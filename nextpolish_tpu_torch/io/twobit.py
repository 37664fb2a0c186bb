"""2-bit sequence codec — vectorized numpy equivalent of lib/bseq.c.

The reference packs 16 bases per uint32 with a 65536-entry decode LUT
(lib/bseq.c:22-33, seq2bit1/bit2seq1 at :87-124, subbit at :170).  Here the
codec is a numpy bit-twiddle: A=0 C=1 G=2 T=3 packed 4 bases/byte; N and
other ambiguity codes collapse to A on pack (same lossy behavior as the
reference, which maps non-ACGT via its 0..3 table).
"""
from __future__ import annotations

import numpy as np

_CODE = np.zeros(256, dtype=np.uint8)  # default 0 = A (reference parity)
for i, c in enumerate(b"ACGT"):
    _CODE[c] = i
    _CODE[c + 32] = i
_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G in 2-bit space


def pack(seq: bytes | np.ndarray) -> tuple[np.ndarray, int]:
    """Pack ASCII sequence into 2-bit codes, 4 bases per byte (big-end first).

    Returns (packed uint8 array, length in bases).
    """
    a = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    codes = _CODE[a]
    n = codes.size
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 4)
    packed = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
    return packed.astype(np.uint8), n


def unpack(packed: np.ndarray, n: int, start: int = 0, end: int | None = None,
           rc: bool = False) -> bytes:
    """Decode a [start, end) slice back to ASCII, optional reverse complement
    (behavior of lib/bseq.c subbit :170)."""
    if end is None:
        end = n
    end = min(end, n)
    if start >= end:
        return b""
    codes = unpack_codes(packed, n, start, end)
    if rc:
        codes = _COMP[codes[::-1]]
    return _DECODE[codes].tobytes()


def unpack_codes(packed: np.ndarray, n: int, start: int = 0,
                 end: int | None = None) -> np.ndarray:
    """Decode to 2-bit code array (0..3)."""
    if end is None:
        end = n
    end = min(end, n)
    b0 = start // 4
    b1 = (end + 3) // 4
    chunk = packed[b0:b1]
    expanded = np.empty(chunk.size * 4, dtype=np.uint8)
    expanded[0::4] = (chunk >> 6) & 3
    expanded[1::4] = (chunk >> 4) & 3
    expanded[2::4] = (chunk >> 2) & 3
    expanded[3::4] = chunk & 3
    off = start - b0 * 4
    return expanded[off : off + (end - start)]


class TwoBitGenome:
    """A genome held as packed 2-bit arrays keyed by contig name
    (role of refs_ in lib/ctg_cns.c:2269-2288)."""

    def __init__(self):
        self._packed: dict[str, tuple[np.ndarray, int]] = {}
        self._order: list[str] = []

    @classmethod
    def from_fasta(cls, path: str, names=None):
        from .fasta import read_fastx

        g = cls()
        keep = set(names) if names is not None else None
        for rec in read_fastx(path):
            if keep is not None and rec.name not in keep:
                continue
            g.add(rec.name, rec.seq)
        return g

    def add(self, name: str, seq: bytes):
        self._packed[name] = pack(seq)
        self._order.append(name)

    @property
    def names(self):
        return list(self._order)

    def length(self, name: str) -> int:
        return self._packed[name][1]

    def fetch(self, name: str, start: int = 0, end: int | None = None,
              rc: bool = False) -> bytes:
        packed, n = self._packed[name]
        return unpack(packed, n, start, end, rc)

    def fetch_codes(self, name: str, start: int = 0, end: int | None = None
                    ) -> np.ndarray:
        packed, n = self._packed[name]
        return unpack_codes(packed, n, start, end)

    def nbytes(self) -> int:
        return sum(p.nbytes for p, _ in self._packed.values())
