"""The benchmark's own BAM writer: BGZF blocks, BAM records and a BAI
index, written from the SAM/BAM specification.

A frozen copy of the port's writer (nextpolish_tpu_torch/io/bam.py
`write_bam` and `_encode_records`, io/bgzf.py `BgzfWriter`, io/bai.py
`write_bai`, as of commit 6e13449), so that the inputs the benchmark
generates do not move when a later change edits the port's I/O layer.
Nothing here imports the port.
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = \
    range(9)
CONSUMES_R = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.uint8)

NIB_CHARS = b"=ACMGRSVTWYHKDBN"
ASCII_TO_NIB = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(NIB_CHARS):
    ASCII_TO_NIB[_c] = _i
    ASCII_TO_NIB[_c + 32] = _i

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


@dataclass
class BamHeader:
    text: str = ""
    names: list = field(default_factory=list)
    lengths: list = field(default_factory=list)


def seq_to_nib(seq: bytes) -> np.ndarray:
    return ASCII_TO_NIB[np.frombuffer(seq, dtype=np.uint8)]


def compress_block(chunk: bytes, level: int = 6) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = comp.compress(chunk) + comp.flush()
    bsize = len(cdata) + 25 + 1  # 12 hdr + 6 extra + 8 trailer
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    trailer = struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
    return header + cdata + trailer


class BgzfWriter:
    """Streaming BGZF writer with 64KB blocks."""

    BLOCK = 0xFF00  # htslib-compatible uncompressed block payload size

    def __init__(self, path_or_handle, level: int = 6):
        if isinstance(path_or_handle, str):
            self._fh = open(path_or_handle, "wb")
            self._own = True
        else:
            self._fh = path_or_handle
            self._own = False
        self._buf = bytearray()
        self._level = level
        self._coffset = 0  # compressed bytes written so far
        # compressed offset of each block's start, the unflushed one last
        self.block_offsets = [0]

    def tell_virtual(self) -> int:
        """BGZF virtual offset (coffset << 16 | within-block offset) of the
        next byte to be written."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes):
        """Append data; every full BLOCK bytes of the stream become one
        block (compressed on several threads when many are full)."""
        self._buf += data
        n = len(self._buf) // self.BLOCK
        if not n:
            return
        chunks = [bytes(self._buf[i * self.BLOCK:(i + 1) * self.BLOCK])
                  for i in range(n)]
        del self._buf[: n * self.BLOCK]
        if n >= 16:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
                blks = list(pool.map(compress_block, chunks,
                                     [self._level] * n))
        else:
            blks = [compress_block(c, self._level) for c in chunks]
        for blk in blks:
            self._fh.write(blk)
            self._coffset += len(blk)
            self.block_offsets.append(self._coffset)

    def close(self):
        if self._buf:
            blk = compress_block(bytes(self._buf), self._level)
            self._fh.write(blk)
            self._coffset += len(blk)
            self.block_offsets.append(self._coffset)
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def write_bai(path: str, n_ref: int, records):
    """records: iterable of (tid, pos, ref_end, voff_start, voff_end),
    sorted by (tid, pos).  voff_* are BGZF virtual offsets."""
    per_ref_bins = [dict() for _ in range(n_ref)]
    per_ref_lin = [dict() for _ in range(n_ref)]
    for tid, pos, rend, vs, ve in records:
        if tid < 0:
            continue
        b = reg2bin(pos, max(rend, pos + 1))
        chunks = per_ref_bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == vs:
            chunks[-1][1] = ve
        else:
            chunks.append([vs, ve])
        for w in range(pos >> 14, ((max(rend - 1, pos)) >> 14) + 1):
            lin = per_ref_lin[tid]
            if w not in lin or vs < lin[w]:
                lin[w] = vs
    with open(path, "wb") as fh:
        fh.write(b"BAI\x01" + struct.pack("<i", n_ref))
        for r in range(n_ref):
            bins = per_ref_bins[r]
            fh.write(struct.pack("<i", len(bins)))
            for b, chunks in sorted(bins.items()):
                fh.write(struct.pack("<Ii", b, len(chunks)))
                for vs, ve in chunks:
                    fh.write(struct.pack("<QQ", vs, ve))
            lin = per_ref_lin[r]
            n_intv = (max(lin) + 1) if lin else 0
            fh.write(struct.pack("<i", n_intv))
            filled = 0
            for w in range(n_intv):
                if w in lin:
                    filled = lin[w]
                fh.write(struct.pack("<Q", filled))


def write_bam(path: str, header: BamHeader, records, index: bool = False
              ) -> None:
    """Write records to a BAM file.  Each record is a dict with keys:
    name, flag, tid, pos, mapq, cigar (uint32 array), seq_nib (uint8 array),
    qual (uint8 array), mtid, mpos, tlen, tags (raw bytes, optional).

    With index=True also writes `path + ".bai"` (records must be sorted by
    (tid, pos)).  Records are encoded _ENCODE_BATCH at a time by numpy
    (_encode_records), and the stream is cut into the same BGZF blocks as
    a record-at-a-time writer cuts it, so the bytes do not depend on the
    batching."""
    records = records if isinstance(records, list) else list(records)
    text = header.text.encode()
    buf = bytearray()
    buf += b"BAM\x01" + struct.pack("<i", len(text)) + text
    buf += struct.pack("<i", len(header.names))
    for nm, ln in zip(header.names, header.lengths):
        nb = nm.encode() + b"\x00"
        buf += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    ustart, ends, tids, poss = [], [], [], []
    with BgzfWriter(path) as out:
        out.write(bytes(buf))
        upos = len(buf)
        for lo in range(0, len(records), _ENCODE_BATCH):
            batch = records[lo:lo + _ENCODE_BATCH]
            data, rec_len, pos, span = _encode_records(batch)
            if index:
                ustart.append(upos + np.cumsum(rec_len) - rec_len)
                ends.append(pos + np.maximum(span, 1))
                tids.append(np.array([r["tid"] for r in batch], np.int64))
                poss.append(pos)
            out.write(data)
            upos += len(data)
        blocks = np.asarray(out.block_offsets, dtype=np.int64)
    if index:
        us = np.concatenate(ustart) if ustart else np.zeros(0, np.int64)
        ue = us + np.diff(np.append(us, upos))

        def voff(u):
            return (blocks[u // BgzfWriter.BLOCK] << 16) | (
                u % BgzfWriter.BLOCK)

        cat = (lambda xs: np.concatenate(xs).tolist() if xs else [])
        write_bai(path + ".bai", len(header.names),
                  zip(cat(tids), cat(poss), cat(ends), voff(us).tolist(),
                      voff(ue).tolist()))


_ENCODE_BATCH = 32768
# the fixed part of a BAM record: block_size, then "<iiBBHHHiiii"
_FIXED = np.dtype([("block_size", "<u4"), ("tid", "<i4"), ("pos", "<i4"),
                   ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                   ("mtid", "<i4"), ("mpos", "<i4"), ("tlen", "<i4")])


def _place(out: np.ndarray, dst: np.ndarray, lens: np.ndarray,
           src: np.ndarray) -> None:
    """out[dst[i] : dst[i] + lens[i]] = record i's piece of src (the
    pieces of all records back to back, in order)."""
    if len(src):
        out[np.repeat(dst - (np.cumsum(lens) - lens), lens)
            + np.arange(len(src))] = src


def _encode_records(recs: list):
    """BAM records, back to back, as bytes, with each record's length, pos
    and reference span (1 for a record without a CIGAR)."""
    n = len(recs)
    names = [r["name"].encode() + b"\x00" for r in recs]
    cigars = [np.asarray(r["cigar"], dtype=np.uint32) for r in recs]
    seqs = [np.asarray(r["seq_nib"], dtype=np.uint8) for r in recs]
    l_name = np.fromiter(map(len, names), np.int64, n)
    n_cig = np.fromiter(map(len, cigars), np.int64, n)
    l_seq = np.fromiter(map(len, seqs), np.int64, n)
    if any("qual" in r for r in recs):
        quals = [np.asarray(r["qual"], dtype=np.uint8) if "qual" in r
                 else np.full(ls, 0xFF, np.uint8)
                 for r, ls in zip(recs, l_seq)]
        l_qual = np.fromiter(map(len, quals), np.int64, n)
        qual = np.concatenate(quals) if l_qual.sum() else np.zeros(0, np.uint8)
    else:  # 0xFF for every base, as the spec marks absent qualities
        l_qual = l_seq
        qual = np.full(int(l_seq.sum()), 0xFF, np.uint8)
    tags = [r.get("tags", b"") for r in recs]
    tags = [t if isinstance(t, bytes) else bytes(t) for t in tags]
    l_tag = np.fromiter(map(len, tags), np.int64, n)
    cig = np.concatenate(cigars) if n_cig.sum() else np.zeros(0, np.uint32)
    seq = np.concatenate(seqs) if l_seq.sum() else np.zeros(0, np.uint8)
    # reference span: the CIGAR's reference-consuming lengths
    ref = ((cig >> 4) * CONSUMES_R[cig & 0xF]).astype(np.int64)
    span = np.ones(n, np.int64)
    has = n_cig > 0
    if has.any():
        span[has] = np.add.reduceat(ref, (np.cumsum(n_cig) - n_cig)[has])
    pos = np.array([r["pos"] for r in recs], np.int64)
    # the sequence, two bases a byte (each record padded to even length)
    l_pack = (l_seq + 1) // 2
    padded = np.zeros(2 * int(l_pack.sum()), np.uint8)
    _place(padded, 2 * (np.cumsum(l_pack) - l_pack), l_seq, seq)
    packed = (padded[0::2] << 4) | padded[1::2]
    rec_len = 36 + l_name + 4 * n_cig + l_pack + l_qual + l_tag
    start = np.cumsum(rec_len) - rec_len
    cols = {"block_size": rec_len - 4,
            "tid": [r["tid"] for r in recs],
            "pos": pos,
            "l_read_name": l_name,
            "mapq": [r.get("mapq", 0) for r in recs],
            "bin": _reg2bin(pos, pos + np.maximum(span, 1)),
            "n_cigar": n_cig,
            "flag": [r.get("flag", 0) for r in recs],
            "l_seq": l_seq,
            "mtid": [r.get("mtid", -1) for r in recs],
            "mpos": [r.get("mpos", -1) for r in recs],
            "tlen": [r.get("tlen", 0) for r in recs]}
    fixed = np.zeros(n, _FIXED)
    for field, values in cols.items():
        fixed[field] = _in_range(field, values)
    out = np.empty(int(rec_len.sum()), np.uint8)
    at = start
    for lens, part in (
            (np.full(n, 36), fixed.view(np.uint8)),
            (l_name, np.frombuffer(b"".join(names), np.uint8)),
            (4 * n_cig, cig.view(np.uint8)),
            (l_pack, packed),
            (l_qual, qual),
            (l_tag, np.frombuffer(b"".join(tags), np.uint8))):
        _place(out, at, lens, part)
        at = at + lens
    return out.tobytes(), rec_len, pos, span


def _in_range(field: str, values) -> np.ndarray:
    """values as int64, or struct.error where the per-record writer's
    struct.pack of the fixed fields would raise it: a value that does not
    fit the field's type (a read name past 254 characters, more than
    65,535 CIGAR ops, a mapq, flag or bin out of range, an int32 field
    past its range) is refused, never wrapped."""
    v = np.asarray(values, dtype=np.int64)
    info = np.iinfo(_FIXED[field])
    bad = (v < info.min) | (v > info.max)
    if bad.any():
        raise struct.error(f"BAM record field {field} = {v[bad][0]} is "
                           f"outside {info.min}..{info.max}")
    return v


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM spec's reg2bin of each [beg, end)."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift in (14, 17, 20, 23, 26):
        m = ~done & ((beg >> shift) == (end >> shift))
        out[m] = ((1 << (29 - shift)) - 1) // 7 + (beg[m] >> shift)
        done |= m
    return out


