"""BAM container parsing/writing into struct-of-arrays batches.

Written from the SAM/BAM specification.  Fills the role of the reference's
htslib BAM record layer (bam_read1/sam_itr_next) but decodes straight into
numpy columns so the CIGAR-expansion and pileup stages can run vectorized.

Alignment batches (`AlnBatch`) are the framework's native alignment exchange
format: the built-in aligner produces them directly, and BAM files import
into them for bring-your-own-BAM workflows (doc/TUTORIAL.rst:50-82 parity).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import BgzfWriter, read_bgzf

# BAM flag bits (SAM spec)
FPAIRED = 0x1
FPROPER = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

# CIGAR ops
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
CIGAR_CHARS = "MIDNSHP=X"
_CIGAR_CODE = {c: i for i, c in enumerate(CIGAR_CHARS)}

# consumes query / consumes reference tables
CONSUMES_Q = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.uint8)
CONSUMES_R = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.uint8)

NIB_CHARS = b"=ACMGRSVTWYHKDBN"
_ASCII_TO_NIB = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(NIB_CHARS):
    _ASCII_TO_NIB[_c] = _i
    _ASCII_TO_NIB[_c + 32] = _i


@dataclass
class BamHeader:
    text: str = ""
    names: list = field(default_factory=list)
    lengths: list = field(default_factory=list)

    def name2id(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            return -1


@dataclass
class AlnBatch:
    """Struct-of-arrays batch of N alignment records.

    Variable-length fields are flat arrays indexed by (off, len) columns.
    seq is stored unpacked as 4-bit nibble codes (uint8 per base).
    """

    header: BamHeader
    tid: np.ndarray  # int32 [N]
    pos: np.ndarray  # int32 [N] 0-based leftmost
    mapq: np.ndarray  # uint8 [N]
    flag: np.ndarray  # uint16 [N]
    tlen: np.ndarray  # int32 [N] (isize)
    lqseq: np.ndarray  # int32 [N]
    cigar: np.ndarray  # uint32 flat (len<<4 | op)
    cigar_off: np.ndarray  # int64 [N]
    cigar_len: np.ndarray  # int32 [N]
    seq: np.ndarray  # uint8 flat nibbles
    seq_off: np.ndarray  # int64 [N]
    qual: np.ndarray  # uint8 flat
    qual_off: np.ndarray  # int64 [N]
    names: list | None = None  # optional python list of str
    tags: np.ndarray | None = None  # uint8 flat raw tag bytes
    tags_off: np.ndarray | None = None
    tags_len: np.ndarray | None = None
    mtid: np.ndarray | None = None
    mpos: np.ndarray | None = None

    def __len__(self):
        return len(self.pos)

    def rec_cigar(self, i: int) -> np.ndarray:
        o, l = self.cigar_off[i], self.cigar_len[i]
        return self.cigar[o : o + l]

    def rec_seq_nib(self, i: int) -> np.ndarray:
        o, l = self.seq_off[i], self.lqseq[i]
        return self.seq[o : o + l]

    def rec_qual(self, i: int) -> np.ndarray:
        o, l = self.qual_off[i], self.lqseq[i]
        return self.qual[o : o + l]

    def rec_tags(self, i: int) -> bytes:
        if self.tags is None:
            return b""
        o, l = self.tags_off[i], self.tags_len[i]
        return self.tags[o : o + l].tobytes()

    def select(self, mask_or_idx) -> "AlnBatch":
        idx = np.asarray(mask_or_idx)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        return AlnBatch(
            header=self.header,
            tid=self.tid[idx],
            pos=self.pos[idx],
            mapq=self.mapq[idx],
            flag=self.flag[idx],
            tlen=self.tlen[idx],
            lqseq=self.lqseq[idx],
            cigar=self.cigar,
            cigar_off=self.cigar_off[idx],
            cigar_len=self.cigar_len[idx],
            seq=self.seq,
            seq_off=self.seq_off[idx],
            qual=self.qual,
            qual_off=self.qual_off[idx],
            names=[self.names[i] for i in idx] if self.names is not None else None,
            tags=self.tags,
            tags_off=self.tags_off[idx] if self.tags_off is not None else None,
            tags_len=self.tags_len[idx] if self.tags_len is not None else None,
            mtid=self.mtid[idx] if self.mtid is not None else None,
            mpos=self.mpos[idx] if self.mpos is not None else None,
        )

    def ref_span(self) -> np.ndarray:
        """Reference-consumed length per record (bam_cigar2rlen equivalent).
        Memoized per batch — several pileup passes ask for it."""
        cached = getattr(self, "_span_cache", None)
        if cached is not None:
            return cached
        ops = self.cigar & 0xF
        lens = self.cigar >> 4
        contrib = lens * CONSUMES_R[ops]
        cum = np.concatenate([[0], np.cumsum(contrib)])
        ends = self.cigar_off + self.cigar_len
        spans = cum[ends] - cum[self.cigar_off]
        self._span_cache = spans
        return spans

    def sa_tagged(self) -> np.ndarray:
        """bool [N]: records whose aux data holds the bytes `SA` followed
        by `Z` or `H`, the keys and types an SA-tag walk takes: every
        record with an SA tag, and the rare record whose other tags hold
        those bytes.  Memoized per batch."""
        cached = getattr(self, "_sa_cache", None)
        if cached is not None:
            return cached
        out = np.zeros(len(self), dtype=bool)
        t = self.tags
        if t is not None and len(t) >= 3:
            hit = ((t[:-2] == ord("S")) & (t[1:-1] == ord("A"))
                   & ((t[2:] == ord("Z")) | (t[2:] == ord("H"))))
            cum = np.concatenate([[0], np.cumsum(hit)])
            lo = self.tags_off.astype(np.int64)
            ok = self.tags_len >= 3
            # a key that starts in [lo, lo + len - 2) lies inside the record
            out[ok] = cum[lo[ok] + self.tags_len[ok] - 2] > cum[lo[ok]]
        self._sa_cache = out
        return out

    def clip_lens(self) -> tuple[np.ndarray, np.ndarray]:
        """(left, right) soft+hard clip length per record."""
        n = len(self)
        left = np.zeros(n, dtype=np.int64)
        right = np.zeros(n, dtype=np.int64)
        has = self.cigar_len > 0
        first = self.cigar[self.cigar_off[has]]
        last = self.cigar[self.cigar_off[has] + self.cigar_len[has] - 1]
        fo, lo = first & 0xF, last & 0xF
        fl = np.where((fo == CSOFT_CLIP) | (fo == CHARD_CLIP), first >> 4, 0)
        ll = np.where((lo == CSOFT_CLIP) | (lo == CHARD_CLIP), last >> 4, 0)
        left[has] = fl
        right[has] = ll
        return left, right

    def soft_clip_lens(self) -> tuple[np.ndarray, np.ndarray]:
        n = len(self)
        left = np.zeros(n, dtype=np.int64)
        right = np.zeros(n, dtype=np.int64)
        has = self.cigar_len > 0
        first = self.cigar[self.cigar_off[has]]
        last = self.cigar[self.cigar_off[has] + self.cigar_len[has] - 1]
        left[has] = np.where((first & 0xF) == CSOFT_CLIP, first >> 4, 0)
        right[has] = np.where((last & 0xF) == CSOFT_CLIP, last >> 4, 0)
        return left, right


_NIB_EXPAND_HI = None
_NIB_EXPAND_LO = None


def _nib_tables():
    global _NIB_EXPAND_HI, _NIB_EXPAND_LO
    if _NIB_EXPAND_HI is None:
        b = np.arange(256, dtype=np.uint8)
        _NIB_EXPAND_HI = (b >> 4).astype(np.uint8)
        _NIB_EXPAND_LO = (b & 0xF).astype(np.uint8)
    return _NIB_EXPAND_HI, _NIB_EXPAND_LO


def read_bam(path: str, with_names: bool = False, with_tags: bool = True) -> AlnBatch:
    """Parse an entire BAM file into an AlnBatch."""
    data = read_bgzf(path)
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    text = data[8 : 8 + l_text].rstrip(b"\x00").decode(errors="replace")
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        names.append(data[off : off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        lengths.append(l_ref)
    header = BamHeader(text, names, lengths)
    from .. import native

    cols = native.bam_scan(data, off)
    if cols is not None:
        return _batch_from_native(cols, header, with_names, with_tags)
    return _parse_records(data, off, header, with_names, with_tags)


def _batch_from_native(cols, header, with_names, with_tags) -> "AlnBatch":
    names = None
    if with_names:
        names = cols["qnames"].decode(errors="replace").split("\x00")[:-1] \
            if cols["qnames"] else []
        if len(names) != cols["n"]:
            names = None
    batch = AlnBatch(
        header=header,
        tid=cols["tid"], pos=cols["pos"], mapq=cols["mapq"],
        flag=cols["flag"], tlen=cols["tlen"], lqseq=cols["lqseq"],
        cigar=cols["cigar"], cigar_off=cols["cigar_off"],
        cigar_len=cols["cigar_len"], seq=cols["seq"],
        seq_off=cols["seq_off"], qual=cols["qual"],
        qual_off=cols["seq_off"].copy(), names=names,
        mtid=cols["mtid"], mpos=cols["mpos"],
    )
    if with_tags:
        batch.tags = cols["tags"]
        batch.tags_off = cols["tags_off"]
        batch.tags_len = cols["tags_len"]
    return batch


def _parse_records(data: bytes, off: int, header: BamHeader,
                   with_names: bool, with_tags: bool) -> AlnBatch:
    mv = memoryview(data)
    n_bytes = len(data)
    tid_l, pos_l, mapq_l, flag_l, tlen_l, lqseq_l = [], [], [], [], [], []
    mtid_l, mpos_l = [], []
    cigar_parts, seq_parts, qual_parts, tag_parts = [], [], [], []
    cigar_lens, seq_lens, tag_lens = [], [], []
    names_l = [] if with_names else None
    u32 = struct.Struct("<I")
    core = struct.Struct("<iiBBHHHiiii")  # refID pos l_qname mapq bin ncig flag lseq nrefID npos tlen
    hi, lo = _nib_tables()
    while off + 4 <= n_bytes:
        (block_size,) = u32.unpack_from(mv, off)
        off += 4
        rec_end = off + block_size
        (refid, pos, l_qname, mapq, _bin, n_cig, flag, l_seq, mtid, mpos, tlen
         ) = core.unpack_from(mv, off)
        p = off + 32
        if with_names:
            names_l.append(bytes(mv[p : p + l_qname - 1]).decode())
        p += l_qname
        cig = np.frombuffer(mv[p : p + 4 * n_cig], dtype=np.uint32)
        p += 4 * n_cig
        packed = np.frombuffer(mv[p : p + (l_seq + 1) // 2], dtype=np.uint8)
        p += (l_seq + 1) // 2
        nib = np.empty(packed.size * 2, dtype=np.uint8)
        nib[0::2] = hi[packed]
        nib[1::2] = lo[packed]
        nib = nib[:l_seq]
        qual = np.frombuffer(mv[p : p + l_seq], dtype=np.uint8)
        p += l_seq
        if with_tags:
            tag_parts.append(np.frombuffer(mv[p:rec_end], dtype=np.uint8))
            tag_lens.append(rec_end - p)
        tid_l.append(refid)
        pos_l.append(pos)
        mapq_l.append(mapq)
        flag_l.append(flag)
        tlen_l.append(tlen)
        lqseq_l.append(l_seq)
        mtid_l.append(mtid)
        mpos_l.append(mpos)
        cigar_parts.append(cig)
        cigar_lens.append(n_cig)
        seq_parts.append(nib)
        seq_lens.append(l_seq)
        qual_parts.append(qual)
        off = rec_end

    n = len(pos_l)
    cigar_len = np.asarray(cigar_lens, dtype=np.int32)
    cigar_off = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(cigar_len[:-1], out=cigar_off[1:])
    seq_len = np.asarray(seq_lens, dtype=np.int64)
    seq_off = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(seq_len[:-1], out=seq_off[1:])
    batch = AlnBatch(
        header=header,
        tid=np.asarray(tid_l, dtype=np.int32),
        pos=np.asarray(pos_l, dtype=np.int32),
        mapq=np.asarray(mapq_l, dtype=np.uint8),
        flag=np.asarray(flag_l, dtype=np.uint16),
        tlen=np.asarray(tlen_l, dtype=np.int32),
        lqseq=np.asarray(lqseq_l, dtype=np.int32),
        cigar=np.concatenate(cigar_parts) if n else np.empty(0, np.uint32),
        cigar_off=cigar_off,
        cigar_len=cigar_len,
        seq=np.concatenate(seq_parts) if n else np.empty(0, np.uint8),
        seq_off=seq_off,
        qual=np.concatenate(qual_parts) if n else np.empty(0, np.uint8),
        qual_off=seq_off.copy(),
        names=names_l,
        mtid=np.asarray(mtid_l, dtype=np.int32),
        mpos=np.asarray(mpos_l, dtype=np.int32),
    )
    if with_tags:
        tl = np.asarray(tag_lens, dtype=np.int32)
        to = np.zeros(n, dtype=np.int64)
        if n:
            np.cumsum(tl[:-1], out=to[1:])
        batch.tags = np.concatenate(tag_parts) if n else np.empty(0, np.uint8)
        batch.tags_off = to
        batch.tags_len = tl
    return batch


def get_tag(batch: AlnBatch, i: int, tag: bytes):
    """Extract one aux tag value from record i (spec-conformant walk)."""
    raw = batch.rec_tags(i)
    p = 0
    n = len(raw)
    while p + 3 <= n:
        t = raw[p : p + 2]
        typ = raw[p + 2 : p + 3]
        p += 3
        if typ == b"A":
            val, sz = raw[p : p + 1].decode(), 1
        elif typ in b"cC":
            val, sz = raw[p], 1
            if typ == b"c" and val > 127:
                val -= 256
        elif typ in b"sS":
            val = struct.unpack_from("<h" if typ == b"s" else "<H", raw, p)[0]
            sz = 2
        elif typ in b"iI":
            val = struct.unpack_from("<i" if typ == b"i" else "<I", raw, p)[0]
            sz = 4
        elif typ == b"f":
            val, sz = struct.unpack_from("<f", raw, p)[0], 4
        elif typ in b"ZH":
            end = raw.index(b"\x00", p)
            val, sz = raw[p:end].decode(), end - p + 1
        elif typ == b"B":
            subtyp = raw[p : p + 1]
            (cnt,) = struct.unpack_from("<I", raw, p + 1)
            esz = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}[subtyp]
            val = np.frombuffer(raw, dtype={b"c": np.int8, b"C": np.uint8,
                                            b"s": np.int16, b"S": np.uint16,
                                            b"i": np.int32, b"I": np.uint32,
                                            b"f": np.float32}[subtyp],
                                count=cnt, offset=p + 5)
            sz = 5 + esz * cnt
        else:
            raise ValueError(f"unknown tag type {typ!r}")
        if t == tag:
            return val
        p += sz
    return None


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
        from .bai import write_bai

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


def cigar_from_string(s: str) -> np.ndarray:
    import re

    ops = re.findall(r"(\d+)([MIDNSHP=X])", s)
    return np.array([(int(l) << 4) | _CIGAR_CODE[o] for l, o in ops], dtype=np.uint32)


def cigar_to_string(cig: np.ndarray) -> str:
    return "".join(f"{int(c) >> 4}{CIGAR_CHARS[c & 0xF]}" for c in cig)


def seq_to_nib(seq: bytes) -> np.ndarray:
    return _ASCII_TO_NIB[np.frombuffer(seq, dtype=np.uint8)]
