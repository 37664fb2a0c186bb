"""Region-restricted BAM reading + streaming multi-BAM merge.

The out-of-core data plane: htslib's `bam_itr_queryi` role (used by the
reference at lib/contig.c:1010-1043) and the k-way sorted-BAM merge
iterator of lib/bsort.c:1202-1463, reimplemented from the SAM spec on top
of our BGZF/BAI codecs.  Instead of loading whole BAMs, `IndexedBam`
decompresses only the BGZF blocks a region needs (position-sorted BAMs
keep a region's records contiguous; the .bai linear index gives the first
candidate virtual offset), so peak memory is O(region), not O(file).

Merge-order parity: the reference heap emits by
(tid, pos, reverse-strand, input-file index, arrival order)
(heap_lt, lib/bsort.c:174-199 with pos=(tid<<32|pos+1), rev, i, idx);
`merge_region_batches` reproduces that exactly with a stable lexsort, so
multi-BAM consensus output is byte-identical to the reference's merge.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from collections import OrderedDict

import numpy as np

from .bam import CONSUMES_R, AlnBatch, BamHeader, FREVERSE, _nib_tables

_CORE = struct.Struct("<iiBBHHHiiii")


def read_bai(path: str):
    """Parse a .bai: per-ref ({bin: [(voff_start, voff_end)]}, linear[])."""
    data = open(path, "rb").read()
    if data[:4] != b"BAI\x01":
        raise ValueError(f"{path}: not a BAI index")
    (n_ref,) = struct.unpack_from("<i", data, 4)
    off = 8
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                vs, ve = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((vs, ve))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        lin = np.frombuffer(data, dtype="<u8", count=n_intv, offset=off)
        off += 8 * n_intv
        refs.append((bins, lin))
    return refs


def reg2bins(beg: int, end: int):
    """All bins overlapping [beg, end) (SAM spec §5.3)."""
    end -= 1
    out = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


class IndexedBam:
    """Position-sorted BAM with .bai-driven region fetch and bounded-RAM
    block decompression (LRU over ~4 MB of blocks)."""

    CACHE_BLOCKS = 256

    def __init__(self, path: str, bai_path: str | None = None):
        self.path = path
        self._fh = open(path, "rb")
        self._size = os.fstat(self._fh.fileno()).st_size
        self._cache: OrderedDict[int, tuple[bytes, int]] = OrderedDict()
        # worker2 fetches windows of several contigs from threads at once:
        # the file position and the block cache are shared state
        self._lock = threading.Lock()
        self.header, self._first_voff = self._read_header()
        bai_path = bai_path or path + ".bai"
        self._bai = read_bai(bai_path) if os.path.exists(bai_path) else None

    def close(self):
        self._fh.close()

    # ---- BGZF blocks ---------------------------------------------------
    def _block(self, coffset: int) -> tuple[bytes, int]:
        """Decompressed payload of the block at compressed offset, plus
        the next block's compressed offset (thread-safe)."""
        with self._lock:
            return self._block_locked(coffset)

    def _block_locked(self, coffset: int) -> tuple[bytes, int]:
        hit = self._cache.get(coffset)
        if hit is not None:
            self._cache.move_to_end(coffset)
            return hit
        self._fh.seek(coffset)
        head = self._fh.read(18)
        if len(head) < 18:
            return b"", self._size
        (xlen,) = struct.unpack_from("<H", head, 10)
        bsize = None
        extra = head[12:18] + (self._fh.read(xlen - 6) if xlen > 6 else b"")
        xoff = 0
        while xoff + 4 <= xlen:
            si1, si2 = extra[xoff], extra[xoff + 1]
            (slen,) = struct.unpack_from("<H", extra, xoff + 2)
            if si1 == 66 and si2 == 67 and slen == 2:
                (bs,) = struct.unpack_from("<H", extra, xoff + 4)
                bsize = bs + 1
            xoff += 4 + slen
        if bsize is None:
            raise ValueError(f"{self.path}: BGZF block missing BSIZE")
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        self._fh.read(4)  # crc
        (isize,) = struct.unpack("<I", self._fh.read(4))
        payload = (zlib.decompress(cdata, wbits=-15, bufsize=isize)
                   if isize else b"")
        ent = (payload, coffset + bsize)
        self._cache[coffset] = ent
        if len(self._cache) > self.CACHE_BLOCKS:
            self._cache.popitem(last=False)
        return ent

    def _read_header(self):
        buf = bytearray()
        voffs = []  # (uncompressed offset of block start, coffset)
        coffset = 0
        need = 12

        def extend_to(n):
            nonlocal coffset
            while len(buf) < n and coffset < self._size:
                voffs.append((len(buf), coffset))
                payload, coffset = self._block(coffset)
                if not payload and coffset >= self._size:
                    break
                buf.extend(payload)

        extend_to(need)
        if bytes(buf[:4]) != b"BAM\x01":
            raise ValueError(f"{self.path}: not a BAM file")
        (l_text,) = struct.unpack_from("<i", buf, 4)
        extend_to(8 + l_text + 4)
        text = bytes(buf[8 : 8 + l_text]).rstrip(b"\x00").decode(
            errors="replace")
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", buf, off)
        off += 4
        names, lengths = [], []
        for _ in range(n_ref):
            extend_to(off + 4)
            (l_name,) = struct.unpack_from("<i", buf, off)
            off += 4
            extend_to(off + l_name + 4)
            names.append(bytes(buf[off : off + l_name - 1]).decode())
            off += l_name
            (l_ref,) = struct.unpack_from("<i", buf, off)
            off += 4
            lengths.append(l_ref)
        # virtual offset of the first alignment record
        bo = 0
        for u, c in voffs:
            if u <= off:
                bo = (u, c)
        uoff = off - bo[0]
        payload, nxt = self._block(bo[1])
        if uoff >= len(payload) and uoff > 0:
            # header ends exactly at the block boundary: a 16-bit uoff
            # cannot hold 65536, so the first record's voff is the next
            # block at uoff 0
            first_voff = nxt << 16
        else:
            first_voff = (bo[1] << 16) | uoff
        return BamHeader(text, names, lengths), first_voff

    # ---- region fetch --------------------------------------------------
    def _region_start_voff(self, tid: int, start: int) -> int | None:
        if self._bai is None or tid < 0 or tid >= len(self._bai):
            return self._first_voff
        bins, lin = self._bai[tid]
        if not bins:
            return None  # no records for this reference
        cand = []
        lin_min = int(lin[min(start >> 14, len(lin) - 1)]) if len(lin) \
            else 0
        for b in reg2bins(start, 1 << 29):
            for vs, ve in bins.get(b, ()):
                if ve > lin_min:
                    cand.append(max(vs, lin_min))
        if not cand:
            return None
        return min(cand)

    def fetch(self, tid: int, start: int, end: int, with_tags: bool = True
              ) -> AlnBatch:
        """All records overlapping [start, end] of reference tid, in file
        order (bam_itr_queryi semantics)."""
        voff = self._region_start_voff(tid, start)
        cols = _ColAccum(with_tags)
        if voff is not None:
            self._scan_records(voff, tid, start, end, cols)
        return cols.finish(self.header)

    def fetch_all(self, with_tags: bool = True) -> AlnBatch:
        cols = _ColAccum(with_tags)
        self._scan_records(self._first_voff, None, 0, 1 << 62, cols)
        return cols.finish(self.header)

    def fetch_head(self, n: int, with_tags: bool = False) -> AlnBatch:
        """First n records (the insert-size estimator reads 10k,
        lib/config.c:80-101)."""
        cols = _ColAccum(with_tags)
        self._scan_records(self._first_voff, None, 0, 1 << 62, cols,
                           max_records=n)
        return cols.finish(self.header)

    def _scan_records(self, voff: int, tid: int | None, start: int,
                      end: int, cols: "_ColAccum",
                      max_records: int | None = None) -> None:
        coffset, uoff = voff >> 16, voff & 0xFFFF
        buf = bytearray()
        payload, nxt = self._block(coffset)
        buf.extend(payload[uoff:])
        coffset = nxt
        p = 0

        def ensure(n):
            nonlocal coffset
            while len(buf) - p < n and coffset < self._size:
                payload, nxt = self._block(coffset)
                if not payload and nxt >= self._size:
                    coffset = self._size
                    break
                buf.extend(payload)
                coffset = nxt
            return len(buf) - p >= n

        n_seen = 0
        while True:
            if max_records is not None and n_seen >= max_records:
                break
            n_seen += 1
            if not ensure(4):
                break
            (block_size,) = struct.unpack_from("<I", buf, p)
            if not ensure(4 + block_size):
                break
            rec = bytes(buf[p + 4 : p + 4 + block_size])
            p += 4 + block_size
            if p > (1 << 20):
                del buf[:p]
                p = 0
            refid, pos = struct.unpack_from("<ii", rec, 0)
            if tid is not None:
                # refid -1 (unmapped tail of a position-sorted BAM) sorts
                # after every reference: stop, don't skip-scan it per fetch
                if refid < 0 or refid > tid or (refid == tid and pos > end):
                    break
                if refid < tid:
                    continue
            cols.add(rec, None if tid is None else (start, end))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _ColAccum:
    """Record-bytes -> AlnBatch column accumulator (shares the layout of
    bam._parse_records)."""

    def __init__(self, with_tags: bool):
        self.with_tags = with_tags
        self.tid, self.pos, self.mapq, self.flag = [], [], [], []
        self.tlen, self.lqseq, self.mtid, self.mpos = [], [], [], []
        self.cig, self.cig_len = [], []
        self.seq, self.qual = [], []
        self.tags, self.tags_len = [], []
        self._hi, self._lo = _nib_tables()

    def add(self, rec: bytes, region: tuple[int, int] | None) -> None:
        (refid, pos, l_qname, mapq, _bin, n_cig, flag, l_seq, mtid, mpos,
         tlen) = _CORE.unpack_from(rec, 0)
        p = 32 + l_qname
        cig = np.frombuffer(rec, dtype=np.uint32, count=n_cig, offset=p)
        if region is not None:
            span = int(((cig >> 4) * CONSUMES_R[cig & 0xF]).sum()) \
                if n_cig else 1
            if pos + max(span, 1) <= region[0] or pos > region[1]:
                return
        p += 4 * n_cig
        packed = np.frombuffer(rec, dtype=np.uint8,
                               count=(l_seq + 1) // 2, offset=p)
        p += (l_seq + 1) // 2
        nib = np.empty(packed.size * 2, dtype=np.uint8)
        nib[0::2] = self._hi[packed]
        nib[1::2] = self._lo[packed]
        qual = np.frombuffer(rec, dtype=np.uint8, count=l_seq, offset=p)
        p += l_seq
        self.tid.append(refid)
        self.pos.append(pos)
        self.mapq.append(mapq)
        self.flag.append(flag)
        self.tlen.append(tlen)
        self.lqseq.append(l_seq)
        self.mtid.append(mtid)
        self.mpos.append(mpos)
        self.cig.append(cig)
        self.cig_len.append(n_cig)
        self.seq.append(nib[:l_seq])
        self.qual.append(qual)
        if self.with_tags:
            self.tags.append(np.frombuffer(rec, dtype=np.uint8,
                                           offset=p).copy())
            self.tags_len.append(len(rec) - p)

    def finish(self, header: BamHeader) -> AlnBatch:
        n = len(self.pos)
        cigar_len = np.asarray(self.cig_len, dtype=np.int32)
        cigar_off = np.zeros(n, dtype=np.int64)
        seq_len = np.asarray(self.lqseq, dtype=np.int64)
        seq_off = np.zeros(n, dtype=np.int64)
        if n:
            np.cumsum(cigar_len[:-1], out=cigar_off[1:])
            np.cumsum(seq_len[:-1], out=seq_off[1:])
        batch = AlnBatch(
            header=header,
            tid=np.asarray(self.tid, dtype=np.int32),
            pos=np.asarray(self.pos, dtype=np.int32),
            mapq=np.asarray(self.mapq, dtype=np.uint8),
            flag=np.asarray(self.flag, dtype=np.uint16),
            tlen=np.asarray(self.tlen, dtype=np.int32),
            lqseq=np.asarray(self.lqseq, dtype=np.int32),
            cigar=(np.concatenate(self.cig) if n
                   else np.empty(0, np.uint32)),
            cigar_off=cigar_off,
            cigar_len=cigar_len,
            seq=(np.concatenate(self.seq) if n else np.empty(0, np.uint8)),
            seq_off=seq_off,
            qual=(np.concatenate(self.qual) if n
                  else np.empty(0, np.uint8)),
            qual_off=seq_off.copy(),
            mtid=np.asarray(self.mtid, dtype=np.int32),
            mpos=np.asarray(self.mpos, dtype=np.int32),
        )
        if self.with_tags:
            tl = np.asarray(self.tags_len, dtype=np.int32)
            to = np.zeros(n, dtype=np.int64)
            if n:
                np.cumsum(tl[:-1], out=to[1:])
            batch.tags = (np.concatenate(self.tags) if n
                          else np.empty(0, np.uint8))
            batch.tags_off = to
            batch.tags_len = tl
        return batch


def merge_region_batches(batches: list[AlnBatch], heap_rev: bool = True
                         ) -> AlnBatch:
    """Merge per-file batches in the reference heap's emission order:
    (tid, pos, reverse-strand, file index, in-file order) — heap_lt,
    lib/bsort.c:174-199.  Input batches must each be position-sorted.

    heap_rev=False drops the strand key: (tid, pos, file, order) — the
    `samtools merge` order the short-read pipeline sees (and the order a
    stable (tid, pos) sort of chunk-concatenated records produces, so the
    spilled and in-memory data planes emit identical streams)."""
    if len(batches) == 1:
        return batches[0]
    base = batches[0]

    def cat(field):
        return np.concatenate([getattr(b, field) for b in batches])

    tags_ok = all(b.tags is not None for b in batches)
    cigar_off, seq_off, qual_off, tags_off = [], [], [], []
    cbase = sbase = qbase = tbase = 0
    file_i = []
    rec_i = []
    for i, b in enumerate(batches):
        cigar_off.append(b.cigar_off + cbase)
        seq_off.append(b.seq_off + sbase)
        qual_off.append(b.qual_off + qbase)
        cbase += len(b.cigar)
        sbase += len(b.seq)
        qbase += len(b.qual)
        if tags_ok:
            tags_off.append(b.tags_off + tbase)
            tbase += len(b.tags)
        file_i.append(np.full(len(b), i, dtype=np.int32))
        rec_i.append(np.arange(len(b), dtype=np.int64))
    merged = AlnBatch(
        header=base.header,
        tid=cat("tid"), pos=cat("pos"), mapq=cat("mapq"), flag=cat("flag"),
        tlen=cat("tlen"), lqseq=cat("lqseq"),
        cigar=cat("cigar"), cigar_off=np.concatenate(cigar_off),
        cigar_len=cat("cigar_len"), seq=cat("seq"),
        seq_off=np.concatenate(seq_off), qual=cat("qual"),
        qual_off=np.concatenate(qual_off), names=None,
        tags=cat("tags") if tags_ok else None,
        tags_off=np.concatenate(tags_off) if tags_ok else None,
        tags_len=cat("tags_len") if tags_ok else None,
        mtid=cat("mtid"), mpos=cat("mpos"),
    )
    if heap_rev:
        rev = (merged.flag & FREVERSE) != 0
        order = np.lexsort((np.concatenate(rec_i), np.concatenate(file_i),
                            rev, merged.pos, merged.tid))
    else:
        order = np.lexsort((np.concatenate(rec_i), np.concatenate(file_i),
                            merged.pos, merged.tid))
    return merged.select(order)


class RegionFetcher:
    """Callable window-batch source over a list of sorted BAMs: the
    bam_merge_iter_init(region) role of ctg_cns_core
    (lib/ctg_cns.c:3474).  heap_rev picks the merge tie order (see
    merge_region_batches)."""

    def __init__(self, paths: list[str], heap_rev: bool = True):
        self.bams = [IndexedBam(p) for p in paths]
        self.header = self.bams[0].header
        self.heap_rev = heap_rev

    def fetch(self, tid: int, start: int, end: int) -> AlnBatch:
        return merge_region_batches(
            [b.fetch(tid, start, end) for b in self.bams],
            heap_rev=self.heap_rev)

    def fetch_head(self, n: int) -> AlnBatch:
        """First n records of the merged stream (the insert-size
        estimator's 10k head, lib/config.c:80-101): the merge of each
        file's own n-head contains the global n-head."""
        heads = [b.fetch_head(n) for b in self.bams]
        merged = merge_region_batches(heads, heap_rev=self.heap_rev)
        return merged.select(np.arange(min(n, len(merged))))

    def close(self):
        for b in self.bams:
            b.close()
