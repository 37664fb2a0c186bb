"""BGZF block-compressed stream codec (SAM/BAM spec §4.1), written from the
published spec.  Replaces the reference's htslib BGZF layer for BAM ingest.

Reading decompresses block-parallel-friendly chunks with zlib; writing emits
spec-compliant blocks with the BC extra field and the BGZF EOF marker.
"""
from __future__ import annotations

import os
import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2BH")


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(18)
    return (
        len(head) >= 18
        and head[0] == 0x1F
        and head[1] == 0x8B
        and head[3] & 4 != 0
        and head[12:14] == b"BC"
    )


def decompress_stream(data: bytes) -> bytes:
    """Decompress a whole BGZF byte string to the uncompressed stream."""
    out = []
    pos = 0
    n = len(data)
    while pos + 18 <= n:
        if data[pos] != 0x1F or data[pos + 1] != 0x8B:
            raise ValueError(f"bad BGZF magic at offset {pos}")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        # scan extra subfields for BSIZE (SI1=66 SI2=67)
        bsize = None
        xoff = pos + 12
        xend = xoff + xlen
        while xoff + 4 <= xend:
            si1, si2, slen = data[xoff], data[xoff + 1], struct.unpack_from("<H", data, xoff + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", data, xoff + 4)[0] + 1
            xoff += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BSIZE")
        cdata_off = pos + 12 + xlen
        cdata_len = bsize - xlen - 19  # 12 hdr + 8 trailer - 1
        isize = struct.unpack_from("<I", data, pos + bsize - 4)[0]
        if isize:
            out.append(
                zlib.decompress(
                    data[cdata_off : cdata_off + cdata_len], wbits=-15, bufsize=isize
                )
            )
        pos += bsize
    return b"".join(out)


def read_bgzf(path: str) -> bytes:
    with open(path, "rb") as fh:
        data = fh.read()
    from .. import native

    out = native.bgzf_decompress(data)
    if out is not None:
        return out
    return decompress_stream(data)


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
