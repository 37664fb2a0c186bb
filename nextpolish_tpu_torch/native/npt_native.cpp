// Native host substrate for nextpolish_tpu.
//
// Replaces the reference's htslib usage (lib/htslib) for the ingest hot
// path with a small, fresh implementation written from the SAM/BAM and
// BGZF specifications:
//   * block-parallel BGZF decompression (std::thread + zlib raw inflate)
//   * BAM record scan into columnar arrays (struct-of-arrays) matching
//     io/bam.py's AlnBatch layout
//
// Exposed as C symbols for ctypes; no Python headers required.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

struct BgzfBlock {
  size_t in_off;
  size_t in_len;
  size_t out_off;
  size_t out_len;
};

static int scan_blocks(const uint8_t *data, size_t n,
                       std::vector<BgzfBlock> &blocks, size_t *total_out) {
  size_t pos = 0, out = 0;
  while (pos + 18 <= n) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return -1;
    uint16_t xlen;
    std::memcpy(&xlen, data + pos + 10, 2);
    size_t xoff = pos + 12, xend = xoff + xlen;
    long bsize = -1;
    while (xoff + 4 <= xend) {
      uint8_t si1 = data[xoff], si2 = data[xoff + 1];
      uint16_t slen;
      std::memcpy(&slen, data + xoff + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        std::memcpy(&bs, data + xoff + 4, 2);
        bsize = (long)bs + 1;
      }
      xoff += 4 + slen;
    }
    if (bsize < 0 || pos + (size_t)bsize > n) return -1;
    uint32_t isize;
    std::memcpy(&isize, data + pos + bsize - 4, 4);
    BgzfBlock b;
    b.in_off = pos + 12 + xlen;
    b.in_len = (size_t)bsize - xlen - 19;
    b.out_off = out;
    b.out_len = isize;
    blocks.push_back(b);
    out += isize;
    pos += (size_t)bsize;
  }
  *total_out = out;
  return 0;
}

// Pass 1: total decompressed size (so the caller can allocate).
long long npt_bgzf_size(const uint8_t *data, long long n) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (scan_blocks(data, (size_t)n, blocks, &total) != 0) return -1;
  return (long long)total;
}

// Pass 2: decompress all blocks in parallel into out (size from pass 1).
int npt_bgzf_decompress(const uint8_t *data, long long n, uint8_t *out,
                        long long out_len, int n_threads) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (scan_blocks(data, (size_t)n, blocks, &total) != 0) return -1;
  if ((long long)total != out_len) return -2;
  if (n_threads < 1) n_threads = 1;
  std::atomic<size_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || err.load()) break;
      const BgzfBlock &b = blocks[i];
      if (b.out_len == 0) continue;
      z_stream zs;
      std::memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) { err.store(1); break; }
      zs.next_in = const_cast<uint8_t *>(data + b.in_off);
      zs.avail_in = (uInt)b.in_len;
      zs.next_out = out + b.out_off;
      zs.avail_out = (uInt)b.out_len;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END) { err.store(2); break; }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads - 1; t++) ts.emplace_back(worker);
  worker();
  for (auto &t : ts) t.join();
  return err.load() ? -3 : 0;
}

// ---------------------------------------------------------------------------
// BAM record scan
// ---------------------------------------------------------------------------

// Pass 1 over decompressed records starting at `off`: counts.
// Returns 0; fills n_records, total cigar words, total seq bases, total tag
// bytes.
int npt_bam_count(const uint8_t *data, long long n, long long off,
                  long long *n_records, long long *n_cigar,
                  long long *n_bases, long long *n_tags) {
  long long nr = 0, nc = 0, nb = 0, nt = 0;
  long long p = off;
  while (p + 4 <= n) {
    uint32_t block_size;
    std::memcpy(&block_size, data + p, 4);
    long long rec_end = p + 4 + (long long)block_size;
    if (rec_end > n || block_size < 32) break;
    const uint8_t *r = data + p + 4;
    uint8_t l_qname = r[8];
    uint16_t n_cig;
    std::memcpy(&n_cig, r + 12, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, r + 16, 4);
    nr += 1;
    nc += n_cig;
    nb += l_seq;
    long long fixed = 32 + l_qname + 4LL * n_cig + (l_seq + 1) / 2 + l_seq;
    nt += (long long)block_size - fixed;
    p = rec_end;
  }
  *n_records = nr;
  *n_cigar = nc;
  *n_bases = nb;
  *n_tags = nt;
  return 0;
}

// Pass 2: fill columnar arrays (caller allocated from pass-1 counts).
// qname bytes are written NUL-terminated into qnames (cap qnames_len).
int npt_bam_fill(const uint8_t *data, long long n, long long off,
                 int32_t *tid, int32_t *pos, uint8_t *mapq, uint16_t *flag,
                 int32_t *tlen, int32_t *lqseq, int32_t *mtid, int32_t *mpos,
                 uint32_t *cigar, int64_t *cigar_off, int32_t *cigar_len,
                 uint8_t *seq_nib, int64_t *seq_off, uint8_t *qual,
                 uint8_t *tags, int64_t *tags_off, int32_t *tags_len,
                 uint8_t *qnames, long long qnames_cap,
                 long long *qnames_used) {
  long long p = off;
  long long i = 0, coff = 0, soff = 0, toff = 0, qoff = 0;
  while (p + 4 <= n) {
    uint32_t block_size;
    std::memcpy(&block_size, data + p, 4);
    long long rec_end = p + 4 + (long long)block_size;
    if (rec_end > n || block_size < 32) break;
    const uint8_t *r = data + p + 4;
    std::memcpy(&tid[i], r, 4);
    std::memcpy(&pos[i], r + 4, 4);
    uint8_t l_qname = r[8];
    mapq[i] = r[9];
    uint16_t n_cig;
    std::memcpy(&n_cig, r + 12, 2);
    std::memcpy(&flag[i], r + 14, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, r + 16, 4);
    std::memcpy(&mtid[i], r + 20, 4);
    std::memcpy(&mpos[i], r + 24, 4);
    std::memcpy(&tlen[i], r + 28, 4);
    lqseq[i] = l_seq;
    const uint8_t *q = r + 32;
    long long qn = l_qname;
    if (qoff + qn <= qnames_cap) {
      std::memcpy(qnames + qoff, q, qn);
      qoff += qn;
    }
    q += l_qname;
    cigar_off[i] = coff;
    cigar_len[i] = n_cig;
    std::memcpy(cigar + coff, q, 4LL * n_cig);
    coff += n_cig;
    q += 4LL * n_cig;
    seq_off[i] = soff;
    const uint8_t *packed = q;
    for (int32_t b = 0; b < l_seq; b++) {
      uint8_t byte = packed[b >> 1];
      seq_nib[soff + b] = (b & 1) ? (byte & 0xF) : (byte >> 4);
    }
    q += (l_seq + 1) / 2;
    std::memcpy(qual + soff, q, l_seq);
    soff += l_seq;
    q += l_seq;
    long long tl = (data + rec_end) - q;
    tags_off[i] = toff;
    tags_len[i] = (int32_t)tl;
    if (tl > 0) {
      std::memcpy(tags + toff, q, tl);
      toff += tl;
    }
    i += 1;
    p = rec_end;
  }
  *qnames_used = qoff;
  return 0;
}

}  // extern "C"
