// A copy of nextpolish_tpu/native/pileup.cpp (unchanged).
//
// Single-pass pileup accumulation for the score-chain engine.
//
// Native transcription of the reference's per-read pileup walk
// (contig_parse_read + contig_cut_read, lib/contig.c:247-358) over the cell
// chain defined in ops/pileup.py.  Replaces the vectorized-numpy event
// expansion on the hot path: one pass over the selected reads, a rolling
// 9-bit compact 3-mer, and direct increments into a dense
// [n_cells * 512] uint16 count table (saturating) + int32 per-cell totals.
//
// Parallelism: the cell chain is split into T contiguous position ranges;
// each thread walks every read that can emit into its range (reads are
// position-sorted, so that is a binary-searched subrange) but only records
// cells it owns.  A read spanning a boundary is walked by both neighbours
// with identical rolling-kmer state, so per-cell observation order — and
// therefore the first-observation ranks that encode the reference's
// SeqList insertion order (lib/base.c:60-71) — is byte-identical to the
// single-thread walk.
//
// Semantics must match ops/pileup.py::expand_reads + build_pileup_sparse
// exactly (both are property-tested against the slow oracle and the
// reference .so); see the comments there for why emissions form a
// contiguous cell range per read.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int CMATCH = 0, CINS = 1, CDEL = 2, CSOFT = 4, CHARD = 5;
constexpr int SYM_DEL = 3;  // compact DEL (ops/symbols.py)
constexpr uint16_t SAT = 0xFFFF;

// BAM nibble -> compact symbol (ops/symbols.py NIB_TO_SYM)
constexpr uint8_t NIB2SYM[16] = {0, 1, 2, 3, 4, 7, 7, 7,
                                 5, 7, 7, 7, 7, 7, 7, 6};

inline int kshift(int kmer, int sym) { return ((kmer & 63) << 3) | sym; }

struct Acc {
  uint16_t *counts;
  int32_t *totals;
  uint16_t *cellrank;          // next first-observation ordinal per cell
  long long lo, hi;            // owned cell range [lo, hi)
  std::vector<int64_t> dirty;  // key<<9 | rank, pushed on the 0 -> 1
                               // transition (observation order = the
                               // reference's SeqList data insertion order;
                               // rank < 512 since a cell has at most 512
                               // distinct 3-mers)
  inline void add(long long cell, int kmer) {
    if (cell < lo || cell >= hi) return;
    const long long key = cell * 512 + kmer;
    uint16_t &c = counts[key];
    if (c == 0) dirty.push_back((key << 9) | cellrank[cell]++);
    if (c != SAT) c++;
    totals[cell]++;
  }
};

struct WalkArgs {
  const int64_t *ridx;
  long long n_sel;
  const int32_t *rpos;
  const uint32_t *cigar;
  const int64_t *cigar_off;
  const int32_t *cigar_len;
  const uint8_t *seq_nib;
  const int64_t *seq_off;
  const int32_t *lqseq;
  long long start, end;
  const int64_t *cell_of;
  const int64_t *ins_len;
  long long n_dp;
  const int32_t *refkmer;
  int trim_len_edge;
};

// Walk reads [s_lo, s_hi) of ridx, recording only cells in [acc.lo, acc.hi)
// anchored at positions <= pos_hi (the per-thread early-exit bound).
template <class A>
void walk(const WalkArgs &a, A &acc, long long s_lo, long long s_hi,
          long long pos_hi) {
  const long long start = a.start, end = a.end;
  for (long long s = s_lo; s < s_hi; s++) {
    const long long r = a.ridx[s];
    const int32_t lq = a.lqseq[r];
    const int32_t ncig = a.cigar_len[r];
    if (ncig <= 0 || lq <= 0) continue;
    const uint32_t *cig = a.cigar + a.cigar_off[r];
    const uint8_t *nib = a.seq_nib + a.seq_off[r];

    // trims (contig_cut_read, lib/contig.c:333-358)
    long long lsoft = ((cig[0] & 0xF) == CSOFT) ? (cig[0] >> 4) : 0;
    const uint32_t lastw = cig[ncig - 1];
    long long rsoft = ((lastw & 0xF) == CSOFT) ? (lastw >> 4) : 0;
    long long qstart = a.trim_len_edge + lsoft;
    long long qend = (long long)lq - a.trim_len_edge - rsoft - 1;
    if (a.trim_len_edge > 0) {
      // homopolymer extension over raw nibbles (as _read_trims does)
      while (qstart > 0 && qstart < lq && nib[qstart] == nib[qstart - 1])
        qstart++;
      while (qend >= 0 && qend < lq - 1 && nib[qend] == nib[qend + 1]) qend--;
    }

    // ---- gapless fast path: [S] M [S] fully inside the region with no
    // insert slots under the span (the overwhelmingly common case for
    // short reads).  Emissions are then one contiguous cell run with no
    // pass-through padding, so the guarded per-op walk collapses to a
    // tight rolling-kmer loop.
    {
      const int mi = (ncig == 1) ? 0 : ((cig[0] & 0xF) == CSOFT ? 1 : 0);
      const bool shape_ok =
          (ncig == 1 + mi + (((cig[ncig - 1] & 0xF) == CSOFT && ncig > 1)
                                 ? 1
                                 : 0)) &&
          (cig[mi] & 0xF) == CMATCH;
      if (shape_ok && qend >= qstart) {
        const long long mlen = cig[mi] >> 4;
        const long long pos0 = a.rpos[r];
        if (pos0 >= start && pos0 + mlen - 1 <= end && mlen > 0 &&
            a.cell_of[pos0 + mlen - 1 - start] -
                    a.cell_of[pos0 - start] == mlen - 1) {
          // emissions: query q in [qstart, qend] -> cell c0 + (q - lsoft)
          const long long c0 = a.cell_of[pos0 - start] - lsoft;
          int kmer = 0;
          for (long long qp = qstart; qp <= qend; qp++) {
            kmer = kshift(kmer, NIB2SYM[nib[qp] & 0xF]);
            acc.add(c0 + qp, kmer);
          }
          continue;
        }
      }
    }

    long long pos = a.rpos[r];
    long long qpos = 0;
    int kmer = 0;
    int lastcig = CINS;
    for (int32_t w = 0; w < ncig; w++) {
      const int op = cig[w] & 0xF;
      const long long ln = cig[w] >> 4;
      if (op == CMATCH || op == CDEL) {
        for (long long b = 0; b < ln; b++) {
          if (pos >= start && pos <= end && qpos >= qstart && qpos <= qend) {
            if (lastcig != CINS && pos > start &&
                (qpos > qstart || (qpos == qstart && lastcig == CDEL))) {
              // pass-through DEL padding of the previous anchor's slots
              const long long an = pos - 1 - start;
              const long long cell = a.cell_of[an];
              const long long il = a.ins_len[an];
              for (long long k = 0; k < il; k++) {
                kmer = kshift(kmer, SYM_DEL);
                acc.add(cell + 1 + k, kmer);
              }
            }
            const int sym =
                (op == CDEL) ? SYM_DEL : NIB2SYM[nib[qpos] & 0xF];
            kmer = kshift(kmer, sym);
            acc.add(a.cell_of[pos - start], kmer);
          }
          if (op != CDEL) qpos++;
          pos++;
          lastcig = op;
        }
      } else if (op == CINS) {
        if (pos) {
          const long long an = pos - 1 - start;
          const bool inr = (pos > start && pos <= end);
          const long long il = inr ? a.ins_len[an] : 0;
          const long long cell = inr ? a.cell_of[an] : 0;
          for (long long j = 0; j < ln; j++) {
            // the j < il clip mirrors expand_reads' slot-count guard
            if (inr && qpos >= qstart && qpos <= qend && j < il) {
              kmer = kshift(kmer, NIB2SYM[nib[qpos] & 0xF]);
              acc.add(cell + 1 + j, kmer);
            }
            qpos++;
          }
          if (inr && qpos > qstart && qpos <= qend + 1) {
            for (long long j = ln; j < il; j++) {
              kmer = kshift(kmer, SYM_DEL);
              acc.add(cell + 1 + j, kmer);
            }
          }
          lastcig = op;
        } else {
          qpos += ln;
          qstart += ln;
          lastcig = op;
        }
      } else if (op == CSOFT || op == CHARD) {
        qpos += ln;
      }
      // insertions anchored at pos_hi+1-1 == pos_hi are still owned, so
      // the walk may stop only once pos exceeds pos_hi+1
      if (pos > end || pos > pos_hi + 1) break;
    }
  }
}

// Slot-line accumulator for the plane-format pack (pack_chain_planes
// semantics, ops/tropical.py): per cell one 32-byte line of up to 8
// u32 slots (kmer<<16 | count, saturating u16), filled in
// first-observation order — the slot index IS the insertion rank, so
// the walk emits the transfer planes directly with no dense [cells*512]
// table, no dirty-list sort, and an L1-resident working set.  Distinct
// kmers beyond 8 spill to a small per-thread hash (rare).
struct SlotAcc {
  uint32_t *slots;  // [n_cells * 8], caller-zeroed
  int32_t *totals;
  long long lo, hi;  // owned cell range
  std::unordered_map<int64_t, std::pair<int32_t, int32_t>> sp;  // key ->
                                                                // (cnt, rank)
  std::unordered_map<int64_t, int32_t> spn;  // cell -> spill count
  inline void add(long long cell, int kmer) {
    if (cell < lo || cell >= hi) return;
    totals[cell]++;
    uint32_t *s = slots + cell * 8;
    const uint32_t tag = (uint32_t)kmer << 16;
    for (int j = 0; j < 8; j++) {
      const uint32_t w = s[j];
      if (w == 0) {  // first observation -> next free slot (rank j)
        s[j] = tag | 1;
        return;
      }
      if ((w & 0xFFFF0000u) == tag) {
        if ((w & 0xFFFFu) != SAT) s[j] = w + 1;
        return;
      }
    }
    const int64_t key = cell * 512 + kmer;
    auto it = sp.find(key);
    if (it == sp.end())
      sp.emplace(key, std::make_pair(1, 8 + spn[cell]++));
    else if (it->second.first != (int32_t)SAT)
      it->second.first++;
  }
};

}  // namespace

extern "C" {

// Accumulate the pileup of the selected reads (+ optional contig-as-read)
// into counts[n_cells*512] / totals[n_cells].  `counts` must be all-zero on
// entry; this function restores it to all-zero before returning (the caller
// keeps one persistent scratch buffer — no per-call zeroing of the full
// table).  Emits the sorted nonzero (key, count, first-observation rank)
// triples via out_uk/out_cn/out_rk (malloc'd; free with npt_cns_free).
// `max_span` = an upper bound on any read's reference span (used to bound
// the binary-searched per-thread read subranges); n_threads <= 0 means one
// thread per hardware core.  Returns nnz, or -1 on bad input.
long long npt_pileup_sgs(
    const int64_t *ridx, long long n_sel, const int32_t *rpos,
    const uint32_t *cigar, const int64_t *cigar_off, const int32_t *cigar_len,
    const uint8_t *seq_nib, const int64_t *seq_off, const int32_t *lqseq,
    long long start, long long end, const int64_t *cell_of,
    const int64_t *ins_len, long long n_cells, long long n_dp,
    const int32_t *refkmer, int trim_len_edge, long long max_span,
    int n_threads, uint16_t *counts, int32_t *totals, int64_t **out_uk,
    int64_t **out_cn, int64_t **out_rk) {
  if (end < start || n_cells <= 0) return -1;
  const long long width = end - start + 1;
  std::vector<uint16_t> cellrank((size_t)n_cells, 0);

  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((long long)T > width) T = (int)width;
  if (n_sel < 4096) T = 1;  // threading overhead beats tiny workloads

  WalkArgs wa{ridx,    n_sel,   rpos,    cigar, cigar_off, cigar_len,
              seq_nib, seq_off, lqseq,   start, end,       cell_of,
              ins_len, n_dp,    refkmer, trim_len_edge};

  std::vector<Acc> accs;
  accs.reserve(T);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; t++) {
    // position range [ps, pe]; owned cells [cell_of[ps], cell_of[pe+1])
    const long long ps = start + width * t / T;
    const long long pe = start + width * (t + 1) / T - 1;
    const long long clo = cell_of[ps - start];
    const long long chi =
        (pe == end) ? n_cells
                    : cell_of[pe + 1 - start];
    accs.push_back(Acc{counts, totals, cellrank.data(), clo, chi, {}});
    accs.back().dirty.reserve(4096 + 3 * (size_t)(chi - clo));
  }
  for (int t = 0; t < T; t++) {
    const long long ps = start + width * t / T;
    const long long pe = start + width * (t + 1) / T - 1;
    Acc *acc = &accs[t];
    auto job = [&wa, acc, ps, pe, rpos, ridx, n_sel, max_span, n_dp]() {
      // contig-as-read (lib/contig.c:373-383): one emission per DP cell —
      // first, so its kmer ranks precede every read's (contig_as_read runs
      // before contig_parse_region, lib/contig.c:714-716)
      if (wa.refkmer) {
        const long long dlo = std::max(acc->lo, 0LL);
        const long long dhi = std::min(acc->hi, n_dp);
        for (long long c = dlo; c < dhi; c++)
          acc->add(c, wa.refkmer[c] & 0x1FF);
      }
      // reads that can reach [ps, pe]: pos in [ps - max_span, pe + 1]
      // (pos == pe+1 can anchor a leading insertion at pe)
      const long long plo = ps - max_span;
      long long s_lo = 0, s_hi = n_sel;
      {
        long long a = 0, b = n_sel;
        while (a < b) {
          const long long m = (a + b) / 2;
          if (rpos[ridx[m]] < plo) a = m + 1; else b = m;
        }
        s_lo = a;
        a = s_lo; b = n_sel;
        while (a < b) {
          const long long m = (a + b) / 2;
          if (rpos[ridx[m]] <= pe + 1) a = m + 1; else b = m;
        }
        s_hi = a;
      }
      walk(wa, *acc, s_lo, s_hi, pe);
      std::sort(acc->dirty.begin(), acc->dirty.end());
    };
    if (t == T - 1) job();
    else threads.emplace_back(job);
  }
  for (auto &th : threads) th.join();

  long long nnz = 0;
  for (auto &a : accs) nnz += (long long)a.dirty.size();
  int64_t *uk = (int64_t *)malloc(sizeof(int64_t) * (nnz ? nnz : 1));
  int64_t *cn = (int64_t *)malloc(sizeof(int64_t) * (nnz ? nnz : 1));
  int64_t *rk = (int64_t *)malloc(sizeof(int64_t) * (nnz ? nnz : 1));
  if (!uk || !cn || !rk) {
    free(uk);
    free(cn);
    free(rk);
    for (auto &a : accs)
      for (int64_t packed : a.dirty) counts[packed >> 9] = 0;
    return -1;
  }
  // threads own disjoint ascending cell ranges, so concatenating their
  // sorted dirty lists yields globally key-sorted output
  long long i = 0;
  for (auto &a : accs) {
    for (int64_t packed : a.dirty) {
      const int64_t key = packed >> 9;
      uk[i] = key;
      cn[i] = counts[key];
      rk[i] = packed & 0x1FF;
      counts[key] = 0;
      i++;
    }
  }
  *out_uk = uk;
  *out_cn = cn;
  *out_rk = rk;
  return nnz;
}

// Slot-walker variant emitting the chain-DP transfer planes directly
// (pack_chain_planes layout pieces, ops/tropical.py): upper[7 * n_dp]
// u16 rank-major planes (kmer<<7 | count; count 0 with the kmer kept
// when the count exceeds the 7-bit cap and diverts), c0[n_dp] u8 slot-0
// counts (0 when diverted or when slot 0's kmer mismatches refkmer),
// totals[n_cells] i32, stats[16] = {occ_hist[0..8] of KEPT dense
// entries per rank (8 = unused), s0mask at [9]}, and the malloc'd
// overflow list (cap-diverted + rank>=8 spills + refkmer mismatches),
// sorted by key with exact u16 counts and true ranks.  `slots` is a
// caller-zeroed [n_cells * 8] u32 scratch, restored to zero on return.
// Returns n_overflow, or -1 on bad input.
long long npt_pileup_planes(
    const int64_t *ridx, long long n_sel, const int32_t *rpos,
    const uint32_t *cigar, const int64_t *cigar_off, const int32_t *cigar_len,
    const uint8_t *seq_nib, const int64_t *seq_off, const int32_t *lqseq,
    long long start, long long end, const int64_t *cell_of,
    const int64_t *ins_len, long long n_cells, long long n_dp,
    const int32_t *refkmer, int trim_len_edge, long long max_span,
    int n_threads, uint32_t *slots, int32_t *totals, uint16_t *upper,
    uint8_t *c0, int32_t *stats, int64_t **ov_key, int64_t **ov_cn,
    int64_t **ov_rk) {
  if (end < start || n_cells <= 0 || n_dp <= 0) return -1;
  const long long width = end - start + 1;
  int T = n_threads > 0 ? n_threads
                        : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((long long)T > width) T = (int)width;
  if (n_sel < 4096) T = 1;

  WalkArgs wa{ridx,    n_sel,   rpos,    cigar, cigar_off, cigar_len,
              seq_nib, seq_off, lqseq,   start, end,       cell_of,
              ins_len, n_dp,    refkmer, trim_len_edge};

  std::vector<SlotAcc> accs;
  accs.reserve(T);
  for (int t = 0; t < T; t++) {
    const long long ps = start + width * t / T;
    const long long pe = start + width * (t + 1) / T - 1;
    const long long clo = cell_of[ps - start];
    const long long chi = (pe == end) ? n_cells : cell_of[pe + 1 - start];
    accs.push_back(SlotAcc{slots, totals, clo, chi, {}, {}});
  }
  // per-thread outputs of the emission half
  std::vector<std::vector<int64_t>> tov(T);  // key<<36 | cnt<<20 | rank
  std::vector<std::array<int64_t, 16>> tstats(T);
  for (auto &a : tstats) a.fill(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; t++) {
    const long long ps = start + width * t / T;
    const long long pe = start + width * (t + 1) / T - 1;
    SlotAcc *acc = &accs[t];
    auto *ovp = &tov[t];
    auto *stp = &tstats[t];
    auto job = [&wa, acc, ovp, stp, ps, pe, rpos, ridx, n_sel, max_span,
                n_dp, upper, c0, slots]() {
      // contig-as-read first (lib/contig.c:373-383): rank 0 everywhere
      if (wa.refkmer) {
        const long long dlo = std::max(acc->lo, 0LL);
        const long long dhi = std::min(acc->hi, n_dp);
        for (long long c = dlo; c < dhi; c++)
          acc->add(c, wa.refkmer[c] & 0x1FF);
      }
      const long long plo = ps - max_span;
      long long s_lo = 0, s_hi = n_sel;
      {
        long long a = 0, b = n_sel;
        while (a < b) {
          const long long m = (a + b) / 2;
          if (rpos[ridx[m]] < plo) a = m + 1; else b = m;
        }
        s_lo = a;
        a = s_lo; b = n_sel;
        while (a < b) {
          const long long m = (a + b) / 2;
          if (rpos[ridx[m]] <= pe + 1) a = m + 1; else b = m;
        }
        s_hi = a;
      }
      walk(wa, *acc, s_lo, s_hi, pe);
      // emission over the owned DP cells: planes + diversion + stats;
      // restore the slot scratch to zero as we go
      const long long dlo = std::max(acc->lo, 0LL);
      const long long dhi = std::min(acc->hi, n_dp);
      for (long long cell = dlo; cell < dhi; cell++) {
        uint32_t *s = slots + cell * 8;
        for (int j = 0; j < 8 && s[j]; j++) {
          const uint32_t w = s[j];
          const int kmer = (int)(w >> 16);
          const uint32_t cnt = w & 0xFFFFu;
          const bool mis0 =
              j == 0 && wa.refkmer && kmer != (wa.refkmer[cell] & 0x1FF);
          const uint32_t cap = j == 0 ? 255u : 127u;
          if (mis0 || cnt > cap) {
            // diverted entries leave their dense slot EMPTY (the caller
            // hands zeroed planes), exactly like the numpy pack
            ovp->push_back(((cell * 512 + kmer) << 28) |
                           ((int64_t)cnt << 12) | j);
          } else {
            (*stp)[j]++;
            if (j == 0) c0[cell] = (uint8_t)cnt;
            else
              upper[(j - 1) * n_dp + cell] =
                  (uint16_t)((kmer << 7) | cnt);
          }
          if (cell == 0)
            (*stp)[9] |= 1LL << ((kmer >> 3) & 7);
          s[j] = 0;
        }
      }
      // spills: always overflow, true ranks
      for (auto &kv : acc->sp) {
        const int64_t key = kv.first;
        const long long cell = key >> 9;
        if (cell < dlo || cell >= dhi) continue;  // non-DP cells drop
        ovp->push_back((key << 28) | ((int64_t)kv.second.first << 12) |
                       kv.second.second);
        if (cell == 0) (*stp)[9] |= 1LL << (((key & 0x1FF) >> 3) & 7);
      }
      // zero any non-DP cells this shard touched (insert slots past
      // n_dp and range overlap padding)
      for (long long cell = std::max(acc->lo, n_dp); cell < acc->hi;
           cell++) {
        uint32_t *s = slots + cell * 8;
        for (int j = 0; j < 8 && s[j]; j++) s[j] = 0;
      }
      std::sort(ovp->begin(), ovp->end());
    };
    if (t == T - 1) job();
    else threads.emplace_back(job);
  }
  for (auto &th : threads) th.join();

  long long nov = 0;
  for (auto &v : tov) nov += (long long)v.size();
  int64_t *ok = (int64_t *)malloc(8 * (size_t)(nov ? nov : 1));
  int64_t *oc = (int64_t *)malloc(8 * (size_t)(nov ? nov : 1));
  int64_t *orr = (int64_t *)malloc(8 * (size_t)(nov ? nov : 1));
  if (!ok || !oc || !orr) {
    free(ok); free(oc); free(orr);
    return -1;
  }
  long long i = 0;
  for (auto &v : tov)  // disjoint ascending cell ranges -> sorted concat
    for (int64_t packed : v) {
      ok[i] = packed >> 28;
      oc[i] = (packed >> 12) & 0xFFFF;
      orr[i] = packed & 0xFFF;
      i++;
    }
  *ov_key = ok;
  *ov_cn = oc;
  *ov_rk = orr;
  int64_t hist[16];
  for (int j = 0; j < 16; j++) hist[j] = 0;
  for (auto &a : tstats) {
    for (int j = 0; j < 9; j++) hist[j] += a[j];
    hist[9] |= a[9];
  }
  for (int j = 0; j < 16; j++) stats[j] = (int32_t)hist[j];
  return nov;
}

// Insertion-slot discovery (contig_create_insert, lib/contig.c:170-245):
// ins_len[p - start] = max insertion length anchored after position p over
// the selected reads.  One pass over the cigars — replaces the numpy
// flat-op expansion on the task-1 host hot path (build_cell_index).
// ins_len must be zeroed by the caller (width = end - start + 1).
long long npt_cell_index(
    const int64_t *ridx, long long n_sel, const int32_t *rpos,
    const uint32_t *cigar, const int64_t *cigar_off, const int32_t *cigar_len,
    long long start, long long end, int64_t *ins_len) {
  for (long long s = 0; s < n_sel; s++) {
    const long long r = ridx[s];
    const int32_t ncig = cigar_len[r];
    if (ncig <= 0) continue;
    const uint32_t *cig = cigar + cigar_off[r];
    long long pos = rpos[r];
    for (int32_t w = 0; w < ncig; w++) {
      const int op = cig[w] & 0xF;
      const long long ln = cig[w] >> 4;
      if (op == CINS) {
        if (pos > start && pos <= end) {
          int64_t &m = ins_len[pos - 1 - start];
          if (ln > m) m = ln;
        }
      } else if (op == CMATCH || op == CDEL || op == 3 /*REF_SKIP*/ ||
                 op == 7 || op == 8) {
        pos += ln;
        if (pos > end + 1) break;
      }
    }
  }
  return 0;
}

}  // extern "C"
