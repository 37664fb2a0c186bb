// Engine-2 level scan (second-order link DP over a window's levels) for
// NVIDIA Hopper, sm_90a: two kernels, the chain and the winners.
//
// Replaces nextpolish_tpu/models/cns/pallas_scan.py::_kernel, the TPU
// kernel, and computes what it computes (and what the lax.scan twin
// nextpolish_tpu/models/cns/device_dp.py::_dp_level computes): for every
// level (an occupied (t_pos, delta) pair, in DP order), every base cell
// (6) and every entry slot (E <= 24, insertion order):
//
//   w      = 10*link - cov_coef*cov
//   pred   = the pp_idx row of the boundary ring (Vb position slots) or of
//            the previous level
//   n_best = max of pred over the set match bits, n_last = pred at the
//            last set bit (slot 0 when none is set)
//   sc     = head ? w : match ? max(n_best + w, 0) : 0, NEG when invalid
//
// with the carry update of _dp_level (prev <- sc; a delta-0 level resets
// the ring to NEG and then writes its own ring slot), and then one winning
// slot per cell by the read-type rules (template RT: 0 ont, 1 clr, 2 rs,
// 3 hifi) and the common final rule.
//
// What bounds it.  Not bytes and not operations: each level reads the
// scores of the level before it or of the ring, so the levels of a window
// form one dependency chain, and the time is the chain length times the
// latency of one level.  The floor is one dependent shared-memory
// load -> store step per level, 33 SM cycles as npt_smem_step_cycles
// below measures it on an H100.  The first design of this kernel spent
// about 3,000 cycles per level: two block-wide barriers, the serial winner
// loop and two dependent global loads sat on the chain.  This design
// reaches about 420 cycles per level (0.21 us at 1.98 GHz; PERF.md has the
// measurements) by keeping on the chain warp only what the chain needs:
//
//  * Winner selection leaves the chain.  The winner rules read no carry,
//    so level_chain_kernel writes each entry's sc, n_best (and, for ONT,
//    n_last) to device memory in entry-stream order, and
//    level_winners_kernel, one thread per level over every window, applies
//    the rules afterwards, with the whole card instead of six threads.
//  * No global load on the chain.  A producer warp stages chunks of kChunk
//    levels (meta, level offsets, entry words) into kStages shared-memory
//    stages with 1-D bulk copies (TMA) whose arrival completes an
//    mbarrier.  Two decoder warps then turn each level into one 16-byte
//    record per lane: the carry cells of up to five match bits, the
//    stamp's source, the weight and the flags.  The chain warp waits once
//    per chunk, and loads the next level's record, at an address it knows
//    in advance, while it scores the current one.
//  * No block-wide barrier per level.  One warp per window scores the
//    level's entries, one per lane, gathers their predecessors from the
//    carry in shared memory and writes the carry.  Only __syncwarp orders
//    a level: once between the gather and the carry writes (a delta-0
//    level may overwrite a ring row it reads), once after the writes.  A
//    level of over 32 entries, or with an entry of over five match bits,
//    is "wide": the chain warp scores it from the staged stream, lanes
//    looping over its entries.
//  * O(1) carry reset.  Every carry cell holds (score, stamp), the level
//    that wrote it.  prev is double-buffered by level parity and is live
//    where its stamp is the previous level; ring row v is live where its
//    stamp equals the level that last wrote row v, which lane v keeps in a
//    register (-1 after a delta-0 reset).  A cell that no live level wrote
//    reads NEG, as in the cleared carry of _dp_level, and a reset costs one
//    register write per lane instead of Vb*6*E shared stores.
//
// Entries arrive as the compact level-major stream of level_scan.py, in
// (cell, slot) order within a level, with at most 6*E entries a level and
// match bits below E (device_dp.pack_batch checks all three); the winners
// kernel relies on the order to walk the slots in insertion order.  All
// arithmetic is int32 and byte-equal to the JAX package.  The wrapper
// asserts on the card, before the winners launch, that every link is
// >= 0, so C's truncating division matches JAX's floor division in the ONT
// rules.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 24;
constexpr int kMaxVb = 24;
constexpr int kCells = 6;
constexpr int kCols = kCells * kMaxE;  // (cell, slot) columns of a level
constexpr int kWinFields = 8;
constexpr int kNeg = -(1 << 29);
constexpr int kNegInit = -(1 << 30);
constexpr int kNoStamp = -2;  // no level wrote the cell

constexpr int kValid = 1;
constexpr int kHead = 2;
constexpr int kCond1a = 4;
constexpr int kCond2b = 8;
constexpr int kPpbNotGap = 16;

constexpr unsigned kFull = 0xffffffffu;

// ---- chain kernel ---------------------------------------------------------
constexpr int kChunk = 32;                   // levels per staged chunk
constexpr int kChunkEnt = kChunk * kCols;    // entries a chunk can hold
constexpr int kStages = 3;
constexpr int kPerLane = (kCols + 31) / 32;  // entries per lane and level
constexpr int kDecoders = 2;                 // decoder warps
// warp 0 the chain, warp 1 the producer, warps 2.. the decoders
constexpr int kChainThreads = 32 * (2 + kDecoders);

// A bulk copy moves whole 16-byte granules, so a staged range starts up to
// 15 bytes early and ends up to 15 bytes late.  Every granule it reads
// holds at least one byte of the range, so it never leaves the pages of
// the source tensor.
struct Stage {
  alignas(16) int4 rec[kChunk][32];  // per level and lane: see make_record
  alignas(16) int32_t rec_o0[kChunk];  // per level: its first entry
  alignas(16) int32_t A[kChunkEnt + 8];
  alignas(16) int32_t M[kChunkEnt + 8];
  alignas(16) int8_t b[kChunkEnt + 32];
  alignas(16) int8_t s[kChunkEnt + 32];
  alignas(16) int32_t meta[kChunk + 8];
  alignas(16) int32_t off[kChunk + 8];  // kChunk + 1 level offsets
};

// The carry, (score, stamp) cells in one array: ring row pp = v*6 + cell
// at pp*kMaxE, then the previous level's scores by level parity.  A cell
// index fits 12 bits.
constexpr int kRingCells = kMaxVb * kCols;
constexpr int kCarryCells = kRingCells + 2 * kCols;
static_assert(kCarryCells <= 4096, "carry cell index must fit 12 bits");

__device__ __forceinline__ int prev_cell(int l, int col) {
  return kRingCells + (l & 1) * kCols + col;
}

struct ChainSmem {
  int2 carry[kCarryCells];
  Stage st[kStages];
  uint64_t full[kStages];     // the chunk's bytes have landed
  uint64_t decoded[kStages];  // the decoders have written its records
  uint64_t empty[kStages];    // the chain is done with the stage
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Element index at which base[lo] lands in a granule-aligned copy.
template <typename T>
__device__ __forceinline__ int shift_of(const T* base, int lo) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(base + lo) & 15) /
                          sizeof(T));
}

// Bytes of the granules that hold base[lo, hi): what bulk_load copies, and
// what the stage's barrier is told to expect.
template <typename T>
__device__ __forceinline__ uint32_t bulk_bytes(const T* base, int lo,
                                               int hi) {
  if (hi <= lo) return 0;
  const uintptr_t p0 = reinterpret_cast<uintptr_t>(base + lo);
  const uintptr_t p1 = reinterpret_cast<uintptr_t>(base + hi);
  return static_cast<uint32_t>(((p1 + 15) & ~uintptr_t(15)) -
                               (p0 & ~uintptr_t(15)));
}

// Copies those granules to dst, so base[lo] lands at
// dst[shift_of(base, lo)]; completion counts on the barrier.
template <typename T>
__device__ __forceinline__ void bulk_load(T* dst, const T* base, int lo,
                                          int hi, uint64_t* bar) {
  const uint32_t bytes = bulk_bytes(base, lo, hi);
  if (bytes == 0) return;
  const uintptr_t a0 =
      reinterpret_cast<uintptr_t>(base + lo) & ~uintptr_t(15);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(a0), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Inputs {
  const int32_t* A;
  const int32_t* M;
  const int8_t* b;
  const int8_t* s;
  const int32_t* off;
  const int32_t* meta;
};

// The producer (one thread): stages the window's chunks in order, each
// into the stage its chunk number names, once the chain warp has released
// that stage's previous chunk.
__device__ void produce(ChainSmem& S, const Inputs& in, int lb,
                        int n_levels) {
  const int n_chunks = (n_levels + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kStages;
    if (c >= kStages) mbar_wait(&S.empty[st], ((c / kStages) - 1) & 1);
    const int g0 = lb + c * kChunk;
    const int g1 = lb + min((c + 1) * kChunk, n_levels);
    const int e0 = in.off[g0];
    const int e1 = in.off[g1];
    if (e1 - e0 > kChunkEnt) __trap();  // over 6*24 entries a level
    Stage& T = S.st[st];
    uint64_t* bar = &S.full[st];
    mbar_arrive_expect_tx(
        bar, bulk_bytes(in.off, g0, g1 + 1) + bulk_bytes(in.meta, g0, g1) +
                 bulk_bytes(in.A, e0, e1) + bulk_bytes(in.M, e0, e1) +
                 bulk_bytes(in.b, e0, e1) + bulk_bytes(in.s, e0, e1));
    bulk_load(T.off, in.off, g0, g1 + 1, bar);
    bulk_load(T.meta, in.meta, g0, g1, bar);
    bulk_load(T.A, in.A, e0, e1, bar);
    bulk_load(T.M, in.M, e0, e1, bar);
    bulk_load(T.b, in.b, e0, e1, bar);
    bulk_load(T.s, in.s, e0, e1, bar);
  }
}

// Where the chain warp finds a staged chunk: staged element i + bias of
// each array holds window-local level i (meta, off) or global entry i.
struct ChunkView {
  const Stage* T;
  int b_meta, b_off, b_A, b_M, b_b, b_s;
};

// The view of chunk c, once its stage holds it.
__device__ __forceinline__ ChunkView chunk_view(const ChainSmem& S,
                                                const Inputs& in, int c,
                                                int lb) {
  ChunkView v;
  v.T = &S.st[c % kStages];
  const int l0 = c * kChunk;
  v.b_meta = shift_of(in.meta, lb + l0) - l0;
  v.b_off = shift_of(in.off, lb + l0) - l0;
  const int e0 = v.T->off[l0 + v.b_off];
  v.b_A = shift_of(in.A, e0) - e0;
  v.b_M = shift_of(in.M, e0) - e0;
  v.b_b = shift_of(in.b, e0) - e0;
  v.b_s = shift_of(in.s, e0) - e0;
  return v;
}

// One entry as the chain needs it, decoded from the staged stream:
// everything but the carry reads.
struct Entry {
  int a;          // A word (0 where the lane has no entry: scores NEG)
  int has;        // the lane holds an entry of the level
  int col;        // cell * kMaxE + slot
  int from_prev;  // the predecessor row is the previous level's
  int row;        // else its ring row v, whose stamp lane v keeps
  int src;        // carry cell of the predecessor row's slot 0
  int any;        // a match bit is set
  int i0, i1, i2, i3;  // the lowest three and the second-highest match
  int il;              // bit (repeated when fewer), the highest (0: none)
  unsigned more;       // match bits past those five
  int wgt;             // 10*link - cov_coef*cov
};

__device__ __forceinline__ int low_bit(unsigned m, int dflt) {
  return m ? __ffs(m) - 1 : dflt;
}

__device__ __forceinline__ int high_bit(unsigned m, int dflt) {
  return m ? 31 - __clz(m) : dflt;
}

// Entry k of the staged stream at level l; a lane past the level's end
// reads the level's first entry and drops it (a = 0).
__device__ __forceinline__ Entry load_entry(const ChunkView& v, int k,
                                            bool has, int l, int cov,
                                            int vb6, int cov_coef) {
  const Stage* T = v.T;
  Entry e;
  e.has = has;
  e.a = has ? T->A[k + v.b_A] : 0;
  const unsigned m = has ? static_cast<unsigned>(T->M[k + v.b_M]) : 0u;
  e.col = has ? T->b[k + v.b_b] * kMaxE + T->s[k + v.b_s] : 0;
  const int pp = (e.a >> 8) & 0xFF;
  e.from_prev = pp >= vb6;
  e.row = e.from_prev ? 0 : pp / kCells;
  e.src = e.from_prev ? prev_cell(l - 1, (pp - vb6) * kMaxE) : pp * kMaxE;
  // five bit positions in two dependent rounds
  e.any = m != 0;
  e.i0 = low_bit(m, 0);
  e.il = high_bit(m, 0);
  const unsigned mid = m & ~(1u << e.i0) & ~(1u << e.il);
  e.i1 = low_bit(mid, e.i0);
  e.i3 = high_bit(mid, e.i0);
  const unsigned mid2 = mid & ~(1u << e.i1) & ~(1u << e.i3);
  e.i2 = low_bit(mid2, e.i0);
  e.more = mid2 & ~(1u << e.i2);
  e.wgt = 10 * (e.a >> 16) - cov_coef * cov;
  return e;
}

__device__ __forceinline__ int live(int2 cell, int stamp) {
  return cell.y == stamp ? cell.x : kNeg;
}

__device__ __forceinline__ int score(int a, int wgt, int best) {
  const int matched = best > kNeg / 2 ? max(best + wgt, 0) : 0;
  const int sc = (a & kHead) ? wgt : matched;
  return (a & kValid) ? sc : kNeg;
}

// A level's record for one lane, 16 bytes, written by the decoders and
// read by the chain warp in one load (c = the carry cell of a named match
// bit: i0, i1, i2, i3, il):
//   x: c0 | c1 << 12 | col << 24
//   y: c2 | c3 << 12 | any << 24 | valid << 25 | head << 26 | has << 27 |
//      from_prev << 28 | is_d0 << 29 | wide << 31
//   z: cl | (vslot + 1) << 12 | row << 17
//   w: wgt
// wide is the same on every lane of a level: over 32 entries, or an entry
// with over five match bits; the chain then reads the staged stream.
__device__ __forceinline__ int4 make_record(const Entry& e, int mt,
                                            bool wide) {
  int4 r;
  r.x = (e.src + e.i0) | (e.src + e.i1) << 12 | e.col << 24;
  r.y = (e.src + e.i2) | (e.src + e.i3) << 12 | e.any << 24 |
        (e.a & kValid) << 25 | ((e.a & kHead) != 0) << 26 | e.has << 27 |
        e.from_prev << 28 | ((mt >> 1) & 1) << 29 |
        static_cast<int>(static_cast<unsigned>(wide) << 31);
  r.z = (e.src + e.il) | ((mt >> 2) & 0x1F) << 12 | e.row << 17;
  r.w = e.wgt;
  return r;
}

// The decoders (warps 2..): once a chunk has landed, decoder d writes the
// records of the chunk's levels d, d + kDecoders, ..., then each of its
// lanes arrives on the chunk's `decoded` barrier.  Off the chain: the
// chain warp reads one record per level and lane, at an address it knows
// in advance.
__device__ void decode_chunks(ChainSmem& S, const Inputs& in, int lb,
                              int n_levels, int d, int lane, int vb6,
                              int cov_coef) {
  const int n_chunks = (n_levels + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kStages;
    mbar_wait(&S.full[st], (c / kStages) & 1);
    const ChunkView v = chunk_view(S, in, c, lb);
    Stage& T = S.st[st];
    const int l0 = c * kChunk;
    const int l1 = min(l0 + kChunk, n_levels);
    for (int l = l0 + d; l < l1; l += kDecoders) {
      const int mt = T.meta[l + v.b_meta];
      const int o0 = T.off[l + v.b_off];
      const int n = T.off[l + 1 + v.b_off] - o0;
      if (n > 32 * kPerLane) __trap();  // over 6*24 entries a level
      const bool has = lane < n;
      const Entry e = load_entry(v, has ? o0 + lane : o0, has, l, mt >> 8,
                                 vb6, cov_coef);
      const bool wide = __any_sync(kFull, e.more != 0) || n > 32;
      T.rec[l - l0][lane] = make_record(e, mt, wide);
      if (lane == 0) T.rec_o0[l - l0] = o0;
    }
    mbar_arrive(&S.decoded[st]);
  }
}

// A wide level: lane j scores entries j, j+32, ... from the staged stream
// (E up to 24 gives up to 144), and writes the carry only after every lane
// has gathered.
template <bool kLast>
__device__ void wide_level(ChainSmem& S, const ChunkView& v, int l, int lane,
                           int rowlvl, int vb6, int cov_coef, int vslot,
                           int32_t* out_sc, int32_t* out_nb,
                           int32_t* out_nl) {
  const Stage* T = v.T;
  const int cov = T->meta[l + v.b_meta] >> 8;
  const int o0 = T->off[l + v.b_off];
  const int n = T->off[l + 1 + v.b_off] - o0;
  Entry e[kPerLane];
  int sc[kPerLane], nb[kPerLane], nl[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    sc[i] = nb[i] = nl[i] = kNeg;
    if (32 * i < n) {  // warp-uniform
      const int j = lane + 32 * i;
      e[i] = load_entry(v, j < n ? o0 + j : o0, j < n, l, cov, vb6,
                        cov_coef);
      // every lane shuffles (a ring stamp is lane row's register)
      const int ring_stamp = __shfl_sync(kFull, rowlvl, e[i].row);
      const int stamp = e[i].from_prev ? l - 1 : ring_stamp;
      const int2* src = S.carry + e[i].src;
      int best = max(max(live(src[e[i].i0], stamp), live(src[e[i].i1], stamp)),
                     max(live(src[e[i].i2], stamp),
                         max(live(src[e[i].i3], stamp),
                             live(src[e[i].il], stamp))));
      best = e[i].any ? best : kNeg;
      for (unsigned mm = e[i].more; mm; mm &= mm - 1)
        best = max(best, live(src[__ffs(mm) - 1], stamp));
      nb[i] = best;
      nl[i] = live(src[e[i].il], stamp);
      sc[i] = score(e[i].a, e[i].wgt, best);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = lane + 32 * i;
    if (32 * i < n && j < n) {
      const int2 cell = make_int2(sc[i], l);
      S.carry[prev_cell(l, e[i].col)] = cell;
      if (vslot >= 0) S.carry[vslot * kCols + e[i].col] = cell;
      const int k = o0 + j;
      out_sc[k] = sc[i];
      out_nb[k] = nb[i];
      if (kLast) out_nl[k] = nl[i];
    }
  }
}

// Waits until the decoders have written chunk c; returns its view.
__device__ __forceinline__ ChunkView decoded_chunk(ChainSmem& S,
                                                   const Inputs& in, int c,
                                                   int lb) {
  mbar_wait(&S.decoded[c % kStages], (c / kStages) & 1);
  return chunk_view(S, in, c, lb);
}

template <bool kLast>
__global__ void __launch_bounds__(kChainThreads, 1)
    level_chain_kernel(Inputs in, const int32_t* __restrict__ win,
                       int cov_coef, int32_t* __restrict__ out_sc,
                       int32_t* __restrict__ out_nb,
                       int32_t* __restrict__ out_nl) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ChainSmem& S = *reinterpret_cast<ChainSmem*>(smem_raw);
  const int32_t* wp = win + blockIdx.x * kWinFields;
  const int lb = wp[0];
  const int n_levels = wp[1];
  const int vb6 = wp[3] * kCells;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kCarryCells; i += kChainThreads)
    S.carry[i] = make_int2(kNeg, kNoStamp);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&S.full[st], 1);
      mbar_init(&S.decoded[st], 32 * kDecoders);  // every decoder lane
      mbar_init(&S.empty[st], 32);                // every chain lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_levels <= 0) return;
  if (warp == 1) {
    if (lane == 0) produce(S, in, lb, n_levels);
    return;
  }
  if (warp >= 2) {
    decode_chunks(S, in, lb, n_levels, warp - 2, lane, vb6, cov_coef);
    return;
  }

  // ---- the chain warp --------------------------------------------------
  // Per level: the gather from the carry at the cells the record names,
  // the next level's record (its address is known), the score, the carry
  // write.  vnext is the chunk of level l+1, entered at the end of l-1.
  int2* C = S.carry;
  int rowlvl = -1;  // lane v < Vb: the level that last wrote ring row v
  ChunkView vcur = decoded_chunk(S, in, 0, lb);
  ChunkView vnext = vcur;
  int4 rec = vcur.T->rec[0][lane];
  int o0 = vcur.T->rec_o0[0];
  for (int l = 0; l < n_levels; ++l) {
    const int4 r = rec;
    const int k = o0 + lane;
    const int vslot = ((r.z >> 12) & 0x1F) - 1;
    const int l_next = min(l + 1, n_levels - 1) & (kChunk - 1);
    if (r.y >= 0) {  // warp-uniform: one entry a lane, at most five bits
      // the dependent loads first ...
      const int ring_stamp = __shfl_sync(kFull, rowlvl, (r.z >> 17) & 0x1F);
      const int2 v0 = C[r.x & 0xFFF], v1 = C[(r.x >> 12) & 0xFFF];
      const int2 v2 = C[r.y & 0xFFF], v3 = C[(r.y >> 12) & 0xFFF];
      const int2 vl = C[r.z & 0xFFF];
      // ... then the next level's record while they are in flight
      rec = vnext.T->rec[l_next][lane];
      o0 = vnext.T->rec_o0[l_next];
      const int stamp = (r.y >> 28) & 1 ? l - 1 : ring_stamp;
      int best = max(max(live(v0, stamp), live(v1, stamp)),
                     max(live(v2, stamp), max(live(v3, stamp),
                                              live(vl, stamp))));
      best = (r.y >> 24) & 1 ? best : kNeg;
      // y's valid and head bits, shifted down, are A's kValid and kHead
      const int sc = score((r.y >> 25) & (kValid | kHead), r.w, best);
      __syncwarp();
      if ((r.y >> 27) & 1) {
        const int col = (r.x >> 24) & 0xFF;
        const int2 cell = make_int2(sc, l);
        C[prev_cell(l, col)] = cell;
        if (vslot >= 0) C[vslot * kCols + col] = cell;
        out_sc[k] = sc;
        out_nb[k] = best;
        if (kLast) out_nl[k] = live(vl, stamp);
      }
    } else {
      rec = vnext.T->rec[l_next][lane];
      o0 = vnext.T->rec_o0[l_next];
      wide_level<kLast>(S, vcur, l, lane, rowlvl, vb6, cov_coef, vslot,
                        out_sc, out_nb, out_nl);
    }
    if ((r.y >> 29) & 1)  // delta-0: every ring row but its own is reset
      rowlvl = lane == vslot ? l : -1;
    else if (lane == vslot)
      rowlvl = l;
    __syncwarp();

    // level l was the last of its chunk: hand its stage back; level l+2
    // opens a chunk: wait for its records
    if ((l + 1) % kChunk == 0) {
      mbar_arrive(&S.empty[(l / kChunk) % kStages]);
      vcur = vnext;
    }
    if ((l + 2) % kChunk == 0 && l + 2 < n_levels)
      vnext = decoded_chunk(S, in, (l + 2) / kChunk, lb);
  }
}

// ---- winners kernel -------------------------------------------------------
constexpr int kWinnerThreads = 128;

// One thread per (window, level): walks the level's entries cell by cell
// (slots ascending) and applies the read-type rules, then the common final
// rule, exactly as _dp_level's loop over slots.
template <int RT>
__global__ void __launch_bounds__(kWinnerThreads)
    level_winners_kernel(const int32_t* __restrict__ ent_A,
                         const int8_t* __restrict__ ent_b,
                         const int8_t* __restrict__ ent_slot,
                         const int32_t* __restrict__ lvl_off,
                         const int32_t* __restrict__ meta,
                         const int32_t* __restrict__ win,
                         const int32_t* __restrict__ ent_sc,
                         const int32_t* __restrict__ ent_nb,
                         const int32_t* __restrict__ ent_nl,
                         int8_t* __restrict__ best_out,
                         int32_t* __restrict__ sc_out) {
  const int32_t* wp = win + blockIdx.y * kWinFields;
  const int l = blockIdx.x * kWinnerThreads + threadIdx.x;
  if (l >= wp[1]) return;
  const int g = wp[0] + l;
  const int sc_from = wp[4];
  const int sc_base = wp[5];
  const int cov = meta[g] >> 8;
  const int hi = lvl_off[g + 1];
  int k = lvl_off[g];
  for (int c = 0; c < kCells; ++c) {
    const int k0 = k;
    while (k < hi && ent_b[k] == c) ++k;  // cell c: entries [k0, k)
    int bm = 0;
    int sc_bm = kNeg;  // an empty slot 0 scores NEG with link 0
    int link_bm = 0;
    if (k0 < k && ent_slot[k0] == 0) {
      sc_bm = ent_sc[k0];
      link_bm = ent_A[k0] >> 16;
    }
    int p_pp = kNegInit;
    int raiser = kNegInit;
    int tmp = 0;
    if (RT == 0) {
      for (int j = k0; j < k; ++j) {
        const int as = ent_A[j];
        if (as & kValid) tmp = max(tmp, as >> 16);
      }
    }
    for (int j = k0; j < k; ++j) {
      const int as = ent_A[j];
      if (!(as & kValid)) continue;  // every update below needs valid
      const int s = ent_slot[j];
      const int sc_e = ent_sc[j];
      const int nb = ent_nb[j];
      const int ln = as >> 16;
      const bool ng = as & kPpbNotGap;
      const bool hm = !(as & kHead) && nb > kNeg / 2;
      if (sc_e > 0) raiser = nb;
      if (RT == 1 || RT == 3) {  // clr / hifi
        if (hm && (nb > p_pp || (nb == p_pp && ng))) {
          bm = s;
          sc_bm = sc_e;
          link_bm = ln;
          p_pp = nb;
        }
      } else if (RT == 0) {  // ont
        const bool c1 =
            hm && (as & kCond1a) && (5 * ln > cov || ln > tmp / 2);
        const bool c2 =
            !c1 && hm && ln > link_bm / 2 && nb > p_pp && (as & kCond2b);
        if (c1 || c2) {
          bm = s;
          sc_bm = sc_e;
          link_bm = ln;
        }
        if (c1) {
          p_pp = ent_nl[j];
        } else if (c2) {
          p_pp = nb;
        }
      }
      const bool fin = RT == 2 ? sc_e >= sc_bm
                               : (sc_e > sc_bm || (sc_e == sc_bm && ng));
      if (fin) {
        bm = s;
        sc_bm = sc_e;
        link_bm = ln;
        p_pp = raiser;
      }
    }
    best_out[static_cast<int64_t>(g) * kCells + c] = static_cast<int8_t>(bm);
    if (l >= sc_from)
      sc_out[static_cast<int64_t>(sc_base + l - sc_from) * kCells + c] =
          sc_bm;
  }
}

// ---- the shared-memory step probe -----------------------------------------

// One warp repeats the chain's dependent step: each lane loads a shared
// word that it stored in the step before, adds one and stores it to the
// next word, then __syncwarp.  Cycles per step, by clock64, go to out[0].
__global__ void smem_step_probe(int steps, long long* out) {
  __shared__ int buf[64];
  volatile int* vb = buf;
  const int lane = threadIdx.x;
  vb[lane] = lane;
  vb[32 + lane] = 0;
  __syncwarp();
  int p = lane;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    const int x = vb[p];
    p ^= 32;
    vb[p] = x + 1;
    __syncwarp();
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = (t1 - t0) / steps;
    out[1] = vb[p];  // keeps the chain observable
  }
}

template <bool kLast>
int launch_chain(const Inputs& in, const int32_t* win, int n_windows,
                 int cov_coef, int32_t* sc, int32_t* nb, int32_t* nl,
                 cudaStream_t st) {
  const int bytes = static_cast<int>(sizeof(ChainSmem));
  cudaError_t e = cudaFuncSetAttribute(
      level_chain_kernel<kLast>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  level_chain_kernel<kLast><<<n_windows, kChainThreads, bytes, st>>>(
      in, win, cov_coef, sc, nb, nl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launches below go to `stream` (PyTorch's current stream) and return
// cudaGetLastError(); nothing is synchronised and nothing is allocated
// here.  win is int32 [n_windows, 8]:
// (lvl_base, n_levels, E, Vb, sc_from, sc_base, 0, 0).

// The chain: per entry, sc and n_best (and n_last when with_last) into
// ent_sc / ent_nb / ent_nl, int32 [Et] each, in entry-stream order.
int npt_level_chain(const void* ent_A, const void* ent_M, const void* ent_b,
                    const void* ent_slot, const void* lvl_off,
                    const void* meta, const void* win, int n_windows,
                    int with_last, int cov_coef, void* ent_sc, void* ent_nb,
                    void* ent_nl, void* stream) {
  if (n_windows <= 0) return 0;
  const Inputs in{static_cast<const int32_t*>(ent_A),
                  static_cast<const int32_t*>(ent_M),
                  static_cast<const int8_t*>(ent_b),
                  static_cast<const int8_t*>(ent_slot),
                  static_cast<const int32_t*>(lvl_off),
                  static_cast<const int32_t*>(meta)};
  const auto* w = static_cast<const int32_t*>(win);
  auto* sc = static_cast<int32_t*>(ent_sc);
  auto* nb = static_cast<int32_t*>(ent_nb);
  auto* nl = static_cast<int32_t*>(ent_nl);
  auto st = reinterpret_cast<cudaStream_t>(stream);
  return with_last ? launch_chain<true>(in, w, n_windows, cov_coef, sc, nb,
                                        nl, st)
                   : launch_chain<false>(in, w, n_windows, cov_coef, sc, nb,
                                         nl, st);
}

// The winners: best int8 [Lt, 6] and the score tail int32 [n_sc_rows, 6]
// from the chain's per-entry results.  max_levels is the longest window's
// level count.
int npt_level_winners(const void* ent_A, const void* ent_b,
                      const void* ent_slot, const void* lvl_off,
                      const void* meta, const void* win, int n_windows,
                      int max_levels, int rt_id, const void* ent_sc,
                      const void* ent_nb, const void* ent_nl, void* best_out,
                      void* sc_out, void* stream) {
  if (n_windows <= 0 || max_levels <= 0) return 0;
  const dim3 grid((max_levels + kWinnerThreads - 1) / kWinnerThreads,
                  n_windows);
  auto st = reinterpret_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int32_t*>(ent_A);
  const auto* b = static_cast<const int8_t*>(ent_b);
  const auto* s = static_cast<const int8_t*>(ent_slot);
  const auto* lo = static_cast<const int32_t*>(lvl_off);
  const auto* mt = static_cast<const int32_t*>(meta);
  const auto* w = static_cast<const int32_t*>(win);
  const auto* sc = static_cast<const int32_t*>(ent_sc);
  const auto* nb = static_cast<const int32_t*>(ent_nb);
  const auto* nl = static_cast<const int32_t*>(ent_nl);
  auto* best = static_cast<int8_t*>(best_out);
  auto* sco = static_cast<int32_t*>(sc_out);
  switch (rt_id) {
    case 0:
      level_winners_kernel<0><<<grid, kWinnerThreads, 0, st>>>(
          A, b, s, lo, mt, w, sc, nb, nl, best, sco);
      break;
    case 1:
      level_winners_kernel<1><<<grid, kWinnerThreads, 0, st>>>(
          A, b, s, lo, mt, w, sc, nb, nl, best, sco);
      break;
    case 2:
      level_winners_kernel<2><<<grid, kWinnerThreads, 0, st>>>(
          A, b, s, lo, mt, w, sc, nb, nl, best, sco);
      break;
    case 3:
      level_winners_kernel<3><<<grid, kWinnerThreads, 0, st>>>(
          A, b, s, lo, mt, w, sc, nb, nl, best, sco);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one chain block, in bytes.
int npt_level_chain_smem_bytes() { return static_cast<int>(sizeof(ChainSmem)); }

// Cycles of one dependent shared-memory load -> store step (see
// smem_step_probe), written to out_dev (int64 [2] on the card).
int npt_smem_step_cycles(int steps, void* out_dev, void* stream) {
  smem_step_probe<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<long long*>(out_dev));
  return static_cast<int>(cudaGetLastError());
}

const char* npt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
