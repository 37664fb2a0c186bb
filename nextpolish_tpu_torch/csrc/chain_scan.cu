// Task 1's chain DP scans for NVIDIA Hopper, sm_90a: the forward (max,+)
// scan `chain_forward` and the pointer walk back `chain_traceback`.
//
// chain_forward replaces nextpolish_tpu/ops/tropical.py::_forward_states
// (an XLA program in the JAX package, not a Pallas kernel).  Per row b of
// B contigs, with A [B, L, 8, 8] f32 transition matrices and s0 [B, 8]:
//
//   f[t] = s0 (x) A_0 (x) ... (x) A_t,   (x) the (max,+) product,
//
// with _forward_states' exact float order, so f is bit-equal to JAX's (an
// addition is one rounding and max is order-free, so only the
// association of the products fixes the bits, and magnitudes past 2^24
// do round: chunk products of a multi-megabase contig, and the NEG
// domain).  What fixes the bits: the 128-cell chunks; phase 1's P = I,
// P = P (x) A_t, P -= max(P) after every step, giving X[c]; the inclusive
// scan of the X in jax.lax.associative_scan's order; the replay's s =
// max_i(s0_i + Pexc[i, :]) minus its max, then s = s (x) A_t unnormalised.
// Which thread computes which entry of a product is free.
//
// JAX's scan order as a recurrence.  For chunk c of a row let 2^k be the
// lowest set bit of c + 1, and T(c) the tree product of the 2^k chunks
// that end at c: T(c) = T(c - 2^(k-1)) (x) ( ... (x) (T(c - 2) (x) (T(c - 1)
// (x) X[c]))), each T(c - 2^j) built the same way.  Then
//   Pinc[c] = T(c) when c + 1 = 2^k, else Pinc[c - 2^k] (x) T(c):
// associative_scan combines adjacent pairs and recurses on the pair
// results, so its element c + 1 = 2^k m (m odd) is the prefix of m pair
// results of level k, which by induction is Pinc of the last chunk before
// the block, times the block's tree.  ops/chain.py::lookback_scan renders
// this order in Python, and tests/test_torch_chain.py holds it to
// associative_scan with an operator that is not associative.
//
// The design: one launch, fwd_scan.  A warp's four groups of 8 threads
// take a unit of 4 consecutive chunks by ticket (an atomic counter, in
// increasing order).  Group r runs phase 1 on its chunk (thread i row i,
// a 3-step shuffle max), the warp builds the unit's tree N = (X0 (x) X1)
// (x) (X2 (x) X3) and, with the recurrence above at the level of units,
// T(u) from the published T of units u - 1, u - 2, ..., u - 2^(k-1);
// publishes it; then Pinc(u) from Pinc(u - 2^k); publishes it; takes
// Pinc(u - 1) as the prefix the unit enters with; forms the prefixes of
// its first three chunks (Pprev (x) X0, Pprev (x) T1, then (x) X2); and
// each group replays its chunk (thread j state j).  A look-back waits only
// on lower tickets, held by running warps of other units, so it cannot
// deadlock on the card or in the emulation (which runs a launch's blocks
// one at a time).  Publication needs no flags or fences: T and Pinc start
// as all-ones words (the call's one memset) and are written once, and a
// reader polls its rows through L2 until no word is all ones (no
// arithmetic of the card yields that NaN).  A ring of 4 cp.async stages a
// warp feeds both phases, so no step waits on a load it started that step.
//
// What bounds chain_forward on the H100.  Bytes: A once (256 B a cell)
// and f (32 B a cell) is 0.7212 ms at 8.4 M cells and 3.35 TB/s.  Its
// dependency chain is 256 steps a chunk plus a look-back of about log2
// (chunks) products, and a chunk's data waits between its two reads of
// A: the card can hold a window of chunks in flight, and A's second read
// comes from L2 only while that window's A (about 16 KB a chunk on
// average) fits in its 50 MB.  Measured on an H100 80GB HBM3 at 700 W
// (bench_chain): with 16 warps an SM (about 8,000 chunks in
// flight, 130 MB) the replay rereads HBM and the launch moves about 4.6 GB
// (1.635 ms at 8.4 M cells); with 4–6 warps an SM the window fits but a
// warp's 256 steps (about 63 µs for its 4 chunks) leave the card waiting
// (1.67–1.99 ms).  Four threads a chunk (two rows a thread) halve the
// register traffic of phase 1 but not the time of a lone warp's step; the
// L2 priorities (evict_last for phase 1's copies, evict_first for the
// replay's) did not move the time.  The launch stays at 16 warps an SM.
//
// chain_traceback replaces tropical.py::_traceback_batch: b_{c-1} = P[c,
// b_c], from b_end at each row's last cell (padding cells carry the
// identity map).  JAX composes the maps as 0/NEG relation matrices through
// _forward_states and takes the argmax; a composition of maps has exactly
// one 0 per row there, so composing the 8-entry maps directly gives the
// same bytes.  Composition is exact and associative, so any order of it,
// any split over threads and any scratch layout gives those bytes too.  A
// map is one 32-bit word of nibbles, composed by four byte permutes
// (compose_maps).
//
// What bounds chain_traceback on the H100: bytes.  It must read P (32 B a
// cell) and write one byte a cell: 0.0826 ms at 8.4 M cells.  The design
// reads P once, coalesced, and keeps no step serial over a whole row:
//   1. tb_maps, a warp per 128-cell chunk: lane l loads the chunk's 16-byte
//      words l, l + 32, ..., l + 224 (4 KB a warp in eight coalesced
//      loads), packs each cell's row into a map through a shared-memory
//      transpose and stores its cells 4l..4l+3 as one 16-byte word of the
//      scratch Q [B, L] (4 B a cell; from here on Q stands in for P).  It
//      composes its four maps, and a 5-step shuffle scan gives S, the
//      composition from its cells to the chunk's end (a word a lane);
//      lane 0's is the chunk map P_first o ... o P_last.  The block's 8
//      chunk maps are composed into a group map H (groups of 8 chunks, or
//      of the row's chunks if fewer).  Many warps an SM keep the loads in
//      flight.
//   2. tb_walk, a block per row over its groups, T = min(1,024, groups)
//      threads (at least a warp): thread t composes the run of R = groups
//      / T group maps t R .. t R + R - 1, which tb_maps stored at i T + t
//      (i < R), so each of the R loads is coalesced across the block; a
//      block-wide suffix composition (shuffles, then the warp aggregates
//      in shared memory) gives the base each run enters with, and each
//      thread replays its run, writing the base at every group's last
//      cell, E (a byte).  At 8.4 M cells that is 8,192 groups, 8 a thread.
//   3. tb_replay, a warp per 4 chunks: lane l loads its four maps from Q
//      as one 16-byte word and the next lane's S; the base at the chunk's
//      end comes from E and the group's later chunk maps (a 3-step shuffle
//      scan over 8 lanes, shared by the warp's chunks); the lane enters
//      its cells with the next lane's S applied to it, walks its four
//      cells and writes their four bytes as one 32-bit store (128
//      contiguous bytes a warp).  No shuffle scan sits on this pass.
// Bytes moved at B = 1, L = 8,388,608: P 268.4 MB read once, Q 33.6 MB
// and S 8.4 MB written and read back, choice 8.4 MB written, H and E
// under 1 MB: about 361 MB, 0.108 ms at 3.35 TB/s.  Without Q, P would be
// read twice (545 MB).  A single pass with a decoupled look-back (P read
// once, no Q) would move about 277 MB; it is not built.
//
// Every launch and memset goes to the caller's stream (PyTorch's current
// stream); the C entry points return cudaGetLastError() after each launch
// and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

// The dynamic shared memory and a kernel launch go through these macros,
// which csrc/emu/cuda_runtime.h (the CPU stand-in that emu_chain.py builds
// this file against) defines anew.
#ifndef NPT_EMU
#define NPT_DYNAMIC_SMEM(name) extern __shared__ __align__(16) uint8_t name[]
#define NPT_LAUNCH(grid, block, smem, stream, ...) \
  __VA_ARGS__<<<grid, block, smem, stream>>>
#endif

namespace {

constexpr int kS = 8;
constexpr int kChunk = 128;
constexpr int kThreads = 256;
constexpr float kNeg = -1e9f;  // ops/chain.py NEG, exact in f32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;  // chunks a block of tb_maps
constexpr int kLgGroup = 3;            // log2 of the chunks a group, at most
static_assert(1 << kLgGroup == kWarps, "a group is a tb_maps block at most");
constexpr int kReplay = 4;             // chunks a warp of tb_replay
// log2 of tb_walk's most threads (the emulation cuts it to reach that
// kernel's route of several group maps a thread at small rows)
#ifndef NPT_LG_WALK
#define NPT_LG_WALK 10
#endif
constexpr int kLgWalk = NPT_LG_WALK;
// The identity map {0..7} -> {0..7}.  A map m is one 32-bit word: nibble
// 2j holds m(j) and nibble 2j+1 holds m(j+4) (j < 4), i.e. lo | hi << 4
// with lo and hi the bytes m(0..3) and m(4..7).
constexpr uint32_t kIdentity = 0x73625140u;

__device__ __forceinline__ float group_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1, 8));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2, 8));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4, 8));
  return v;
}

__device__ __forceinline__ void load_row(const float* __restrict__ m, int i,
                                         float (&c)[kS]) {
  const float4* m4 = reinterpret_cast<const float4*>(m + i * kS);
  const float4 lo = __ldg(m4), hi = __ldg(m4 + 1);
  c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
  c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
}

__device__ __forceinline__ void store_row(float* m, int i,
                                          const float (&c)[kS]) {
  float4* m4 = reinterpret_cast<float4*>(m + i * kS);
  m4[0] = make_float4(c[0], c[1], c[2], c[3]);
  m4[1] = make_float4(c[4], c[5], c[6], c[7]);
}

// ---- chain_forward -------------------------------------------------------

constexpr int kUnit = 4;  // chunks a ticket: the four 8-thread groups of a warp
// 16 warps an SM (the note above: fewer leave the card waiting on latency)
constexpr int kFwdWarps = 8;        // warps a block
constexpr int kFwdBlocksPerSm = 2;  // the grid's cap
// a warp's 8x8 matrices in shared memory: X_0..X_3 in slots 0..3, then
constexpr int kT1 = 4, kN23 = 5, kAcc = 6, kPprev = 7, kPinc0 = 8;
constexpr int kSlots = 11;  // kPinc0 .. kPinc0 + 2 hold Pinc of chunks 0..2
// then a ring of kStages steps of A for the warp's four chunks; a chunk's
// 64 floats padded to 72, so that the replay's column reads of the four
// chunks hit 32 banks
constexpr int kStages = 4;
constexpr int kGrp = 72;
constexpr int kWarpFloats = kSlots * 64 + kStages * kUnit * kGrp;

#ifndef NPT_EMU
// L2 policies for the loads of A: phase 1's keep them, so that the
// replay's second read finds them in L2; the replay's go first.
__device__ __forceinline__ uint64_t npt_l2_keep() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t npt_l2_drop() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
#define NPT_CP_ASYNC16_HINT(dst, src, pol)                                 \
  asm volatile(                                                           \
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" :: \
          "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),     \
      "l"(src), "l"(pol))
#define NPT_CP_ASYNC_COMMIT() asm volatile("cp.async.commit_group;\n" ::)
#define NPT_CP_ASYNC_WAIT(n) asm volatile("cp.async.wait_group %0;\n" ::"n"(n))
__device__ __forceinline__ float4 npt_ld_volatile4(const float4* q) {
  float4 v;
  asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(q));
  return v;
}
__device__ __forceinline__ uint64_t npt_globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// out[j] = max_k c[k] + m[k][j]: one row of a (max,+) product, m an 8x8
// row-major matrix in shared memory.
__device__ __forceinline__ void row_times_s(const float (&c)[kS],
                                            const float* m,
                                            float (&out)[kS]) {
  const float4* m4 = reinterpret_cast<const float4*>(m);
#pragma unroll
  for (int k = 0; k < kS; k++) {
    const float4 lo = m4[2 * k], hi = m4[2 * k + 1];
    const float r[kS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < kS; j++) {
      const float v = __fadd_rn(c[k], r[j]);
      out[j] = k == 0 ? v : fmaxf(out[j], v);
    }
  }
}

__device__ __forceinline__ void load_row_s(const float* m, int i,
                                           float (&c)[kS]) {
  const float4* m4 = reinterpret_cast<const float4*>(m + i * kS);
  const float4 lo = m4[0], hi = m4[1];
  c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
  c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
}

// A unit's published T or Pinc starts as kUnset in every word (the
// launch's memset) and is written once; no arithmetic of the card yields
// these bits (its NaN is 0x7fffffff), so a word that differs is final.
constexpr uint32_t kUnset = 0xffffffffu;

// Row i of the matrix m another warp publishes, once all 64 words of it
// are written: every lane polls its row through L2 until no lane sees
// kUnset.  The wait is on a unit of a lower ticket, which a running warp
// holds, so it ends within microseconds; one that has not ended after
// 2^26 polls (some seconds) traps, so that a fault fails the launch and
// hangs nothing.
__device__ __forceinline__ void await_row(const float* m, int i,
                                          float (&c)[kS]) {
  const float4* m4 = reinterpret_cast<const float4*>(m + i * kS);
  for (int n = 0;; n++) {
    const float4 lo = npt_ld_volatile4(m4), hi = npt_ld_volatile4(m4 + 1);
    c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
    c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
    bool done = true;
#pragma unroll
    for (int j = 0; j < kS; j++) done &= __float_as_uint(c[j]) != kUnset;
    if (__all_sync(kFull, done)) return;
    if (n == 1 << 26) __trap();
    __nanosleep(32);
  }
}

// One launch: warps take units of kUnit chunks by ticket, in increasing
// order, until n_units are taken.  Per unit, group r of the warp (lanes
// 8r .. 8r + 7) runs phase 1 on chunk 4u + r (thread i row i of X), the
// warp combines the unit's X in the tree's order and finishes the look-back
// (rows of nch >= 4 chunks; rows of 1 or 2 chunks lie inside a unit), and
// group r replays its chunk from its exclusive prefix (thread j state j).
// Tpub and Ppub hold each unit's T and Pinc (64 floats a unit, kUnset
// until written); *ticket counts from -1.  With `trace`, lane 0 stamps
// each unit's events in globaltimer nanoseconds (bench_chain --trace).
__global__ void __launch_bounds__(kFwdWarps * 32)
fwd_scan(const float* __restrict__ A, const float* __restrict__ s0, int nch,
         int n_chunks, int n_units, float* __restrict__ Tpub,
         float* __restrict__ Ppub, int* __restrict__ ticket,
         float* __restrict__ f, uint64_t* __restrict__ trace) {
  NPT_DYNAMIC_SMEM(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 3, i = lane & 7;
  float* sm = reinterpret_cast<float*>(smem) + warp * kWarpFloats;
  float* ring = sm + kSlots * 64;
  const uint64_t keep = npt_l2_keep(), drop = npt_l2_drop();
  const int nu = nch / kUnit;  // units a row, when nch >= kUnit
  for (;;) {
    int u = 0;
    if (lane == 0) u = atomicAdd(ticket, 1) + 1;
    u = __shfl_sync(kFull, u, 0);
    if (u >= n_units) break;
    // events: ticket, phase 1 done, T published, Pinc published, the
    // unit's prefix in hand, replay done
    auto mark = [&](int e) {
      if (trace && lane == 0) trace[(long long)u * 8 + e] = npt_globaltimer();
    };
    mark(0);
    const long long g = (long long)u * kUnit + r;
    const bool live = g < n_chunks;
    // a group past the end runs a copy of the last chunk, stores nothing
    const long long gc = live ? g : n_chunks - 1;
    const float* a = A + gc * kChunk * 64;
    // lane i of group r copies floats 8i .. 8i + 7 of its chunk's A_t
    // into the ring's stage t % kStages
    auto copy_in = [&](int t, uint64_t pol) {
      if (t < kChunk) {
        float* dst = ring + (t % kStages) * (kUnit * kGrp) + r * kGrp + 8 * i;
        const float* src = a + t * 64 + 8 * i;
        NPT_CP_ASYNC16_HINT(dst, src, pol);
        NPT_CP_ASYNC16_HINT(dst + 4, src + 4, pol);
      }
      NPT_CP_ASYNC_COMMIT();
    };
    // stage t's copies are done and visible to the warp; the next copy
    // goes to the stage every lane has finished reading
    auto arrive = [&](int t, uint64_t pol) {
      NPT_CP_ASYNC_WAIT(kStages - 2);
      __syncwarp();
      copy_in(t + kStages - 1, pol);
      return ring + (t % kStages) * (kUnit * kGrp) + r * kGrp;
    };
    // phase 1: X = the renormalised product of the chunk's matrices
    float c[kS];
#pragma unroll
    for (int j = 0; j < kS; j++) c[j] = j == i ? 0.f : kNeg;
    for (int t = 0; t < kStages - 1; t++) copy_in(t, keep);
    for (int t = 0; t < kChunk; t++) {
      float n[kS];
      row_times_s(c, arrive(t, keep), n);
      float m = n[0];
#pragma unroll
      for (int j = 1; j < kS; j++) m = fmaxf(m, n[j]);
      m = group_max8(m);
#pragma unroll
      for (int j = 0; j < kS; j++) c[j] = __fsub_rn(n[j], m);
    }
    store_row(sm + r * 64, i, c);
    __syncwarp();
    mark(1);
    // the chunk's exclusive prefix Pexc: pe, or the identity
    bool ident = true;
    const float* pe = sm;
    if (nch == 2) {
      ident = !(r & 1);
      pe = sm + (r & 2) * 64;
    } else if (nch >= kUnit) {
      const int ur = u % nu;  // the unit's index in its row
      const bool first = ur == 0;
      float x[kS], acc[kS];
      // T1 = X0 (x) X1 (groups 0, 1) and N23 = X2 (x) X3 (groups 2, 3)
      const int pr = r & 2;
      load_row_s(sm + pr * 64, i, x);
      row_times_s(x, sm + (pr + 1) * 64, acc);
      if (!(r & 1)) store_row(sm + (kT1 + (r >> 1)) * 64, i, acc);
      __syncwarp();
      // N = T1 (x) N23, the unit's tree product (every group)
      load_row_s(sm + kT1 * 64, i, x);
      row_times_s(x, sm + kN23 * 64, acc);
      // T(u) = T(u - 2^(k-1)) (x) ( ... (x) (T(u - 1) (x) N)), 2^k the
      // lowest set bit of ur + 1
      const int k = __ffs(ur + 1) - 1;
      for (int j = 0; j < k; j++) {
        __syncwarp();
        if (r == 0) store_row(sm + kAcc * 64, i, acc);
        await_row(Tpub + (long long)(u - (1 << j)) * 64, i, x);
        __syncwarp();
        row_times_s(x, sm + kAcc * 64, acc);
      }
      if (r == 0) store_row(Tpub + (long long)u * 64, i, acc);
      mark(2);
      // Pinc(u) = Pinc(u - 2^k) (x) T(u), or T(u) when ur + 1 = 2^k
      if (ur + 1 != 1 << k) {
        __syncwarp();
        if (r == 0) store_row(sm + kAcc * 64, i, acc);
        await_row(Ppub + (long long)(u - (1 << k)) * 64, i, x);
        __syncwarp();
        row_times_s(x, sm + kAcc * 64, acc);
      }
      if (r == 0) store_row(Ppub + (long long)u * 64, i, acc);
      mark(3);
      // Pprev = Pinc(u - 1), the prefix the unit enters with
      if (!first) {
        await_row(Ppub + (long long)(u - 1) * 64, i, x);
        if (r == 0) store_row(sm + kPprev * 64, i, x);
      }
      __syncwarp();
      // Pinc0 = Pprev (x) X0 (group 1 keeps it), Pinc1 = Pprev (x) T1
      // (group 2); X0 and T1 themselves in a row's first unit
      const float* rhs = sm + (r == 2 ? kT1 : 0) * 64;
      if (first) {
        load_row_s(rhs, i, acc);
      } else {
        load_row_s(sm + kPprev * 64, i, x);
        row_times_s(x, rhs, acc);
      }
      if (r == 1 || r == 2) store_row(sm + (kPinc0 + r - 1) * 64, i, acc);
      __syncwarp();
      // Pinc2 = Pinc1 (x) X2 (group 3)
      load_row_s(sm + kPinc0 * 64 + 64, i, x);
      row_times_s(x, sm + 2 * 64, acc);
      if (r == 3) store_row(sm + (kPinc0 + 2) * 64, i, acc);
      __syncwarp();
      ident = r == 0 && first;
      pe = r == 0 ? sm + kPprev * 64 : sm + (kPinc0 + r - 1) * 64;
    }
    mark(4);
    // phase 3: s = max_i (s0_i + Pexc[i, :]) minus its max, then the replay
    float s[kS];
    load_row(s0, (int)(gc / nch), s);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kS; k++) {
      const float p = ident ? (k == i ? 0.f : kNeg) : pe[k * kS + i];
      const float v = __fadd_rn(s[k], p);
      ss = k == 0 ? v : fmaxf(ss, v);
    }
    __syncwarp();  // the slots are read: the next unit may overwrite them
    ss = __fsub_rn(ss, group_max8(ss));
#pragma unroll
    for (int k = 0; k < kS; k++) s[k] = __shfl_sync(kFull, ss, k, 8);
    float* fo = f + gc * kChunk * kS;
    for (int t = 0; t < kStages - 1; t++) copy_in(t, drop);
    for (int t = 0; t < kChunk; t++) {
      const float* m = arrive(t, drop);
      float out = 0.f;
#pragma unroll
      for (int k = 0; k < kS; k++) {
        const float v = __fadd_rn(s[k], m[k * kS + i]);
        out = k == 0 ? v : fmaxf(out, v);
      }
      if (live) __stcs(fo + t * kS + i, out);
#pragma unroll
      for (int k = 0; k < kS; k++) s[k] = __shfl_sync(kFull, out, k, 8);
    }
    __syncwarp();  // the ring is read: the next unit may refill it
    mark(5);
  }
}

// ---- chain_traceback -----------------------------------------------------

// m(b) for a map m as kIdentity lays it out: nibble 2(b & 3) + (b >> 2),
// i.e. bits 8(b & 3) + 4(b >> 2) = (9 b) & 0x1c.
__device__ __forceinline__ int apply_map(uint32_t m, int b) {
  return (int)((m >> ((b * 9) & 0x1c)) & 7u);
}

// (x o y)(b) = x(y(b)).  With x's entries as the eight bytes lo, hi, the
// nibbles of y select them: a = x(y(0)) x(y(4)) x(y(1)) x(y(5)) and
// b = x(y(2)) x(y(6)) x(y(3)) x(y(7)) as bytes; two more permutes put the
// result's lo and hi bytes in order.
__device__ __forceinline__ uint32_t compose_maps(uint32_t x, uint32_t y) {
  const uint32_t lo = x & 0x0f0f0f0fu, hi = (x >> 4) & 0x0f0f0f0fu;
  const uint32_t a = __byte_perm(lo, hi, y);
  const uint32_t b = __byte_perm(lo, hi, y >> 16);
  return __byte_perm(a, b, 0x6420) | __byte_perm(a, b, 0x7531) << 4;
}

// Four pointer entries (each 0..7) as the four bytes of one word.
__device__ __forceinline__ uint32_t pack4(int4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x40), __byte_perm(v.z, v.w, 0x40),
                     0x5410) & 0x07070707u;
}

// Where tb_walk reads group k's map and writes its end base: row-major
// over rows of 2^lg_n groups; in a row, group j = t R + i sits at i T + t
// (T = 2^lg_n / R threads, R = 2^lg_run groups a thread).
__device__ __forceinline__ long long walk_pos(long long k, int lg_n,
                                              int lg_run) {
  const long long row = k >> lg_n;
  const int j = (int)(k & ((1LL << lg_n) - 1));
  const int i = j & ((1 << lg_run) - 1), t = j >> lg_run;
  return (row << lg_n) + ((long long)i << (lg_n - lg_run)) + t;
}

// A warp per chunk g: Q[c] = cell c's pointer row as a map, for the
// chunk's 128 cells, and S[32 g + l] = P_{4l} o ... o P_{127}, the maps
// of the chunk's cells from 4l on, composed (l < 32).  S[32 g], the chunk
// map, takes the base at the chunk's last cell to the base at the cell
// before the chunk.  Then per group of 2^lg_gs chunks of the block (8 or
// the row's chunk count, if fewer), H[walk_pos(group)] = their chunk maps
// composed.
__global__ void __launch_bounds__(kThreads)
tb_maps(const int* __restrict__ P, int n_chunks, int lg_gs, int lg_n,
        int lg_run, uint32_t* __restrict__ Q, uint32_t* __restrict__ S,
        uint32_t* __restrict__ H) {
  NPT_DYNAMIC_SMEM(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem) + warp * kChunk;
  uint32_t* cmap = reinterpret_cast<uint32_t*>(smem) + kWarps * kChunk;
  uint32_t a = kIdentity;
  if (g < n_chunks) {  // whole warps
    // word k * 32 + l of the chunk's 256 16-byte words: cell 16 k + l / 2,
    // entries 4 (l & 1) .. 4 (l & 1) + 3
    const int4* p = reinterpret_cast<const int4*>(P) + g * (kChunk * kS / 4);
    int4 v[8];
#pragma unroll
    for (int k = 0; k < 8; k++) v[k] = __ldg(p + k * 32 + lane);
    const int half = lane & 1;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      uint32_t m = pack4(v[k]) << (4 * half);
      m |= __shfl_xor_sync(kFull, m, 1);
      if (!half) stage[16 * k + (lane >> 1)] = m;
    }
    __syncwarp();
    const uint4 c = reinterpret_cast<const uint4*>(stage)[lane];  // 4l..4l+3
    reinterpret_cast<uint4*>(Q)[g * 32 + lane] = c;
    a = compose_maps(compose_maps(c.x, c.y), compose_maps(c.z, c.w));
    // the suffix composition across the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_down_sync(kFull, a, d);
      if (lane + d < 32) a = compose_maps(a, o);
    }
    S[g * 32 + lane] = a;
  }
  if (lane == 0) cmap[warp] = a;
  __syncthreads();
  if (warp == 0) {
    const int gs = 1 << lg_gs;
    uint32_t m = lane < kWarps ? cmap[lane] : kIdentity;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint32_t o = __shfl_down_sync(kFull, m, d);
      if ((lane & (gs - 1)) + d < gs) m = compose_maps(m, o);
    }
    const long long c = (long long)blockIdx.x * kWarps + lane;
    if (lane < kWarps && !(lane & (gs - 1)) && c < n_chunks)
      H[walk_pos(c >> lg_gs, lg_n, lg_run)] = m;
  }
}

// A block per row: E[walk_pos(group)] = the base at the group's last
// cell, from b_end at the row's last cell.  Thread t < T owns groups t R
// .. t R + R - 1 (threads past T, when a row has fewer than 32 groups,
// hold the identity).
__global__ void __launch_bounds__(1 << kLgWalk)
tb_walk(const uint32_t* __restrict__ H, const int* __restrict__ b_end,
        int lg_n, int lg_run, uint8_t* __restrict__ E) {
  NPT_DYNAMIC_SMEM(smem);
  uint32_t* wmap = reinterpret_cast<uint32_t*>(smem);  // [32]
  int* wbase = reinterpret_cast<int*>(smem) + 32;      // [32]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int R = 1 << lg_run, T = 1 << (lg_n - lg_run);
  const uint32_t* h = H + ((long long)blockIdx.x << lg_n);
  uint8_t* e = E + ((long long)blockIdx.x << lg_n);
  uint32_t A = kIdentity;
  if (t < T) {
#pragma unroll 8
    for (int i = 0; i < R; i++) A = compose_maps(A, h[i * T + t]);
  }
  // S = A_t o ... o A_{warp's last thread}
  uint32_t S = A;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_down_sync(kFull, S, d);
    if (lane + d < 32) S = compose_maps(S, o);
  }
  if (lane == 0) wmap[warp] = S;
  __syncthreads();
  if (warp == 0) {
    // the same over the warps; wbase[w] = the base at warp w's last group
    uint32_t W = lane < nw ? wmap[lane] : kIdentity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_down_sync(kFull, W, d);
      if (lane + d < 32) W = compose_maps(W, o);
    }
    const uint32_t after = __shfl_down_sync(kFull, W, 1);
    const int end = b_end[blockIdx.x] & 7;
    wbase[lane] = lane == 31 ? end : apply_map(after, end);
  }
  __syncthreads();
  const uint32_t after = __shfl_down_sync(kFull, S, 1);
  int b = lane == 31 ? wbase[warp] : apply_map(after, wbase[warp]);
  if (t < T) {
#pragma unroll 8
    for (int i = R - 1; i >= 0; i--) {
      e[i * T + t] = (uint8_t)b;
      b = apply_map(h[i * T + t], b);
    }
  }
}

// A warp per kReplay chunks g: the walk from the base at the chunk's last
// cell down to its first; lane l takes cells 4l..4l+3 and enters them
// with S[32 g + l + 1] applied to that base.  The base at the chunk's last
// cell comes from its group's end base E and the maps of the group's
// later chunks.
__global__ void __launch_bounds__(kThreads)
tb_replay(const uint32_t* __restrict__ Q, const uint32_t* __restrict__ S,
          const uint8_t* __restrict__ E, int n_chunks, int lg_gs, int lg_n,
          int lg_run,
          int8_t* __restrict__ choice) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g0 = ((long long)blockIdx.x * kWarps + warp) * kReplay;
  if (g0 >= n_chunks) return;  // whole warps only
  const int gs = 1 << lg_gs;
  // lanes 0..7: the maps of the 8 chunks from g0 & ~7, each composed with
  // its group's later ones (the groups are 8, 4, 2 or 1 chunks, aligned)
  const long long win = g0 & ~(long long)(kWarps - 1);
  uint32_t X = lane < kWarps && win + lane < n_chunks
                   ? __ldg(S + (win + lane) * 32)
                   : kIdentity;
  uint4 c[kReplay];
  uint32_t s[kReplay];
#pragma unroll
  for (int r = 0; r < kReplay; r++) {
    const bool live = g0 + r < n_chunks;
    c[r] = live ? __ldg(reinterpret_cast<const uint4*>(Q) + (g0 + r) * 32 +
                        lane)
                : make_uint4(kIdentity, kIdentity, kIdentity, kIdentity);
    s[r] = live ? __ldg(S + (g0 + r) * 32 + lane) : kIdentity;
  }
#pragma unroll
  for (int d = 1; d < kWarps; d <<= 1) {
    const uint32_t o = __shfl_down_sync(kFull, X, d);
    if ((lane & (gs - 1)) + d < gs) X = compose_maps(X, o);
  }
#pragma unroll
  for (int r = 0; r < kReplay; r++) {
    const long long g = g0 + r;
    // the group's later chunks composed, from the lane after g's
    const int o = (int)(g & (kWarps - 1)) + 1;
    const uint32_t later = __shfl_sync(kFull, X, o & (kWarps - 1));
    const uint32_t after = __shfl_down_sync(kFull, s[r], 1);
    if (g >= n_chunks) continue;  // whole warps
    int end = E[walk_pos(g >> lg_gs, lg_n, lg_run)];
    if (o & (gs - 1)) end = apply_map(later, end);
    const int b3 = lane == 31 ? end : apply_map(after, end);
    const int b2 = apply_map(c[r].w, b3);
    const int b1 = apply_map(c[r].z, b2);
    const int b0 = apply_map(c[r].y, b1);
    reinterpret_cast<uint32_t*>(choice)[g * 32 + lane] =
        (uint32_t)b0 | (uint32_t)b1 << 8 | (uint32_t)b2 << 16 |
        (uint32_t)b3 << 24;
  }
}

inline unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

inline int log2_exact(int n) {
  int k = 0;
  while ((1 << k) < n) k++;
  return k;
}

}  // namespace

extern "C" {

#define NPT_CHECK()                                  \
  do {                                               \
    const cudaError_t err = cudaGetLastError();      \
    if (err != cudaSuccess) return (int)err;         \
  } while (0)

// f [B, nch*128, 8] from A [B, nch*128, 8, 8] and s0 [B, 8] (f32, row
// major); xs and rs are f32 scratch of B * 2 * nch * 64 each; nch is a
// power of two.  xs holds the units' T and Pinc (a matrix each a unit of
// 4 chunks: B * nch * 32 floats at most) and the ticket counter, set to
// all ones here on the caller's stream; a build with NPT_FWD_TRACE set
// stamps each unit's events into rs (8 words a unit).
int npt_chain_forward(const void* A, const void* s0, int B, int nch,
                      void* xs, void* rs, void* f, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_chunks = B * nch;
  const int n_units = (n_chunks + kUnit - 1) / kUnit;
  float* T = static_cast<float*>(xs);
  float* Pinc = T + (long long)n_units * 64;
  int* ticket = reinterpret_cast<int*>(Pinc + (long long)n_units * 64);
  cudaMemsetAsync(T, 0xff, (2LL * n_units * 64 + 1) * sizeof(float), st);
  NPT_CHECK();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  NPT_CHECK();
  const int want = (n_units + kFwdWarps - 1) / kFwdWarps;
  const int cap = sms * kFwdBlocksPerSm;
  const int sm_bytes = kFwdWarps * kWarpFloats * sizeof(float);
  cudaFuncSetAttribute(fwd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       sm_bytes);
  NPT_CHECK();
#ifdef NPT_FWD_TRACE
  uint64_t* trace = static_cast<uint64_t*>(rs);
#else
  uint64_t* trace = nullptr;
#endif
  NPT_LAUNCH(want < cap ? want : cap, kFwdWarps * 32, sm_bytes, st,
             fwd_scan)(static_cast<const float*>(A),
                       static_cast<const float*>(s0), nch, n_chunks, n_units,
                       T, Pinc, ticket, static_cast<float*>(f), trace);
  NPT_CHECK();
  return 0;
}

// choice [B, nch*128] int8 from P [B, nch*128, 8] int32 and b_end [B]
// int32; nch is a power of two.  maps is u32 scratch of B * nch * 161
// words (Q, a map a cell; S, a map a 4 cells; H, a map a group); ends is
// scratch of B * nch bytes or more (E).
int npt_chain_traceback(const void* P, const void* b_end, int B, int nch,
                        void* maps, void* ends, void* choice, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(P);
  const int n_chunks = B * nch;
  const int lg_nch = log2_exact(nch);
  const int lg_gs = lg_nch < kLgGroup ? lg_nch : kLgGroup;
  const int lg_n = lg_nch - lg_gs;  // groups a row
  const int lg_run = lg_n > kLgWalk ? lg_n - kLgWalk : 0;
  const int walk_threads = 1 << (lg_n - lg_run);
  uint32_t* Q = static_cast<uint32_t*>(maps);
  uint32_t* S = Q + (long long)n_chunks * kChunk;
  uint32_t* H = S + (long long)n_chunks * 32;
  uint8_t* E = static_cast<uint8_t*>(ends);
  NPT_LAUNCH(blocks_for(32LL * n_chunks), kThreads,
             (kWarps * kChunk + kWarps) * sizeof(uint32_t), st, tb_maps)(
      p, n_chunks, lg_gs, lg_n, lg_run, Q, S, H);
  NPT_CHECK();
  NPT_LAUNCH(B, walk_threads < 32 ? 32 : walk_threads, 64 * sizeof(uint32_t),
             st, tb_walk)(H, static_cast<const int*>(b_end), lg_n, lg_run, E);
  NPT_CHECK();
  NPT_LAUNCH(blocks_for(32LL * ((n_chunks + kReplay - 1) / kReplay)),
             kThreads, 0, st, tb_replay)(Q, S, E, n_chunks, lg_gs, lg_n,
                                         lg_run, static_cast<int8_t*>(choice));
  NPT_CHECK();
  return 0;
}

const char* npt_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
