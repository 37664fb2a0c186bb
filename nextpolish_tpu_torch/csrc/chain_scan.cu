// Task 1's chain DP scans for NVIDIA Hopper, sm_90a: the forward (max,+)
// scan `chain_forward` and the pointer walk back `chain_traceback`.
//
// chain_forward replaces nextpolish_tpu/ops/tropical.py::_forward_states
// (an XLA program in the JAX package, not a Pallas kernel).  Per row b of
// B contigs, with A [B, L, 8, 8] f32 transition matrices and s0 [B, 8]:
//
//   f[t] = s0 (x) A_0 (x) ... (x) A_t,   (x) the (max,+) product,
//
// in _forward_states' three phases and with its exact float order, so f is
// bit-equal to JAX's (an addition is one rounding and max is order-free, so
// only the association of the products fixes the bits, and magnitudes past
// 2^24 do round: chunk products of a multi-megabase contig, and the NEG
// domain):
//   1. fwd_chunks: per 128-cell chunk, P = I; P = P (x) A_t, then P -= max(P)
//      after every step (a group of 8 threads per chunk, thread i owns row i
//      of P; the max is a 3-step shuffle within the group);
//   2. fwd_up / fwd_down: the inclusive scan of the chunk products in
//      jax.lax.associative_scan's order (combine adjacent pairs, recurse on
//      the pair results, then combine each odd result with the next even
//      element): one pass per tree level, up and then down, over a scratch
//      tensor the wrapper allocates (the chunk count is a power of two);
//   3. fwd_replay: per chunk, s = max_i(s0_i + Pexc[i, :]) minus its max,
//      then s = s (x) A_t with no renormalisation, writing f (a group of 8
//      threads per chunk, thread j owns state j).
//
// What bounds chain_forward on the H100.  It reads A (256 B a cell) in
// phases 1 and 3 and writes f (32 B a cell): bytes, about 0.7 ms at 8.4 M
// cells, against about 10^3 float operations a cell.  Its dependency chain
// is 128 + 2 log2(chunks) + 128 steps.  The design spreads phases 1 and 3
// over B x L/128 groups of 8 threads, which fills the card at task-1 sizes,
// reads each A_t as two 16-byte loads per thread that the group shares,
// and pays one kernel launch per tree level of phase 2 (34 launches at
// 8.4 M cells, a few microseconds each).
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
// Every launch goes to the caller's stream (PyTorch's current stream); the
// C entry points return cudaGetLastError() after each launch and allocate
// nothing.

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

// out[j] = max_k c[k] + m[k][j]: one row of a (max,+) product, m an 8x8
// row-major matrix in device memory (16-byte aligned).
__device__ __forceinline__ void row_times(const float (&c)[kS],
                                          const float* __restrict__ m,
                                          float (&out)[kS]) {
  const float4* m4 = reinterpret_cast<const float4*>(m);
#pragma unroll
  for (int k = 0; k < kS; k++) {
    const float4 lo = __ldg(m4 + 2 * k);
    const float4 hi = __ldg(m4 + 2 * k + 1);
    const float r[kS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < kS; j++) {
      const float v = __fadd_rn(c[k], r[j]);
      out[j] = k == 0 ? v : fmaxf(out[j], v);
    }
  }
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

// Phase 1: X0[g] = the renormalised product of chunk g's 128 matrices
// (g = b * nch + chunk); 8 threads per chunk, thread i owns row i.
__global__ void __launch_bounds__(kThreads)
fwd_chunks(const float* __restrict__ A, int n_groups, float* __restrict__ X0) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int i = (int)(gid & 7);
  const bool live = (gid >> 3) < n_groups;
  // groups past the end compute a copy of the last one (the group's
  // shuffles need all 32 lanes) and store nothing
  const long long g = live ? (gid >> 3) : n_groups - 1;
  const float* a = A + g * kChunk * 64;
  float c[kS];
#pragma unroll
  for (int j = 0; j < kS; j++) c[j] = j == i ? 0.f : kNeg;
  for (int t = 0; t < kChunk; t++) {
    float n[kS];
    row_times(c, a + t * 64, n);
    float m = n[0];
#pragma unroll
    for (int j = 1; j < kS; j++) m = fmaxf(m, n[j]);
    m = group_max8(m);
#pragma unroll
    for (int j = 0; j < kS; j++) c[j] = __fsub_rn(n[j], m);
  }
  if (live) store_row(X0 + g * 64, i, c);
}

// Phase 2, up: Y[b, j] = X[b, 2j] (x) X[b, 2j+1] for j < n_out.
__global__ void __launch_bounds__(kThreads)
fwd_up(const float* __restrict__ X, float* __restrict__ Y, int n_out, int B) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)B * n_out * 8) return;
  const int i = (int)(gid & 7);
  const long long pj = gid >> 3;
  const long long b = pj / n_out, j = pj % n_out;
  const float* x = X + (b * 2 * n_out + 2 * j) * 64;
  float c[kS], out[kS];
  load_row(x, i, c);
  row_times(c, x + 64, out);
  store_row(Y + (b * n_out + j) * 64, i, out);
}

// Phase 2, down: the inclusive prefixes R of one tree level (n elements a
// row) from the next level's prefixes Rn (n/2) and this level's
// elements X: R[2j+1] = Rn[j], R[0] = X[0], R[2j] = Rn[j-1] (x) X[2j].
__global__ void __launch_bounds__(kThreads)
fwd_down(const float* __restrict__ Rn, const float* __restrict__ X,
         float* __restrict__ R, int n, int B) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)B * n * 8) return;
  const int i = (int)(gid & 7);
  const long long pe = gid >> 3;
  const long long b = pe / n, e = pe % n;
  float out[kS];
  if (e & 1) {
    load_row(Rn + (b * (n / 2) + (e >> 1)) * 64, i, out);
  } else if (e == 0) {
    load_row(X + b * n * 64, i, out);
  } else {
    float c[kS];
    load_row(Rn + (b * (n / 2) + (e >> 1) - 1) * 64, i, c);
    row_times(c, X + (b * n + e) * 64, out);
  }
  store_row(R + (b * n + e) * 64, i, out);
}

// Phase 3: per chunk, the start state from s0 and the exclusive prefix
// (the identity for chunk 0, else Pinc[g-1]), renormalised, then the
// replay; 8 threads per chunk, thread j owns state j.
__global__ void __launch_bounds__(kThreads)
fwd_replay(const float* __restrict__ A, const float* __restrict__ s0,
           const float* __restrict__ Pinc, int nch, int n_groups,
           float* __restrict__ f) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int j = (int)(gid & 7);
  const bool live = (gid >> 3) < n_groups;
  const long long g = live ? (gid >> 3) : n_groups - 1;
  const long long b = g / nch, ch = g % nch;
  float s[kS];
  load_row(s0, (int)b, s);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kS; i++) {
    const float p = ch == 0 ? (i == j ? 0.f : kNeg)
                            : __ldg(Pinc + (g - 1) * 64 + i * kS + j);
    const float v = __fadd_rn(s[i], p);
    ss = i == 0 ? v : fmaxf(ss, v);
  }
  ss = __fsub_rn(ss, group_max8(ss));
#pragma unroll
  for (int i = 0; i < kS; i++) s[i] = __shfl_sync(kFull, ss, i, 8);
  const float* a = A + g * kChunk * 64;
  float* fo = f + g * kChunk * kS;
  for (int t = 0; t < kChunk; t++) {
    float out = 0.f;
#pragma unroll
    for (int i = 0; i < kS; i++) {
      const float v = __fadd_rn(s[i], __ldg(a + t * 64 + i * kS + j));
      out = i == 0 ? v : fmaxf(out, v);
    }
    if (live) fo[t * kS + j] = out;
#pragma unroll
    for (int i = 0; i < kS; i++) s[i] = __shfl_sync(kFull, out, i, 8);
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

// Level k of phase 2's level-major scratch [levels][B][n_k][64], n_k =
// nch >> k.
inline float* level(float* base, int B, int nch, int k) {
  return base + (long long)B * (2LL * nch - 2LL * (nch >> k)) * 64;
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
// power of two.
int npt_chain_forward(const void* A, const void* s0, int B, int nch,
                      void* xs, void* rs, void* f, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  float* X = static_cast<float*>(xs);
  float* R = static_cast<float*>(rs);
  const int n_groups = B * nch;
  NPT_LAUNCH(blocks_for(8LL * n_groups), kThreads, 0, st, fwd_chunks)(
      a, n_groups, X);
  NPT_CHECK();
  const int K = log2_exact(nch);
  for (int k = 0; k < K; k++) {
    const int n_out = nch >> (k + 1);
    NPT_LAUNCH(blocks_for(8LL * B * n_out), kThreads, 0, st, fwd_up)(
        level(X, B, nch, k), level(X, B, nch, k + 1), n_out, B);
    NPT_CHECK();
  }
  const float* Rn = level(X, B, nch, K);
  for (int k = K - 1; k >= 0; k--) {
    const int n = nch >> k;
    NPT_LAUNCH(blocks_for(8LL * B * n), kThreads, 0, st, fwd_down)(
        Rn, level(X, B, nch, k), level(R, B, nch, k), n, B);
    NPT_CHECK();
    Rn = level(R, B, nch, k);
  }
  NPT_LAUNCH(blocks_for(8LL * n_groups), kThreads, 0, st, fwd_replay)(
      a, static_cast<const float*>(s0), Rn, nch, n_groups,
      static_cast<float*>(f));
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
