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
// chain_traceback replaces tropical.py::_traceback_batch: b_{c-1} = P[c,
// b_c], from b_end at each row's last cell (padding cells carry the
// identity map).  JAX composes the maps as 0/NEG relation matrices through
// _forward_states and takes the argmax; a composition of maps has exactly
// one 0 per row there, so composing the 8-entry maps directly, as 3-bit
// fields of one 32-bit word, gives the same bytes:
//   1. tb_maps: per 128-cell chunk, the composed map (thread per chunk);
//   2. tb_walk: per row one warp walks the chunk maps from the end, 32 at a
//      time (a 5-step suffix composition across the lanes), writing the
//      base at every chunk's last cell;
//   3. tb_replay: per chunk, the walk within the chunk (thread per chunk).
//
// What bounds them on the H100.  chain_forward reads A (256 B a cell) in
// phases 1 and 3 and writes f (32 B a cell): bytes, about 0.7 ms at 8.4 M
// cells, against about 10^3 float operations a cell.  Its dependency chain
// is 128 + 2 log2(chunks) + 128 steps.  The design spreads phases 1 and 3
// over B x L/128 groups of 8 threads, which fills the card at task-1 sizes,
// reads each A_t as two 16-byte loads per thread that the group shares,
// and pays one kernel launch per tree level of phase 2 (34 launches at
// 8.4 M cells, a few microseconds each).  chain_traceback reads P (32 B a
// cell) and writes one byte a cell; a dependent global load per cell would
// cost about 0.3 s at 8 M cells, so no load sits on a dependency: each P
// row is loaded and packed, then one shift and mask walks it, and tb_walk
// prefetches the next 32 chunk maps while it composes the current ones.
//
// Every launch goes to the caller's stream (PyTorch's current stream); the
// C entry points return cudaGetLastError() after each launch and allocate
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 8;
constexpr int kChunk = 128;
constexpr int kThreads = 256;
constexpr float kNeg = -1e9f;  // ops/chain.py NEG, exact in f32
constexpr unsigned kFull = 0xffffffffu;
// the identity map {0..7} -> {0..7}, 3 bits per entry
constexpr uint32_t kIdentity = 0u | 1u << 3 | 2u << 6 | 3u << 9 | 4u << 12 |
                               5u << 15 | 6u << 18 | 7u << 21;

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

__device__ __forceinline__ int apply_map(uint32_t m, int b) {
  return (int)((m >> (3 * b)) & 7u);
}

// (x o y)(b) = x(y(b))
__device__ __forceinline__ uint32_t compose_maps(uint32_t x, uint32_t y) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < kS; b++)
    r |= (uint32_t)apply_map(x, apply_map(y, b)) << (3 * b);
  return r;
}

// One cell's pointer row P[c, 0..7] as a packed map.
__device__ __forceinline__ uint32_t load_map(const int* __restrict__ p) {
  const int4 lo = __ldg(reinterpret_cast<const int4*>(p));
  const int4 hi = __ldg(reinterpret_cast<const int4*>(p) + 1);
  return (uint32_t)(lo.x & 7) | (uint32_t)(lo.y & 7) << 3 |
         (uint32_t)(lo.z & 7) << 6 | (uint32_t)(lo.w & 7) << 9 |
         (uint32_t)(hi.x & 7) << 12 | (uint32_t)(hi.y & 7) << 15 |
         (uint32_t)(hi.z & 7) << 18 | (uint32_t)(hi.w & 7) << 21;
}

// G[g] = P_{first cell} o ... o P_{last cell} of chunk g: the base at the
// cell before the chunk, given the base at the chunk's last cell.
__global__ void __launch_bounds__(kThreads)
tb_maps(const int* __restrict__ P, int n_groups, uint32_t* __restrict__ G) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  const int* p = P + g * kChunk * kS;
  uint32_t m = kIdentity;
#pragma unroll 8
  for (int c = kChunk - 1; c >= 0; c--)
    m = compose_maps(load_map(p + c * kS), m);
  G[g] = m;
}

// Per row (one warp): E[chunk] = the base at the chunk's last cell, from
// b_end at the row's last cell, 32 chunk maps at a time.
__global__ void __launch_bounds__(kThreads)
tb_walk(const uint32_t* __restrict__ G, const int* __restrict__ b_end, int B,
        int nch, int* __restrict__ E) {
  const int row = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // whole warps only
  const uint32_t* g = G + (long long)row * nch;
  int* e = E + (long long)row * nch;
  int e_in = b_end[row] & 7;
  int hi = nch;
  int lo = hi > 32 ? hi - 32 : 0;
  uint32_t nxt = lane < hi - lo ? g[lo + lane] : kIdentity;
  while (hi > 0) {
    const int n = hi - lo;
    uint32_t T = nxt;
    // prefetch the next 32 maps while these compose
    const int hi2 = lo, lo2 = lo > 32 ? lo - 32 : 0;
    nxt = lane < hi2 - lo2 ? g[lo2 + lane] : kIdentity;
    // suffix composition: T_l = G_{lo+l} o ... o G_{hi-1}
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_down_sync(kFull, T, d);
      if (lane + d < 32) T = compose_maps(T, o);
    }
    const uint32_t after = __shfl_down_sync(kFull, T, 1);
    if (lane < n) e[lo + lane] = lane == n - 1 ? e_in : apply_map(after, e_in);
    e_in = apply_map(__shfl_sync(kFull, T, 0), e_in);
    hi = hi2;
    lo = lo2;
  }
}

// Per chunk: the walk from the base at its last cell down to its first.
__global__ void __launch_bounds__(kThreads)
tb_replay(const int* __restrict__ P, const int* __restrict__ E, int n_groups,
          int8_t* __restrict__ choice) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  const int* p = P + g * kChunk * kS;
  int8_t* out = choice + g * kChunk;
  int b = E[g];
#pragma unroll 8
  for (int c = kChunk - 1; c >= 0; c--) {
    out[c] = (int8_t)b;
    b = apply_map(load_map(p + c * kS), b);
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
  fwd_chunks<<<blocks_for(8LL * n_groups), kThreads, 0, st>>>(a, n_groups, X);
  NPT_CHECK();
  const int K = log2_exact(nch);
  for (int k = 0; k < K; k++) {
    const int n_out = nch >> (k + 1);
    fwd_up<<<blocks_for(8LL * B * n_out), kThreads, 0, st>>>(
        level(X, B, nch, k), level(X, B, nch, k + 1), n_out, B);
    NPT_CHECK();
  }
  const float* Rn = level(X, B, nch, K);
  for (int k = K - 1; k >= 0; k--) {
    const int n = nch >> k;
    fwd_down<<<blocks_for(8LL * B * n), kThreads, 0, st>>>(
        Rn, level(X, B, nch, k), level(R, B, nch, k), n, B);
    NPT_CHECK();
    Rn = level(R, B, nch, k);
  }
  fwd_replay<<<blocks_for(8LL * n_groups), kThreads, 0, st>>>(
      a, static_cast<const float*>(s0), Rn, nch, n_groups,
      static_cast<float*>(f));
  NPT_CHECK();
  return 0;
}

// choice [B, nch*128] int8 from P [B, nch*128, 8] int32 and b_end [B]
// int32; maps and ends are int32 scratch of B * nch each.
int npt_chain_traceback(const void* P, const void* b_end, int B, int nch,
                        void* maps, void* ends, void* choice, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(P);
  uint32_t* G = static_cast<uint32_t*>(maps);
  int* E = static_cast<int*>(ends);
  const int n_groups = B * nch;
  tb_maps<<<blocks_for(n_groups), kThreads, 0, st>>>(p, n_groups, G);
  NPT_CHECK();
  tb_walk<<<blocks_for(32LL * B), kThreads, 0, st>>>(
      G, static_cast<const int*>(b_end), B, nch, E);
  NPT_CHECK();
  tb_replay<<<blocks_for(n_groups), kThreads, 0, st>>>(
      p, E, n_groups, static_cast<int8_t*>(choice));
  NPT_CHECK();
  return 0;
}

const char* npt_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
