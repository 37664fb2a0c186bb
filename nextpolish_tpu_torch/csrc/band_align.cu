// The built-in mappers' extension stage for NVIDIA Hopper, sm_90a: the
// banded affine-gap DP `band_align` and its traceback walk
// `band_traceback`.
//
// band_align replaces nextpolish_tpu/align/extend.py::_band_align_core (an
// XLA program in the JAX package: one lax.scan over the query rows, the
// band as a vector).  Per read b, with q [Bt, R] and t [Bt, R+B] uint8 base
// codes (4 = pad), cell (i, c) aligns q[i] to t[i+c]; per row:
//   E[c]  = max(H'[c+1] - gapo, E'[c+1]) - gape     (from the row above)
//   Hp[c] = max(H'[c] + sub(i, c), E[c])            (floored at 0 unless
//                                                    global)
//   F[c]  = cummax_{c'<c}(Hp[c'] + c'*gape) - (gapo+gape) - c*gape
//   H[c]  = max(Hp[c], F[c])
// with the closed form of F, its "open" bit (Hp[c-1] + (c-1)*gape equals
// the running max, ties included) and the H-source priority of each mode
// exactly as extend.py writes them, so tb [Bt, R, B] (H source | E open << 2
// | F open << 3), the best score and the end cell are byte-equal to JAX's.
// Local and extend modes keep the first row reaching a strictly greater
// maximum and that row's first maximal cell (jnp.argmax), then apply the
// clip3 rule; global mode reads the forced end cell (qlen-1, tlen-qlen+B/2)
// as jnp.take_along_axis does (a negative index wraps once, anything still
// outside the band reads INT32_MIN).
//
// Design: one block per read; each thread owns K = 1 or 2 adjacent band
// cells (B <= 1024 or <= 2048), so the 1,150-cell mate-rescue band runs on
// 576 threads.  The row above lives in shared memory, double-buffered, so a
// row costs three barriers: (A) after the per-thread scan totals, (B) after
// the cross-warp scan, (C) after the row is written.  The cummax is a
// sequential scan over the thread's cells, a warp max-scan by shuffles and
// one pass over the warp totals.  The row's maximum and its first cell are
// one 64-bit max-reduction of (H << 32) + (2^32 - 1 - c).  Every row is
// computed, rows past qlen included, since tb is returned whole.
//
// band_traceback replaces extend.py::_traceback_device (a lax.while_loop
// vectorised over the batch).  One thread per read walks tb from the end
// cell through the H/E/F state machine, writing op+1 codes as 2-bit fields,
// four steps a byte, little-endian; the caller zero-fills ops [Bt, S/4].
// A read stops at START or at i < 0; a read whose cell leaves the band
// stops too, emitting zeros and keeping its cell, which is where the
// batched loop leaves such a read.
//
// What bounds them on the H100.  band_align writes one tb byte a cell and
// does about 30 integer operations a cell: about 0.3 ps a cell by bytes at
// 3.35 TB/s, 0.45 ps by operations at 67 T/s, so 18 us for the 39 M cells
// of an 8,192-read short-read batch.  Its real limit is the row chain: R
// dependent rows, each three barriers and a shuffle scan, per block; the
// design keeps a read in one block so no row waits on another block, and
// fills the card with reads (8,192 one-warp blocks at the short-read
// shape).  band_traceback is a chain of dependent one-byte loads, one per
// step (up to 2R + B of them); it reads a few bytes a step and is bounded by
// load latency, which threads of different reads overlap.
//
// Every launch goes to the caller's stream; the C entry points return
// cudaGetLastError() after each launch and allocate nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -10000000;  // align/extend.py NEG
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGlobal = 1, kExtend = 2;  // extend.py MODES (0 = local)
constexpr int kStart = 0, kDiag = 1, kE = 2, kF = 3;  // H sources
constexpr long long kKeyMin = LLONG_MIN;
constexpr long long kTwo32 = 4294967296LL;

struct Params {
  int R, B, mode, match, mismatch, gapo, gape, clip5, clip3;
};

// Order by H, then by the smaller cell.
__device__ __forceinline__ long long key_of(int h, int c) {
  return (long long)h * kTwo32 + (long long)(0xffffffffu - (unsigned)c);
}
__device__ __forceinline__ int key_h(long long k) { return (int)(k >> 32); }
__device__ __forceinline__ int key_c(long long k) {
  return (int)(0xffffffffu - (unsigned)(k & 0xffffffffLL));
}

__device__ __forceinline__ long long warp_max64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Shared memory: H and E of the row above, double-buffered (B+1 cells each,
// the last one the NEG pad), the per-warp scan totals, the scanned warp
// prefixes, each warp's last decay value, and the per-warp row maxima.
struct Smem {
  int* H;
  int* E;
  int* wsum;
  int* wpre;
  int* wlast;
  long long* red;
};

__device__ __forceinline__ Smem carve(int* base, int B) {
  Smem s;
  s.H = base;
  s.E = base + 2 * (B + 1);
  s.wsum = s.E + 2 * (B + 1);
  s.wpre = s.wsum + 32;
  s.wlast = s.wpre + 32;
  // 8-byte aligned: 4(B+1) + 96 ints, rounded up to even
  const int used = 4 * (B + 1) + 96;
  s.red = reinterpret_cast<long long*>(base + used + (used & 1));
  return s;
}

template <int K>
__global__ void __launch_bounds__(1024)
band_align_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  const int* __restrict__ qlen_, const int* __restrict__ tlen_,
                  Params p, uint8_t* __restrict__ tb, int* __restrict__ best_o,
                  int* __restrict__ best_i_o, int* __restrict__ best_c_o) {
  extern __shared__ int smem_raw[];
  const int R = p.R, B = p.B;
  const Smem s = carve(smem_raw, B);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool extend = p.mode == kExtend;
  const bool local = p.mode != kGlobal;
  const int off = local ? 0 : B / 2;
  const int qlen = qlen_[b], tlen = tlen_[b];
  const uint8_t* qb = q + (size_t)b * R;
  const uint8_t* tbase = t + (size_t)b * (R + B);
  uint8_t* tbo = tb + (size_t)b * R * B;

  // row -1 into buffer 0; both buffers' pad cell B holds NEG
  for (int c = tid; c <= B; c += blockDim.x) {
    int h;
    if (c == B) {
      h = kNeg;
    } else if (extend) {
      h = c == 0 ? p.clip5 : p.clip5 - (p.gapo + c * p.gape);
    } else if (local) {
      h = p.clip5;
    } else {
      h = c == off ? 0 : (c > off ? -(p.gapo + (c - off) * p.gape) : kNeg);
    }
    s.H[c] = h;
    s.E[c] = kNeg;
    if (c == B) {
      s.H[2 * B + 1] = kNeg;
      s.E[2 * B + 1] = kNeg;
    }
  }
  int hfin[K];
#pragma unroll
  for (int k = 0; k < K; k++) hfin[k] = kNeg;
  int run_h = INT_MIN, run_i = 0, run_c = 0;  // thread 0: the best row
  __syncthreads();

  for (int i = 0; i < R; i++) {
    const int* Hu = s.H + (i & 1) * (B + 1);
    const int* Eu = s.E + (i & 1) * (B + 1);
    int* Hn = s.H + ((i + 1) & 1) * (B + 1);
    int* En = s.E + ((i + 1) & 1) * (B + 1);
    const int qi = qb[i];
    const bool vq = qi < 4 && i < qlen;
    int hp[K], ev[K], dg[K], dec[K], cmi[K];
    unsigned eo = 0;
    int run = INT_MIN;
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int c = tid * K + k;
      int d = INT_MIN;
      if (c < B) {
        const int hup = Hu[c + 1], eup = Eu[c + 1];
        const int tj = tbase[i + c];
        const int j = i + c - off;
        const bool vt = tj < 4 && j < tlen && j >= 0;
        const int sub = (vq && vt) ? (qi == tj ? p.match : -p.mismatch) : kNeg;
        if (hup - p.gapo >= eup) eo |= 1u << k;
        ev[k] = max(hup - p.gapo, eup) - p.gape;
        dg[k] = Hu[c] + sub;
        int h = max(dg[k], ev[k]);
        if (local) h = max(h, 0);
        hp[k] = h;
        d = h + c * p.gape;
      }
      dec[k] = d;
      run = max(run, d);
      cmi[k] = run;
    }
    // exclusive max-scan of the thread totals: warp shuffles, then one
    // pass over the warp totals
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int texcl = __shfl_up_sync(kFull, incl, 1);
    int prev_dec = __shfl_up_sync(kFull, dec[K - 1], 1);
    if (lane == 31) {
      s.wsum[warp] = incl;
      s.wlast[warp] = dec[K - 1];
    }
    __syncthreads();  // (A)
    if (warp == 0 && nwarps > 1) {
      const int v = lane < nwarps ? s.wsum[lane] : INT_MIN;
      int w = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w = max(w, u);
      }
      const int ex = __shfl_up_sync(kFull, w, 1);
      s.wpre[lane] = lane == 0 ? INT_MIN : ex;
    }
    __syncthreads();  // (B)
    if (lane == 0) {
      texcl = INT_MIN;
      prev_dec = warp > 0 ? s.wlast[warp - 1] : kNeg;
    }
    if (nwarps > 1) texcl = max(texcl, s.wpre[warp]);

    long long rowkey = kKeyMin;
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int c = tid * K + k;
      if (c < B) {
        const int cms = c == 0 ? kNeg : (k == 0 ? texcl : max(texcl, cmi[k - 1]));
        const int hps = c == 0 ? kNeg : (k == 0 ? prev_dec : dec[k - 1]);
        const int F = cms - (p.gapo + p.gape) - c * p.gape;
        const bool fo = hps >= cms;
        const int H = max(hp[k], F);
        int src;
        if (local) {
          src = H == 0 ? kStart : (H == F ? kF : (H == dg[k] ? kDiag : kE));
          if (H == dg[k] && H > 0) src = kDiag;
        } else {
          src = H == F ? kF : (H == dg[k] ? kDiag : kE);
          if (H == dg[k]) src = kDiag;
        }
        tbo[(size_t)i * B + c] =
            (uint8_t)(src | (((eo >> k) & 1u) << 2) | ((fo ? 1u : 0u) << 3));
        Hn[c] = H;
        En[c] = ev[k];
        if (i == qlen - 1) hfin[k] = H;
        if (local) {
          const long long kk = key_of(H, c);
          rowkey = kk > rowkey ? kk : rowkey;
        }
      }
    }
    if (local) {
      rowkey = warp_max64(rowkey);
      if (lane == 0) s.red[warp] = rowkey;
    }
    __syncthreads();  // (C)
    if (local && warp == 0) {
      long long v = lane < nwarps ? s.red[lane] : kKeyMin;
      v = warp_max64(v);
      if (tid == 0 && key_h(v) > run_h) {
        run_h = key_h(v);
        run_i = i;
        run_c = key_c(v);
      }
    }
  }

  if (local) {
    int best = run_h, bi = run_i, bc = run_c;
    if (p.clip3) {
      __syncthreads();  // warp 0 has read the last row's maxima
      long long g = kKeyMin;
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int c = tid * K + k;
        if (c < B) {
          const long long kk = key_of(hfin[k], c);
          g = kk > g ? kk : g;
        }
      }
      g = warp_max64(g);
      if (lane == 0) s.red[warp] = g;
      __syncthreads();
      if (warp == 0) {
        g = warp_max64(lane < nwarps ? s.red[lane] : kKeyMin);
        const int gb = key_h(g);
        if (gb > 0 && gb + p.clip3 >= best) {
          best = gb;
          bi = qlen - 1;
          bc = key_c(g);
        }
      }
    }
    if (tid == 0) {
      best_o[b] = best;
      best_i_o[b] = bi;
      best_c_o[b] = bc;
    }
  } else {
    const int bc = tlen - qlen + off;
    const int idx = bc < 0 ? bc + B : bc;
    if (idx < 0 || idx >= B) {
      if (tid == 0) best_o[b] = INT_MIN;
    } else {
#pragma unroll
      for (int k = 0; k < K; k++)
        if (tid * K + k == idx) best_o[b] = hfin[k];
    }
    if (tid == 0) {
      best_i_o[b] = qlen - 1;
      best_c_o[b] = bc;
    }
  }
}

__global__ void band_traceback_kernel(const uint8_t* __restrict__ tb,
                                      const int* __restrict__ end_i,
                                      const int* __restrict__ end_c, int Bt,
                                      int R, int B, int S,
                                      uint8_t* __restrict__ ops,
                                      int* __restrict__ fin_i,
                                      int* __restrict__ fin_c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bt) return;
  const uint8_t* tbb = tb + (size_t)b * R * B;
  uint8_t* ob = ops + (size_t)b * (S / 4);
  int i = end_i[b], c = end_c[b], state = 0;
  unsigned acc = 0;
  int step = 0;
  for (; step < S; step++) {
    // done (i < 0), or out of the band: nothing moves any more
    if (i < 0 || c < 0 || c >= B) break;
    const int cell = tbb[(size_t)i * B + c];
    unsigned act = 0;
    if (state == 0) {
      const int h = cell & 3;
      if (h == kStart) break;
      if (h == kDiag) {
        act = 1;  // M + 1
        i -= 1;
      } else {
        state = h == kE ? 1 : 2;
      }
    } else if (state == 1) {
      act = 2;  // I + 1
      i -= 1;
      c += 1;
      if ((cell >> 2) & 1) state = 0;
    } else {
      act = 3;  // D + 1
      c -= 1;
      if ((cell >> 3) & 1) state = 0;
    }
    acc |= act << (2 * (step & 3));
    if ((step & 3) == 3) {
      ob[step >> 2] = (uint8_t)acc;
      acc = 0;
    }
  }
  if (step & 3) ob[step >> 2] = (uint8_t)acc;
  fin_i[b] = i;
  fin_c[b] = c;
}

size_t smem_bytes(int B) {
  const int used = 4 * (B + 1) + 96;
  return (size_t)(used + (used & 1)) * 4 + 32 * sizeof(long long);
}

}  // namespace

extern "C" {

// tb [Bt, R, B] u8, best / best_i / best_c [Bt] i32 from q [Bt, R] u8,
// t [Bt, R+B] u8, qlen / tlen [Bt] i32; mode 0 local, 1 global, 2 extend;
// 1 <= B <= 2048.
int npt_band_align(const void* q, const void* t, const void* qlen,
                   const void* tlen, int Bt, int R, int B, int mode,
                   int match, int mismatch, int gapo, int gape, int clip5,
                   int clip3, void* tb, void* best, void* best_i,
                   void* best_c, void* stream) {
  if (B < 1 || B > 2048 || R < 1 || Bt < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Params p{R, B, mode, match, mismatch, gapo, gape, clip5, clip3};
  const int K = B <= 1024 ? 1 : 2;
  const int threads = ((B + K - 1) / K + 31) / 32 * 32;
  const size_t sm = smem_bytes(B);
  const uint8_t* q8 = static_cast<const uint8_t*>(q);
  const uint8_t* t8 = static_cast<const uint8_t*>(t);
  const int* ql = static_cast<const int*>(qlen);
  const int* tl = static_cast<const int*>(tlen);
  uint8_t* tb8 = static_cast<uint8_t*>(tb);
  int* bo = static_cast<int*>(best);
  int* bi = static_cast<int*>(best_i);
  int* bc = static_cast<int*>(best_c);
  if (K == 1)
    band_align_kernel<1><<<Bt, threads, sm, st>>>(q8, t8, ql, tl, p, tb8, bo,
                                                   bi, bc);
  else
    band_align_kernel<2><<<Bt, threads, sm, st>>>(q8, t8, ql, tl, p, tb8, bo,
                                                   bi, bc);
  return (int)cudaGetLastError();
}

// ops [Bt, S/4] u8 (zero-filled by the caller), fin_i / fin_c [Bt] i32
// from tb [Bt, R, B] u8 and the end cells; S a multiple of 4.
int npt_band_traceback(const void* tb, const void* end_i, const void* end_c,
                       int Bt, int R, int B, int S, void* ops, void* fin_i,
                       void* fin_c, void* stream) {
  if (Bt < 1 || R < 1 || B < 1 || S % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 128;
  band_traceback_kernel<<<(Bt + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const uint8_t*>(tb), static_cast<const int*>(end_i),
      static_cast<const int*>(end_c), Bt, R, B, S,
      static_cast<uint8_t*>(ops), static_cast<int*>(fin_i),
      static_cast<int*>(fin_c));
  return (int)cudaGetLastError();
}

const char* npt_band_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
