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
// Local and extend modes end at jnp.argmax's cell: the first row reaching
// the largest H, and that row's first cell holding it.  That is the
// lexicographic best of (largest H, smallest row, smallest cell), so each
// thread keeps a running best over its own cells (replaced only by a
// strictly larger H, rows and cells visited in order) and the read's
// threads reduce it once, after the last row; then the clip3 rule.  Global
// mode reads the forced end cell (qlen-1, tlen-qlen+B/2) as
// jnp.take_along_axis does (a negative index wraps once, anything still
// outside the band reads INT32_MIN).
//
// Design of band_align.  Each thread owns K adjacent band cells and keeps
// H and E of the row above in registers: a cell's H'[c+1] / E'[c+1] is the
// thread's next register or, for its last cell, the next thread's first
// cell, one __shfl_down_sync away.  F's cummax is the thread's sequential
// scan over its K cells plus one 5-round warp shuffle scan; the previous
// thread's last decay value comes by one shuffle.  The read's q and t are
// staged into shared memory by coalesced 16-byte loads, kChunk rows at a
// time, as codes with the validity tests folded in (an invalid query base
// reads kQBad, a base outside t or the segment reads kTBad), so a row needs
// one broadcast load of q and one byte of t per thread (the thread's t
// window slides by one a row).  A thread writes its K tb bytes of a row as
// one vector store where B % K == 0, so a row is one coalesced B-byte write.
// Rows past qlen are computed, since tb is returned whole.  Two routes:
//   warp route, B <= 256 (short reads B = 32, end extensions 64, segment
//     buckets up to B = 256), and 256 < B <= 512 from kWideWarpReads reads
//     a launch: one warp per read, four reads a block, K = the smallest
//     power of two with 32K >= B (1..16); no block barrier at all; two rows
//     a trip at K = 16.  The row step is two shuffles for the neighbours, K
//     cells of integer work, a 5-round shuffle scan and two shuffles for
//     the scan's exclusive value and the previous decay.
//   block route, every other launch up to B = 2048 (mate rescue, B =
//     1,150; a B = 512 segment bucket of fewer reads): one block per
//     read, K = 4 cells a thread (up to 16 warps); the warp's first cell and
//     each warp's scan total and last decay value cross warps through
//     shared memory, so a row has two barriers: (P) after the warp totals
//     are written (each warp then reduces the totals of the warps before it
//     itself), (Q) after each warp's first cell is written for the row
//     below.
// At B = 512 a warp of K = 16 cells a lane is latency-bound: with few reads
// the block route's 4 warps a read take it faster (R = 4,096 on an H100:
// 1.45 against 1.90 ms at 16 and at 128 reads), while from about two
// reads an SM the block route runs out of issue slots first (1.00 against
// 0.98 ms at 256 reads, R = 2,100; 5.65 against 3.21 ms at 1,024 reads).
//
// band_traceback replaces extend.py::_traceback_device (a lax.while_loop
// vectorised over the batch).  One warp per read: the walk only ever moves
// to the same or a lower row, so the warp copies tb in tiles from the end
// row downward into a ring of shared-memory stages by cp.async, 16 bytes a
// lane, keeping up to three tiles in flight while it walks the tile that
// has arrived.  Bands up to kWinCols take whole rows (T·B about 8 KB a
// tile; one tile when R·B fits); wider bands, whose walk reads one or two
// cells a row, take windows of kWinCols columns around the walk's cell,
// kWinRows rows a tile, and fetch anew from the current row when the walk
// leaves the window.  The H/E/F state machine runs in step in every lane;
// in state H the lanes read the walk's column in the next 32 rows and one
// ballot gives the run of DIAG moves, taken at once (most of a walk is
// such runs), while E and F moves go one step a trip.  Op+1 codes are 2-bit
// fields, four steps a byte, little-endian, gathered in shared memory and
// copied out by the warp at the end; the caller zero-fills ops [Bt, S/4].
// A read stops at START or at i < 0; a read whose cell leaves the band
// stops too, emitting zeros and keeping its cell, which is where the
// batched loop leaves such a read.  End rows are band_align's (below R); a
// read whose end row is R or more stops at once.
//
// What bounds them on the H100.  band_align writes one tb byte a cell and
// does about 30 integer operations a cell: 18 us by operations for the
// 39 M cells of an 8,192-read short-read batch.  Its dependency bound is the
// row chain: R dependent rows, each at least one neighbour exchange and a
// log2(B/K)-round shuffle scan (band_step_probe measures a round).  At the
// short-read shape the launch is about 1.3 waves of 48 warps an SM, and the
// schedulers' issue rate, not the chain, limits it; a few wide reads (16
// at B = 512, on the block route) are latency-bound, the row's barriers in
// series.
// band_traceback moves a few bytes a step; its dependency bound is its
// longest walk at one dependent shared-memory load and state update a step
// (band_step_probe measures it), which the DIAG runs undercut 32 rows a
// ballot; the copy of the next tiles overlaps the walk.
//
// Every launch goes to the caller's stream; the C entry points return
// cudaGetLastError() after each launch and allocate nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// The dynamic shared memory, the cp.async instructions and a kernel launch
// go through these macros, which csrc/emu/cuda_runtime.h (the CPU stand-in
// that emu_band.py builds this file against) defines anew.
#ifndef NPT_EMU
#define NPT_DYNAMIC_SMEM(name) extern __shared__ __align__(16) uint8_t name[]
#define NPT_CP_ASYNC16(dst, src)                                          \
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(      \
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))), \
               "l"(src))
#define NPT_CP_ASYNC_COMMIT() asm volatile("cp.async.commit_group;\n" ::)
#define NPT_CP_ASYNC_WAIT(n) asm volatile("cp.async.wait_group %0;\n" ::"n"(n))
#define NPT_LAUNCH(grid, block, smem, stream, ...) \
  __VA_ARGS__<<<grid, block, smem, stream>>>
#endif

namespace {

constexpr int kNeg = -10000000;  // align/extend.py NEG
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGlobal = 1, kExtend = 2;  // extend.py MODES (0 = local)
constexpr int kStart = 0, kDiag = 1, kE = 2, kF = 3;  // H sources
constexpr int kQBad = 16, kTBad = 8;  // staged codes of invalid bases
constexpr int kChunk = 1024;          // rows of q / t staged at a time
constexpr int kWarpMaxB = 512;        // widest band of the warp route
constexpr int kWideWarpB = 256;       // wider bands take it from
constexpr int kWideWarpReads = 256;   //   this many reads a launch
constexpr int kWarpReads = 4;         // reads (warps) a block, warp route
constexpr int kBlockK = 4;            // cells a thread, block route
constexpr int kTileBytes = 8192;      // traceback tile of full rows
constexpr int kWinCols = 64;          // wider bands: a window of columns
constexpr int kWinRows = 32;          // rows of a window tile
constexpr int kWinStride = 80;        // bytes a window row takes in a stage
constexpr int kStages = 4;            // traceback ring, when R·B > a tile
constexpr int kWalkReads = 4;         // reads (warps) a block, traceback

struct Params {
  int R, B, mode, match, mismatch, gapo, gape, clip5, clip3;
};

// Bytes a staged copy of n bytes may span: 16-byte chunks from the aligned
// address at or below its start.
__host__ __device__ constexpr int span16(int n) { return (n + 30) / 16 * 16; }

// (h, i, c) beats (h2, i2, c2): larger h, then smaller row, then smaller
// cell.
__device__ __forceinline__ bool better(int h, int i, int c, int h2, int i2,
                                       int c2) {
  return h > h2 || (h == h2 && (i < i2 || (i == i2 && c < c2)));
}

__device__ __forceinline__ void warp_best(int& h, int& i, int& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int h2 = __shfl_xor_sync(kFull, h, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    const int c2 = __shfl_xor_sync(kFull, c, o);
    if (better(h2, i2, c2, h, i, c)) {
      h = h2;
      i = i2;
      c = c2;
    }
  }
}

// dst[x] = the code at row[x0 + x] for x < n (row holds len bytes), or
// `bad` where the code is not a base (>= 4), its position lies outside
// [lo, hi) or past len.  The row is read by 16-byte loads from the aligned
// address at or below row + x0 (bytes around it in the same 16-byte chunk
// are read and dropped); tid / nthr spread the chunks over the threads.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* row,
                                      int len, int x0, int n, int lo, int hi,
                                      int bad, int tid, int nthr) {
  const int m = max(0, min(n, len - x0));
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + x0);
  const uint4* src = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int delta = static_cast<int>(a & 15);
  const int chunks = m > 0 ? (delta + m + 15) >> 4 : 0;
  for (int k = tid; k < chunks; k += nthr) {
    const uint4 v = __ldg(src + k);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; j++) {
      const int x = 16 * k + j - delta;
      if (x >= 0 && x < m) {
        const int code = (w[j >> 2] >> (8 * (j & 3))) & 255;
        const int at = x0 + x;
        dst[x] = static_cast<uint8_t>(
            code < 4 && at >= lo && at < hi ? code : bad);
      }
    }
  }
  for (int x = m + tid; x < n; x += nthr) dst[x] = static_cast<uint8_t>(bad);
}

// Shared memory of the block route: the cross-warp exchange (each warp's
// first cell for the row below, its scan total and last decay value, and
// the final reductions), then the staged q and t.
struct Xchg {
  int h[32], e[32], sum[32], last[32], rh[32], ri[32], rc[32];
};

__host__ __device__ constexpr int read_smem(int cells) {
  return kChunk + span16(kChunk + cells);
}

template <int K, bool kBlock, bool kLocal>
__global__ void __launch_bounds__(kBlock ? 512 : 32 * kWarpReads)
band_align_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  const int* __restrict__ qlen_, const int* __restrict__ tlen_,
                  Params p, int Bt, int vec_store, uint8_t* __restrict__ tb,
                  int* __restrict__ best_o, int* __restrict__ best_i_o,
                  int* __restrict__ best_c_o) {
  NPT_DYNAMIC_SMEM(smem);
  const int R = p.R, B = p.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = kBlock ? static_cast<int>(blockDim.x >> 5) : 1;
  const int b = kBlock ? blockIdx.x : blockIdx.x * kWarpReads + warp;
  if (!kBlock && b >= Bt) return;  // the whole warp: no barrier follows
  const int tid = kBlock ? threadIdx.x : lane;
  const int nthr = 32 * nwarps;
  const int span = nthr * K;  // cells the read's threads cover (>= B)
  Xchg* x = reinterpret_cast<Xchg*>(smem);
  uint8_t* qs = kBlock ? smem + sizeof(Xchg) : smem + warp * read_smem(span);
  uint8_t* ts = qs + kChunk;

  const int off = kLocal ? 0 : B / 2;
  const int qlen = qlen_[b], tlen = tlen_[b];
  const uint8_t* qb = q + (size_t)b * R;
  const uint8_t* tbase = t + (size_t)b * (R + B);
  uint8_t* tbo = tb + (size_t)b * R * B;
  const int c0 = tid * K;
  const bool pads = c0 + K > B;  // the thread holds cells past the band
  const int gopen = p.gapo + p.gape;

  // row -1; cells at or past B stay NEG (the band's pad cell)
  int h[K], e[K], tv[K];
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int c = c0 + k;
    int v;
    if (c >= B) {
      v = kNeg;
    } else if (p.mode == kExtend) {
      v = c == 0 ? p.clip5 : p.clip5 - (p.gapo + c * p.gape);
    } else if (kLocal) {
      v = p.clip5;
    } else {
      v = c == off ? 0 : (c > off ? -(p.gapo + (c - off) * p.gape) : kNeg);
    }
    h[k] = v;
    e[k] = kNeg;
    tv[k] = kTBad;
  }
  if (kBlock && lane == 0) {
    x->h[warp] = h[0];
    x->e[warp] = e[0];
  }
  // global mode's forced end cell
  const int gcell = tlen - qlen + off;
  const int gidx = gcell < 0 ? gcell + B : gcell;
  // local: the thread's best key H*16 + (15 - k) (a larger key is a larger
  // H, then a smaller cell) and its row; the same for row qlen-1 (clip3)
  int bkey = INT_MIN, bi = 0, gkey = INT_MIN;
  int gv = kNeg;  // global: H at the forced end cell (its thread)

  for (int i0 = 0; i0 < R; i0 += kChunk) {
    if (kBlock) __syncthreads(); else __syncwarp();
    stage(qs, qb, R, i0, kChunk, 0, qlen, kQBad, tid, nthr);
    stage(ts, tbase, R + B, i0, kChunk + span, off, off + tlen, kTBad, tid,
          nthr);
    if (kBlock) __syncthreads(); else __syncwarp();
    if (i0 == 0) {
#pragma unroll
      for (int k = 1; k < K; k++) tv[k] = ts[c0 + k - 1];
    }
    const int i1 = min(R, i0 + kChunk);
    // the next row's query base and new t byte, loaded a row ahead (one
    // past the chunk's last row stays inside the staged buffers)
    int qn = qs[0], tn = ts[c0 + K - 1];
    // two rows a trip where a lane holds 16 cells: the compiler overlaps
    // one row's tail with the next row's head
#pragma unroll(K >= 16 ? 2 : 1)
    for (int i = i0; i < i1; i++) {
      const int qi = qn;
#pragma unroll
      for (int k = 0; k + 1 < K; k++) tv[k] = tv[k + 1];
      tv[K - 1] = tn;
      qn = qs[i + 1 - i0];
      tn = ts[i + 1 - i0 + c0 + K - 1];
      const int mis = qi < 4 ? -p.mismatch : kNeg;
      // the row above at c+1 for the last cell: the next thread's first
      int hn = __shfl_down_sync(kFull, h[0], 1);
      int en = __shfl_down_sync(kFull, e[0], 1);
      if (lane == 31) {
        const bool nxt = kBlock && warp + 1 < nwarps;
        hn = nxt ? x->h[warp + 1] : kNeg;
        en = nxt ? x->e[warp + 1] : kNeg;
      }
      int hp[K], ev[K], dg[K], dec[K], cmi[K];
      unsigned eo = 0;
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int hup = k + 1 < K ? h[k + 1] : hn;
        const int eup = k + 1 < K ? e[k + 1] : en;
        const int tj = tv[k];
        const int sub = tj < 4 ? (tj == qi ? p.match : mis) : kNeg;
        const int ho = hup - p.gapo;
        if (ho >= eup) eo |= 1u << k;
        ev[k] = max(ho, eup) - p.gape;
        dg[k] = h[k] + sub;
        int hh = max(dg[k], ev[k]);
        if (kLocal) hh = max(hh, 0);
        hp[k] = hh;
        dec[k] = hh + (c0 + k) * p.gape;  // pad cells: only later pads read it
        cmi[k] = k ? max(cmi[k - 1], dec[k]) : dec[k];
      }
      // exclusive max-scan of the thread totals (shfl_up returns a lane's
      // own value where no lane lies o below, which the max absorbs)
      int incl = cmi[K - 1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        incl = max(incl, __shfl_up_sync(kFull, incl, o));
      int up = __shfl_up_sync(kFull, incl, 1);
      int prev_dec = __shfl_up_sync(kFull, dec[K - 1], 1);
      // lane 0: nothing before it in its warp; cell 0 reads NEG for both
      int texcl = lane == 0 ? INT_MIN : up;
      int cms0 = lane == 0 ? kNeg : up;
      if (lane == 0) prev_dec = kNeg;
      if (kBlock) {
        if (lane == 31) {
          x->sum[warp] = incl;
          x->last[warp] = dec[K - 1];
        }
        __syncthreads();  // (P)
        if (warp > 0) {
          int pre = INT_MIN;
          for (int v = 0; v < warp; v++) pre = max(pre, x->sum[v]);
          texcl = max(texcl, pre);
          cms0 = lane == 0 ? pre : max(cms0, pre);
          if (lane == 0) prev_dec = x->last[warp - 1];
        }
      }

      unsigned w[(K + 3) / 4];
#pragma unroll
      for (int k = 0; k < (K + 3) / 4; k++) w[k] = 0;
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int c = c0 + k;
        const int cms = k == 0 ? cms0 : max(texcl, cmi[k - 1]);
        const int hps = k == 0 ? prev_dec : dec[k - 1];
        const int F = cms - gopen - c * p.gape;
        const bool fo = hps >= cms;
        const int H = max(hp[k], F);
        const bool isd = H == dg[k];
        unsigned src = H == F ? kF : kE;
        if (kLocal) {
          if (H == 0) src = kStart;
          if (isd && H > 0) src = kDiag;
        } else {
          if (isd) src = kDiag;
        }
        w[k >> 2] |= (src | (((eo >> k) & 1u) << 2) | ((fo ? 1u : 0u) << 3))
                     << (8 * (k & 3));
        h[k] = H;
        e[k] = ev[k];
      }
      if (pads) {
#pragma unroll
        for (int k = 0; k < K; k++)
          if (c0 + k >= B) {
            h[k] = kNeg;
            e[k] = kNeg;
          }
      }
      uint8_t* row = tbo + (size_t)i * B;
      if (vec_store && !pads) {
        if constexpr (K == 1) {
          row[c0] = static_cast<uint8_t>(w[0]);
        } else if constexpr (K == 2) {
          *reinterpret_cast<uint16_t*>(row + c0) = static_cast<uint16_t>(w[0]);
        } else if constexpr (K == 4) {
          *reinterpret_cast<unsigned*>(row + c0) = w[0];
        } else if constexpr (K == 8) {
          *reinterpret_cast<uint2*>(row + c0) = make_uint2(w[0], w[1]);
        } else {
          *reinterpret_cast<uint4*>(row + c0) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; k++)
          if (c0 + k < B)
            row[c0 + k] = static_cast<uint8_t>(w[k >> 2] >> (8 * (k & 3)));
      }
      if (kLocal) {
        int rk = INT_MIN;
#pragma unroll
        for (int k = 0; k < K; k++) rk = max(rk, h[k] * 16 + (15 - k));
        if ((rk >> 4) > (bkey >> 4)) {  // a strictly larger H: a later row
          bkey = rk;                      // never wins a tie
          bi = i;
        }
        if (i == qlen - 1) gkey = rk;  // the same row for the whole read
      } else if (i == qlen - 1) {
#pragma unroll
        for (int k = 0; k < K; k++)
          if (c0 + k == gidx) gv = h[k];
      }
      if (kBlock) {
        if (lane == 0) {
          x->h[warp] = h[0];
          x->e[warp] = e[0];
        }
        __syncthreads();  // (Q)
      }
    }
  }

  if (kLocal) {
    // keys -> (H, row, cell); pad-only threads hold NEG keys, which lose
    int bh = bkey >> 4, bc = c0 + 15 - (bkey & 15);
    int gh = gkey >> 4, gc = c0 + 15 - (gkey & 15), gi = 0;
    if (bkey == INT_MIN) bh = INT_MIN;
    if (gkey == INT_MIN) gh = INT_MIN;
    warp_best(bh, bi, bc);
    warp_best(gh, gi, gc);
    if (kBlock) {
      if (lane == 0) {
        x->rh[warp] = bh;
        x->ri[warp] = bi;
        x->rc[warp] = bc;
        x->sum[warp] = gh;
        x->last[warp] = gc;
      }
      __syncthreads();
      if (warp != 0) return;
      const bool in = lane < nwarps;
      bh = in ? x->rh[lane] : INT_MIN;
      bi = in ? x->ri[lane] : 0;
      bc = in ? x->rc[lane] : 0;
      gh = in ? x->sum[lane] : INT_MIN;
      gi = 0;
      gc = in ? x->last[lane] : 0;
      warp_best(bh, bi, bc);
      warp_best(gh, gi, gc);
    }
    if (tid == 0) {
      // a read whose row qlen-1 was never computed keeps Hfin = NEG,
      // which never passes gh > 0
      if (p.clip3 && gh > 0 && gh + p.clip3 >= bh) {
        bh = gh;
        bi = qlen - 1;
        bc = gc;
      }
      best_o[b] = bh;
      best_i_o[b] = bi;
      best_c_o[b] = bc;
    }
  } else {
    if (gidx < 0 || gidx >= B) {
      if (tid == 0) best_o[b] = INT_MIN;
    } else if (gidx >= c0 && gidx < c0 + K) {
      best_o[b] = gv;
    }
    if (tid == 0) {
      best_i_o[b] = qlen - 1;
      best_c_o[b] = gcell;
    }
  }
}

// ---- band_traceback ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  NPT_CP_ASYNC16(dst, src);
}
__device__ __forceinline__ void cp_async_commit() { NPT_CP_ASYNC_COMMIT(); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  NPT_CP_ASYNC_WAIT(N);
}

// Op fields a..b-1 of a byte (2 bits each, field 0 lowest) set to M + 1.
__device__ __forceinline__ unsigned ones(int a, int b) {
  return 0x55u & (0xffu << (2 * a)) & (0xffu >> (8 - 2 * b));
}

// Start the copy of n bytes at src into dst, 16-byte chunks from the
// aligned address at or below src (dst[src & 15] holds src[0]).
__device__ __forceinline__ void copy_tile(uint8_t* dst, const uint8_t* src,
                                          int n, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint8_t* a0 = reinterpret_cast<const uint8_t*>(a & ~uintptr_t(15));
  const int chunks = (static_cast<int>(a & 15) + n + 15) >> 4;
  for (int j = lane; j < chunks; j += 32) cp_async16(dst + 16 * j, a0 + 16 * j);
}

// Start the copy of rows [lo, hi] of a read's tb into a stage.  Full rows
// (bands up to kWinCols): one span, 16-byte chunks from the aligned
// address at or below row lo.  Windows (wider bands): columns [cw, cw +
// kWinCols) of each row, row r at dst + (r - lo) * kWinStride, from the
// aligned address at or below its cell (r, cw).
template <bool kWindow>
__device__ __forceinline__ void issue_tile(uint8_t* dst, const uint8_t* tbb,
                                           int B, int lo, int hi, int cw,
                                           int lane) {
  if (!kWindow) {
    copy_tile(dst, tbb + (size_t)lo * B, (hi - lo + 1) * B, lane);
    return;
  }
  constexpr int kParts = kWinStride / 16;  // 16-byte chunks a row may span
  for (int j = lane; j < (hi - lo + 1) * kParts; j += 32) {
    const int r = j / kParts, part = j - kParts * r;
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(tbb + (size_t)(lo + r) * B + cw);
    if (16 * part < static_cast<int>(a & 15) + kWinCols)  // chunks it spans
      cp_async16(dst + r * kWinStride + 16 * part,
                 reinterpret_cast<const uint8_t*>((a & ~uintptr_t(15)) +
                                                  16 * part));
  }
}

template <int NS, bool kWindow>
__global__ void __launch_bounds__(32 * kWalkReads)
band_traceback_kernel(const uint8_t* __restrict__ tb,
                      const int* __restrict__ end_i,
                      const int* __restrict__ end_c, int Bt, int R, int B,
                      int S, int T, int stage_bytes, int ops_bytes,
                      uint8_t* __restrict__ ops, int* __restrict__ fin_i,
                      int* __restrict__ fin_c) {
  NPT_DYNAMIC_SMEM(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= Bt) return;  // the whole warp
  uint8_t* ring = smem + (size_t)warp * (NS * stage_bytes + ops_bytes);
  uint8_t* os = ring + NS * stage_bytes;
  const uint8_t* tbb = tb + (size_t)b * R * B;
  const int W = kWindow ? kWinCols : B;
  // the walk, in step with the whole warp: i, c, state, step and the
  // pending ops byte acc are the same in every lane
  int i = end_i[b], c = end_c[b];
  int state = 0, step = 0;
  unsigned acc = 0;
  bool done = !(i >= 0 && i < R && c >= 0 && c < B);
  while (!done) {
    // tiles from row top down, columns [cw, cw + W): tile k holds rows
    // [max(0, top - kT - T + 1), top - kT]
    const int top = i;
    const int cw = kWindow ? min(max(c - W / 2, 0), B - W) : 0;
    const int ntiles = top / T + 1;
    for (int k = 0; k < NS - 1; k++) {
      if (k < ntiles)
        issue_tile<kWindow>(ring + k * stage_bytes, tbb, B,
                            max(0, top - k * T - T + 1), top - k * T, cw,
                            lane);
      cp_async_commit();
    }
    bool moved = false;  // the walk left the window: refetch around it
    for (int k = 0; k < ntiles; k++) {
      const int kn = k + NS - 1;  // into the stage walked last
      if (kn < ntiles)
        issue_tile<kWindow>(ring + (kn % NS) * stage_bytes, tbb, B,
                            max(0, top - kn * T - T + 1), top - kn * T, cw,
                            lane);
      cp_async_commit();
      cp_async_wait<NS - 1>();  // tile k has landed
      __syncwarp();
      const int lo = max(0, top - k * T - T + 1);
      const int sbase = static_cast<int>(ring - smem) + (k % NS) * stage_bytes;
      const int a_lo = static_cast<int>(
          reinterpret_cast<uintptr_t>(tbb + (size_t)lo * B + cw) & 15);
      // where cell (r, cc) of the tile lies in smem
      auto at = [&](int r, int cc) {
        return kWindow ? sbase + (r - lo) * kWinStride +
                             ((a_lo + (r - lo) * B) & 15) + cc - cw
                       : sbase + a_lo + (r - lo) * B + cc;
      };
      for (;;) {
        // done (i < 0), out of the band or out of steps: nothing moves any
        // more; rows below lo are the next tile's
        if (step >= S || i < 0 || (unsigned)c >= (unsigned)B) {
          done = true;
          break;
        }
        if (i < lo) break;
        if (kWindow && (unsigned)(c - cw) >= (unsigned)W) {
          moved = true;
          break;
        }
        if (state == 0) {
          // a run of diagonal moves: lane l reads row i - l, and the run is
          // the lanes before the first cell that is not DIAG (or not here)
          const int r_l = i - lane;
          const int cell = r_l >= lo ? smem[at(r_l, c)] : kStart;
          const unsigned dm = __ballot_sync(kFull, (cell & 3) == kDiag);
          const int r = min(dm == kFull ? 32 : __ffs(~dm) - 1, S - step);
          if (r > 0) {  // r M ops (code 1): steps [step, step + r)
            const int s1 = step + r;
            if ((step >> 2) == (s1 >> 2)) {
              acc |= ones(step & 3, s1 & 3);
            } else {
              if ((step & 3) && lane == 0)
                os[step >> 2] =
                    static_cast<uint8_t>(acc | ones(step & 3, 4));
              for (int j = ((step + 3) >> 2) + lane; j < (s1 >> 2); j += 32)
                os[j] = 0x55;
              acc = ones(0, s1 & 3);
            }
            i -= r;
            step = s1;
            continue;
          }
          const int hs = __shfl_sync(kFull, cell, 0) & 3;  // row i's cell
          if (hs == kStart) {
            done = true;
            break;
          }
          state = hs - 1;  // E -> 1, F -> 2; this step emits no op
        } else {
          const int cell = smem[at(i, c)];
          if (state == 1) {
            acc |= 2u << (2 * (step & 3));  // I + 1
            i -= 1;
            c += 1;
            if ((cell >> 2) & 1) state = 0;
          } else {
            acc |= 3u << (2 * (step & 3));  // D + 1
            c -= 1;
            if ((cell >> 3) & 1) state = 0;
          }
        }
        if ((++step & 3) == 0) {
          if (lane == 0) os[(step >> 2) - 1] = static_cast<uint8_t>(acc);
          acc = 0;
        }
      }
      __syncwarp();  // every lane has left the stage the next copy refills
      if (done || moved) break;
    }
    cp_async_wait<0>();  // nothing in flight when the stages start over
    __syncwarp();
  }
  if (lane == 0 && (step & 3)) os[step >> 2] = static_cast<uint8_t>(acc);
  __syncwarp();
  uint8_t* ob = ops + (size_t)b * (S / 4);
  for (int j = lane; j < (step + 3) >> 2; j += 32) ob[j] = os[j];
  if (lane == 0) {
    fin_i[b] = i;
    fin_c[b] = c;
  }
}

// ---- the dependent-step probe ------------------------------------------------

// One warp times two dependent chains by clock64: out[0] the cycles of one
// shuffle-scan round (__shfl_up_sync, then a max), out[1] those of one
// traceback step (a shared-memory byte load whose value picks the next
// address).  out[2] keeps both chains observable.
__global__ void band_step_probe(int steps, long long* out) {
  __shared__ uint8_t buf[256];
  const int lane = threadIdx.x;
  for (int j = lane; j < 256; j += 32) buf[j] = static_cast<uint8_t>(j * 7 + 3);
  __syncwarp();
  int v = lane;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    const int u = __shfl_up_sync(kFull, v, 1);
    v = max(v, u) + 1;
  }
  const long long t1 = clock64();
  int pos = lane;
  for (int s = 0; s < steps; ++s) {
    const int cell = reinterpret_cast<volatile uint8_t*>(buf)[pos];
    pos = (pos + 1 + (cell & 3)) & 255;
  }
  const long long t2 = clock64();
  if (lane == 0) {
    out[0] = (t1 - t0) / steps;
    out[1] = (t2 - t1) / steps;
    out[2] = v + pos;
  }
}

template <int K, bool kLocal>
int launch_warp(const Params& p, int Bt, int vec, const uint8_t* q,
                const uint8_t* t, const int* ql, const int* tl, uint8_t* tb,
                int* bo, int* bi, int* bc, cudaStream_t st) {
  const int sm = kWarpReads * read_smem(32 * K);
  NPT_LAUNCH((Bt + kWarpReads - 1) / kWarpReads, 32 * kWarpReads, sm, st,
             band_align_kernel<K, false, kLocal>)(q, t, ql, tl, p, Bt, vec,
                                                  tb, bo, bi, bc);
  return (int)cudaGetLastError();
}

template <bool kLocal>
int launch_align(const Params& p, int Bt, bool aligned, const uint8_t* q,
                 const uint8_t* t, const int* ql, const int* tl, uint8_t* tb,
                 int* bo, int* bi, int* bc, cudaStream_t st) {
  const int B = p.B;
  if (B <= kWideWarpB || (B <= kWarpMaxB && Bt >= kWideWarpReads)) {
    const int K =
        B <= 32 ? 1 : B <= 64 ? 2 : B <= 128 ? 4 : B <= 256 ? 8 : 16;
    const int vec = aligned && B % K == 0;
    switch (K) {
      case 1:
        return launch_warp<1, kLocal>(p, Bt, vec, q, t, ql, tl, tb, bo, bi,
                                      bc, st);
      case 2:
        return launch_warp<2, kLocal>(p, Bt, vec, q, t, ql, tl, tb, bo, bi,
                                      bc, st);
      case 4:
        return launch_warp<4, kLocal>(p, Bt, vec, q, t, ql, tl, tb, bo, bi,
                                      bc, st);
      case 8:
        return launch_warp<8, kLocal>(p, Bt, vec, q, t, ql, tl, tb, bo, bi,
                                      bc, st);
      default:
        return launch_warp<16, kLocal>(p, Bt, vec, q, t, ql, tl, tb, bo, bi,
                                       bc, st);
    }
  }
  const int threads = ((B + kBlockK - 1) / kBlockK + 31) / 32 * 32;
  const int sm = (int)sizeof(Xchg) + read_smem(threads * kBlockK);
  NPT_LAUNCH(Bt, threads, sm, st, band_align_kernel<kBlockK, true, kLocal>)(
      q, t, ql, tl, p, Bt, aligned && B % kBlockK == 0, tb, bo, bi, bc);
  return (int)cudaGetLastError();
}

template <int NS, bool kWindow>
int launch_walk(const uint8_t* tb, const int* ei, const int* ec, int Bt,
                int R, int B, int S, int T, int stage_bytes, uint8_t* ops,
                int* fi, int* fc, cudaStream_t st) {
  const int ops_bytes = (S / 4 + 15) / 16 * 16;
  const int per = NS * stage_bytes + ops_bytes;
  // small launches spread one read a block over the SMs
  const int reads =
      Bt >= 1024 ? max(1, min(kWalkReads, 160 * 1024 / per)) : 1;
  const size_t sm = (size_t)reads * per;
  if (sm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_traceback_kernel<NS, kWindow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (e != cudaSuccess) return (int)e;
  }
  NPT_LAUNCH((Bt + reads - 1) / reads, 32 * reads, sm, st,
             band_traceback_kernel<NS, kWindow>)(
      tb, ei, ec, Bt, R, B, S, T, stage_bytes, ops_bytes, ops, fi, fc);
  return (int)cudaGetLastError();
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
  const uint8_t* q8 = static_cast<const uint8_t*>(q);
  const uint8_t* t8 = static_cast<const uint8_t*>(t);
  const int* ql = static_cast<const int*>(qlen);
  const int* tl = static_cast<const int*>(tlen);
  uint8_t* tb8 = static_cast<uint8_t*>(tb);
  int* bo = static_cast<int*>(best);
  int* bi = static_cast<int*>(best_i);
  int* bc = static_cast<int*>(best_c);
  const bool aligned = reinterpret_cast<uintptr_t>(tb) % 16 == 0;
  if (mode == kGlobal)
    return launch_align<false>(p, Bt, aligned, q8, t8, ql, tl, tb8, bo, bi,
                               bc, st);
  return launch_align<true>(p, Bt, aligned, q8, t8, ql, tl, tb8, bo, bi, bc,
                            st);
}

// ops [Bt, S/4] u8 (zero-filled by the caller), fin_i / fin_c [Bt] i32
// from tb [Bt, R, B] u8 and the end cells; S a multiple of 4.
int npt_band_traceback(const void* tb, const void* end_i, const void* end_c,
                       int Bt, int R, int B, int S, void* ops, void* fin_i,
                       void* fin_c, void* stream) {
  if (Bt < 1 || R < 1 || B < 1 || S % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* t8 = static_cast<const uint8_t*>(tb);
  const int* ei = static_cast<const int*>(end_i);
  const int* ec = static_cast<const int*>(end_c);
  uint8_t* o8 = static_cast<uint8_t*>(ops);
  int* fi = static_cast<int*>(fin_i);
  int* fc = static_cast<int*>(fin_c);
  if (B > kWinCols)
    return launch_walk<kStages, true>(t8, ei, ec, Bt, R, B, S, kWinRows,
                                      kWinRows * kWinStride, o8, fi, fc, st);
  if ((long long)R * B <= kTileBytes)
    return launch_walk<1, false>(t8, ei, ec, Bt, R, B, S, R, span16(R * B),
                                 o8, fi, fc, st);
  const int T = kTileBytes / B;
  return launch_walk<kStages, false>(t8, ei, ec, Bt, R, B, S, T,
                                     span16(T * B), o8, fi, fc, st);
}

// Cycles of one shuffle-scan round and of one traceback step (see
// band_step_probe), written to out_dev (int64 [3] on the card).
int npt_band_step_cycles(int steps, void* out_dev, void* stream) {
  NPT_LAUNCH(1, 32, 0, reinterpret_cast<cudaStream_t>(stream),
             band_step_probe)(steps, static_cast<long long*>(out_dev));
  return (int)cudaGetLastError();
}

const char* npt_band_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
