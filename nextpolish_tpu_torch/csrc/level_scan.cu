// Engine-2 level scan (second-order link DP over a window's levels) for
// NVIDIA Hopper, sm_90a.
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
// then one winning slot per cell by the read-type rules (template RT:
// 0 ont, 1 clr, 2 rs, 3 hifi) and the common final rule, and the carry
// update of device_dp.py::_dp_level (prev <- sc; a delta-0 level resets
// the ring to NEG and then writes its own ring slot).
//
// Design.  One thread block per window and one thread per (cell, slot):
// a loop over the window's own levels inside the block takes the place of
// the TPU's sequential grid, and each block stops at its window's level
// count (there are no pad levels).  The carry (ring [Vb*6, E] and prev
// [6, E], at most 14.4 KB) lives in shared memory.  Entries arrive as a
// compact level-major stream (A word, match bits, cell, slot, plus one
// entry offset per level) and are scattered into a shared [6, E] tile per
// level; a per-slot level stamp marks which slots the level filled, so
// the tile is never cleared.  None of the TPU machinery carries over: no
// bf16-exact one-hot matmuls, no lane packing of windows, no dense
// [levels, 6EB] slabs.  Per level: compute (every thread) -> barrier ->
// carry update (every thread, own column) + scatter of the next level's
// entries (warp 0) + winner loop (six threads of the last warp, one per
// cell, because the rules depend on slot order) -> barrier.
//
// What bounds it.  Not bytes and not operations: the levels form a
// dependency chain (each level reads the scores of the level before it or
// of the ring), so the time is the chain length times the latency of one
// level, which is two __syncthreads, the serial winner loop and the global
// load of the next level's entries.  One block per window fills only as
// many of the 132 SMs as the batch has windows (8 by default); spreading a
// window's work over more SMs, or more windows per launch, is later work.
//
// All arithmetic is int32 and byte-equal to the JAX package.  The wrapper
// (models/cns/level_scan.py::level_scan) asserts on the card, before the
// launch, that every link is >= 0, so C's truncating division matches
// JAX's floor division in the ONT rules.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 24;
constexpr int kMaxVb = 24;
constexpr int kCells = 6;
constexpr int kThreads = kCells * kMaxE;  // one thread per (cell, slot)
constexpr int kWinner0 = 128;             // first winner thread (last warp)
constexpr int kWinFields = 8;
constexpr int kNeg = -(1 << 29);
constexpr int kNegInit = -(1 << 30);

constexpr int kValid = 1;
constexpr int kHead = 2;
constexpr int kCond1a = 4;
constexpr int kCond2b = 8;
constexpr int kPpbNotGap = 16;

// Scatters level l's entries (a contiguous range of the level-major entry
// stream) into the shared [6, E] tile and stamps the slots they fill.
__device__ __forceinline__ void scatter_level(
    int l, int lvl_base, int tid, const int32_t* __restrict__ lvl_off,
    const int32_t* __restrict__ ent_A, const int32_t* __restrict__ ent_M,
    const int8_t* __restrict__ ent_b, const int8_t* __restrict__ ent_slot,
    int32_t (*a_s)[kMaxE], int32_t (*m_s)[kMaxE], int32_t (*stamp)[kMaxE]) {
  const int g = lvl_base + l;
  const int lo = lvl_off[g];
  const int n = lvl_off[g + 1] - lo;
  for (int t = tid; t < n; t += kThreads) {
    const int k = lo + t;
    const int b = ent_b[k];
    const int s = ent_slot[k];
    a_s[b][s] = ent_A[k];
    m_s[b][s] = ent_M[k];
    stamp[b][s] = l;
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
level_scan_kernel(const int32_t* __restrict__ ent_A,
                  const int32_t* __restrict__ ent_M,
                  const int8_t* __restrict__ ent_b,
                  const int8_t* __restrict__ ent_slot,
                  const int32_t* __restrict__ lvl_off,
                  const int32_t* __restrict__ meta,
                  const int32_t* __restrict__ win,
                  int cov_coef,
                  int8_t* __restrict__ best_out,
                  int32_t* __restrict__ sc_out) {
  __shared__ int32_t ring[kMaxVb * kCells][kMaxE];
  __shared__ int32_t prev[kCells][kMaxE];
  __shared__ int32_t a_s[kCells][kMaxE];    // this level's A words
  __shared__ int32_t m_s[kCells][kMaxE];    // this level's match bits
  __shared__ int32_t stamp[kCells][kMaxE];  // level that filled the slot
  __shared__ int32_t aw_s[kCells][kMaxE];   // A word as computed (0 = empty)
  __shared__ int32_t sc_s[kCells][kMaxE];
  __shared__ int32_t nb_s[kCells][kMaxE];
  __shared__ int32_t nl_s[kCells][kMaxE];

  const int32_t* wp = win + blockIdx.x * kWinFields;
  const int lvl_base = wp[0];
  const int n_levels = wp[1];
  const int E = wp[2];
  const int Vb = wp[3];
  const int sc_from = wp[4];
  const int sc_base = wp[5];
  const int tid = threadIdx.x;
  const int c = tid / kMaxE;
  const int e = tid % kMaxE;
  const int vb6 = Vb * kCells;

  for (int v = 0; v < kMaxVb; ++v) ring[v * kCells + c][e] = kNeg;
  prev[c][e] = kNeg;
  stamp[c][e] = -1;
  __syncthreads();

  if (n_levels > 0)
    scatter_level(0, lvl_base, tid, lvl_off, ent_A, ent_M, ent_b, ent_slot,
                  a_s, m_s, stamp);
  __syncthreads();

  for (int l = 0; l < n_levels; ++l) {
    const int mt = meta[lvl_base + l];
    const int cov = mt >> 8;

    // ---- per (cell, slot): weight, predecessor gather, score ----------
    int a = 0;
    unsigned m = 0;
    if (stamp[c][e] == l) {
      a = a_s[c][e];
      m = static_cast<unsigned>(m_s[c][e]);
    }
    const int link = a >> 16;
    const int pp = (a >> 8) & 0xFF;
    const int wgt = 10 * link - cov_coef * cov;
    const int32_t* src = pp >= vb6 ? prev[pp - vb6] : ring[pp];
    int n_best = kNeg;
    int last = 0;
    while (m) {
      const int n = __ffs(m) - 1;
      m &= m - 1;
      n_best = max(n_best, src[n]);
      last = n;
    }
    const int n_last = src[last];
    int sc;
    if (!(a & kValid)) {
      sc = kNeg;
    } else if (a & kHead) {
      sc = wgt;
    } else {
      sc = n_best > kNeg / 2 ? max(n_best + wgt, 0) : 0;
    }
    aw_s[c][e] = a;
    sc_s[c][e] = sc;
    nb_s[c][e] = n_best;
    nl_s[c][e] = n_last;
    __syncthreads();

    // ---- carry update, each thread its own (cell, slot) column --------
    prev[c][e] = sc;
    const int vslot = ((mt >> 2) & 0x3F) - 1;
    if ((mt >> 1) & 1) {  // delta-0 level: reset the ring, then write
      for (int v = 0; v < Vb; ++v)
        ring[v * kCells + c][e] = v == vslot ? sc : kNeg;
    } else if (vslot >= 0) {
      ring[vslot * kCells + c][e] = sc;
    }

    if (l + 1 < n_levels)
      scatter_level(l + 1, lvl_base, tid, lvl_off, ent_A, ent_M, ent_b,
                    ent_slot, a_s, m_s, stamp);

    // ---- winning entry per cell, in insertion order -------------------
    if (tid >= kWinner0 && tid < kWinner0 + kCells) {
      const int cc = tid - kWinner0;
      int bm = 0;
      int sc_bm = sc_s[cc][0];
      int link_bm = aw_s[cc][0] >> 16;
      int p_pp = kNegInit;
      int raiser = kNegInit;
      int tmp = 0;
      if (RT == 0) {
        for (int s = 0; s < E; ++s) {
          const int as = aw_s[cc][s];
          if (as & kValid) tmp = max(tmp, as >> 16);
        }
      }
      for (int s = 0; s < E; ++s) {
        const int as = aw_s[cc][s];
        if (!(as & kValid)) continue;  // every update below needs valid
        const int sc_e = sc_s[cc][s];
        const int nb = nb_s[cc][s];
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
          const bool c1 = hm && (as & kCond1a) &&
                          (5 * ln > cov || ln > tmp / 2);
          const bool c2 = !c1 && hm && ln > link_bm / 2 && nb > p_pp &&
                          (as & kCond2b);
          if (c1 || c2) {
            bm = s;
            sc_bm = sc_e;
            link_bm = ln;
          }
          if (c1) {
            p_pp = nl_s[cc][s];
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
      best_out[static_cast<int64_t>(lvl_base + l) * kCells + cc] =
          static_cast<int8_t>(bm);
      if (l >= sc_from)
        sc_out[static_cast<int64_t>(sc_base + l - sc_from) * kCells + cc] =
            sc_bm;
    }
    __syncthreads();
  }
}

template <int RT>
void launch(int n_windows, cudaStream_t stream, const int32_t* ent_A,
            const int32_t* ent_M, const int8_t* ent_b, const int8_t* ent_slot,
            const int32_t* lvl_off, const int32_t* meta, const int32_t* win,
            int cov_coef, int8_t* best_out, int32_t* sc_out) {
  level_scan_kernel<RT><<<n_windows, kThreads, 0, stream>>>(
      ent_A, ent_M, ent_b, ent_slot, lvl_off, meta, win, cov_coef, best_out,
      sc_out);
}

}  // namespace

extern "C" {

// Launches the scan of n_windows windows on `stream` (PyTorch's current
// stream) and returns cudaGetLastError(); nothing is synchronised and
// nothing is allocated here.  win is int32 [n_windows, 8]:
// (lvl_base, n_levels, E, Vb, sc_from, sc_base, 0, 0).
int npt_level_scan(const void* ent_A, const void* ent_M, const void* ent_b,
                   const void* ent_slot, const void* lvl_off,
                   const void* meta, const void* win, int n_windows,
                   int rt_id, int cov_coef, void* best_out, void* sc_out,
                   void* stream) {
  if (n_windows <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int32_t*>(ent_A);
  const auto* M = static_cast<const int32_t*>(ent_M);
  const auto* b = static_cast<const int8_t*>(ent_b);
  const auto* s = static_cast<const int8_t*>(ent_slot);
  const auto* lo = static_cast<const int32_t*>(lvl_off);
  const auto* mt = static_cast<const int32_t*>(meta);
  const auto* w = static_cast<const int32_t*>(win);
  auto* best = static_cast<int8_t*>(best_out);
  auto* sc = static_cast<int32_t*>(sc_out);
  switch (rt_id) {
    case 0:
      launch<0>(n_windows, st, A, M, b, s, lo, mt, w, cov_coef, best, sc);
      break;
    case 1:
      launch<1>(n_windows, st, A, M, b, s, lo, mt, w, cov_coef, best, sc);
      break;
    case 2:
      launch<2>(n_windows, st, A, M, b, s, lo, mt, w, cov_coef, best, sc);
      break;
    case 3:
      launch<3>(n_windows, st, A, M, b, s, lo, mt, w, cov_coef, best, sc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* npt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
