// K1: forward tile blend for Hopper (sm_90a) in three modes.
//
// Replaces the TPU kernel rtgslam_tpu/ops/rasterize/pallas_blend.py::_kernel
// (pallas_call at :397) and, on the port's main path, the XLA blends it is
// held against: blend.py::blend_tiles (:306 -> blend_tiles_blocked :407),
// the custom-VJP forward blend.py::_fused_fwd (:669) and the mask renders'
// blend.py::blend_transmission (:482).
//
// Contract (same as the JAX calls): every 16x16 tile walks its depth-ordered
// list front to back in chunks of min(128, Kt) entries.
//   alpha = opacity * exp(power); 0 when power > 0 or alpha < 1/255;
//           capped at 0.99
//   color  += alpha * T * rgb, T *= 1 - alpha
//   depth / depth_index / depth_weight: the first entry with elig > 0.5 and
//           alpha >= opaque_threshold
//   color_index / color_weight: the entry of largest weight, the earliest
//           one on ties (strictly greater in sequential order)
// The tile exits when its list ends or when max T over its 256 pixels is
// <= T_threshold, checked once per chunk: inside a chunk every pixel keeps
// blending, as blend.py:367-377 does.  List positions at and past the
// tile's count hold the zero sentinel row V (alpha 0), so the walk stops at
// the count: chunk c walks min(chunk, count - c * chunk) entries.
//
// Modes (a template parameter of the one kernel):
//   INFERENCE     the seven per-pixel maps.
//   RESIDUAL      the same maps plus what the backward K2 (blend_bwd.cu)
//                 replays: entry[t, c, p], the tile's T at the top of every
//                 chunk c it processed (0 for chunks never reached, as in
//                 blend.py:689), chunk_color[t, c, p, 3], the chunk's sum
//                 of alpha T rgb (undefined for chunks never reached), and
//                 done[t], the number of chunks processed.
//   TRANSMISSION  final T only, from 6-column rows (mean_x mean_y conic_a
//                 conic_b conic_c opacity): no color, depth or index
//                 bookkeeping.  T is exactly 1 iff every alpha of the pixel
//                 is exactly 0, so the optimize masks' T != 1 test is exact.
//
// Design: one CTA per tile, one thread per pixel.  The CTA gathers each
// chunk's feature rows itself from the depth-sorted [V+1, F] table through
// tile_lists (row V is the all-zero sentinel), so the [T, Kt, F] per-tile
// copy the JAX path materialises never exists.  Thread j stages row j of
// the chunk in shared memory, row-major and padded to 12 floats (8 in
// transmission mode) with the index-map value in the last slot, so every
// entry of the walk is three (two) 16-byte broadcast loads.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phases 3b/3e
// and 6b, PERF.md): every live (pixel, entry) pair, 256 x sum_t
// min(count_t, chunk x done_t), needs its alpha, 17 FP32 operations with
// expf; a pair with a non-zero alpha (0.38-0.48 of them on the main path)
// needs 12 more to blend (2 in transmission mode).  The bytes are the rows
// the live list entries name, those entries and the outputs.  Measured:
// 0.18 of that bound in inference mode (3840 x 512 lists, 0.1159 ms
// against 0.0206 ms, bound by operations), 0.23 in transmission mode, 0.19
// in residual mode on a local call's compact lists and 0.18 on the final
// pass's, 0.17 on the windowed global call's (bound by bytes there).  What
// stands between: the instructions the count leaves out (expf's software
// routine, three shared loads and the selects of the depth and colour
// bookkeeping for every pair, the loop) and latency: on the main path
// nearly every tile walks one chunk (3224 of 3225 at the final pass), so
// each chunk's dependent list -> row gather is hidden only by the other
// CTAs on the SM (5-8 at 32-47 registers).  Neither prefetching the next
// chunk's rows into registers (that variant took 1.00-1.04x the time) nor
// launching the tiles heaviest first (its count sort costs more than a
// launch saves) paid (PERF.md).
//
// Transmittance is a sequential product here; the JAX blend takes it in log
// space (exp of an exclusive cumsum of log1p(-alpha)).  The two differ by
// rounding only: tests hold them to 1e-5 absolute.

#include "blend_common.cuh"

namespace {

using namespace rtg;

constexpr int NFEAT = 11;  // mean_x mean_y conic_a conic_b conic_c z r g b opacity elig
constexpr int NTRANS = 6;  // mean_x mean_y conic_a conic_b conic_c opacity

enum Mode { INFERENCE = 0, RESIDUAL = 1, TRANSMISSION = 2 };

// Thread j < n of the CTA stages row j of the chunk: row-major, 12 floats
// (8 in transmission mode: mean_x mean_y conic_a conic_b | conic_c opacity),
// the index-map value in the last slot.
template <int MODE>
__device__ __forceinline__ void stage(float* s_rows,
                                      const float* __restrict__ feat,
                                      const int* __restrict__ order, int V,
                                      const int* __restrict__ list, int n,
                                      int j) {
  if (j >= n) return;
  const int e = clamp_entry(list[j], V);
  if constexpr (MODE == TRANSMISSION) {
    const float* row = feat + static_cast<size_t>(e) * NTRANS;
    float* r = s_rows + j * 8;
#pragma unroll
    for (int k = 0; k < NTRANS; ++k) r[k] = row[k];
  } else {
    const float* row = feat + static_cast<size_t>(e) * NFEAT;
    float* r = s_rows + j * 12;
#pragma unroll
    for (int k = 0; k < NFEAT; ++k) r[k] = row[k];
    r[11] = __int_as_float(e == V ? -1 : order[e]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(NPIX)
blend_fwd_kernel(const float* __restrict__ feat, const int* __restrict__ order,
                 int V, const int* __restrict__ tile_lists,
                 const int* __restrict__ tile_counts,
                 const float* __restrict__ origins, int Kt, int chunk,
                 float opaque_threshold, float t_threshold,
                 float* __restrict__ color, float* __restrict__ depth,
                 int* __restrict__ depth_index, int* __restrict__ color_index,
                 float* __restrict__ depth_weight,
                 float* __restrict__ color_weight, float* __restrict__ t_final,
                 float* __restrict__ entry, int* __restrict__ done,
                 float* __restrict__ chunk_color) {
  constexpr int S = MODE == TRANSMISSION ? 8 : 12;  // staged floats per row
  __shared__ __align__(16) float s_rows[CHUNK * S];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float px = origins[2 * tile] + static_cast<float>(p % TILE);
  const float py = origins[2 * tile + 1] + static_cast<float>(p / TILE);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  float d = 0.0f, dw = 0.0f, cw = 0.0f;
  int didx = -1, cidx = -1;

  const int count = min(max(tile_counts[tile], 0), Kt);
  const int n_chunks = (count + chunk - 1) / chunk;
  const int total = Kt / chunk;
  const int* list = tile_lists + static_cast<size_t>(tile) * Kt;

  int c = 0;
  for (; c < n_chunks; ++c) {
    // the tile-wide early exit; also the barrier after which the previous
    // chunk's rows may be overwritten
    if (!__syncthreads_or(T > t_threshold)) break;
    const int n = min(chunk, count - c * chunk);
    const size_t slot = (static_cast<size_t>(tile) * total + c) * NPIX + p;
    if constexpr (MODE == RESIDUAL) entry[slot] = T;
    stage<MODE>(s_rows, feat, order, V, list + c * chunk, n, p);
    __syncthreads();

    float ccr = 0.0f, ccg = 0.0f, ccb = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float4* r = reinterpret_cast<const float4*>(s_rows + j * S);
      const float4 a = r[0], b = r[1];
      if constexpr (MODE == TRANSMISSION) {
        T = transmit(T, entry_alpha(a.x, a.y, a.z, a.w, b.x, b.y, px, py).alpha);
      } else {
        const float4 q = r[2];
        const float alpha =
            entry_alpha(a.x, a.y, a.z, a.w, b.x, q.y, px, py).alpha;
        const float w = __fmul_rn(alpha, T);
        ccr = __fmaf_rn(w, b.z, ccr);
        ccg = __fmaf_rn(w, b.w, ccg);
        ccb = __fmaf_rn(w, q.x, ccb);
        if (didx < 0 && q.z > 0.5f && alpha >= opaque_threshold) {
          d = b.y;
          didx = __float_as_int(q.w);
          dw = w;
        }
        if (w > cw) {
          cw = w;
          cidx = __float_as_int(q.w);
        }
        T = transmit(T, alpha);
      }
    }
    if constexpr (MODE != TRANSMISSION) {
      cr = __fadd_rn(cr, ccr);
      cg = __fadd_rn(cg, ccg);
      cb = __fadd_rn(cb, ccb);
    }
    if constexpr (MODE == RESIDUAL) {
      chunk_color[3 * slot] = ccr;
      chunk_color[3 * slot + 1] = ccg;
      chunk_color[3 * slot + 2] = ccb;
    }
  }

  const size_t o = static_cast<size_t>(tile) * NPIX + p;
  t_final[o] = T;
  if constexpr (MODE == TRANSMISSION) return;
  color[3 * o] = cr;
  color[3 * o + 1] = cg;
  color[3 * o + 2] = cb;
  depth[o] = d;
  depth_index[o] = didx;
  color_index[o] = cidx;
  depth_weight[o] = dw;
  color_weight[o] = cw;
  if constexpr (MODE == RESIDUAL) {
    // entry T is 0 past done (the JAX contract); chunk colours there stay
    // undefined: K2 and the reduce stop at done
    for (int r = c; r < total; ++r)
      entry[(static_cast<size_t>(tile) * total + r) * NPIX + p] = 0.0f;
    if (p == 0) done[tile] = c;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() of the launch: 0 on success.
extern "C" int rtg_blend_fwd(const float* feat, const int* order, int V,
                             const int* tile_lists, const int* tile_counts,
                             const float* origins, int n_tiles, int Kt,
                             float opaque_threshold, float t_threshold,
                             float* color, float* depth, int* depth_index,
                             int* color_index, float* depth_weight,
                             float* color_weight, float* t_final,
                             void* stream) {
  const int chunk = Kt < CHUNK ? Kt : CHUNK;
  blend_fwd_kernel<INFERENCE>
      <<<n_tiles, NPIX, 0, static_cast<cudaStream_t>(stream)>>>(
          feat, order, V, tile_lists, tile_counts, origins, Kt, chunk,
          opaque_threshold, t_threshold, color, depth, depth_index,
          color_index, depth_weight, color_weight, t_final, nullptr, nullptr,
          nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtg_blend_fwd_residual(
    const float* feat, const int* order, int V, const int* tile_lists,
    const int* tile_counts, const float* origins, int n_tiles, int Kt,
    float opaque_threshold, float t_threshold, float* color, float* depth,
    int* depth_index, int* color_index, float* depth_weight,
    float* color_weight, float* t_final, float* entry, int* done,
    float* chunk_color, void* stream) {
  const int chunk = Kt < CHUNK ? Kt : CHUNK;
  blend_fwd_kernel<RESIDUAL>
      <<<n_tiles, NPIX, 0, static_cast<cudaStream_t>(stream)>>>(
          feat, order, V, tile_lists, tile_counts, origins, Kt, chunk,
          opaque_threshold, t_threshold, color, depth, depth_index,
          color_index, depth_weight, color_weight, t_final, entry, done,
          chunk_color);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtg_blend_transmission(const float* feat6, int V,
                                      const int* tile_lists,
                                      const int* tile_counts,
                                      const float* origins, int n_tiles,
                                      int Kt, float t_threshold,
                                      float* t_final, void* stream) {
  const int chunk = Kt < CHUNK ? Kt : CHUNK;
  blend_fwd_kernel<TRANSMISSION>
      <<<n_tiles, NPIX, 0, static_cast<cudaStream_t>(stream)>>>(
          feat6, nullptr, V, tile_lists, tile_counts, origins, Kt, chunk,
          0.0f, t_threshold, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, t_final, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}
