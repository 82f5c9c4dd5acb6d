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
// blending, as blend.py:367-377 does.
//
// Modes (a template parameter of the one kernel):
//   INFERENCE     the seven per-pixel maps.
//   RESIDUAL      the same maps plus what the backward K2 (blend_bwd.cu)
//                 replays: entry[t, c, p], the tile's T at the top of every
//                 chunk c it processed (rows it never reached are 0, as in
//                 blend.py:689), and done[t], the number of chunks processed.
//   TRANSMISSION  final T only, from 6-column rows (mean_x mean_y conic_a
//                 conic_b conic_c opacity): no color, depth or index
//                 bookkeeping.  T is exactly 1 iff every alpha of the pixel
//                 is exactly 0, so the optimize masks' T != 1 test is exact.
//
// Design: one CTA per tile, one thread per pixel.  The CTA gathers each
// chunk's feature rows itself from the depth-sorted [V+1, F] table through
// tile_lists (row V is the all-zero sentinel), so the [T, Kt, F] per-tile
// copy the JAX path materialises never exists.  The chunk sits in shared
// memory as F columns of 128 floats; every thread of a warp reads the same
// entry at once, so the reads are broadcasts.
//
// What bounds it: the per-pixel walk is ~25 FP32 operations and one expf per
// entry, with one gathered row per entry per tile from L2.  At the 680x1200
// bench shape (3840 tiles, Kt = 512) that is latency of the dependent
// gather -> __syncthreads -> walk sequence, not bandwidth; a later version
// double-buffers the chunk with cp.async.
//
// Transmittance is a sequential product here; the JAX blend takes it in log
// space (exp of an exclusive cumsum of log1p(-alpha)).  The two differ by
// rounding only: tests hold them to 1e-5 absolute.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int NFEAT = 11;  // mean_x mean_y conic_a conic_b conic_c z r g b opacity elig
constexpr int NTRANS = 6;  // mean_x mean_y conic_a conic_b conic_c opacity
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;

enum Mode { INFERENCE = 0, RESIDUAL = 1, TRANSMISSION = 2 };

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
                 float* __restrict__ entry, int* __restrict__ done) {
  constexpr int NF = MODE == TRANSMISSION ? NTRANS : NFEAT;
  constexpr int OPA = MODE == TRANSMISSION ? 5 : 9;
  __shared__ float s_feat[NF][CHUNK];
  __shared__ int s_gidx[CHUNK];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float px = origins[2 * tile] + static_cast<float>(p % TILE);
  const float py = origins[2 * tile + 1] + static_cast<float>(p / TILE);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  float d = 0.0f, dw = 0.0f, cw = 0.0f;
  int didx = -1, cidx = -1;

  const int count = tile_counts[tile];
  const int n_chunks = (count + chunk - 1) / chunk;
  const int* list = tile_lists + static_cast<size_t>(tile) * Kt;

  int c = 0;
  for (; c < n_chunks; ++c) {
    // the tile-wide early exit; also the barrier that frees the chunk
    // buffer of the previous trip
    if (!__syncthreads_or(T > t_threshold)) break;
    if constexpr (MODE == RESIDUAL)
      entry[(static_cast<size_t>(tile) * (Kt / chunk) + c) * NPIX + p] = T;
    for (int j = p; j < chunk; j += NPIX) {
      int e = list[c * chunk + j];
      if (e < 0 || e > V) e = V;  // out-of-contract entry -> sentinel
      const float* row = feat + static_cast<size_t>(e) * NF;
#pragma unroll
      for (int f = 0; f < NF; ++f) s_feat[f][j] = row[f];
      if constexpr (MODE != TRANSMISSION) s_gidx[j] = e == V ? -1 : order[e];
    }
    __syncthreads();

    for (int j = 0; j < chunk; ++j) {
      const float dx = px - s_feat[0][j];
      const float dy = py - s_feat[1][j];
      const float power =
          -0.5f * (s_feat[2][j] * dx * dx + s_feat[4][j] * dy * dy) -
          s_feat[3][j] * dx * dy;
      float alpha = s_feat[OPA][j] * expf(fminf(power, 0.0f));
      if (power > 0.0f) alpha = 0.0f;
      alpha = fminf(alpha, ALPHA_MAX);
      if (alpha < ALPHA_EPS) alpha = 0.0f;

      if constexpr (MODE != TRANSMISSION) {
        const float w = alpha * T;
        cr += w * s_feat[6][j];
        cg += w * s_feat[7][j];
        cb += w * s_feat[8][j];
        if (didx < 0 && s_feat[10][j] > 0.5f && alpha >= opaque_threshold) {
          d = s_feat[5][j];
          didx = s_gidx[j];
          dw = w;
        }
        if (w > cw) {
          cw = w;
          cidx = s_gidx[j];
        }
      }
      T *= 1.0f - alpha;
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
    const int total = Kt / chunk;
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
          color_index, depth_weight, color_weight, t_final, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtg_blend_fwd_residual(
    const float* feat, const int* order, int V, const int* tile_lists,
    const int* tile_counts, const float* origins, int n_tiles, int Kt,
    float opaque_threshold, float t_threshold, float* color, float* depth,
    int* depth_index, int* color_index, float* depth_weight,
    float* color_weight, float* t_final, float* entry, int* done,
    void* stream) {
  const int chunk = Kt < CHUNK ? Kt : CHUNK;
  blend_fwd_kernel<RESIDUAL>
      <<<n_tiles, NPIX, 0, static_cast<cudaStream_t>(stream)>>>(
          feat, order, V, tile_lists, tile_counts, origins, Kt, chunk,
          opaque_threshold, t_threshold, color, depth, depth_index,
          color_index, depth_weight, color_weight, t_final, entry, done);
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
          nullptr, t_final, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}
