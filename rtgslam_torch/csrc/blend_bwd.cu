// K2: backward tile blend for Hopper (sm_90a).
//
// Replaces the TPU kernel rtgslam_tpu/ops/rasterize/pallas_blend.py::_bwd_kernel
// (pallas_call at :353, via blend_bwd_pallas :308).  Its numerical contract
// is the XLA custom-VJP backward blend.py::_fused_bwd (:726): the Pallas
// kernel never compiled on the TPU and serves as a structural template only.
//
// Math (blend.py:596-600), per pixel and tile-list entry i:
//   w_i      = alpha_i T_i,        T_i = entry T of the chunk * prod_{j<i} (1 - alpha_j)
//   dL/drgb_i   = w_i g_C
//   dL/dalpha_i = T_i (rgb_i . g_C) - (s_i + T_final g_T) / (1 - alpha_i),
//                 s_i = sum_{j>i} w_j (rgb_j . g_C)
//   gated to 0 unless power <= 0 and 1/255 <= opacity * exp(power) < 0.99
//   (blend.py::_chunk_alphas_vjp :626), then through alpha = opacity * exp(power)
//   to mean_x, mean_y, conic a/b/c and opacity; dL/dz_k = g_D at the pixel's
//   depth hit (opaque, its index == depth_index >= 0, :814); elig gets 0.
//
// Design: one CTA per tile, one thread per pixel.  The tile walks its chunks
// from done-1 (the forward K1 in residual mode reports `done` and each
// chunk's entry T) down to 0, staging each chunk's rows in shared memory
// through tile_lists as K1 does.  Inside a chunk, two front-to-back sweeps
// recompute alpha and T from the entry T exactly as the forward rounds them:
// sweep 1 sums the chunk's w (rgb . g_C); sweep 2 forms the suffix sum as
// s_carry + (chunk total - inclusive prefix), the Pallas kernel's `tot - incl`
// (pallas_blend.py:254-257), and the ten per-pixel gradient terms.  Each term
// is summed over the 256 pixels by warp shuffles, then across the 8 warps in
// shared memory; a warp whose 32 pixels all have alpha == 0 for an entry
// contributes exactly 0 and skips the shuffles.  The CTA's sums are
// atomicAdd-ed into the [V+1, 11] gradient of the depth-sorted feature table
// (an entry appears at most once per tile list, but in many tiles).  Atomics
// make the float sums' order vary between runs: callers hold K2 to its plain
// twin with a relative tolerance, not bitwise.
//
// What bounds it: the walk is ~2.5x the forward's arithmetic per entry and
// pixel (two recompute sweeps, ten products) plus 50 warp shuffles per
// (entry, warp) with a live alpha.  One CTA per tile, so live tiles in
// flight and the per-chunk __syncthreads set the latency; the moment-basis
// matmul and lane packing of the TPU formulation have no use here.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NWARP = NPIX / 32;
constexpr int CHUNK = 128;
constexpr int NFEAT = 11;  // mean_x mean_y conic_a conic_b conic_c z r g b opacity elig
constexpr int NGRAD = 10;  // every column but elig
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr unsigned FULL = 0xffffffffu;

struct Alpha {
  float alpha, e, dx, dy;
  bool gate;
};

__device__ __forceinline__ Alpha chunk_alpha(const float (*s_feat)[CHUNK],
                                             int j, float px, float py) {
  Alpha a;
  a.dx = px - s_feat[0][j];
  a.dy = py - s_feat[1][j];
  const float power =
      -0.5f * (s_feat[2][j] * a.dx * a.dx + s_feat[4][j] * a.dy * a.dy) -
      s_feat[3][j] * a.dx * a.dy;
  a.e = expf(fminf(power, 0.0f));
  const float raw = s_feat[9][j] * a.e;
  a.gate = power <= 0.0f && raw >= ALPHA_EPS && raw < ALPHA_MAX;
  a.alpha = (power > 0.0f || raw < ALPHA_EPS) ? 0.0f : fminf(raw, ALPHA_MAX);
  return a;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(NPIX)
blend_bwd_kernel(const float* __restrict__ feat, const int* __restrict__ order,
                 int V, const int* __restrict__ tile_lists,
                 const float* __restrict__ origins,
                 const float* __restrict__ entry, const int* __restrict__ done,
                 const float* __restrict__ g_color,
                 const float* __restrict__ g_depth,
                 const float* __restrict__ tfin_gt,
                 const int* __restrict__ depth_index, int Kt, int chunk,
                 float opaque_threshold, float* __restrict__ g_feat) {
  __shared__ float s_feat[NFEAT][CHUNK];
  __shared__ int s_row[CHUNK];
  __shared__ int s_gidx[CHUNK];
  __shared__ float s_part[NWARP][NGRAD][CHUNK];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const float px = origins[2 * tile] + static_cast<float>(p % TILE);
  const float py = origins[2 * tile + 1] + static_cast<float>(p / TILE);
  const size_t o = static_cast<size_t>(tile) * NPIX + p;
  const float gr = g_color[3 * o], gg = g_color[3 * o + 1],
              gb = g_color[3 * o + 2];
  const float gd = g_depth[o];
  const float tg = tfin_gt[o];
  const int didx = depth_index[o];
  const int total_chunks = Kt / chunk;
  const int* list = tile_lists + static_cast<size_t>(tile) * Kt;

  float s_carry = 0.0f;
  for (int c = done[tile] - 1; c >= 0; --c) {
    __syncthreads();  // frees the previous chunk's buffers
    for (int j = p; j < chunk; j += NPIX) {
      int e = list[c * chunk + j];
      if (e < 0 || e > V) e = V;  // out-of-contract entry -> sentinel
      const float* row = feat + static_cast<size_t>(e) * NFEAT;
#pragma unroll
      for (int f = 0; f < NFEAT; ++f) s_feat[f][j] = row[f];
      s_row[j] = e;
      s_gidx[j] = e == V ? -1 : order[e];
    }
    __syncthreads();

    const float T0 =
        entry[(static_cast<size_t>(tile) * total_chunks + c) * NPIX + p];

    // sweep 1: the chunk's total of w (rgb . g_C)
    float T = T0, total = 0.0f;
    for (int j = 0; j < chunk; ++j) {
      const Alpha a = chunk_alpha(s_feat, j, px, py);
      const float rgbdot =
          gr * s_feat[6][j] + gg * s_feat[7][j] + gb * s_feat[8][j];
      total += a.alpha * T * rgbdot;
      T *= 1.0f - a.alpha;
    }

    // sweep 2: per-entry gradient terms, reduced over the tile's pixels
    T = T0;
    float incl = 0.0f;
    for (int j = 0; j < chunk; ++j) {
      const Alpha a = chunk_alpha(s_feat, j, px, py);
      float t[NGRAD];
      if (!__any_sync(FULL, a.alpha != 0.0f)) {
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < NGRAD; ++f) s_part[warp][f][j] = 0.0f;
        }
        continue;  // alpha == 0: T and the prefix sum do not move
      }
      const float rgbdot =
          gr * s_feat[6][j] + gg * s_feat[7][j] + gb * s_feat[8][j];
      const float w = a.alpha * T;
      incl += w * rgbdot;
      const float s = s_carry + (total - incl);
      float galpha = T * rgbdot - (s + tg) / (1.0f - a.alpha);
      if (!a.gate) galpha = 0.0f;
      const float gpow = galpha * a.alpha;
      const float ca = s_feat[2][j], cb = s_feat[3][j], cc = s_feat[4][j];
      const bool hit = s_feat[10][j] > 0.5f && a.alpha >= opaque_threshold &&
                       didx >= 0 && s_gidx[j] == didx;
      t[0] = gpow * (ca * a.dx + cb * a.dy);
      t[1] = gpow * (cc * a.dy + cb * a.dx);
      t[2] = gpow * (-0.5f * a.dx * a.dx);
      t[3] = gpow * (-a.dx * a.dy);
      t[4] = gpow * (-0.5f * a.dy * a.dy);
      t[5] = hit ? gd : 0.0f;
      t[6] = gr * w;
      t[7] = gg * w;
      t[8] = gb * w;
      t[9] = galpha * a.e;
#pragma unroll
      for (int f = 0; f < NGRAD; ++f) {
        const float v = warp_sum(t[f]);
        if (lane == 0) s_part[warp][f][j] = v;
      }
      T *= 1.0f - a.alpha;
    }
    s_carry += total;
    __syncthreads();

    for (int k = p; k < NGRAD * chunk; k += NPIX) {
      const int f = k / chunk, j = k % chunk;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) v += s_part[w][f][j];
      if (v != 0.0f && s_row[j] < V)
        atomicAdd(g_feat + static_cast<size_t>(s_row[j]) * NFEAT + f, v);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  g_feat [V+1, 11] must be zeroed
// by the caller.  Launches on `stream` and returns cudaGetLastError() of the
// launch: 0 on success.
extern "C" int rtg_blend_bwd(const float* feat, const int* order, int V,
                             const int* tile_lists, const float* origins,
                             const float* entry, const int* done,
                             const float* g_color, const float* g_depth,
                             const float* tfin_gt, const int* depth_index,
                             int n_tiles, int Kt, float opaque_threshold,
                             float* g_feat, void* stream) {
  const int chunk = Kt < CHUNK ? Kt : CHUNK;
  blend_bwd_kernel<<<n_tiles, NPIX, 0, static_cast<cudaStream_t>(stream)>>>(
      feat, order, V, tile_lists, origins, entry, done, g_color, g_depth,
      tfin_gt, depth_index, Kt, chunk, opaque_threshold, g_feat);
  return static_cast<int>(cudaGetLastError());
}
