// K2: backward tile blend for Hopper (sm_90a), and its deterministic
// reduction into the feature rows.
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
// Design, blend_bwd_kernel: one CTA of 128 threads per tile, each thread
// two pixels (p and p + 128).  The tile walks its chunks from done-1 (the
// forward K1 in residual mode reports `done`, each chunk's entry T and each
// chunk's colour sum) down to 0, staging each chunk's rows in shared memory
// row-major (blend_common.cuh), and stops at the tile's count (later
// positions hold the zero sentinel row).  One front-to-back sweep per chunk
// rebuilds T from the entry T through K1's own alpha and transmittance
// functions (blend_common.cuh); the suffix sum s_i is s_carry + (chunk total
// - inclusive prefix), the chunk total being the forward's chunk colour .
// g_C.  A thread adds its two pixels' ten terms in registers; the warp then
// sums them (padded to 16) with a transpose-reduce butterfly: at the xor
// steps 16, 8, 4, 2 a lane keeps half its values and trades the other half
// with its partner (8 + 4 + 2 + 1 shuffles), and one more at xor 1 leaves
// term l/2's warp total in lane l.  So 64 pixels cost 16 shuffles per entry
// (ten plain warp sums over 32 pixels: 50).  A warp whose 64 pixels all have
// alpha == 0 for an entry writes zeros and skips it.  Every 32 entries the
// 4 warps' totals are added in warp order from shared memory
// (double-buffered, one barrier) and written to partials[tile, position,
// 10].  No atomics.
//
// Design, blend_bwd_reduce_kernel: 16 lanes per feature row, two rows per
// warp.  A row finds its list positions through a CSR inverse index of the
// lists (row_ptr [V+2], pos: the positions t * Kt + k in ascending order
// within each row, positions at or past the tile's count excluded); lane l
// adds the partials of the row's positions l, l + 16, ... in that order,
// skipping chunks at or past done[t], which K2 never wrote, and the
// half-warp's butterfly adds the 16 lane sums pairwise over lane bits 3, 2,
// 1, 0.  Rows without positions and the sentinel row V write 0, and so does
// every row's elig column.  The order of every sum is fixed: two launches
// on the same inputs give bitwise-equal gradients, and the plain twin, which
// adds in the same order, equals the kernel bit for bit.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phases 3e and
// 6b, PERF.md): every live (pixel, entry) pair needs its alpha, 17 FP32
// operations with expf; a pair with a non-zero alpha (0.38-0.48 of them on
// the main path) needs 50 more for its ten terms and their pixel sums (a
// pair with alpha 0 has no gradient); the bytes take microseconds, so the
// bound is arithmetic.  Measured 0.13 of it on a local call's compact
// lists (3150 x 256: 0.2410 ms against 0.0323 ms) and on the final pass's
// lists, 0.12 on the windowed global call's.  What stands between: a warp
// whose 64 pixels have any non-zero alpha at an entry computes the terms
// of all 64; the butterfly (15 shuffles, 30 selects and 16 adds per entry
// and 64 pixels); the alpha recomputation with its software expf; a
// barrier every 32 entries.  The division is the approximate __fdividef
// (blend_common.cuh): 1.08-1.12x faster than __fdiv_rn.  The reduce is
// bound by bytes (the live partials, the index, the [V+1, 11] output):
// 0.26 of that bound on the local lists (0.0137 ms, index_add_ 0.0166
// ms); what is left is the latency of each position's dependent pos ->
// done -> partials loads.  The row index it reads
// (blend.py::row_index, a stable sort of the lists) is built per backward
// on the final pass: 0.21 ms there, 0.8 of K2's time (PERF.md).

#include "blend_common.cuh"

namespace {

using namespace rtg;

constexpr int NFEAT = 11;  // mean_x mean_y conic_a conic_b conic_c z r g b opacity elig
constexpr int NGRAD = 10;  // every column but elig
constexpr int NPAD = 16;   // the butterfly's width
constexpr int SUB = 32;    // entries per cross-warp reduction
constexpr int ROW = 12;    // staged floats per entry (blend_common.cuh)

// One butterfly step: lanes whose bit `OFF` is set keep the upper HALF
// values and send the lower ones; the partner keeps the lower ones.
template <int HALF, int OFF>
__device__ __forceinline__ void butterfly_step(float (&v)[NPAD], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, OFF));
  }
}

// v[k] summed over the warp's 32 lanes; lane l returns the total of term
// l / 2 (so lanes 2k and 2k + 1 both hold term k).  16 shuffles.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[NPAD],
                                                    int lane) {
  butterfly_step<8, 16>(v, lane);
  butterfly_step<4, 8>(v, lane);
  butterfly_step<2, 4>(v, lane);
  butterfly_step<1, 2>(v, lane);
  return __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], 1));
}

constexpr int NT = NPIX / 2;  // threads per CTA: pixels p and p + 128 each
constexpr int NW2 = NT / 32;  // warps per CTA

struct Pixel {
  float px, py, gr, gg, gb, gd, tg, T, incl, total, carry;
  int didx;
};

// one pixel's ten terms for entry (a, b, q); advances its T and prefix sum
__device__ __forceinline__ void pixel_terms(Pixel& x, const float4& a,
                                            const float4& b, const float4& q,
                                            const Alpha& al, float thr,
                                            float (&t)[NGRAD]) {
  const float rgbdot =
      __fmaf_rn(x.gb, q.x, __fmaf_rn(x.gg, b.w, __fmul_rn(x.gr, b.z)));
  const float w = __fmul_rn(al.alpha, x.T);
  x.incl = __fmaf_rn(w, rgbdot, x.incl);
  const float s = __fadd_rn(x.carry, __fsub_rn(x.total, x.incl));
  float galpha = __fsub_rn(
      __fmul_rn(x.T, rgbdot),
      __fdividef(__fadd_rn(s, x.tg), __fsub_rn(1.0f, al.alpha)));
  if (!al.gate) galpha = 0.0f;
  const float gpow = __fmul_rn(galpha, al.alpha);
  const float dx = al.dx, dy = al.dy;
  const bool hit = q.z > 0.5f && al.alpha >= thr && x.didx >= 0 &&
                   __float_as_int(q.w) == x.didx;
  t[0] = __fmul_rn(gpow, __fmaf_rn(a.z, dx, __fmul_rn(a.w, dy)));
  t[1] = __fmul_rn(gpow, __fmaf_rn(b.x, dy, __fmul_rn(a.w, dx)));
  t[2] = __fmul_rn(gpow, __fmul_rn(__fmul_rn(-0.5f, dx), dx));
  t[3] = __fmul_rn(gpow, __fmul_rn(-dx, dy));
  t[4] = __fmul_rn(gpow, __fmul_rn(__fmul_rn(-0.5f, dy), dy));
  t[5] = hit ? x.gd : 0.0f;
  t[6] = __fmul_rn(x.gr, w);
  t[7] = __fmul_rn(x.gg, w);
  t[8] = __fmul_rn(x.gb, w);
  t[9] = __fmul_rn(galpha, al.e);
  x.T = transmit(x.T, al.alpha);
}

__global__ void __launch_bounds__(NT)
blend_bwd_kernel(const float* __restrict__ feat, const int* __restrict__ order,
                 int V, const int* __restrict__ tile_lists,
                 const int* __restrict__ tile_counts,
                 const float* __restrict__ origins,
                 const float* __restrict__ entry, const int* __restrict__ done,
                 const float* __restrict__ chunk_color,
                 const float* __restrict__ g_color,
                 const float* __restrict__ g_depth,
                 const float* __restrict__ tfin_gt,
                 const int* __restrict__ depth_index, int Kt, int chunk,
                 float opaque_threshold, float* __restrict__ partials) {
  __shared__ __align__(16) float s_rows[CHUNK * ROW];
  __shared__ float s_part[2][NW2][SUB][NGRAD];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  Pixel x[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = tid + h * NT;
    const size_t o = static_cast<size_t>(tile) * NPIX + p;
    x[h].px = origins[2 * tile] + static_cast<float>(p % TILE);
    x[h].py = origins[2 * tile + 1] + static_cast<float>(p / TILE);
    x[h].gr = g_color[3 * o];
    x[h].gg = g_color[3 * o + 1];
    x[h].gb = g_color[3 * o + 2];
    x[h].gd = g_depth[o];
    x[h].tg = tfin_gt[o];
    x[h].didx = depth_index[o];
    x[h].carry = 0.0f;
  }
  const int count = min(max(tile_counts[tile], 0), Kt);
  const int total = Kt / chunk;
  const int* list = tile_lists + static_cast<size_t>(tile) * Kt;

  int buf = 0;
  for (int c = done[tile] - 1; c >= 0; --c) {
    const int n = min(chunk, count - c * chunk);
    __syncthreads();  // frees the previous chunk's rows
    if (tid < n) {  // stage: thread j loads row j
      const int e = clamp_entry(list[c * chunk + tid], V);
      const float* row = feat + static_cast<size_t>(e) * NFEAT;
      float* r = s_rows + tid * ROW;
#pragma unroll
      for (int k = 0; k < NFEAT; ++k) r[k] = row[k];
      r[11] = __int_as_float(e == V ? -1 : order[e]);
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t slot =
          (static_cast<size_t>(tile) * total + c) * NPIX + tid + h * NT;
      x[h].T = entry[slot];
      x[h].total = __fmaf_rn(
          x[h].gb, chunk_color[3 * slot + 2],
          __fmaf_rn(x[h].gg, chunk_color[3 * slot + 1],
                    __fmul_rn(x[h].gr, chunk_color[3 * slot])));
      x[h].incl = 0.0f;
    }
    for (int jb = 0; jb < n; jb += SUB, buf ^= 1) {
      const int m = min(SUB, n - jb);
      for (int jj = 0; jj < m; ++jj) {
        const float4* r = reinterpret_cast<const float4*>(s_rows + (jb + jj) * ROW);
        const float4 a = r[0], b = r[1], q = r[2];
        const Alpha al0 = entry_alpha(a.x, a.y, a.z, a.w, b.x, q.y, x[0].px, x[0].py);
        const Alpha al1 = entry_alpha(a.x, a.y, a.z, a.w, b.x, q.y, x[1].px, x[1].py);
        if (!__any_sync(FULL, al0.alpha != 0.0f || al1.alpha != 0.0f)) {
          if (lane < NGRAD) s_part[buf][warp][jj][lane] = 0.0f;
          continue;
        }
        float t0[NGRAD], t1[NGRAD], v[NPAD];
        pixel_terms(x[0], a, b, q, al0, opaque_threshold, t0);
        pixel_terms(x[1], a, b, q, al1, opaque_threshold, t1);
#pragma unroll
        for (int k = 0; k < NGRAD; ++k) v[k] = __fadd_rn(t0[k], t1[k]);
#pragma unroll
        for (int k = NGRAD; k < NPAD; ++k) v[k] = 0.0f;
        const float sum = warp_transpose_sum(v, lane);
        if ((lane & 1) == 0 && lane < 2 * NGRAD)
          s_part[buf][warp][jj][lane / 2] = sum;
      }
      __syncthreads();
      float* out = partials +
                   (static_cast<size_t>(tile) * Kt + c * chunk + jb) * NGRAD;
      for (int k = tid; k < m * NGRAD; k += NT) {
        const int jj = k / NGRAD, f = k % NGRAD;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < NW2; ++w) sum = __fadd_rn(sum, s_part[buf][w][jj][f]);
        out[k] = sum;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) x[h].carry = __fadd_rn(x[h].carry, x[h].total);
  }
}

constexpr int RLANES = 16;  // lanes per feature row of the reduce
constexpr int RWARPS = 8;   // warps per CTA of the reduce

__global__ void __launch_bounds__(32 * RWARPS)
blend_bwd_reduce_kernel(const float* __restrict__ partials,
                        const int* __restrict__ row_ptr,
                        const int* __restrict__ pos,
                        const int* __restrict__ done, int V, int Kt,
                        int chunk, float* __restrict__ g_feat) {
  const int lane = threadIdx.x % 32, sub = lane % RLANES;
  const int r = (blockIdx.x * RWARPS + threadIdx.x / 32) * (32 / RLANES) +
                lane / RLANES;
  // the sentinel row V and rows past it have no positions
  int begin = 0, end = 0;
  if (r < V) {
    begin = row_ptr[r];
    end = row_ptr[r + 1];
  }
  float* out = g_feat + static_cast<size_t>(r) * NFEAT;
  if (!__any_sync(FULL, end > begin)) {  // both rows of the warp empty
    if (r <= V && sub < NFEAT) out[sub] = 0.0f;
    return;
  }
  // lane l of the row's 16 adds positions begin + l, begin + l + 16, ...
  float v[NPAD];
#pragma unroll
  for (int k = 0; k < NPAD; ++k) v[k] = 0.0f;
  for (int i = begin + sub; i < end; i += RLANES) {
    const int q = pos[i];
    const int t = q / Kt;
    if ((q - t * Kt) / chunk < done[t]) {
      const float2* src = reinterpret_cast<const float2*>(
          partials + static_cast<size_t>(q) * NGRAD);
#pragma unroll
      for (int k = 0; k < NGRAD / 2; ++k) {
        const float2 x = src[k];
        v[2 * k] = __fadd_rn(v[2 * k], x.x);
        v[2 * k + 1] = __fadd_rn(v[2 * k + 1], x.y);
      }
    }
  }
  // the 16 lane sums pairwise over lane bits 3, 2, 1, 0 (15 shuffles, each
  // inside its half-warp); lane l then holds column l % 16 (column 10,
  // elig, is a zero pad)
  butterfly_step<8, 8>(v, lane);
  butterfly_step<4, 4>(v, lane);
  butterfly_step<2, 2>(v, lane);
  butterfly_step<1, 1>(v, lane);
  if (r <= V && sub < NFEAT) out[sub] = v[0];
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() of the launch: 0 on success.
//
// partials [n_tiles, Kt, 10]: written at the positions below the tile's
// count inside its first done[t] chunks, nowhere else.
extern "C" int rtg_blend_bwd(const float* feat, const int* order, int V,
                             const int* tile_lists, const int* tile_counts,
                             const float* origins, const float* entry,
                             const int* done, const float* chunk_color,
                             const float* g_color, const float* g_depth,
                             const float* tfin_gt, const int* depth_index,
                             int n_tiles, int Kt, float opaque_threshold,
                             float* partials, void* stream) {
  const int chunk = Kt < CHUNK ? Kt : CHUNK;
  blend_bwd_kernel<<<n_tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      feat, order, V, tile_lists, tile_counts, origins, entry, done,
      chunk_color, g_color, g_depth, tfin_gt, depth_index, Kt, chunk,
      opaque_threshold, partials);
  return static_cast<int>(cudaGetLastError());
}

// g_feat [V+1, 11]: every row and column written.
extern "C" int rtg_blend_bwd_reduce(const float* partials, const int* row_ptr,
                                    const int* pos, const int* done, int V,
                                    int Kt, float* g_feat, void* stream) {
  const int chunk = Kt < CHUNK ? Kt : CHUNK;
  const int rows_per_cta = RWARPS * (32 / RLANES);
  const int blocks = (V + 1 + rows_per_cta - 1) / rows_per_cta;
  blend_bwd_reduce_kernel<<<blocks, 32 * RWARPS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      partials, row_ptr, pos, done, V, Kt, chunk, g_feat);
  return static_cast<int>(cudaGetLastError());
}
