// Arithmetic shared by the forward (blend_fwd.cu, K1) and backward
// (blend_bwd.cu, K2) tile blends, so that K2 rebuilds every transmittance
// with K1's own rounding.
//
// The sources build with -fmad=false: nvcc contracts no multiply-add on its
// own, and every fused multiply-add below is an explicit __fmaf_rn.  Which
// ones fuse is a decision of this file:
//   * alpha is computed unfused, in the plain twins' order of operations,
//     so its threshold tests (power > 0, 1/255, the 0.99 cap, the opaque
//     threshold) give the same verdict as the plain PyTorch twin on the
//     same inputs: a flip at 1/255 would move a colour by up to 1/255;
//   * the transmittance step and the running sums fuse (one rounding each;
//     the twins take T in log space and hold the kernels to 1e-5);
//   * the one division, K2's d/dalpha by (1 - alpha), is the approximate
//     __fdividef (2 ulp; the divisor lies in [0.01, 1]), not an IEEE
//     __fdiv_rn: on the H100 it makes K2 1.08-1.12x faster and moves its
//     per-position gradients by at most 5.4e-8 of the largest
//     (PERF.md), against the 1e-4 it is held to.

#pragma once

#include <cuda_runtime.h>

namespace rtg {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr unsigned FULL = 0xffffffffu;

// A chunk entry is staged row-major in shared memory as three 16-byte
// words, so a warp reads an entry with three broadcast loads:
//   (mean_x, mean_y, conic_a, conic_b)
//   (conic_c, z, r, g)
//   (b, opacity, elig, index-map value as int bits; -1 = sentinel)
// Transmission mode stages the first and (conic_c, opacity, -, -) only.

struct Alpha {
  float alpha;  // the blend weight's alpha: 0, or in [1/255, 0.99]
  float e;      // exp(min(power, 0))
  float dx, dy;
  bool gate;    // alpha has a gradient: power <= 0 and 1/255 <= raw < 0.99
};

// alpha = opacity * exp(power); 0 when power > 0 or alpha < 1/255; capped
// at 0.99 (blend.py::_chunk_alphas).  Unfused, in the twins' order.
__device__ __forceinline__ Alpha entry_alpha(float mx, float my, float ca,
                                             float cb, float cc, float opa,
                                             float px, float py) {
  Alpha a;
  a.dx = __fsub_rn(px, mx);
  a.dy = __fsub_rn(py, my);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, a.dx), a.dx),
                               __fmul_rn(__fmul_rn(cc, a.dy), a.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, a.dx), a.dy));
  a.e = expf(fminf(power, 0.0f));
  const float raw = __fmul_rn(opa, a.e);
  a.gate = power <= 0.0f && raw >= ALPHA_EPS && raw < ALPHA_MAX;
  a.alpha = (power > 0.0f || raw < ALPHA_EPS) ? 0.0f : fminf(raw, ALPHA_MAX);
  return a;
}

// T after an entry of alpha `alpha`: T (1 - alpha) in one rounding.  T
// stays exactly 1 iff every alpha so far is exactly 0.
__device__ __forceinline__ float transmit(float T, float alpha) {
  return __fmaf_rn(-alpha, T, T);
}

__device__ __forceinline__ int clamp_entry(int e, int V) {
  return (e < 0 || e > V) ? V : e;  // out-of-contract entry -> sentinel
}

}  // namespace rtg
