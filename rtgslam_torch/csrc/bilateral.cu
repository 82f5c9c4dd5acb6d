// The tracker's bilateral depth filter for Hopper (sm_90a): one launch per
// frame in place of the plain loop's ~900 elementwise launches.
//
// Replaces no TPU kernel: the JAX package's
// rtgslam_tpu/ops/preprocess.py::bilateral_filter (:85) is plain jnp that
// XLA fuses.  Its port, rtgslam_torch/ops/preprocess.py::
// bilateral_filter_plain, runs the same loop eagerly: 81 offsets of a
// radius-5 disc x 11 ops, each a kernel over the whole frame.
//
// Contract (bilateral_filter_plain, reference SLAM/utils.py:550): for every
// pixel, over the offsets (dy, dx) of the disc dy^2 + dx^2 <= r^2, dy outer
// and dx inner, each ascending, with s the neighbour's depth (0 outside the
// image, as F.pad gives) and d the pixel's own:
//   w  = exp(sw + cw) * (s != 0),  sw = -(dy^2 + dx^2) / (2 sigma_s^2),
//                                  cw = -(d - s)^2 / (2 sigma_c^2)
//   ws += w,  ps += w * s;   out = ws == 0 ? 0 : ps / max(ws, 1e-12)
//
// Bitwise the plain loop on the card.  Each step rounds as the eager op
// does: the square is diff * diff (torch's pow by 2); the division of a
// tensor by a host scalar is a multiply by the scalar's float reciprocal
// (torch's div_true with a CPU scalar), so cw = (-sq) * inv with inv =
// 1.0f / float(2 sigma_c^2) taken on the host; sw is Python's double
// quotient rounded to float; the sums run in the loop's order in float
// registers.  -fmad=false (utils/cuda_build.py) keeps every product out of
// the adds that follow it, as separate kernels keep them.
//
// Design: one thread per output pixel, 32 x 8 pixels a block.  The block
// stages its tile of depth with a radius-wide halo (zero outside the
// image) in shared memory, and the spatial term of each squared distance
// 0..r^2 (sw) beside it, so the walk reads only shared memory.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): operations.  A tap costs 9
// FP32 operations (the difference, the square, the colour term, sw + cw,
// expf counted as one, the mask product, two adds and a product into the
// sums); a pixel 81 taps and 3 more (clamp, compare, divide): 732 a pixel,
// against 8 bytes (one float in, one out).  At 480x640 that is 2.2e8
// operations, 3.4 us at 67 TFLOP/s, against 0.7 us for the bytes.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__global__ void __launch_bounds__(BX * BY)
    bilateral_kernel(const float* __restrict__ depth, int H, int W, int radius,
                     double two_var_space, float inv_two_var_color,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tw = BX + 2 * radius;
  const int th = BY + 2 * radius;
  const int r2 = radius * radius;
  float* tile = smem;               // [th][tw], the block's pixels and halo
  float* sw_of = smem + tw * th;    // [r2 + 1], sw by dy^2 + dx^2
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int x0 = blockIdx.x * BX - radius;
  const int y0 = blockIdx.y * BY - radius;
  for (int i = tid; i < tw * th; i += BX * BY) {
    const int y = y0 + i / tw;
    const int x = x0 + i % tw;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W)
                  ? depth[static_cast<size_t>(y) * W + x]
                  : 0.0f;
  }
  for (int q = tid; q <= r2; q += BX * BY) {
    sw_of[q] = static_cast<float>(static_cast<double>(-q) / two_var_space);
  }
  __syncthreads();

  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* centre = tile + (threadIdx.y + radius) * tw + threadIdx.x + radius;
  const float d = *centre;
  float ws = 0.0f;
  float ps = 0.0f;
  for (int dy = -radius; dy <= radius; ++dy) {
    int m = radius;   // the widest |dx| with dy^2 + dx^2 <= r^2
    while (m * m > r2 - dy * dy) --m;
    const float* row = centre + dy * tw;
    for (int dx = -m; dx <= m; ++dx) {
      const float s = row[dx];
      const float diff = d - s;
      const float cw = -(diff * diff) * inv_two_var_color;
      const float e = expf(sw_of[dy * dy + dx * dx] + cw);
      const float w = e * (s != 0.0f ? 1.0f : 0.0f);
      ws = ws + w;
      ps = ps + w * s;
    }
  }
  // torch.clamp(min=1e-12) rounds its double bound to float; NaN passes
  const float lo = static_cast<float>(1e-12);
  out[static_cast<size_t>(y) * W + x] =
      ws == 0.0f ? 0.0f : ps / (ws < lo ? lo : ws);
}

}  // namespace

// depth, out: [H, W] float32, contiguous, on the stream's device.
// two_var_space, two_var_color: 2 sigma^2 as the caller computed them in
// double.  Returns cudaGetLastError() after the launch.
extern "C" int rtg_bilateral(const float* depth, int H, int W, int radius,
                             double two_var_space, double two_var_color,
                             float* out, void* stream) {
  const float inv_two_var_color = 1.0f / static_cast<float>(two_var_color);
  const int tw = BX + 2 * radius;
  const int th = BY + 2 * radius;
  const size_t smem = sizeof(float) * (tw * th + radius * radius + 1);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY);
  bilateral_kernel<<<grid, dim3(BX, BY), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      depth, H, W, radius, two_var_space, inv_two_var_color, out);
  return static_cast<int>(cudaGetLastError());
}
