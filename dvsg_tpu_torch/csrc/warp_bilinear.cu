// f32 bilinear warp kernels for Hopper (sm_90a): the training path's warps.
//
// Replaces the TPU kernels of dvsg_tpu/ops/warp_pallas.py:
//   dvsg_warp_f32           bilinear_warp_batch (pallas_call in _run_warp,
//                           body _make_warp_kernel)
//   dvsg_warp_f32_diff_fwd  _gdiff_fwd of bilinear_warp_batch_grids_diff
//                           (the same call with_grad=True, body
//                           _make_warp_grad_kernel)
//   dvsg_warp_f32_diff_bwd  _gdiff_bwd (plain jnp in the reference)
//
// All compute grid_sample(bilinear, border, align_corners=True) of NHWC
// f32 frames through a dense normalized grid:
//   x = clamp((gx + 1) * 0.5 * (W - 1), 0, W - 1),  x0 = floor(x),
//   second tap min(x0 + 1, W - 1), lerp in f32 in the oracle's order.
// The differentiable forward also writes, per channel, the derivative of
// the output with respect to the pixel coordinate, from the same taps:
//   dximg = (1 - fy)(v01 - v00) + fy(v11 - v10)
//   dyimg = (1 - fx)(v10 - v00) + fx(v11 - v01)
// (zero at the right/bottom border, where the clamped second tap equals
// the first). The backward turns an output cotangent g into the grid's:
//   dgx = (sum_c g * dximg) * [0 < x < W - 1] * 0.5 * (W - 1)
// with the mask taken on the unclamped coordinate, strict on both sides;
// the frames get no gradient.
//
// Inputs are contiguous, on the device:
//   frames f32 (B, H, W, C), grids f32 (B, Ho, Wo, 2),
//   out / dximg / dyimg / g f32 (B, Ho, Wo, C), dgrids f32 (B, Ho, Wo, 2).
//
// Bound: memory. Each output value needs one input value, 8/C grid bytes
// and about ten f32 operations, so the card's 3.35 TB/s is reached long
// before its 67 TFLOP/s. These first versions are one thread per output
// pixel over all C channels, with the four taps read straight from the
// unpadded frame: a CUDA gather reads any in-range address, so the TPU
// kernel's planar transpose, edge-padded copy, stripe windows, candidate
// row loop and coverage guard have no counterpart. Stores are C floats per
// thread (12 bytes for RGB), which wastes store bandwidth; vectorized
// rows are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kGrad>
__global__ void warp_f32_kernel(const float* __restrict__ frames,
                                const float* __restrict__ grids,
                                float* __restrict__ out,
                                float* __restrict__ dximg,
                                float* __restrict__ dyimg,
                                long long n_pix, long long pix_per_img,
                                int h, int w, int c) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_pix) return;
  const long long b = i / pix_per_img;
  const float2 g = reinterpret_cast<const float2*>(grids)[i];

  float x = (g.x + 1.0f) * 0.5f * static_cast<float>(w - 1);
  float y = (g.y + 1.0f) * 0.5f * static_cast<float>(h - 1);
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(w - 1));
  y = fminf(fmaxf(y, 0.0f), static_cast<float>(h - 1));
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);

  const float* src = frames + b * h * w * c;
  const float* p00 = src + (static_cast<long long>(y0) * w + x0) * c;
  const float* p01 = src + (static_cast<long long>(y0) * w + x1) * c;
  const float* p10 = src + (static_cast<long long>(y1) * w + x0) * c;
  const float* p11 = src + (static_cast<long long>(y1) * w + x1) * c;
  const long long o = i * c;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = p00[ch], v01 = p01[ch];
    const float v10 = p10[ch], v11 = p11[ch];
    const float top = v00 + (v01 - v00) * fx;
    const float bot = v10 + (v11 - v10) * fx;
    out[o + ch] = top + (bot - top) * fy;
    if (kGrad) {
      dximg[o + ch] = (1.0f - fy) * (v01 - v00) + fy * (v11 - v10);
      dyimg[o + ch] = (1.0f - fx) * (v10 - v00) + fx * (v11 - v01);
    }
  }
}

__global__ void warp_f32_grid_grad_kernel(const float* __restrict__ g,
                                          const float* __restrict__ dximg,
                                          const float* __restrict__ dyimg,
                                          const float* __restrict__ grids,
                                          float* __restrict__ dgrids,
                                          long long n_pix, int h, int w,
                                          int c) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_pix) return;
  const float2 gr = reinterpret_cast<const float2*>(grids)[i];
  // Unclamped pixel coordinate: the clamp's subgradient is zero outside
  // the strict interior.
  const float x = (gr.x + 1.0f) * 0.5f * static_cast<float>(w - 1);
  const float y = (gr.y + 1.0f) * 0.5f * static_cast<float>(h - 1);
  const long long o = i * c;
  float sx = 0.0f, sy = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = g[o + ch];
    sx += gv * dximg[o + ch];
    sy += gv * dyimg[o + ch];
  }
  const float mx = (x > 0.0f && x < static_cast<float>(w - 1)) ? 1.0f : 0.0f;
  const float my = (y > 0.0f && y < static_cast<float>(h - 1)) ? 1.0f : 0.0f;
  float2 d;
  d.x = sx * mx * (0.5f * static_cast<float>(w - 1));
  d.y = sy * my * (0.5f * static_cast<float>(h - 1));
  reinterpret_cast<float2*>(dgrids)[i] = d;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Each launcher enqueues one kernel on ``stream`` and returns
// cudaGetLastError() (0 on a launch the device accepted). None allocates or
// synchronizes.

extern "C" int dvsg_warp_f32(const void* frames, const void* grids,
                             void* out, int b, int h, int w, int c, int ho,
                             int wo, void* stream) {
  const long long pix_per_img = static_cast<long long>(ho) * wo;
  const long long n_pix = pix_per_img * b;
  if (n_pix <= 0 || h <= 0 || w <= 0) return 0;
  warp_f32_kernel<false><<<blocks_for(n_pix), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(grids),
      static_cast<float*>(out), nullptr, nullptr, n_pix, pix_per_img, h, w,
      c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dvsg_warp_f32_diff_fwd(const void* frames, const void* grids,
                                      void* out, void* dximg, void* dyimg,
                                      int b, int h, int w, int c, int ho,
                                      int wo, void* stream) {
  const long long pix_per_img = static_cast<long long>(ho) * wo;
  const long long n_pix = pix_per_img * b;
  if (n_pix <= 0 || h <= 0 || w <= 0) return 0;
  warp_f32_kernel<true><<<blocks_for(n_pix), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(grids),
      static_cast<float*>(out), static_cast<float*>(dximg),
      static_cast<float*>(dyimg), n_pix, pix_per_img, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dvsg_warp_f32_diff_bwd(const void* g, const void* dximg,
                                      const void* dyimg, const void* grids,
                                      void* dgrids, int b, int h, int w,
                                      int c, int ho, int wo, void* stream) {
  const long long n_pix = static_cast<long long>(ho) * wo * b;
  if (n_pix <= 0) return 0;
  warp_f32_grid_grad_kernel<<<blocks_for(n_pix), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(dximg),
      static_cast<const float*>(dyimg), static_cast<const float*>(grids),
      static_cast<float*>(dgrids), n_pix, h, w, c);
  return static_cast<int>(cudaGetLastError());
}
