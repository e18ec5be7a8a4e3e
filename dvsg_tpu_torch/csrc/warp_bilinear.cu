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
// The grid's gradient goes through the derivative of the output with
// respect to the pixel coordinate, per channel, from the same four taps:
//   dximg = (1 - fy)(v01 - v00) + fy(v11 - v10)
//   dyimg = (1 - fx)(v10 - v00) + fx(v11 - v01)
// (zero at the right/bottom border, where the clamped second tap equals
// the first), contracted with the output cotangent g:
//   dgx = (sum_c g * dximg) * [0 < x < W - 1] * 0.5 * (W - 1)
// with the mask taken on the unclamped coordinate, strict on both sides;
// the frames get no gradient.
//
// Inputs are contiguous, on the device:
//   frames f32 (B, H, W, C), grids f32 (B, Ho, Wo, 2),
//   out / g f32 (B, Ho, Wo, C), dgrids f32 (B, Ho, Wo, 2).
//
// Bound: memory. Each output value needs one input value, 8/C grid bytes
// and about ten f32 operations, so the card's 3.35 TB/s is reached long
// before its 67 TFLOP/s, and the way to be faster is to move fewer bytes.
// The reference keeps dximg and dyimg as residuals of its forward because
// its gather is the dear part; here a gather is four loads that mostly hit
// L1/L2 and bytes are dear. So the differentiable forward writes values
// only (the bytes of a plain warp), and the backward reads the frames and
// the grid again, recomputes the taps and forms both derivatives in
// registers: no derivative image ever reaches device memory, and the pair
// moves two thirds of the bytes it would with residuals. Every kernel is
// one thread per output pixel over all C channels, taps read straight from
// the unpadded frame: a CUDA gather reads any in-range address, so the TPU
// kernel's planar transpose, edge-padded copy, stripe windows, candidate
// row loop and coverage guard have no counterpart. A thread's C output
// floats are C stores 4 * C bytes apart across the warp; for RGB the
// differentiable forward stages a warp's 96 floats in shared memory and
// writes them as three whole 128-byte lines instead (timed both ways on
// the card: staging the stores pays, staging the backward's cotangent loads
// and four pixels a thread with 16-byte accesses do not).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One output pixel's four border-clamped taps in a frame (pointers to the
// first channel) and its fractional position.
struct Taps {
  const float* p00;
  const float* p01;
  const float* p10;
  const float* p11;
  float fx, fy;
};

// ``x``, ``y``: the unclamped pixel coordinate.
__device__ __forceinline__ Taps locate(const float* __restrict__ src,
                                       float x, float y, int h, int w,
                                       int c) {
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(w - 1));
  y = fminf(fmaxf(y, 0.0f), static_cast<float>(h - 1));
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);
  Taps t;
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.p00 = src + (static_cast<long long>(y0) * w + x0) * c;
  t.p01 = src + (static_cast<long long>(y0) * w + x1) * c;
  t.p10 = src + (static_cast<long long>(y1) * w + x0) * c;
  t.p11 = src + (static_cast<long long>(y1) * w + x1) * c;
  return t;
}

__global__ void warp_f32_kernel(const float* __restrict__ frames,
                                const float* __restrict__ grids,
                                float* __restrict__ out,
                                long long n_pix, long long pix_per_img,
                                int h, int w, int c) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_pix) return;
  const long long b = i / pix_per_img;
  const float2 g = reinterpret_cast<const float2*>(grids)[i];
  const Taps t = locate(frames + b * h * w * c,
                        (g.x + 1.0f) * 0.5f * static_cast<float>(w - 1),
                        (g.y + 1.0f) * 0.5f * static_cast<float>(h - 1),
                        h, w, c);
  const long long o = i * c;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = t.p00[ch], v01 = t.p01[ch];
    const float v10 = t.p10[ch], v11 = t.p11[ch];
    const float top = v00 + (v01 - v00) * t.fx;
    const float bot = v10 + (v11 - v10) * t.fx;
    out[o + ch] = top + (bot - top) * t.fy;
  }
}

// The warp of RGB frames with coalesced stores: a warp owns 32 consecutive
// pixels of one image and writes their 96 floats from shared memory as
// three 128-byte lines. The batch index is the launch's y dimension.
__global__ void warp_f32_rgb_kernel(const float* __restrict__ frames,
                                    const float* __restrict__ grids,
                                    float* __restrict__ out,
                                    long long pix_per_img, int nb, int h,
                                    int w) {
  __shared__ float stage[kThreads / 32][96];
  const int lane = threadIdx.x & 31;
  float* st = stage[threadIdx.x >> 5];
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  if (first >= pix_per_img) return;            // the whole warp
  const long long p = first + lane;
  const long long left = pix_per_img - first;
  const int n_floats = 3 * static_cast<int>(left < 32 ? left : 32);
  const float sw = static_cast<float>(w - 1);
  const float sh = static_cast<float>(h - 1);
  for (long long b = blockIdx.y; b < nb; b += gridDim.y) {
    if (p < pix_per_img) {
      const float2 g =
          reinterpret_cast<const float2*>(grids)[b * pix_per_img + p];
      const Taps t = locate(frames + b * h * w * 3, (g.x + 1.0f) * 0.5f * sw,
                            (g.y + 1.0f) * 0.5f * sh, h, w, 3);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float v00 = t.p00[ch], v01 = t.p01[ch];
        const float v10 = t.p10[ch], v11 = t.p11[ch];
        const float top = v00 + (v01 - v00) * t.fx;
        const float bot = v10 + (v11 - v10) * t.fx;
        st[3 * lane + ch] = top + (bot - top) * t.fy;
      }
    }
    __syncwarp();
    float* dst = out + (b * pix_per_img + first) * 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = lane + 32 * j;
      if (k < n_floats) dst[k] = st[k];
    }
    __syncwarp();
  }
}

// Grid cotangent from the output cotangent, the frames and the grid. The
// batch index is the launch's y dimension, so no thread divides.
__global__ void warp_f32_grid_grad_kernel(const float* __restrict__ g,
                                          const float* __restrict__ frames,
                                          const float* __restrict__ grids,
                                          float* __restrict__ dgrids,
                                          long long pix_per_img, int nb,
                                          int h, int w, int c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pix_per_img) return;
  const float sw = static_cast<float>(w - 1);
  const float sh = static_cast<float>(h - 1);
  for (long long b = blockIdx.y; b < nb; b += gridDim.y) {
    const long long i = b * pix_per_img + p;
    const float2 gr = reinterpret_cast<const float2*>(grids)[i];
    const float x = (gr.x + 1.0f) * 0.5f * sw;
    const float y = (gr.y + 1.0f) * 0.5f * sh;
    const Taps t = locate(frames + b * h * w * c, x, y, h, w, c);
    const long long o = i * c;
    float sx = 0.0f, sy = 0.0f;
    for (int ch = 0; ch < c; ++ch) {
      const float v00 = t.p00[ch], v01 = t.p01[ch];
      const float v10 = t.p10[ch], v11 = t.p11[ch];
      const float dx = (1.0f - t.fy) * (v01 - v00) + t.fy * (v11 - v10);
      const float dy = (1.0f - t.fx) * (v10 - v00) + t.fx * (v11 - v01);
      const float gv = g[o + ch];
      sx += gv * dx;
      sy += gv * dy;
    }
    // The clamp's subgradient is zero outside the strict interior of the
    // unclamped coordinate.
    const float mx = (x > 0.0f && x < sw) ? 1.0f : 0.0f;
    const float my = (y > 0.0f && y < sh) ? 1.0f : 0.0f;
    float2 d;
    d.x = sx * mx * (0.5f * sw);
    d.y = sy * my * (0.5f * sh);
    reinterpret_cast<float2*>(dgrids)[i] = d;
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Blocks over one image's pixels by as many images as the launch's y
// dimension takes (the kernels loop over the rest).
dim3 batch_grid(long long pix_per_img, int b) {
  return dim3(blocks_for(pix_per_img),
              static_cast<unsigned>(b < 65535 ? b : 65535));
}

int launch_warp(const void* frames, const void* grids, void* out, int b,
                int h, int w, int c, int ho, int wo, void* stream) {
  const long long pix_per_img = static_cast<long long>(ho) * wo;
  const long long n_pix = pix_per_img * b;
  if (n_pix <= 0 || h <= 0 || w <= 0) return 0;
  warp_f32_kernel<<<blocks_for(n_pix), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(grids),
      static_cast<float*>(out), n_pix, pix_per_img, h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher enqueues one kernel on ``stream`` and returns
// cudaGetLastError() (0 on a launch the device accepted). None allocates or
// synchronizes.

extern "C" int dvsg_warp_f32(const void* frames, const void* grids,
                             void* out, int b, int h, int w, int c, int ho,
                             int wo, void* stream) {
  return launch_warp(frames, grids, out, b, h, w, c, ho, wo, stream);
}

// The differentiable warp's forward: the values of dvsg_warp_f32 and
// nothing else (its backward recomputes what it needs). RGB frames take
// the kernel with coalesced stores, every other C the general one.
extern "C" int dvsg_warp_f32_diff_fwd(const void* frames, const void* grids,
                                      void* out, int b, int h, int w, int c,
                                      int ho, int wo, void* stream) {
  if (c != 3) {
    return launch_warp(frames, grids, out, b, h, w, c, ho, wo, stream);
  }
  const long long pix_per_img = static_cast<long long>(ho) * wo;
  if (pix_per_img <= 0 || b <= 0 || h <= 0 || w <= 0) return 0;
  warp_f32_rgb_kernel<<<batch_grid(pix_per_img, b), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(grids),
      static_cast<float*>(out), pix_per_img, b, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dvsg_warp_f32_diff_bwd(const void* g, const void* frames,
                                      const void* grids, void* dgrids, int b,
                                      int h, int w, int c, int ho, int wo,
                                      void* stream) {
  const long long pix_per_img = static_cast<long long>(ho) * wo;
  if (pix_per_img <= 0 || b <= 0 || h <= 0 || w <= 0) return 0;
  warp_f32_grid_grad_kernel<<<batch_grid(pix_per_img, b), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(frames),
      static_cast<const float*>(grids), static_cast<float*>(dgrids),
      pix_per_img, b, h, w, c);
  return static_cast<int>(cudaGetLastError());
}
