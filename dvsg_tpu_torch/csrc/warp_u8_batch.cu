// Dense-grid warp -> uint8 kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel dvsg_tpu/ops/warp_wide.py::warp_u8_batch
// (pallas_call in _launch, body _make_wide_kernel): uint8 frames sampled
// bilinearly through a dense normalized grid, border clamp,
// align_corners=True, written as round-half-even uint8. The output size
// follows the grid and may differ from the input's.
//
// Inputs (all contiguous, on the device):
//   frames  uint8 (B, H, W, C)
//   grids   f32   (B, Ho, Wo, 2)    normalized (x, y)
//   out     uint8 (B, Ho, Wo, C)
//
// The tap/lerp/rintf tail is that of warp_u8_offsets.cu: a 0..255 f32
// accumulator rounded once, which stays within 1 LSB of the plain
// quantize(warp(frames / 255)) * 255.
//
// Bound: memory, and mostly the grid: each output pixel reads 8 bytes of
// coordinates beside its C input bytes and C output bytes. One thread per
// output pixel, all C channels, taps read from the unpadded frame (no
// stripe windows, quad-packed taps, grid padding to 128 columns or
// coverage guard: a CUDA gather reads any in-range address). Byte-wide
// loads and C-byte stores per thread bound it by memory transactions
// before DRAM bytes; row-vectorized stores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void warp_u8_batch_kernel(const uint8_t* __restrict__ frames,
                                     const float* __restrict__ grids,
                                     uint8_t* __restrict__ out,
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

  const uint8_t* src = frames + b * h * w * c;
  const uint8_t* p00 = src + (static_cast<long long>(y0) * w + x0) * c;
  const uint8_t* p01 = src + (static_cast<long long>(y0) * w + x1) * c;
  const uint8_t* p10 = src + (static_cast<long long>(y1) * w + x0) * c;
  const uint8_t* p11 = src + (static_cast<long long>(y1) * w + x1) * c;
  uint8_t* dst = out + i * c;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = p00[ch], v01 = p01[ch];
    const float v10 = p10[ch], v11 = p11[ch];
    const float top = v00 + (v01 - v00) * fx;
    const float bot = v10 + (v11 - v10) * fx;
    const float acc = top + (bot - top) * fy;
    // rintf rounds half to even, as the reference's round does.
    dst[ch] = static_cast<uint8_t>(fminf(fmaxf(rintf(acc), 0.0f), 255.0f));
  }
}

}  // namespace

// Launches the kernel on ``stream``; returns cudaGetLastError() (0 on a
// launch the device accepted). Allocates nothing and does not synchronize.
extern "C" int dvsg_warp_u8_batch(const void* frames, const void* grids,
                                  void* out, int b, int h, int w, int c,
                                  int ho, int wo, void* stream) {
  const long long pix_per_img = static_cast<long long>(ho) * wo;
  const long long n_pix = pix_per_img * b;
  if (n_pix <= 0 || h <= 0 || w <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_pix + kThreads - 1) / kThreads);
  warp_u8_batch_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(grids),
      static_cast<uint8_t*>(out), n_pix, pix_per_img, h, w, c);
  return static_cast<int>(cudaGetLastError());
}
