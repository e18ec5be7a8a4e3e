// Fused offsets -> warp -> uint8 kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel dvsg_tpu/ops/warp_wide.py::warp_u8_offsets
// (pallas_call in _launch_offsets, body _make_offsets_kernel): from a
// coarse (gh, gw) offset field it synthesizes each output pixel's sampling
// coordinate, samples the uint8 frame bilinearly with border clamp and
// align_corners=True, and writes round-half-even uint8. No dense
// (B, H, W, 2) grid is built.
//
// Inputs (all contiguous, on the device):
//   frames  uint8 (B, H, W, C)       the source frames, read in place
//   rows    f32   (B, H, gw, 2)      offsets upsampled along y only, in
//                                    normalized (x, y) units; the wrapper
//                                    computes them as R @ offsets with
//                                    R = _resize_matrix(gh, H)
//   out     uint8 (B, H, W, C)
// The horizontal upsample is a lerp over the gw columns at
// clamp((px + 0.5) * gw / W - 0.5, 0, gw - 1), which is what the
// jax.image.resize operator reduces to when magnifying. The identity is
// scale * px + (1 - scale) * (W - 1) / 2 with scale = 1 - 2 * border_crop.
//
// Bound: memory. Each output byte needs one input byte and a few f32
// operations, so at 720p, T = 16 the kernel reads 44.2 MB of frames and
// writes 44.2 MB: about 26 us per chunk, 1.65 us per frame, at the H100
// SXM's 3.35 TB/s (data-sheet peak at its 700 W limit). The offset rows
// (B * H * gw * 8 bytes, 1.5 MB) stay in L2. This first version is one thread per output pixel computing all C
// channels, with taps read straight from the unpadded frame (a CUDA
// gather reads any in-range address, so the TPU kernel's stripe windows,
// quad-packed taps and coverage guard have no counterpart here). Making it
// fast (16-byte vectorized stores, shared-memory row tiles, TMA) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void warp_u8_offsets_kernel(const uint8_t* __restrict__ frames,
                                       const float* __restrict__ rows,
                                       uint8_t* __restrict__ out,
                                       int h, int w, int c, int gw,
                                       float scale) {
  const int px = blockIdx.y * kThreads + threadIdx.x;
  if (px >= w) return;
  const long long brow = blockIdx.x;          // b * h + py
  const int py = static_cast<int>(brow % h);
  const long long b = brow / h;

  // Horizontal lerp of the y-upsampled offsets at this column.
  float gx = (px + 0.5f) * (static_cast<float>(gw) / w) - 0.5f;
  gx = fminf(fmaxf(gx, 0.0f), static_cast<float>(gw - 1));
  const float c0f = floorf(gx);
  const float fg = gx - c0f;
  const int c0 = static_cast<int>(c0f);
  const int c1 = min(c0 + 1, gw - 1);
  const float* r = rows + brow * gw * 2;
  const float ox = (1.0f - fg) * r[2 * c0] + fg * r[2 * c1];
  const float oy = (1.0f - fg) * r[2 * c0 + 1] + fg * r[2 * c1 + 1];

  // Pixel coordinates: identity (zoomed by the crop) plus the offset.
  const float half_w = 0.5f * (w - 1);
  const float half_h = 0.5f * (h - 1);
  float x = scale * px + (1.0f - scale) * half_w + ox * half_w;
  float y = scale * py + (1.0f - scale) * half_h + oy * half_h;
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
  uint8_t* dst = out + (brow * w + px) * c;
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
extern "C" int dvsg_warp_u8_offsets(const void* frames, const void* rows,
                                    void* out, int b, int h, int w, int c,
                                    int gw, float border_crop,
                                    void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(h),
                  static_cast<unsigned>((w + kThreads - 1) / kThreads));
  warp_u8_offsets_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(rows),
      static_cast<uint8_t*>(out), h, w, c, gw, 1.0f - 2.0f * border_crop);
  return static_cast<int>(cudaGetLastError());
}
