// Fused offsets -> warp -> uint8 kernels for Hopper (sm_90a).
//
// Replace the TPU kernel dvsg_tpu/ops/warp_wide.py::warp_u8_offsets
// (pallas_call in _launch_offsets, body _make_offsets_kernel): from a
// coarse (gh, gw) offset field they synthesize each output pixel's sampling
// coordinate, sample the uint8 frame bilinearly with border clamp and
// align_corners=True, and write round-half-even uint8. No dense
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
// Bound. By bytes the work is small: at 720p, T = 16 a call reads 44.2 MB
// of frames and writes 44.2 MB, 26 us at the H100 SXM's 3.35 TB/s, and the
// offset rows (B * H * gw * 8 bytes, 1.5 MB) stay in L2. What binds both
// kernels on this card is the instruction rate: their time follows the
// length of their SASS, not their bytes. A one-thread-per-pixel kernel has per
// pixel 12 one-byte tap loads, 4 scalar loads of the offset rows, 3
// one-byte stores, two 64-bit divisions for the row index and 64-bit
// address products. The stage variants (each leaves one part of a kernel
// out, see Stage) time those parts on the card; PERF.md has the table.
//
// Two kernels, chosen by the wrapper from the shape alone:
//
// * warp_u8_offsets_packed_kernel, for C = 3 and W % 4 == 0 (every video
//   size in use). A thread owns four consecutive pixels of a row: 12 output
//   bytes leave as three aligned 32-bit stores, so a warp writes 384
//   contiguous bytes. The row and the frame come from the launch's y and z
//   dimensions (no division), and everything inside a frame is 32-bit
//   arithmetic. The two taps of a pixel in one source row are 6
//   contiguous bytes: they are fetched as the two or three aligned 32-bit
//   words that cover them and shifted into place, 4-6 loads a pixel in
//   place of 12, and a row is a whole number of words, so both rows of a
//   pixel share the shift. At the right border the pair starts at W - 2
//   with weight 1 on its second tap, which is the clamped tap's value
//   exactly, so a pair never leaves its row. The offset rows are read as
//   float2. Rounding is one cvt.rni.sat.u8.f32 (round half to even,
//   saturate). The coordinate chain keeps the general kernel's f32 order,
//   so the two kernels give the same bytes. The tap fetch and the rounding
//   are warp_u8_tail.cuh's, shared with warp_u8_batch.cu. What was timed
//   and lost: lanes on neighbouring pixels with the bytes staged through
//   shared memory (fewer load transactions, more instructions: slower),
//   reloading the
//   offset rows only when the coarse cell changes (a branch a pixel), and
//   byte-to-float by bit pattern instead of a conversion (no change).
// * warp_u8_offsets_kernel, the general-shape kernel: one thread per
//   output pixel over any C, byte taps, 64-bit addressing. Any coordinates
//   are legal in both: a CUDA gather reads any in-range address, so the
//   TPU kernel's stripe windows, quad-packed taps and coverage guard have
//   no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_u8_tail.cuh"

namespace {

constexpr int kThreads = 128;

// What a kernel leaves out. kFull is the kernel; the other values are its
// stage variants, launched only by dvsg_warp_u8_offsets_probe to time the
// kernel's parts on the card. kNoTaps and kIdentity combine.
enum Stage : int {
  kFull = 0,
  kNoTaps = 1,     // no tap loads: the bytes are made from the coordinate
  kIdentity = 2,   // no offset rows, no horizontal lerp: identity coordinate
  kIndex32 = 4,    // all of it, but a (W tiles, H, B) launch and 32-bit
                   // indices (general kernel only; the packed one has them)
  kNoStores = 8,   // all of it, but one guarded store that never fires
                   // (general kernel only)
};

template <int kStage>
__global__ void warp_u8_offsets_kernel(const uint8_t* __restrict__ frames,
                                       const float* __restrict__ rows,
                                       uint8_t* __restrict__ out,
                                       int h, int w, int c, int gw,
                                       float scale) {
  int px, py;
  long long b, brow;                          // brow = b * h + py
  if constexpr (kStage & kIndex32) {
    px = blockIdx.x * kThreads + threadIdx.x;
    py = blockIdx.y;
    b = blockIdx.z;
    brow = b * h + py;
  } else {
    px = blockIdx.y * kThreads + threadIdx.x;
    brow = blockIdx.x;
    py = static_cast<int>(brow % h);
    b = brow / h;
  }
  if (px >= w) return;

  // Horizontal lerp of the y-upsampled offsets at this column.
  float ox = 0.0f, oy = 0.0f;
  if constexpr (!(kStage & kIdentity)) {
    float gx = (px + 0.5f) * (static_cast<float>(gw) / w) - 0.5f;
    gx = fminf(fmaxf(gx, 0.0f), static_cast<float>(gw - 1));
    const float c0f = floorf(gx);
    const float fg = gx - c0f;
    const int c0 = static_cast<int>(c0f);
    const int c1 = min(c0 + 1, gw - 1);
    const float* r = rows + brow * gw * 2;
    ox = (1.0f - fg) * r[2 * c0] + fg * r[2 * c1];
    oy = (1.0f - fg) * r[2 * c0 + 1] + fg * r[2 * c1 + 1];
  }

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

  const uint8_t *p00, *p01, *p10, *p11;
  uint8_t* dst;
  if constexpr (kStage & kIndex32) {
    const long long frame = b * h * w * c;
    const uint8_t* src = frames + frame;
    p00 = src + (y0 * w + x0) * c;
    p01 = src + (y0 * w + x1) * c;
    p10 = src + (y1 * w + x0) * c;
    p11 = src + (y1 * w + x1) * c;
    dst = out + frame + (py * w + px) * c;
  } else {
    const uint8_t* src = frames + b * h * w * c;
    p00 = src + (static_cast<long long>(y0) * w + x0) * c;
    p01 = src + (static_cast<long long>(y0) * w + x1) * c;
    p10 = src + (static_cast<long long>(y1) * w + x0) * c;
    p11 = src + (static_cast<long long>(y1) * w + x1) * c;
    dst = out + (brow * w + px) * c;
  }
  float sum = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    float acc;
    if constexpr (kStage & kNoTaps) {
      acc = fx + fy + static_cast<float>((x0 + y0 + ch) & 127);
    } else {
      const float v00 = p00[ch], v01 = p01[ch];
      const float v10 = p10[ch], v11 = p11[ch];
      const float top = v00 + (v01 - v00) * fx;
      const float bot = v10 + (v11 - v10) * fx;
      acc = top + (bot - top) * fy;
    }
    if constexpr (kStage & kNoStores) {
      sum += acc;
    } else {
      // rintf rounds half to even, as the reference's round does.
      dst[ch] = static_cast<uint8_t>(fminf(fmaxf(rintf(acc), 0.0f), 255.0f));
    }
  }
  if constexpr (kStage & kNoStores) {
    if (sum < 0.0f) dst[0] = 1;               // never: every acc is >= 0
  }
}

template <int kStage>
int launch_general(const void* frames, const void* rows, void* out, int b,
                   int h, int w, int c, int gw, float border_crop,
                   void* stream) {
  dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(h),
            static_cast<unsigned>((w + kThreads - 1) / kThreads));
  if (kStage & kIndex32) {
    if (h > 65535 || b > 65535 ||
        static_cast<long long>(h) * w * c > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    grid = dim3(grid.y, static_cast<unsigned>(h), static_cast<unsigned>(b));
  }
  warp_u8_offsets_kernel<kStage><<<grid, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(rows),
      static_cast<uint8_t*>(out), h, w, c, gw, 1.0f - 2.0f * border_crop);
  return static_cast<int>(cudaGetLastError());
}

// --- the packed kernel: C = 3, W % 4 == 0 ---------------------------------

// A block is four warps, each on 128 consecutive pixels of its own row.
constexpr int kPackX = 32;
constexpr int kPackY = 4;

template <int kStage>
__global__ void __launch_bounds__(kPackX * kPackY)
warp_u8_offsets_packed_kernel(const uint8_t* __restrict__ frames,
                              const float* __restrict__ rows,
                              uint8_t* __restrict__ out, int h, int w,
                              int gw, float scale, float gscale) {
  const int px0 = 4 * (blockIdx.x * kPackX + threadIdx.x);
  const int py = blockIdx.y * kPackY + threadIdx.y;
  if (px0 >= w || py >= h) return;
  const size_t b = blockIdx.z;
  const size_t frame = b * h * w * 3;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(frames + frame);
  const float2* r =
      reinterpret_cast<const float2*>(rows) + (b * h + py) * gw;

  const float half_w = 0.5f * (w - 1);
  const float half_h = 0.5f * (h - 1);
  const float x_shift = (1.0f - scale) * half_w;
  const float y_ident = scale * py + (1.0f - scale) * half_h;
  const float px0f = static_cast<float>(px0);
  const int row_words = w / 4 * 3;

  uint32_t word[3] = {0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float px = px0f + static_cast<float>(k);
    // Horizontal lerp of the y-upsampled offsets at this column.
    float gx = (px + 0.5f) * gscale - 0.5f;
    gx = fminf(fmaxf(gx, 0.0f), static_cast<float>(gw - 1));
    const float c0f = floorf(gx);
    const float fg = gx - c0f;
    const int c0 = static_cast<int>(c0f);
    float ox = 0.0f, oy = 0.0f;
    if constexpr (!(kStage & kIdentity)) {
      const float2 r0 = __ldg(r + c0);
      const float2 r1 = __ldg(r + min(c0 + 1, gw - 1));
      ox = (1.0f - fg) * r0.x + fg * r1.x;
      oy = (1.0f - fg) * r0.y + fg * r1.y;
    }

    float x = scale * px + x_shift + ox * half_w;
    float y = y_ident + oy * half_h;
    x = fminf(fmaxf(x, 0.0f), static_cast<float>(w - 1));
    y = fminf(fmaxf(y, 0.0f), static_cast<float>(h - 1));
    // The pair starts at most at W - 2: at x = W - 1 its second tap gets
    // weight exactly 1.
    const int x0 = min(static_cast<int>(floorf(x)), w - 2);
    const float fx = x - static_cast<float>(x0);
    const float y0f = floorf(y);
    const float fy = y - y0f;
    const int y0 = static_cast<int>(y0f);
    const int y1 = min(y0 + 1, h - 1);

    float v00[3], v01[3], v10[3], v11[3];
    // A row is a whole number of words, so the pair one row down starts
    // at the same byte of its word.
    const int a = (y0 * w + x0) * 3;
    const uint32_t* p = src + (a >> 2);
    const unsigned shift = (a & 3) * 8;
    if constexpr (kStage & kNoTaps) {
      for (int ch = 0; ch < 3; ++ch) {
        v00[ch] = fx + static_cast<float>(ch);
        v01[ch] = fy;
        v10[ch] = static_cast<float>((p - src) & 63);
        v11[ch] = static_cast<float>(shift);
      }
    } else {
      load_tap_pair(p, shift, v00, v01);
      load_tap_pair(p + (y1 - y0) * row_words, shift, v10, v11);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float top = v00[ch] + (v01[ch] - v00[ch]) * fx;
      const float bot = v10[ch] + (v11[ch] - v10[ch]) * fx;
      const int j = 3 * k + ch;               // byte of the thread's 12
      word[j >> 2] |= round_u8(top + (bot - top) * fy) << (8 * (j & 3));
    }
  }
  uint32_t* dst =
      reinterpret_cast<uint32_t*>(out + frame) + (py * w + px0) / 4 * 3;
  dst[0] = word[0];
  dst[1] = word[1];
  dst[2] = word[2];
}

template <int kStage>
int launch_packed(const void* frames, const void* rows, void* out, int b,
                  int h, int w, int c, int gw, float border_crop,
                  void* stream) {
  if (c != 3 || w % 4 != 0 || b > 65535 || h > 65535 ||
      static_cast<long long>(h) * w * 3 > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(frames) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(rows) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((w / 4 + kPackX - 1) / kPackX),
                  static_cast<unsigned>((h + kPackY - 1) / kPackY),
                  static_cast<unsigned>(b));
  warp_u8_offsets_packed_kernel<kStage>
      <<<grid, dim3(kPackX, kPackY), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(frames),
          static_cast<const float*>(rows), static_cast<uint8_t*>(out), h, w,
          gw, 1.0f - 2.0f * border_crop, static_cast<float>(gw) / w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher enqueues one kernel on ``stream`` and returns
// cudaGetLastError() (0 on a launch the device accepted). None allocates or
// synchronizes.

// The general-shape kernel.
extern "C" int dvsg_warp_u8_offsets(const void* frames, const void* rows,
                                    void* out, int b, int h, int w, int c,
                                    int gw, float border_crop,
                                    void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  return launch_general<kFull>(frames, rows, out, b, h, w, c, gw,
                               border_crop, stream);
}

// The packed kernel. Takes C = 3, W % 4 == 0, frames under 2^31 bytes, B
// and H up to 65535 and 4-byte aligned frames and out; anything else is
// cudaErrorInvalidValue (the wrapper picks the kernel by shape and never
// sends such a call).
extern "C" int dvsg_warp_u8_offsets_packed(const void* frames,
                                           const void* rows, void* out,
                                           int b, int h, int w, int c,
                                           int gw, float border_crop,
                                           void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  return launch_packed<kFull>(frames, rows, out, b, h, w, c, gw,
                              border_crop, stream);
}

// One stage variant (``stage`` is a sum of Stage values) of the packed
// kernel if ``packed`` else of the general one, for timing a kernel's
// parts; every variant writes ``out``, none but kFull is a warp.
extern "C" int dvsg_warp_u8_offsets_probe(const void* frames,
                                          const void* rows, void* out, int b,
                                          int h, int w, int c, int gw,
                                          float border_crop, int stage,
                                          int packed, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
#define DVSG_STAGE(launch, k) \
  case k:                     \
    return launch<k>(frames, rows, out, b, h, w, c, gw, border_crop, stream)
  if (packed) {
    switch (stage) {
      DVSG_STAGE(launch_packed, kFull);
      DVSG_STAGE(launch_packed, kNoTaps);
      DVSG_STAGE(launch_packed, kIdentity);
      DVSG_STAGE(launch_packed, kNoTaps | kIdentity);
    }
  } else {
    switch (stage) {
      DVSG_STAGE(launch_general, kFull);
      DVSG_STAGE(launch_general, kNoTaps);
      DVSG_STAGE(launch_general, kIdentity);
      DVSG_STAGE(launch_general, kIndex32);
      DVSG_STAGE(launch_general, kNoStores);
    }
  }
#undef DVSG_STAGE
  return static_cast<int>(cudaErrorInvalidValue);
}
