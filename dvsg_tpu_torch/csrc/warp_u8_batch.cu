// Dense-grid warp -> uint8 kernels for Hopper (sm_90a).
//
// Replace the TPU kernel dvsg_tpu/ops/warp_wide.py::warp_u8_batch
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
// The tap/lerp/round tail is that of warp_u8_offsets.cu: a 0..255 f32
// accumulator rounded once, which stays within 1 LSB of the plain
// quantize(warp(frames / 255)) * 255.
//
// Bound. By bytes: at 720p, B = 16 a call reads 44.2 MB of frames and
// 118.0 MB of grid and writes 44.2 MB, 62 us at the H100 SXM's 3.35 TB/s;
// 57 % of the bytes are the grid, a coalesced stream. The stage variants
// (each leaves one part of a kernel out, see Stage) time the parts on the
// card; PERF.md has the table. On an H100 SXM the packed kernel runs at
// about two thirds of the byte bound, and leaving out either its grid
// loads or its taps saves about a third of its time: no one part binds it.
// The general kernel (one thread a pixel, a 64-bit division for the frame
// index, 12 one-byte tap loads and 3 one-byte stores a pixel) takes 1.75x
// as long, and its variant with a third fewer instructions (kIndex32) is no
// faster, so unlike B1's its time does not follow its instruction count.
//
// Two kernels, chosen by the wrapper from the shapes alone:
//
// * warp_u8_batch_packed_kernel, for C = 3, W % 4 == 0 and Wo % 4 == 0
//   (every video size in use). A thread owns four consecutive output
//   pixels of a row: their four (x, y) pairs are 32 contiguous bytes, read
//   as two 16-byte loads, and their 12 output bytes leave as three aligned
//   32-bit stores, so a warp reads 1 KB of grid and writes 384 contiguous
//   bytes. The output row and the frame come from the launch's y and z
//   dimensions (no division), and everything inside a frame is 32-bit
//   arithmetic. The taps are warp_u8_tail.cuh's aligned words shifted into
//   place; a pair starts at most at W - 2, with weight exactly 1 on its
//   second tap at x = W - 1, which gives the clamped tap's value exactly.
//   The coordinate chain keeps the general kernel's f32 order, so the two
//   kernels give the same bytes.
// * warp_u8_batch_kernel, the general-shape kernel: one thread per output
//   pixel over any C, byte taps, 64-bit addressing. Any coordinates are
//   legal in both: a CUDA gather reads any in-range address, so the TPU
//   kernel's stripe windows, quad-packed taps, grid padding to 128 columns
//   and coverage guard have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_u8_tail.cuh"

namespace {

constexpr int kThreads = 256;

// What a kernel leaves out. kFull is the kernel; the other values are its
// stage variants, launched only by dvsg_warp_u8_batch_probe to time the
// kernel's parts on the card. kNoTaps and kNoGrid combine.
enum Stage : int {
  kFull = 0,
  kNoTaps = 1,     // no tap loads: the bytes are made from the coordinate
                   // (packed kernel only)
  kNoGrid = 2,     // no grid loads: the identity coordinate (packed only)
  kIndex32 = 4,    // all of it, but a (Wo tiles, Ho, B) launch and 32-bit
                   // in-frame indices (general kernel only; the packed one
                   // has them)
  kNoStores = 8,   // all of it, but one guarded store that never fires
                   // (packed kernel only)
};

template <int kStage>
__global__ void warp_u8_batch_kernel(const uint8_t* __restrict__ frames,
                                     const float* __restrict__ grids,
                                     uint8_t* __restrict__ out,
                                     long long n_pix, long long pix_per_img,
                                     int h, int w, int c, int wo) {
  long long i, b;                  // output pixel of the batch, its frame
  int in_frame = 0;                // kIndex32: output pixel of the frame
  if constexpr (kStage & kIndex32) {
    const int px = blockIdx.x * kThreads + threadIdx.x;
    if (px >= wo) return;
    b = blockIdx.z;
    in_frame = static_cast<int>(blockIdx.y) * wo + px;
    i = b * pix_per_img + in_frame;
  } else {
    i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n_pix) return;
    b = i / pix_per_img;
  }
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

  const uint8_t *p00, *p01, *p10, *p11;
  uint8_t* dst;
  if constexpr (kStage & kIndex32) {
    const uint8_t* src = frames + b * h * w * c;
    p00 = src + (y0 * w + x0) * c;
    p01 = src + (y0 * w + x1) * c;
    p10 = src + (y1 * w + x0) * c;
    p11 = src + (y1 * w + x1) * c;
    dst = out + b * pix_per_img * c + in_frame * c;
  } else {
    const uint8_t* src = frames + b * h * w * c;
    p00 = src + (static_cast<long long>(y0) * w + x0) * c;
    p01 = src + (static_cast<long long>(y0) * w + x1) * c;
    p10 = src + (static_cast<long long>(y1) * w + x0) * c;
    p11 = src + (static_cast<long long>(y1) * w + x1) * c;
    dst = out + i * c;
  }
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

template <int kStage>
int launch_general(const void* frames, const void* grids, void* out, int b,
                   int h, int w, int c, int ho, int wo, void* stream) {
  const long long pix_per_img = static_cast<long long>(ho) * wo;
  const long long n_pix = pix_per_img * b;
  dim3 grid(static_cast<unsigned>((n_pix + kThreads - 1) / kThreads));
  if (kStage & kIndex32) {
    if (ho > 65535 || b > 65535 ||
        static_cast<long long>(h) * w * c > 0x7fffffffLL ||
        pix_per_img * c > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    grid = dim3(static_cast<unsigned>((wo + kThreads - 1) / kThreads),
                static_cast<unsigned>(ho), static_cast<unsigned>(b));
  }
  warp_u8_batch_kernel<kStage><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frames), static_cast<const float*>(grids),
      static_cast<uint8_t*>(out), n_pix, pix_per_img, h, w, c, wo);
  return static_cast<int>(cudaGetLastError());
}

// --- the packed kernel: C = 3, W % 4 == 0, Wo % 4 == 0 ----------------------

// A block is four warps, each on 128 consecutive output pixels of its own
// row.
constexpr int kPackX = 32;
constexpr int kPackY = 4;

template <int kStage>
__global__ void __launch_bounds__(kPackX * kPackY)
warp_u8_batch_packed_kernel(const uint8_t* __restrict__ frames,
                            const float* __restrict__ grids,
                            uint8_t* __restrict__ out, int h, int w, int ho,
                            int wo, float step_x, float step_y) {
  const int px0 = 4 * (blockIdx.x * kPackX + threadIdx.x);
  const int py = blockIdx.y * kPackY + threadIdx.y;
  if (px0 >= wo || py >= ho) return;
  const size_t b = blockIdx.z;
  const size_t frame_pix = static_cast<size_t>(ho) * wo;
  const unsigned pix = py * wo + px0;        // the first of the thread's four
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(frames + b * h * w * 3);

  float gx[4], gy[4];
  if constexpr (kStage & kNoGrid) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gx[k] = static_cast<float>(px0 + k) * step_x - 1.0f;
      gy[k] = static_cast<float>(py) * step_y - 1.0f;
    }
  } else {
    const float4* g =
        reinterpret_cast<const float4*>(grids + 2 * (b * frame_pix + pix));
    const float4 g01 = __ldg(g);
    const float4 g23 = __ldg(g + 1);
    gx[0] = g01.x; gy[0] = g01.y; gx[1] = g01.z; gy[1] = g01.w;
    gx[2] = g23.x; gy[2] = g23.y; gx[3] = g23.z; gy[3] = g23.w;
  }

  const float wm1 = static_cast<float>(w - 1);
  const float hm1 = static_cast<float>(h - 1);
  const int row_words = w / 4 * 3;
  uint32_t word[3] = {0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float x = (gx[k] + 1.0f) * 0.5f * wm1;
    float y = (gy[k] + 1.0f) * 0.5f * hm1;
    x = fminf(fmaxf(x, 0.0f), wm1);
    y = fminf(fmaxf(y, 0.0f), hm1);
    // The pair starts at most at W - 2: at x = W - 1 its second tap gets
    // weight exactly 1.
    const int x0 = min(static_cast<int>(floorf(x)), w - 2);
    const float fx = x - static_cast<float>(x0);
    const float y0f = floorf(y);
    const float fy = y - y0f;
    const int y0 = static_cast<int>(y0f);
    const int y1 = min(y0 + 1, h - 1);

    float v00[3], v01[3], v10[3], v11[3];
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
  uint32_t* dst = reinterpret_cast<uint32_t*>(out) + b * (frame_pix / 4 * 3)
                  + pix / 4 * 3;
  if constexpr (kStage & kNoStores) {
    // Never on these inputs: all twelve bytes would have to be 255.
    if ((word[0] & word[1] & word[2]) == 0xffffffffu) dst[0] = 0u;
  } else {
    dst[0] = word[0];
    dst[1] = word[1];
    dst[2] = word[2];
  }
}

template <int kStage>
int launch_packed(const void* frames, const void* grids, void* out, int b,
                  int h, int w, int c, int ho, int wo, void* stream) {
  if (c != 3 || w % 4 != 0 || wo % 4 != 0 || b > 65535 || ho > 65535 ||
      static_cast<long long>(h) * w * 3 > 0x7fffffffLL ||
      static_cast<long long>(ho) * wo * 3 > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(frames) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(grids) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((wo / 4 + kPackX - 1) / kPackX),
                  static_cast<unsigned>((ho + kPackY - 1) / kPackY),
                  static_cast<unsigned>(b));
  // The identity grid's steps, read only by the kNoGrid variants.
  const float step_x = 2.0f / static_cast<float>(wo > 1 ? wo - 1 : 1);
  const float step_y = 2.0f / static_cast<float>(ho > 1 ? ho - 1 : 1);
  warp_u8_batch_packed_kernel<kStage>
      <<<grid, dim3(kPackX, kPackY), 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(frames),
          static_cast<const float*>(grids), static_cast<uint8_t*>(out), h, w,
          ho, wo, step_x, step_y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher enqueues one kernel on ``stream`` and returns
// cudaGetLastError() (0 on a launch the device accepted). None allocates or
// synchronizes.

// The general-shape kernel.
extern "C" int dvsg_warp_u8_batch(const void* frames, const void* grids,
                                  void* out, int b, int h, int w, int c,
                                  int ho, int wo, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ho <= 0 || wo <= 0) return 0;
  return launch_general<kFull>(frames, grids, out, b, h, w, c, ho, wo,
                               stream);
}

// The packed kernel. Takes C = 3, W % 4 == 0, Wo % 4 == 0, an input and an
// output frame each under 2^31 bytes, B and Ho up to 65535, 4-byte aligned
// frames and out and 16-byte aligned grids; anything else is
// cudaErrorInvalidValue (the wrapper picks the kernel by shape and never
// sends such a call).
extern "C" int dvsg_warp_u8_batch_packed(const void* frames,
                                         const void* grids, void* out, int b,
                                         int h, int w, int c, int ho, int wo,
                                         void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ho <= 0 || wo <= 0) return 0;
  return launch_packed<kFull>(frames, grids, out, b, h, w, c, ho, wo,
                              stream);
}

// One stage variant (``stage`` is a sum of Stage values) of the packed
// kernel if ``packed`` else of the general one, for timing a kernel's
// parts; every variant writes ``out``, none but kFull is a warp.
extern "C" int dvsg_warp_u8_batch_probe(const void* frames, const void* grids,
                                        void* out, int b, int h, int w, int c,
                                        int ho, int wo, int stage, int packed,
                                        void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ho <= 0 || wo <= 0) return 0;
#define DVSG_STAGE(launch, k) \
  case k:                     \
    return launch<k>(frames, grids, out, b, h, w, c, ho, wo, stream)
  if (packed) {
    switch (stage) {
      DVSG_STAGE(launch_packed, kFull);
      DVSG_STAGE(launch_packed, kNoTaps);
      DVSG_STAGE(launch_packed, kNoGrid);
      DVSG_STAGE(launch_packed, kNoTaps | kNoGrid);
      DVSG_STAGE(launch_packed, kNoStores);
    }
  } else {
    switch (stage) {
      DVSG_STAGE(launch_general, kFull);
      DVSG_STAGE(launch_general, kIndex32);
    }
  }
#undef DVSG_STAGE
  return static_cast<int>(cudaErrorInvalidValue);
}
