// The tap and rounding tail shared by the packed uint8 warp kernels
// (warp_u8_offsets.cu and warp_u8_batch.cu), for C = 3 frames whose rows
// are a whole number of 32-bit words (W % 4 == 0).
//
// A pixel's two horizontally adjacent RGB taps are six contiguous bytes:
// they are fetched as the two or three aligned words that cover them and
// shifted into place. A row is a whole number of words, so the pair one row
// down starts at the same byte of its word and shares the shift. A caller
// starts the pair at most at W - 2 (with weight exactly 1 on the second tap
// at x = W - 1), so a pair never leaves its row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Two horizontally adjacent RGB taps: six bytes that start ``shift`` / 8
// bytes into the aligned 32-bit word at ``p``.
__device__ __forceinline__ void load_tap_pair(
    const uint32_t* __restrict__ p, unsigned shift, float (&v0)[3],
    float (&v1)[3]) {
  const uint32_t w0 = __ldg(p);
  const uint32_t w1 = __ldg(p + 1);
  // Six bytes reach the third word only when they start at its byte 3.
  const uint32_t w2 = shift == 24 ? __ldg(p + 2) : 0u;
  const uint32_t lo = __funnelshift_r(w0, w1, shift);   // bytes 0..3
  const uint32_t hi = __funnelshift_r(w1, w2, shift);   // bytes 4..7
  v0[0] = static_cast<float>(lo & 0xffu);
  v0[1] = static_cast<float>((lo >> 8) & 0xffu);
  v0[2] = static_cast<float>((lo >> 16) & 0xffu);
  v1[0] = static_cast<float>(lo >> 24);
  v1[1] = static_cast<float>(hi & 0xffu);
  v1[2] = static_cast<float>((hi >> 8) & 0xffu);
}

// Round half to even and saturate to 0..255 in one instruction.
__device__ __forceinline__ uint32_t round_u8(float acc) {
  uint32_t q;
  asm("cvt.rni.sat.u8.f32 %0, %1;" : "=r"(q) : "f"(acc));
  return q;
}

}  // namespace
