// The bf16 trunk's rounding passes for Hopper (sm_90a): GELU's forward and
// its gradient, each one pass over device memory.
//
// Replaces no Pallas kernel. The reference writes jax.nn.gelu (tanh form)
// on bf16 arrays and takes its gradient by JAX's transposed JVP; XLA fuses
// each chain into one loop on the TPU and rounds every op's result to bf16
// in registers. The port's plain version (ops/bf16_round.py) spells the
// same chain out as PyTorch ops, one kernel and one trip through device
// memory per op: 9 kernels forward and 21 backward. These kernels do what
// XLA's fusion does, each chain in registers with every rounding where the
// chain rounds, in its order, byte-equal to the plain version on the card:
//
//   forward   x2 = x*x, p = x2*x, c = C*p, a = x+c, s = S*a, t = tanh(s),
//             u = 1+t, h = 0.5*u, y = x*h (f32, unrounded, with f32_out)
//   backward  g rounded to bf16 first; the gate again; xg = x*g,
//             xh = xg*0.5, m = 1-t, q = xh*m, qt = q*t, qq = q+qt,
//             ga = qq*S, gh = g*h, l = gh+ga, gc = ga*C, x3 = x2*3,
//             r = gc*x3, dx = l+r
//
// with C = 0.044715 and S = sqrt(2/pi) rounded to bf16 (the caller passes
// them). The plain version computes each op in f32 and rounds its result
// to bf16. Every operand of every op is a bf16 value, and f32 has more
// than 2 * 8 + 2 significant bits, so that double rounding equals the op
// rounded once to bf16 (Figueroa, "When is double rounding innocuous?",
// 1995): the kernels compute the chain with Hopper's bf16x2 instructions
// (mul.rn / add.rn / sub.rn.bf16x2, which nvcc does not contract into an
// FMA), two values an instruction. They leave bf16 only for tanh, which
// is tanhf on the f32 value rounded to bf16 (what ATen's CUDA tanh computes
// on a bf16 tensor; built without --use_fast_math, so tanhf is the
// accurate one), and for the f32_out product. Each op in f32 rounded by
// __float2bfloat16_rn instead (22 conversions an element backward) ran at
// 47 % (forward) and 31 % (backward) of the bound on an H100 at 192 x 32 x
// 256 x 256: the conversions bound it, not the bytes.
//
// Bound: memory. The forward reads x and writes y (4 bytes an element, 6
// with f32_out), the backward reads x and g and writes dx (6 bytes, 8 with
// an f32 g). Each thread moves 16 bytes of x (8 values) at a time in a
// grid-stride loop; a ragged end, or tensors that are not 16-byte
// aligned, go through a scalar loop.
//
// Inputs are dense on the device, x and g (and y / dx) with the same
// strides, so the kernels walk the storage as a flat array of n values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf2 = __nv_bfloat162;

constexpr int kThreads = 256;
constexpr int kVec = 8;           // bf16 values in 16 bytes
constexpr int kBlocksPerSm = 32;  // grid cap: resident blocks, then a stride

// The chain's constants, both halves alike.
struct Consts {
  bf2 cube, s2pi, half, one, three;
};

__device__ __forceinline__ Consts consts(float cube, float s2pi) {
  return {__float2bfloat162_rn(cube), __float2bfloat162_rn(s2pi),
          __float2bfloat162_rn(0.5f), __float2bfloat162_rn(1.0f),
          __float2bfloat162_rn(3.0f)};
}

// x2, t and h of the forward's chain, for two values.
struct Gate {
  bf2 x2, t, h;
};

__device__ __forceinline__ Gate gate(bf2 x, const Consts& k) {
  Gate r;
  r.x2 = __hmul2_rn(x, x);
  const bf2 p = __hmul2_rn(r.x2, x);
  const bf2 a = __hadd2_rn(x, __hmul2_rn(k.cube, p));
  const float2 s = __bfloat1622float2(__hmul2_rn(k.s2pi, a));
  r.t = __floats2bfloat162_rn(tanhf(s.x), tanhf(s.y));
  r.h = __hmul2_rn(k.half, __hadd2_rn(k.one, r.t));
  return r;
}

// The gradient at x for the cotangent g (bf16), for two values.
__device__ __forceinline__ bf2 gelu_grad2(bf2 x, bf2 g, const Consts& k) {
  const Gate e = gate(x, k);
  const bf2 xh = __hmul2_rn(__hmul2_rn(x, g), k.half);
  const bf2 q = __hmul2_rn(xh, __hsub2_rn(k.one, e.t));
  const bf2 ga = __hmul2_rn(__hadd2_rn(q, __hmul2_rn(q, e.t)), k.s2pi);
  const bf2 l = __hadd2_rn(__hmul2_rn(g, e.h), ga);
  const bf2 r = __hmul2_rn(__hmul2_rn(ga, k.cube), __hmul2_rn(e.x2, k.three));
  return __hadd2_rn(l, r);
}

// GELU of eight values into a bf16 or an f32 output.
__device__ __forceinline__ void gelu8(const bf2* x, const Consts& k,
                                      __nv_bfloat16* y, long long i) {
  uint4 v;
  bf2* o = reinterpret_cast<bf2*>(&v);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) o[j] = __hmul2_rn(x[j], gate(x[j], k).h);
  reinterpret_cast<uint4*>(y)[i] = v;
}

__device__ __forceinline__ void gelu8(const bf2* x, const Consts& k,
                                      float* y, long long i) {
  float f[kVec];
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 a = __bfloat1622float2(x[j]);
    const float2 h = __bfloat1622float2(gate(x[j], k).h);
    f[2 * j] = __fmul_rn(a.x, h.x);
    f[2 * j + 1] = __fmul_rn(a.y, h.y);
  }
  float4* o = reinterpret_cast<float4*>(y) + 2 * i;
  o[0] = make_float4(f[0], f[1], f[2], f[3]);
  o[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Eight values of the cotangent as bf16 pairs (an f32 one rounded).
__device__ __forceinline__ void load8(const __nv_bfloat16* g, long long i,
                                      bf2* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(g) + i);
  const bf2* p = reinterpret_cast<const bf2*>(&v);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) out[j] = p[j];
}

__device__ __forceinline__ void load8(const float* g, long long i, bf2* out) {
  const float4* p = reinterpret_cast<const float4*>(g) + 2 * i;
  const float4 a = __ldg(p), b = __ldg(p + 1);
  out[0] = __floats2bfloat162_rn(a.x, a.y);
  out[1] = __floats2bfloat162_rn(a.z, a.w);
  out[2] = __floats2bfloat162_rn(b.x, b.y);
  out[3] = __floats2bfloat162_rn(b.z, b.w);
}

// One value alone (the scalar loop), in both halves of a pair.
__device__ __forceinline__ bf2 pair(const __nv_bfloat16* p, long long i) {
  return __bfloat162bfloat162(p[i]);
}

__device__ __forceinline__ bf2 pair(const float* p, long long i) {
  return __float2bfloat162_rn(p[i]);
}

__device__ __forceinline__ void put(__nv_bfloat16* y, long long i, bf2 x,
                                    const Consts& k) {
  y[i] = __low2bfloat16(__hmul2_rn(x, gate(x, k).h));
}

__device__ __forceinline__ void put(float* y, long long i, bf2 x,
                                    const Consts& k) {
  y[i] = __fmul_rn(__low2float(x), __low2float(gate(x, k).h));
}

// y = gelu(x): `vecs` groups of 8 values, then values vecs*8 .. n-1 alone.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
    gelu_bf16_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                         Out* __restrict__ y, long long n, long long vecs,
                         float cube, float s2pi) {
  const Consts k = consts(cube, s2pi);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  for (long long i = first; i < vecs; i += stride) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + i);
    gelu8(reinterpret_cast<const bf2*>(&v), k, y, i);
  }
  for (long long i = vecs * kVec + first; i < n; i += stride) {
    put(y, i, pair(x, i), k);
  }
}

// dx = the gradient at x for the cotangent g (bf16, or f32 rounded first).
template <typename G>
__global__ void __launch_bounds__(kThreads)
    gelu_bf16_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const G* __restrict__ g,
                         __nv_bfloat16* __restrict__ dx, long long n,
                         long long vecs, float cube, float s2pi) {
  const Consts k = consts(cube, s2pi);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  for (long long i = first; i < vecs; i += stride) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const bf2* xs = reinterpret_cast<const bf2*>(&v);
    bf2 gs[kVec / 2];
    load8(g, i, gs);
    uint4 out;
    bf2* o = reinterpret_cast<bf2*>(&out);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) o[j] = gelu_grad2(xs[j], gs[j], k);
    reinterpret_cast<uint4*>(dx)[i] = out;
  }
  for (long long i = vecs * kVec + first; i < n; i += stride) {
    dx[i] = __low2bfloat16(gelu_grad2(pair(x, i), pair(g, i), k));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Blocks to launch, and in *vecs the groups of 8 the vector loop takes.
int plan(long long n, bool aligned, long long* vecs) {
  *vecs = aligned ? n / kVec : 0;
  const long long rest = n - *vecs * kVec;
  const long long work = *vecs > rest ? *vecs : rest;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

}  // namespace

// x bf16 (n values) -> y bf16, or f32 with f32_out.
extern "C" int dvsg_gelu_bf16_fwd(const void* x, void* y, long long n,
                                  int f32_out, float cube, float s2pi,
                                  void* stream) {
  if (n <= 0) return 0;
  long long vecs;
  const int blocks = plan(n, aligned16(x) && aligned16(y), &vecs);
  const auto* xin = static_cast<const __nv_bfloat16*>(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32_out) {
    gelu_bf16_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        xin, static_cast<float*>(y), n, vecs, cube, s2pi);
  } else {
    gelu_bf16_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        xin, static_cast<__nv_bfloat16*>(y), n, vecs, cube, s2pi);
  }
  return static_cast<int>(cudaGetLastError());
}

// x bf16, g bf16 or f32 (g_f32), n values each -> dx bf16.
extern "C" int dvsg_gelu_bf16_bwd(const void* x, const void* g, void* dx,
                                  long long n, int g_f32, float cube,
                                  float s2pi, void* stream) {
  if (n <= 0) return 0;
  long long vecs;
  const int blocks =
      plan(n, aligned16(x) && aligned16(g) && aligned16(dx), &vecs);
  const auto* xin = static_cast<const __nv_bfloat16*>(x);
  auto* out = static_cast<__nv_bfloat16*>(dx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_f32) {
    gelu_bf16_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        xin, static_cast<const float*>(g), out, n, vecs, cube, s2pi);
  } else {
    gelu_bf16_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        xin, static_cast<const __nv_bfloat16*>(g), out, n, vecs, cube, s2pi);
  }
  return static_cast<int>(cudaGetLastError());
}
