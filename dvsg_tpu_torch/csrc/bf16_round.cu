// The bf16 trunk's rounding passes for Hopper (sm_90a): GELU's forward and
// its gradient, each one pass over device memory; a bf16 conv's bias add
// with the GroupNorm after it, forward and backward, each one kernel that
// reads a (sample, group) once.
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
//
// The GroupNorm (after the GELU kernels below) computes, for x the bf16
// conv without its bias, NCHW, and c a value's channel:
//
//   forward   y = x + bf16(bias_c) in f32; mean and var = E[q^2] - mean^2
//             of q = bf16(y) over the (sample, group); out = bf16(
//             (y - mean) * (rstd * w_c) + beta_c), rstd = rsqrt(max(var, 0)
//             + eps), each op an f32 op rounded to nearest, in that order;
//   backward  for the bf16 cotangent G: dd = G * s_c (s_c = rstd * w_c),
//             dq = 2 (k1 q) + k0 with k1 = dvar / n, k0 = dmean / n from
//             the group's sums of G s_c and G (y - mean) w_c (dvar 0 where
//             var was clamped), dx = bf16(bf16(dq) + bf16(dd)); the conv
//             bias's gradient bf16(sum of dx), the weight's sum of
//             G (y - mean) rstd, the shift's sum of G.
//
// Every bf16 rounding is the plain chain's (bf16x2 adds where both
// operands are bf16 values, by the argument above); its f32 sums over a
// group or a channel are taken here in a fixed order instead, so two runs
// give the same bytes: the statistics in f64 from the first value on (a
// bf16 value's square is exact there, and the f32 statistics come out
// rounded once from nearly exact ones), the gradient's sums in f32 over
// the 8 values of a 16-byte load and f64 above. A (sample,
// group) is one thread-block cluster (up to 8 blocks, ~16 K values a
// block), each block owning whole "units" (up to ~1 K values of one
// channel, one warp each) and keeping them in shared memory, so x (and G)
// is read once: 4 bytes an element forward, 6 backward, as GELU's. The
// blocks exchange their sums through distributed shared memory; a group
// too large for the cache re-reads its values. The per-channel gradients
// across the batch come from per-unit partials, reduced by a second
// small kernel in a fixed order: no float atomics.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

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

// --- the conv bias add + GroupNorm -------------------------------------------

namespace {

namespace cg = cooperative_groups;

constexpr int kGnThreads = 512;
constexpr int kGnWarps = kGnThreads / 32;
constexpr long long kGnUnit = 1024;     // values a unit, about
constexpr long long kGnBlock = 16384;   // values a block, about
constexpr int kGnMaxCluster = 8;        // the portable cluster size
constexpr size_t kGnCache = 96 * 1024;  // shared memory a block may cache
constexpr int kGnSumThreads = 256;      // the per-channel sums' block

// How a (sample, group) is split: `units` units of at most `len` values,
// each inside one channel (`parts` a channel), over `cluster` blocks, each
// with consecutive units (at most `per_block`) and, with `cached`, a copy
// of their values in shared memory.
struct GnPlan {
  long long hw;       // values a channel
  long long len;      // values a unit (a channel's last may be shorter)
  long long slice;    // values a block's cache holds, per array
  int groups;         // groups a sample
  int cpg;            // channels a group
  int parts;          // units a channel
  int units;          // units a group
  int cluster;        // blocks a group
  int per_block;      // most units a block
  int vec;            // 16-byte loads (hw % 8 == 0, aligned pointers)
  int cached;         // each block keeps its values in shared memory
  size_t part_bytes;  // shared memory for the per-unit sums
  size_t smem;        // dynamic shared memory a block
};

// `arrays` bf16 arrays cached (x, and the cotangent backward), `sums`
// doubles a unit.
GnPlan gn_plan(long long c, long long hw, int groups, int arrays, int sums,
               bool aligned) {
  GnPlan p{};
  p.hw = hw;
  p.groups = groups;
  p.cpg = static_cast<int>(c / groups);
  const long long parts = hw >= 2 * kGnUnit ? hw / kGnUnit : 1;
  p.len = ((hw + parts - 1) / parts + kVec - 1) / kVec * kVec;
  p.parts = static_cast<int>((hw + p.len - 1) / p.len);
  p.units = p.cpg * p.parts;
  long long s = (static_cast<long long>(p.cpg) * hw + kGnBlock - 1) /
                kGnBlock;
  if (s > kGnMaxCluster) s = kGnMaxCluster;
  if (s > p.units) s = p.units;
  p.cluster = s < 1 ? 1 : static_cast<int>(s);
  p.per_block = (p.units + p.cluster - 1) / p.cluster;
  p.vec = aligned && hw % kVec == 0;
  p.slice = static_cast<long long>(p.per_block) * p.len;
  p.part_bytes =
      (static_cast<size_t>(p.per_block) * sums * sizeof(double) + 15) / 16 *
      16;
  const size_t cache =
      static_cast<size_t>(p.slice) * arrays * sizeof(__nv_bfloat16);
  p.cached = cache <= kGnCache;
  p.smem = p.part_bytes + (p.cached ? cache : 0);
  return p;
}

// A unit: its channel in the group, its first value's offset in the group,
// its length.
struct Unit {
  int c;
  long long start, n;
};

__device__ __forceinline__ Unit unit_of(const GnPlan& p, int u) {
  Unit r;
  r.c = u / p.parts;
  const long long lo = static_cast<long long>(u % p.parts) * p.len;
  r.start = static_cast<long long>(r.c) * p.hw + lo;
  r.n = (lo + p.len < p.hw ? lo + p.len : p.hw) - lo;
  return r;
}

// The first unit of cluster block `rank` (rank == cluster: the end).
__device__ __forceinline__ int first_unit(const GnPlan& p, int rank) {
  return static_cast<int>(static_cast<long long>(rank) * p.units /
                          p.cluster);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 1 / sqrt(max(var, 0) + eps): the clamp, then the f32 add, as the chain;
// the root and quotient correctly rounded. A NaN stays NaN.
__device__ __forceinline__ float gn_rstd(float var, float eps) {
  const float v = __fadd_rn(var < 0.0f ? 0.0f : var, eps);
  return static_cast<float>(1.0 / sqrt(static_cast<double>(v)));
}

// Lane 0's sum of the warp's values, in a fixed order.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Eight f32 values summed pairwise.
__device__ __forceinline__ float sum8(const float* v) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

// The cluster's sum of each block's two doubles `mine` (in shared memory,
// written before), block by block in rank order: the same bits in every
// block.
__device__ __forceinline__ void cluster_sum2(cg::cluster_group& cl,
                                             double* mine, int blocks,
                                             double* out) {
  double a = 0.0, b = 0.0;
  for (int r = 0; r < blocks; ++r) {
    const double* t = cl.map_shared_rank(mine, r);
    a += t[0];
    b += t[1];
  }
  out[0] = a;
  out[1] = b;
}

// Forward: one cluster of p.cluster blocks a (sample, group).
__global__ void __launch_bounds__(kGnThreads, 2)
    gn_bf16_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ bias,
                       const float* __restrict__ weight,
                       const float* __restrict__ beta,
                       __nv_bfloat16* __restrict__ y,
                       float* __restrict__ stats, GnPlan p, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double total[2];
  __shared__ float group_stat[2];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const long long grp = blockIdx.x / p.cluster;
  const long long off = grp * p.cpg * p.hw;
  const __nv_bfloat16* xg = x + off;
  __nv_bfloat16* yg = y + off;
  const int ch0 = static_cast<int>(grp % p.groups) * p.cpg;
  double* part = reinterpret_cast<double*>(smem);  // (sum q, sum q^2) a unit
  __nv_bfloat16* cache =
      reinterpret_cast<__nv_bfloat16*>(smem + p.part_bytes);
  const int first = first_unit(p, rank), last = first_unit(p, rank + 1);
  const long long base = unit_of(p, first).start;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The statistics' sums of q = bf16(x + bf16(bias)), a unit a warp.
  for (int u = first + warp; u < last; u += kGnWarps) {
    const Unit t = unit_of(p, u);
    const __nv_bfloat16 bb = __float2bfloat16_rn(bias[ch0 + t.c]);
    double s = 0.0, q = 0.0;
    if (p.vec) {
      const bf2 bb2 = __bfloat162bfloat162(bb);
      const uint4* src = reinterpret_cast<const uint4*>(xg + t.start);
      uint4* keep = reinterpret_cast<uint4*>(cache + (t.start - base));
      for (long long v = lane; v < t.n / kVec; v += 32) {
        const uint4 w = __ldg(src + v);
        if (p.cached) keep[v] = w;
        const bf2* h = reinterpret_cast<const bf2*>(&w);
        double a[kVec / 2], b[kVec / 2];
#pragma unroll
        for (int j = 0; j < kVec / 2; ++j) {
          const float2 f = __bfloat1622float2(__hadd2_rn(h[j], bb2));
          const double lo = f.x, hi = f.y;
          a[j] = lo + hi;
          b[j] = fma(lo, lo, hi * hi);
        }
        s += (a[0] + a[1]) + (a[2] + a[3]);
        q += (b[0] + b[1]) + (b[2] + b[3]);
      }
    } else {
      const float bbf = __bfloat162float(bb);
      for (long long i = lane; i < t.n; i += 32) {
        const __nv_bfloat16 w = xg[t.start + i];
        if (p.cached) cache[t.start - base + i] = w;
        const double f = round_bf16(__fadd_rn(__bfloat162float(w), bbf));
        s += f;
        q = fma(f, f, q);
      }
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      part[2 * (u - first)] = s;
      part[2 * (u - first) + 1] = q;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0, q = 0.0;
    for (int k = 0; k < last - first; ++k) {
      s += part[2 * k];
      q += part[2 * k + 1];
    }
    total[0] = s;
    total[1] = q;
  }
  cl.sync();
  if (threadIdx.x == 0) {
    double sums[2];
    cluster_sum2(cl, total, p.cluster, sums);
    const double n = static_cast<double>(p.cpg) * p.hw;
    const double mean = sums[0] / n;
    group_stat[0] = static_cast<float>(mean);
    group_stat[1] = static_cast<float>(sums[1] / n - mean * mean);
    if (rank == 0) {
      stats[2 * grp] = group_stat[0];
      stats[2 * grp + 1] = group_stat[1];
    }
  }
  cl.sync();  // the statistics in every thread; no block reads another's

  // The normalize of the unrounded y = x + bf16(bias), one rounding.
  const float mean = group_stat[0];
  const float rstd = gn_rstd(group_stat[1], eps);
  for (int u = first + warp; u < last; u += kGnWarps) {
    const Unit t = unit_of(p, u);
    const int ch = ch0 + t.c;
    const float bbf = round_bf16(bias[ch]);
    const float sc = __fmul_rn(rstd, weight[ch]);
    const float sh = beta[ch];
    if (p.vec) {
      const uint4* src = reinterpret_cast<const uint4*>(xg + t.start);
      const uint4* keep =
          reinterpret_cast<const uint4*>(cache + (t.start - base));
      uint4* dst = reinterpret_cast<uint4*>(yg + t.start);
      for (long long v = lane; v < t.n / kVec; v += 32) {
        const uint4 w = p.cached ? keep[v] : __ldg(src + v);
        const bf2* h = reinterpret_cast<const bf2*>(&w);
        uint4 out;
        bf2* o = reinterpret_cast<bf2*>(&out);
#pragma unroll
        for (int j = 0; j < kVec / 2; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          o[j] = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(f.x, bbf), mean), sc),
                        sh),
              __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(f.y, bbf), mean), sc),
                        sh));
        }
        dst[v] = out;
      }
    } else {
      for (long long i = lane; i < t.n; i += 32) {
        const __nv_bfloat16 w =
            p.cached ? cache[t.start - base + i] : xg[t.start + i];
        yg[t.start + i] = __float2bfloat16_rn(__fadd_rn(
            __fmul_rn(__fsub_rn(__fadd_rn(__bfloat162float(w), bbf), mean),
                      sc),
            sh));
      }
    }
  }
}

// Backward: one cluster a (sample, group), as the forward. Writes dx and,
// for each unit, (sum G, sum G (y - mean), sum dx) to `partial`.
__global__ void __launch_bounds__(kGnThreads, 2)
    gn_bf16_bwd_kernel(const __nv_bfloat16* __restrict__ g,
                       const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ stats,
                       const float* __restrict__ bias,
                       const float* __restrict__ weight,
                       __nv_bfloat16* __restrict__ dx,
                       double* __restrict__ partial, GnPlan p, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double total[2];
  __shared__ float coef[2];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const long long grp = blockIdx.x / p.cluster;
  const long long off = grp * p.cpg * p.hw;
  const __nv_bfloat16* xg = x + off;
  const __nv_bfloat16* gg = g + off;
  __nv_bfloat16* dxg = dx + off;
  const int ch0 = static_cast<int>(grp % p.groups) * p.cpg;
  double* part = reinterpret_cast<double*>(smem);  // 3 sums a unit
  __nv_bfloat16* xc = reinterpret_cast<__nv_bfloat16*>(smem + p.part_bytes);
  __nv_bfloat16* gc = xc + p.slice;
  const int first = first_unit(p, rank), last = first_unit(p, rank + 1);
  const long long base = unit_of(p, first).start;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float mean = stats[2 * grp], var = stats[2 * grp + 1];
  const float rstd = gn_rstd(var, eps);

  // The sums of G and of G (y - mean), a unit a warp.
  for (int u = first + warp; u < last; u += kGnWarps) {
    const Unit t = unit_of(p, u);
    const float bbf = round_bf16(bias[ch0 + t.c]);
    double a = 0.0, b = 0.0;
    if (p.vec) {
      const uint4* xs = reinterpret_cast<const uint4*>(xg + t.start);
      const uint4* gs = reinterpret_cast<const uint4*>(gg + t.start);
      uint4* xk = reinterpret_cast<uint4*>(xc + (t.start - base));
      uint4* gk = reinterpret_cast<uint4*>(gc + (t.start - base));
      for (long long v = lane; v < t.n / kVec; v += 32) {
        const uint4 xw = __ldg(xs + v), gw = __ldg(gs + v);
        if (p.cached) {
          xk[v] = xw;
          gk[v] = gw;
        }
        const bf2* xh = reinterpret_cast<const bf2*>(&xw);
        const bf2* gh = reinterpret_cast<const bf2*>(&gw);
        float av[kVec], bv[kVec];
#pragma unroll
        for (int j = 0; j < kVec / 2; ++j) {
          const float2 xf = __bfloat1622float2(xh[j]);
          const float2 gf = __bfloat1622float2(gh[j]);
          av[2 * j] = gf.x;
          av[2 * j + 1] = gf.y;
          bv[2 * j] = __fmul_rn(gf.x, __fsub_rn(__fadd_rn(xf.x, bbf), mean));
          bv[2 * j + 1] =
              __fmul_rn(gf.y, __fsub_rn(__fadd_rn(xf.y, bbf), mean));
        }
        a += sum8(av);
        b += sum8(bv);
      }
    } else {
      for (long long i = lane; i < t.n; i += 32) {
        const __nv_bfloat16 xw = xg[t.start + i], gw = gg[t.start + i];
        if (p.cached) {
          xc[t.start - base + i] = xw;
          gc[t.start - base + i] = gw;
        }
        const float gf = __bfloat162float(gw);
        a += gf;
        b += __fmul_rn(gf, __fsub_rn(__fadd_rn(__bfloat162float(xw), bbf),
                                     mean));
      }
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      part[3 * (u - first)] = a;
      part[3 * (u - first) + 1] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double dr = 0.0, dm = 0.0;  // sum G (y - mean) w_c, sum G s_c
    for (int k = 0; k < last - first; ++k) {
      const float w = weight[ch0 + unit_of(p, first + k).c];
      dr += part[3 * k + 1] * static_cast<double>(w);
      dm += part[3 * k] * static_cast<double>(__fmul_rn(rstd, w));
    }
    total[0] = dr;
    total[1] = dm;
  }
  cl.sync();
  if (threadIdx.x == 0) {
    double sums[2];
    cluster_sum2(cl, total, p.cluster, sums);
    const double n = static_cast<double>(p.cpg) * p.hw;
    const double r = rstd;
    // rsqrt's gradient; none where the clamp held var at 0.
    const double dvar = var < 0.0f ? 0.0 : -0.5 * sums[0] * (r * r * r);
    const double dmean = -sums[1] - 2.0 * static_cast<double>(mean) * dvar;
    coef[0] = static_cast<float>(dvar / n);
    coef[1] = static_cast<float>(dmean / n);
  }
  cl.sync();

  // dx = bf16(bf16(2 (k1 q) + k0) + bf16(G s_c)), and its sums.
  const float k1 = coef[0], k0 = coef[1];
  for (int u = first + warp; u < last; u += kGnWarps) {
    const Unit t = unit_of(p, u);
    const int ch = ch0 + t.c;
    const __nv_bfloat16 bb = __float2bfloat16_rn(bias[ch]);
    const float sc = __fmul_rn(rstd, weight[ch]);
    double d = 0.0;
    if (p.vec) {
      const bf2 bb2 = __bfloat162bfloat162(bb);
      const uint4* xs = reinterpret_cast<const uint4*>(xg + t.start);
      const uint4* gs = reinterpret_cast<const uint4*>(gg + t.start);
      const uint4* xk = reinterpret_cast<const uint4*>(xc + (t.start - base));
      const uint4* gk = reinterpret_cast<const uint4*>(gc + (t.start - base));
      uint4* dst = reinterpret_cast<uint4*>(dxg + t.start);
      for (long long v = lane; v < t.n / kVec; v += 32) {
        const uint4 xw = p.cached ? xk[v] : __ldg(xs + v);
        const uint4 gw = p.cached ? gk[v] : __ldg(gs + v);
        const bf2* xh = reinterpret_cast<const bf2*>(&xw);
        const bf2* gh = reinterpret_cast<const bf2*>(&gw);
        uint4 out;
        bf2* o = reinterpret_cast<bf2*>(&out);
        float sv[kVec];
#pragma unroll
        for (int j = 0; j < kVec / 2; ++j) {
          const float2 q = __bfloat1622float2(__hadd2_rn(xh[j], bb2));
          const float2 gf = __bfloat1622float2(gh[j]);
          const float t0 = __fmul_rn(k1, q.x), t1 = __fmul_rn(k1, q.y);
          const bf2 dq = __floats2bfloat162_rn(
              __fadd_rn(__fadd_rn(t0, t0), k0),
              __fadd_rn(__fadd_rn(t1, t1), k0));
          const bf2 dd =
              __floats2bfloat162_rn(__fmul_rn(gf.x, sc), __fmul_rn(gf.y, sc));
          o[j] = __hadd2_rn(dq, dd);
          const float2 of = __bfloat1622float2(o[j]);
          sv[2 * j] = of.x;
          sv[2 * j + 1] = of.y;
        }
        dst[v] = out;
        d += sum8(sv);
      }
    } else {
      const float bbf = __bfloat162float(bb);
      for (long long i = lane; i < t.n; i += 32) {
        const __nv_bfloat16 xw =
            p.cached ? xc[t.start - base + i] : xg[t.start + i];
        const __nv_bfloat16 gw =
            p.cached ? gc[t.start - base + i] : gg[t.start + i];
        const float q = round_bf16(__fadd_rn(__bfloat162float(xw), bbf));
        const float t0 = __fmul_rn(k1, q);
        const float o = round_bf16(
            __fadd_rn(round_bf16(__fadd_rn(__fadd_rn(t0, t0), k0)),
                      round_bf16(__fmul_rn(__bfloat162float(gw), sc))));
        dxg[t.start + i] = __float2bfloat16_rn(o);
        d += o;
      }
    }
    d = warp_sum(d);
    if (lane == 0) part[3 * (u - first) + 2] = d;
  }
  __syncthreads();
  double* out = partial + (grp * p.units + first) * 3;
  for (int k = threadIdx.x; k < 3 * (last - first); k += kGnThreads) {
    out[k] = part[k];
  }
}

// The per-channel gradients, a block a channel: over the batch (strided
// over the threads, then a fixed tree) and the channel's units in order.
__global__ void __launch_bounds__(kGnSumThreads)
    gn_bf16_params_kernel(const double* __restrict__ partial,
                          const float* __restrict__ stats,
                          float* __restrict__ dbias,
                          float* __restrict__ dweight,
                          float* __restrict__ dbeta, long long batch,
                          GnPlan p, float eps) {
  __shared__ double red[3][kGnSumThreads / 32];
  const int ch = blockIdx.x;
  const int group = ch / p.cpg, c = ch % p.cpg;
  double a = 0.0, b = 0.0, d = 0.0;
  for (long long s = threadIdx.x; s < batch; s += kGnSumThreads) {
    const long long grp = s * p.groups + group;
    const double r = gn_rstd(stats[2 * grp + 1], eps);
    const double* q =
        partial + (grp * p.units + static_cast<long long>(c) * p.parts) * 3;
    double ua = 0.0, ub = 0.0, ud = 0.0;
    for (int k = 0; k < p.parts; ++k) {
      ua += q[3 * k];
      ub += q[3 * k + 1];
      ud += q[3 * k + 2];
    }
    a += ua;
    b += ub * r;
    d += ud;
  }
  a = warp_sum(a);
  b = warp_sum(b);
  d = warp_sum(d);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
    red[2][warp] = d;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kGnSumThreads / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
      d += red[2][w];
    }
    dbeta[ch] = static_cast<float>(a);
    dweight[ch] = static_cast<float>(b);
    dbias[ch] = __bfloat162float(__double2bfloat16(d));
  }
}

constexpr int kGnMaxDevices = 64;

// Launch `kernel` over `clusters` clusters of p.cluster blocks. A launch
// past 48 KB of dynamic shared memory raises the kernel's limit on its
// device first, only where it is below the launch's (a driver call):
// `allowed` is the limit set so far, one array for each kernel (the
// instantiations differ by the kernel's parameters), raised under a lock.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), const GnPlan& p,
                    long long clusters, cudaStream_t s, Args... args) {
  static std::atomic<size_t> allowed[kGnMaxDevices];
  static std::mutex raising;
  if (p.smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kGnMaxDevices || allowed[dev].load() < p.smem) {
      std::lock_guard<std::mutex> hold(raising);
      if (dev >= kGnMaxDevices || allowed[dev].load() < p.smem) {
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(p.smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        if (dev < kGnMaxDevices) allowed[dev].store(p.smem);
      }
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * p.cluster));
  cfg.blockDim = dim3(kGnThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

}  // namespace

// Units a (sample, group) of `c` channels of `hw` values in `groups`
// groups: the backward's partial sums hold 3 doubles a unit.
extern "C" int dvsg_group_norm_bf16_units(long long c, long long hw,
                                          int groups) {
  return gn_plan(c, hw, groups, 2, 3, true).units;
}

// x bf16 (batch, c, hw) dense, bias / weight / beta f32 (c) -> y bf16 like
// x, stats f32 (batch, groups, 2): mean and var before the clamp.
extern "C" int dvsg_group_norm_bf16_fwd(const void* x, const void* bias,
                                        const void* weight, const void* beta,
                                        void* y, void* stats, long long batch,
                                        long long c, long long hw, int groups,
                                        float eps, void* stream) {
  if (batch <= 0 || c <= 0 || hw <= 0) return 0;
  const GnPlan p = gn_plan(c, hw, groups, 1, 2, aligned16(x) && aligned16(y));
  return launch_clusters(
      gn_bf16_fwd_kernel, p, batch * groups, static_cast<cudaStream_t>(stream),
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(bias),
      static_cast<const float*>(weight), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(stats), p, eps);
}

// g bf16 like x, x, the forward's stats, bias and weight -> dx bf16 like x,
// dbias / dweight / dbeta f32 (c); `partial` holds batch * groups * units
// * 3 doubles.
extern "C" int dvsg_group_norm_bf16_bwd(
    const void* g, const void* x, const void* stats, const void* bias,
    const void* weight, void* dx, void* partial, void* dbias, void* dweight,
    void* dbeta, long long batch, long long c, long long hw, int groups,
    float eps, void* stream) {
  if (batch <= 0 || c <= 0 || hw <= 0) return 0;
  const GnPlan p = gn_plan(c, hw, groups, 2, 3,
                           aligned16(g) && aligned16(x) && aligned16(dx));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_clusters(
      gn_bf16_bwd_kernel, p, batch * groups, s,
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(bias), static_cast<const float*>(weight),
      static_cast<__nv_bfloat16*>(dx), static_cast<double*>(partial), p, eps);
  if (rc != 0) return rc;
  gn_bf16_params_kernel<<<static_cast<unsigned>(c), kGnSumThreads, 0, s>>>(
      static_cast<const double*>(partial), static_cast<const float*>(stats),
      static_cast<float*>(dbias), static_cast<float*>(dweight),
      static_cast<float*>(dbeta), batch, p, eps);
  return static_cast<int>(cudaGetLastError());
}
