// Row LayerNorm over the last axis, with an optional residual add (Hopper,
// sm_90a): kernel K5, and its residual form for K11d's call sites.
//
//   x (rows, C) bf16, scale and bias (C) fp32;
//   plain:    out = LN(x)
//   residual: y = bf16(x + r) is stored, and out = LN(y) of the rounded y,
//             as the JAX package's fused_add_ln normalises its stored sum;
// with fp32 statistics: the mean, then the centred variance of the values
// held in registers, rstd = rsqrt(var + eps).
//
// Replaces yolo_sam_inference_tpu/ops/fused_ln.py:761 fused_ln (the neck's
// and the decoder's LayerNorms, the mask head's up_ln) and :56
// fused_add_ln (the flat encoder route's residual LayerNorms).
//
// What bounds it on the H100: each element is read once (twice with the
// residual) and written once (twice), against about 8 flop: memory bound
// at every shape, 0.0100 ms at 32768 x 256 and 0.0758 at the mask head's
// 991232 x 64. The design: a group of L lanes per row, L = C / 8 up to a
// whole warp, so every lane moves 16-byte vectors (8 lanes a row at C 64,
// four rows a warp; a warp a row at C 256; V vectors a lane above C 256),
// several rows a 256-thread block, the row held in registers between the
// statistics and the output (every load of a lane issued before any
// arithmetic, x and r as streaming loads), the group's sums by shuffles.
// It replaces a Triton kernel of one row per program (a one-warp program
// at C 64, two bf16 a lane), and its launch is a ctypes call: less host
// time a call than Triton's launcher, on cells whose card is idle most of
// the time.
//
// Supported: the widths of the ported paths, C 64 (the mask head's up_ln),
// 256 (the SAM and TinyViT necks, the decoder), 768 (ViT-B's flat route),
// 1024 and 1280 (ViT-L's and ViT-H's flat routes), one instantiation each;
// any other C returns cudaErrorInvalidValue (the Python wrapper raises
// before that).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void unpack8(const uint4& raw, float v[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(v[i]);
  return raw;
}

// sum over the L aligned lanes of a row group
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// L = C / 8 lanes a row up to a warp, V 16-byte vectors a lane (vector
// i * L + lane of the row)
template <int C>
__global__ void __launch_bounds__(THREADS)
    layer_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
                      __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ out,
                      const float* __restrict__ scale, const float* __restrict__ bias, int rows,
                      float eps) {
  constexpr int L = C / 8 < 32 ? C / 8 : 32;
  constexpr int V = C / 8 / L;
  static_assert(C % 8 == 0 && L * V * 8 == C, "C is 8 times L times V");
  const int lane = threadIdx.x % L;
  const long row = ((long)blockIdx.x * THREADS + threadIdx.x) / L;
  const bool live = row < rows;  // no early exit: the whole warp takes part in the shuffles
  const long base = row * C;
  // every load of the lane first (x, and r), then the arithmetic
  uint4 xr[V], rr[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vec = i * L + lane;
    if (live) {
      xr[i] = __ldcs(reinterpret_cast<const uint4*>(x + base + vec * 8));
      if (r != nullptr) rr[i] = __ldcs(reinterpret_cast<const uint4*>(r + base + vec * 8));
    }
  }
  float v[V][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vec = i * L + lane;
    if (live) {
      unpack8(xr[i], v[i]);
      if (r != nullptr) {
        float w[8];
        unpack8(rr[i], w);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] += w[e];
        const uint4 sumv = pack8(v[i]);  // the stored sum, and the LN of its rounded value
        *reinterpret_cast<uint4*>(y + base + vec * 8) = sumv;
        unpack8(sumv, v[i]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
  }
  const float mean = group_sum<L>(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (live) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  const float rstd = rsqrtf(group_sum<L>(sq) / C + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vec = i * L + lane;
    if (live) {
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(scale) + 2 * vec);
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(scale) + 2 * vec + 1);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias) + 2 * vec);
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias) + 2 * vec + 1);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = fmaf((v[i][e] - mean) * rstd, gv[e], bv[e]);
      *reinterpret_cast<uint4*>(out + base + vec * 8) = pack8(o);
    }
  }
}

template <int C>
int launch(const void* x, const void* r, void* y, void* out, const void* scale, const void* bias,
           int rows, float eps, cudaStream_t st) {
  constexpr int L = C / 8 < 32 ? C / 8 : 32;
  const long threads = (long)rows * L;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  layer_norm_kernel<C><<<blocks, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(out),
      static_cast<const float*>(scale), static_cast<const float*>(bias), rows, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// r and y are null for the plain form; with r, y receives x + r in bf16.
extern "C" int ysi_layer_norm(const void* x, const void* r, void* y, void* out,
                              const void* scale, const void* bias, int rows, int c, float eps,
                              void* stream) {
  if (rows <= 0 || (r != nullptr && y == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 64: return launch<64>(x, r, y, out, scale, bias, rows, eps, st);
    case 256: return launch<256>(x, r, y, out, scale, bias, rows, eps, st);
    case 768: return launch<768>(x, r, y, out, scale, bias, rows, eps, st);
    case 1024: return launch<1024>(x, r, y, out, scale, bias, rows, eps, st);
    case 1280: return launch<1280>(x, r, y, out, scale, bias, rows, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
