// w8a8 products of the SAM encoder on the int8 tensor cores (Hopper, sm_90a):
// int8 activations x int8 weights, int32 accumulation, fp32 dequantisation.
//
// Replaces (yolo_sam_inference_tpu/ops/fused_ln.py):
//   * fused_ln_matmul_int8 (:711, K11c): LN1 + dynamic row quantisation +
//     the int8 qkv projection;
//   * int8_linear (ops/quant.py:66, the flat route's qkv, mlp1 and mlp2 through
//     apply_linear; not a pallas_call there): dynamic row quantisation of the
//     rows as they come, the int8 product, and for mlp1 the GELU of the
//     bf16-rounded product (the JAX flat route's _gelu after apply_linear);
//   * fused_ln_mlp_int8 (:438, K11a) and fused_ln_mlp_tiled_int8 (:549, K11b):
//     the w8a8 block tail y = x + h; y + mlp2(GELU(mlp1(LN2(y)))) with the
//     hidden dimension in chunks, each chunk requantised with its own row
//     scale. The two differ only in the chunk count (the Python wrapper's
//     int8_tail_chunks), which is part of the function, not of the tiling.
//
// What they compute, as the TPU kernels do (fused_ln.py:27-34, :377-420,
// :694-707):
//   * LN: fp32 row statistics; t = bf16((y - mean) * rstd), then
//     bf16(bf16(t * scale) + bias), scale and bias rounded to bf16;
//   * row quantisation: s = amax / 127 (1 when amax is 0),
//     q = clip(round_half_even(v / s), -127, 127), with an IEEE division;
//   * dequantisation: acc * (s_row * s_col) + bias, in fp32, each product and
//     sum rounded once (no fused multiply-add, so the plain version's
//     integers and scales are reproduced);
//   * tail: per chunk c, h_c = GELU(dequant(xq @ w1q[:, c]) + b1[c]) in fp32
//     (exact erf, erff; the TPU kernels use a rational erf), requantised per
//     (row, chunk); out = b2 + sum_c dequant_c(hq_c @ w2q[c, :]), summed in
//     fp32 in chunk order; result bf16(y + bf16(out)).
//
// Three kernels; four launches per tail (ln_quant, MLP1, quant_chunks,
// MLP2) and two for K11c (ln_quant, QKV) and for int8_linear (ln_quant
// without the LN, QKV or GELU):
//   1. ln_quant_kernel: one warp per row: LN statistics (two passes), the LN
//      values, the row amax, the int8 row and its scale (the LN never goes to
//      device memory); with null LN pointers the rows are quantised as they
//      come;
//   2. gemm_int8_kernel<QKV | GELU | MLP1 | MLP2>: a tiled int8 GEMM on
//      mma.sync.m16n8k32 (s8 x s8 -> s32). QKV dequantises and adds the bias
//      (bf16 out); GELU then rounds to bf16 and applies the exact-erf GELU in
//      fp32 (bf16 out). MLP1 also applies GELU, stores the fp32 hidden and takes
//      each row's |h| maximum per chunk (shared-memory then global atomics on
//      the float bits; |h| >= 0 orders like an int). MLP2 folds the int32
//      accumulator into an fp32 sum at every chunk boundary, scaled by that
//      chunk's row scale, and adds the residual y in its epilogue;
//   3. quant_chunks_kernel: requantises the fp32 hidden per (row, chunk).
//
// What bounds it on the H100: the products are compute bound (at batch 32,
// 32768 rows x K = 1024..5120 is about 1000 int8 operations per byte), so
// the int8 tensor-core rate is the limit; the int8 operands halve the bytes
// and double the rate of the bf16 products. The design takes the bf16 GEMM's
// tiling (128 x 128 block tiles, 8 warps of 64 x 32, a 4-stage cp.async ring
// of 64-byte k-tiles in padded, ldmatrix-conflict-free shared memory) with
// the int8 fragment layout, which in bytes is the bf16 m16n8k16 layout: A
// and the transposed weight (N, K), made once per weight, both load with
// plain ldmatrix. What it gives up for simplicity: the fp32 hidden of the
// tail goes through device memory (4 bytes a value, written once, read once,
// then read again as int8), so the tail moves about 10 bytes per hidden
// value; the TPU kernel keeps it in VMEM. No wgmma or TMA yet.
//
// Requirements (the wrappers check them; the C entry points return
// cudaErrorInvalidValue otherwise): K a multiple of 16, N of 8; MLP1's chunk
// a multiple of 128 (a block's columns lie in one chunk) dividing N; MLP2's
// chunk a multiple of 64 (the k-tile) dividing K. M is free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // BK in int8 elements (bytes)
constexpr int STAGES = 4;
constexpr int THREADS = 256;                     // 8 warps: 2 along M x 4 along N
constexpr int WARP_M = 64, WARP_N = 32;
constexpr int FM = WARP_M / 16, FN = WARP_N / 8;  // m16 x n8 accumulator fragments
constexpr int LDS = BK + 16;                     // 80-byte rows: ldmatrix conflict-free
constexpr int TILE = BM * LDS;                   // bytes per operand per stage (BM == BN)
constexpr int CHUNKS = BM * BK / 16 / THREADS;   // 16-byte copies per thread per operand
constexpr size_t SMEM = 2 * STAGES * TILE;
static_assert(BM == BN, "A and the transposed weight share the tile geometry");

enum Mode { QKV = 0, MLP1 = 1, MLP2 = 2, GELU = 3 };

struct Args {
  const int8_t* a;           // (M, K) row-major int8 activations
  const int8_t* bt;          // (N, K) row-major: the int8 weight, transposed
  const float* a_scale;      // (M,) row scales; MLP2: (M, K / chunk)
  const float* w_scale;      // (N,) column scales
  const float* bias;         // (N,)
  const __nv_bfloat16* r1;   // MLP2: residual x (M, N)
  const __nv_bfloat16* r2;   // MLP2: residual h (M, N) or null
  void* out;                 // bf16 (M, N); MLP1: fp32 (M, N)
  float* amax;               // MLP1: (M, N / chunk) per-chunk row max of |out|, zeroed
  int m, n, k;
  int chunk;                 // MLP1: along N; MLP2: along K
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float quant_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

__device__ __forceinline__ int quant(float v, float scale) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

__device__ __forceinline__ float gelu(float v) {  // v * 0.5 * (1 + erf(v / sqrt(2)))
  return __fmul_rn(__fmul_rn(v, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(v, 0.70710678118654752f))));
}

__device__ __forceinline__ float dequant(int acc, float sa, float sw, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sa, sw)), b);
}

__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulation. In bytes the
// fragments are those of m16n8k16 bf16 (mma_frag.cuh): a[0] = (g, 4t..4t+3),
// a[1] = (g+8, 4t..), a[2] = (g, 16+4t..), a[3] = (g+8, 16+4t..);
// b0 = (k 4t..4t+3, n g), b1 = (k 16+4t.., n g); d as the fp32 C fragment.
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const int8_t* p) {
  ldmatrix_x4(r, reinterpret_cast<const __nv_bfloat16*>(p));  // 8 rows x 16 bytes each
}

// Eight values of y = x (+ h, rounded to bf16 like the stored residual sum).
__device__ __forceinline__ void load_y8(const __nv_bfloat16* x, const __nv_bfloat16* h, long idx,
                                        float v[8]) {
  const uint4 rx = *reinterpret_cast<const uint4*>(x + idx);
  const __nv_bfloat16* ex = reinterpret_cast<const __nv_bfloat16*>(&rx);
  if (h) {
    const uint4 rh = *reinterpret_cast<const uint4*>(h + idx);
    const __nv_bfloat16* eh = reinterpret_cast<const __nv_bfloat16*>(&rh);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(__fadd_rn(__bfloat162float(ex[i]), __bfloat162float(eh[i])));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(ex[i]);
  }
}

// The LN values of eight columns from col, in the activation dtype (bf16).
__device__ __forceinline__ void ln8(const float y[8], float mean, float rstd, const float* s,
                                    const float* b, int col, float l[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float t = round_bf16(__fmul_rn(__fsub_rn(y[i], mean), rstd));
    const float u = round_bf16(__fmul_rn(t, round_bf16(s[col + i])));
    l[i] = round_bf16(__fadd_rn(u, round_bf16(b[col + i])));
  }
}

// One warp per row: xq = quant(LN(x (+ h))), xs = the row scale; with null
// ln_s and ln_b, xq = quant(x (+ h)).
__global__ void __launch_bounds__(256)
    ln_quant_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                    const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                    int8_t* __restrict__ xq, float* __restrict__ xs, int m, int c, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const long base = (long)row * c;
  const bool ln = ln_s != nullptr;
  float y[8], l[8];
  float mean = 0.f, rstd = 1.f;
  if (ln) {
    float s = 0.f;
    for (int j = lane * 8; j < c; j += 256) {
      load_y8(x, h, base + j, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += y[i];
    }
    mean = __fdiv_rn(warp_sum(s), (float)c);
    float q = 0.f;
    for (int j = lane * 8; j < c; j += 256) {
      load_y8(x, h, base + j, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) q += (y[i] - mean) * (y[i] - mean);
    }
    rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)c), eps));
  }
  // the values to quantise, eight columns from j
  auto values = [&](int j) {
    load_y8(x, h, base + j, y);
    if (ln) {
      ln8(y, mean, rstd, ln_s, ln_b, j, l);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) l[i] = y[i];
    }
  };
  float amax = 0.f;
  for (int j = lane * 8; j < c; j += 256) {  // the row is in L1 from here on
    values(j);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(l[i]));
  }
  const float scale = quant_scale(warp_max(amax));
  for (int j = lane * 8; j < c; j += 256) {
    values(j);
    uint2 packed;
    int8_t* e = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = (int8_t)quant(l[i], scale);
    *reinterpret_cast<uint2*>(xq + base + j) = packed;
  }
  if (lane == 0) xs[row] = scale;
}

// One thread per 16 values of the fp32 hidden: hq = quant(hf, s[row, chunk]);
// the thread at a chunk's first column writes s.
__global__ void __launch_bounds__(256)
    quant_chunks_kernel(const float* __restrict__ hf, const float* __restrict__ amax,
                        int8_t* __restrict__ hq, float* __restrict__ hs, int m, int n, int chunk) {
  const int per_row = n / 16;
  const long v = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (long)m * per_row) return;
  const int row = (int)(v / per_row), col = (int)(v % per_row) * 16;
  const int nch = n / chunk, ci = col / chunk;
  const float scale = quant_scale(amax[(long)row * nch + ci]);
  if (col % chunk == 0) hs[(long)row * nch + ci] = scale;
  const float4* src = reinterpret_cast<const float4*>(hf + (long)row * n + col);
  uint4 packed;
  int8_t* e = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = src[i];
    e[4 * i] = (int8_t)quant(f.x, scale);
    e[4 * i + 1] = (int8_t)quant(f.y, scale);
    e[4 * i + 2] = (int8_t)quant(f.z, scale);
    e[4 * i + 3] = (int8_t)quant(f.w, scale);
  }
  *reinterpret_cast<uint4*>(hq + (long)row * n + col) = packed;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, MODE == MLP2 ? 1 : 2) gemm_int8_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + STAGES * TILE;
  __shared__ float row_amax[BM];  // MLP1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / 4) * WARP_M, wn = (warp % 4) * WARP_N;
  const int nk = (p.k + BK - 1) / BK;
  if constexpr (MODE == MLP1) {
    for (int r = tid; r < BM; r += THREADS) row_amax[r] = 0.f;
  }  // made visible by the main loop's first barrier

  auto issue = [&](int kt) {
    const int stage = kt % STAGES, k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BK / 16), c = (v % (BK / 16)) * 16;
      const bool kin = k0 + c < p.k;  // K % 16 == 0: the whole 16 bytes are in range
      const bool oka = kin && m0 + r < p.m;
      const bool okb = kin && n0 + r < p.n;
      cp_async16(As + stage * TILE + r * LDS + c, p.a + (oka ? (long)(m0 + r) * p.k + k0 + c : 0),
                 oka);
      cp_async16(Bs + stage * TILE + r * LDS + c, p.bt + (okb ? (long)(n0 + r) * p.k + k0 + c : 0),
                 okb);
    }
  };

  int acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // MLP2: the fp32 sum over chunks, from the bias on
  constexpr int SM = MODE == MLP2 ? FM : 1, SN = MODE == MLP2 ? FN : 1;
  float sum[SM][SN][4];
  if constexpr (MODE == MLP2) {
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      const float b0 = col < p.n ? p.bias[col] : 0.f, b1 = col < p.n ? p.bias[col + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < SM; ++i) {
        sum[i][j][0] = sum[i][j][2] = b0;
        sum[i][j][1] = sum[i][j][3] = b1;
      }
    }
  }

  auto mma_tile = [&](int kt) {
    const int stage = kt % STAGES;
    const int8_t* at = As + stage * TILE;
    const int8_t* bt = Bs + stage * TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[FM][4], bf[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldsm_x4(af[i], at + (wm + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 16);
#pragma unroll
      for (int jp = 0; jp < FN / 2; ++jp) {
        uint32_t r[4];  // n-tiles 2jp, 2jp + 1; k bytes 0-15 and 16-31 of the step
        ldsm_x4(r, bt + (wn + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk +
                       ((lane >> 3) & 1) * 16);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  };

  // MLP2: sum += acc * (s[row, chunk] * w_scale[col]); acc = 0
  auto fold = [&](int ci) {
    const int nch = p.k / p.chunk;
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      const float w0 = col < p.n ? p.w_scale[col] : 0.f, w1 = col < p.n ? p.w_scale[col + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < SM; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + wm + i * 16 + g + hr * 8;
          const float sa = row < p.m ? p.a_scale[(long)row * nch + ci] : 0.f;
          sum[i][j][2 * hr] = __fadd_rn(sum[i][j][2 * hr],
                                        __fmul_rn(__int2float_rn(acc[i][j][2 * hr]), __fmul_rn(sa, w0)));
          sum[i][j][2 * hr + 1] = __fadd_rn(
              sum[i][j][2 * hr + 1], __fmul_rn(__int2float_rn(acc[i][j][2 * hr + 1]), __fmul_rn(sa, w1)));
          acc[i][j][2 * hr] = acc[i][j][2 * hr + 1] = 0;
        }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  const int kpc = MODE == MLP2 ? p.chunk / BK : 1;  // k-tiles per chunk
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();              // everyone's have; tile kt - 1 is fully consumed
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
    cp_async_commit();
    mma_tile(kt);
    if constexpr (MODE == MLP2) {
      if ((kt + 1) % kpc == 0) fold((kt + 1) / kpc - 1);
    }
  }
  cp_async_wait<0>();

  // epilogue, straight from the fragments: each lane owns column pairs
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rl = wm + i * 16 + g + hr * 8, row = m0 + rl;
      const bool rin = row < p.m;
      const float sa = (MODE != MLP2 && rin) ? p.a_scale[row] : 0.f;
      float rmax = 0.f;
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int col = n0 + wn + j * 8 + 2 * t;
        if (!rin || col >= p.n) continue;  // N % 8 == 0: col + 1 is in range too
        const long idx = (long)row * p.n + col;
        if constexpr (MODE == MLP2) {
          float y0 = __bfloat162float(p.r1[idx]), y1 = __bfloat162float(p.r1[idx + 1]);
          if (p.r2) {
            y0 = round_bf16(__fadd_rn(y0, __bfloat162float(p.r2[idx])));
            y1 = round_bf16(__fadd_rn(y1, __bfloat162float(p.r2[idx + 1])));
          }
          const float o0 = __fadd_rn(y0, round_bf16(sum[i][j][2 * hr]));
          const float o1 = __fadd_rn(y1, round_bf16(sum[i][j][2 * hr + 1]));
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + idx) =
              __floats2bfloat162_rn(o0, o1);
        } else {
          float v0 = dequant(acc[i][j][2 * hr], sa, p.w_scale[col], p.bias[col]);
          float v1 = dequant(acc[i][j][2 * hr + 1], sa, p.w_scale[col + 1], p.bias[col + 1]);
          if constexpr (MODE == GELU) {
            v0 = gelu(round_bf16(v0));
            v1 = gelu(round_bf16(v1));
          }
          if constexpr (MODE == QKV || MODE == GELU) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + idx) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            v0 = gelu(v0);
            v1 = gelu(v1);
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) = make_float2(v0, v1);
            rmax = fmaxf(rmax, fmaxf(fabsf(v0), fabsf(v1)));
          }
        }
      }
      if constexpr (MODE == MLP1) {  // the quad holds the row's 32 columns of this warp
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        if (t == 0 && rin) atomic_max_nonneg(&row_amax[rl], rmax);
      }
    }
  if constexpr (MODE == MLP1) {
    __syncthreads();
    const int nch = p.n / p.chunk, ci = n0 / p.chunk;  // chunk % BN == 0: one chunk per block
    for (int r = tid; r < BM; r += THREADS)
      if (m0 + r < p.m && row_amax[r] > 0.f)
        atomic_max_nonneg(&p.amax[(long)(m0 + r) * nch + ci], row_amax[r]);
  }
}

template <int MODE>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gemm_int8_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM);
}

}  // namespace

// Called once, when the library is loaded: the ring is above the 48 KB default.
extern "C" int ysi_gemm_int8_init(void) {
  cudaError_t err = allow_smem<QKV>();
  if (err == cudaSuccess) err = allow_smem<MLP1>();
  if (err == cudaSuccess) err = allow_smem<MLP2>();
  if (err == cudaSuccess) err = allow_smem<GELU>();
  return (int)err;
}

extern "C" int ysi_ln_quant(const void* x, const void* h, const void* ln_s, const void* ln_b,
                            void* xq, void* xs, int m, int c, float eps, void* stream) {
  if (m <= 0 || c <= 0 || c % 8 || (ln_s == nullptr) != (ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  ln_quant_kernel<<<(m + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(h),
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), m, c, eps);
  return (int)cudaGetLastError();
}

extern "C" int ysi_quant_chunks(const void* hf, const void* amax, void* hq, void* hs, int m, int n,
                                int chunk, void* stream) {
  if (m <= 0 || n <= 0 || chunk <= 0 || chunk % 16 || n % chunk) return (int)cudaErrorInvalidValue;
  const long threads = (long)m * (n / 16);
  quant_chunks_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hf), static_cast<const float*>(amax), static_cast<int8_t*>(hq),
      static_cast<float*>(hs), m, n, chunk);
  return (int)cudaGetLastError();
}

extern "C" int ysi_gemm_int8(int mode, const void* a, const void* bt, const void* a_scale,
                             const void* w_scale, const void* bias, const void* r1, const void* r2,
                             void* out, void* amax, int m, int n, int k, int chunk, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 8) return (int)cudaErrorInvalidValue;
  if (mode == MLP1 && (chunk <= 0 || chunk % BN || n % chunk || amax == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == MLP2 && (chunk <= 0 || chunk % BK || k % chunk || r1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.a = static_cast<const int8_t*>(a);
  p.bt = static_cast<const int8_t*>(bt);
  p.a_scale = static_cast<const float*>(a_scale);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.r1 = static_cast<const __nv_bfloat16*>(r1);
  p.r2 = static_cast<const __nv_bfloat16*>(r2);
  p.out = out;
  p.amax = static_cast<float*>(amax);
  p.m = m;
  p.n = n;
  p.k = k;
  p.chunk = chunk;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == QKV) gemm_int8_kernel<QKV><<<grid, THREADS, SMEM, st>>>(p);
  else if (mode == MLP1) gemm_int8_kernel<MLP1><<<grid, THREADS, SMEM, st>>>(p);
  else if (mode == MLP2) gemm_int8_kernel<MLP2><<<grid, THREADS, SMEM, st>>>(p);
  else if (mode == GELU) gemm_int8_kernel<GELU><<<grid, THREADS, SMEM, st>>>(p);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
