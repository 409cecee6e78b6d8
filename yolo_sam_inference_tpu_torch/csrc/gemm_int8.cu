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
// Three kernels; four launches per tail (ln_quant, MLP1, gelu_quant, MLP2)
// and two for K11c (ln_quant, QKV) and for int8_linear (ln_quant without the
// LN, QKV or GELU):
//   1. ln_quant_kernel: one warp per row: LN statistics (two passes), the LN
//      values, the row amax, the int8 row and its scale (the LN never goes to
//      device memory); with null LN pointers the rows are quantised as they
//      come. Up to C 1280 the row waits in registers and is read once;
//   2. gemm_int8_kernel<QKV | GELU | MLP1 | MLP2>: the int8 GEMM. QKV
//      dequantises and adds the bias (bf16 out); GELU then rounds to bf16 and
//      applies the exact-erf GELU in fp32 (bf16 out). MLP1 stores the
//      dequantised fp32 hidden before its GELU. MLP2 folds the int32
//      accumulator into an fp32 sum at every chunk boundary, scaled by that
//      chunk's row scale, and adds the residual y in its epilogue;
//   3. gelu_quant_kernel: one warp per (row, chunk) of the hidden: the GELU,
//      the chunk's row amax, the int8 values and their scale. The GELU's erf
//      costs more than the product it follows at these widths, so it runs
//      here, on every warp of the card, and not in MLP1's epilogue, where
//      one warpgroup an SM would have to hide it under the other's products.
//
// What bounds it on the H100: the products are compute bound (at batch 32,
// 32768 rows x K = 1024..5120 is about 1000 int8 operations per byte), so
// the int8 tensor-core rate (1979 TOP/s, twice bf16's) is the limit, and
// only wgmma reaches it. The first design issued mma.sync.m16n8k32 from a
// cp.async ring: 2.8597 ms for K11b's tail at ViT-H, slower than the bf16
// tail on wgmma (2.0561), on an H100 80GB HBM3 at 700 W.
//
// This design is gemm_bf16.cu's with the int8 operands:
//   * one producer warp keeps a ring of 4 k-tiles of 128 bytes (A 128 rows,
//     the transposed weight (N, K) BN rows) in flight with TMA (128-byte
//     swizzle, rows and k past the matrix zero-filled), each stage guarded
//     by a full and an empty mbarrier;
//   * two consumer warpgroups take the block's tiles in turn (ping-pong,
//     handing over through turn[]): each multiplies a whole 128 x BN tile with
//     two wgmma m64nBNk32 s8 x s8 -> s32 per 32-byte k-step, A and B both
//     K-major (the s8 form has no transpose), straight from the swizzled
//     tiles, while the other runs its epilogue; the grid is persistent;
//   * MLP2 keeps an fp32 chunk sum in registers beside its int32
//     accumulators, so there the two warpgroups share each 128 x 128 tile
//     (64 rows each, one wgmma m64n128k32 per k-step; cooperative, no
//     ping-pong; 128 x 64 tiles in ping-pong, which halve the products per
//     byte of shared memory read, measured slower: PERF.md). Its residual
//     tiles come into shared memory by cp.async while the products run;
//   * the epilogue dequantises on the accumulators; bf16 results are staged
//     in shared memory and stored with 16-byte coalesced accesses (MLP2 adds
//     the residual there); MLP1 stores its fp32 hidden from the registers (a
//     quad writes a whole 32-byte sector).
// What it keeps for simplicity: the fp32 hidden of the tail goes through
// device memory (4 bytes a value, written once, read once, then read again
// as int8), so the tail moves about 10 bytes per hidden value; the TPU kernel
// keeps it in VMEM.
//
// Requirements (the wrappers check them; the C entry points return
// cudaErrorInvalidValue otherwise): K a multiple of 16 (TMA's 16-byte row
// strides), N of 8; MLP2's chunk a multiple of 128 (the k-tile) dividing K,
// gelu_quant's a multiple of 8 dividing N. M is free; the pointers are
// 16-byte aligned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace {

enum Mode { QKV = 0, MLP1 = 1, MLP2 = 2, GELU = 3 };

constexpr int BM = 128, BK = 128, STAGES = 4;  // BK in int8 elements (bytes)
constexpr int CONSUMERS = 2;                   // warpgroups, alternate tiles
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp

template <int MODE>
struct Tile {
  static constexpr int BN = 128;
  // MLP2 keeps an fp32 chunk sum beside its int32 accumulators, so its two
  // warpgroups share each block tile (64 rows each, "cooperative"); the other
  // modes give each warpgroup whole tiles in turn ("ping-pong")
  static constexpr bool COOP = MODE == MLP2;
  static constexpr int HALVES = COOP ? 1 : 2;  // 64-row halves a warpgroup multiplies
  static constexpr int A_STAGE = BM * BK, B_STAGE = BN * BK;  // bytes
  static constexpr int LDC = BN + 8;  // bf16 row stride of the staged C (and residual) tiles
  // the staged C tile; MLP2: its residual tiles x and h, the output written
  // over x's
  static constexpr size_t C_BYTES =
      MODE == MLP1 ? 0 : (size_t)CONSUMERS * (COOP ? 2 : 1) * HALVES * 64 * LDC * 2;
  static constexpr size_t WS_BYTES = COOP ? CONSUMERS * BN * 4 : 0;  // MLP2: the tile's w_scale
  static constexpr size_t SMEM = 1024 /* alignment slack */ + STAGES * (A_STAGE + B_STAGE) +
                                 C_BYTES + WS_BYTES + (2 * STAGES + 2) * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "shared memory");
};

struct Args {
  const float* a_scale;      // (M,) row scales; MLP2: (M, K / chunk)
  const float* w_scale;      // (N,) column scales
  const float* bias;         // (N,)
  const __nv_bfloat16* r1;   // MLP2: residual x (M, N)
  const __nv_bfloat16* r2;   // MLP2: residual h (M, N) or null
  void* out;                 // bf16 (M, N); MLP1: fp32 (M, N)
  int m, n, k;
  int chunk;                 // MLP2: the hidden chunk along K
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
// ln_s and ln_b, xq = quant(x (+ h)). With CH > 0 (C <= 256 CH) a lane holds
// its CH 8-value chunks of the row in registers, so the row is read once and
// each LN value computed once. With CH = 0 (wider rows: no LN on the paths)
// each pass reads the row again, from L1. Either way a lane sums its values
// in the same order, so the statistics are the same bits.
template <int CH>
__global__ void __launch_bounds__(256)
    ln_quant_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                    const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                    int8_t* __restrict__ xq, float* __restrict__ xs, int m, int c, float eps) {
  const int lane = threadIdx.x % 32;
  const bool ln = ln_s != nullptr;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (row >= m) return;
  const long base = (long)row * c;
  if constexpr (CH > 0) {
    float y[CH][8];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((i * 32 + lane) * 8 < c) load_y8(x, h, base + (i * 32 + lane) * 8, y[i]);
    if (ln) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if ((i * 32 + lane) * 8 < c) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s += y[i][e];
        }
      const float mean = __fdiv_rn(warp_sum(s), (float)c);
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if ((i * 32 + lane) * 8 < c) {
#pragma unroll
          for (int e = 0; e < 8; ++e) q += (y[i][e] - mean) * (y[i][e] - mean);
        }
      const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)c), eps));
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if ((i * 32 + lane) * 8 < c) {  // the LN values in the activation dtype (bf16)
          float l[8];
          ln8(y[i], mean, rstd, ln_s, ln_b, (i * 32 + lane) * 8, l);
#pragma unroll
          for (int e = 0; e < 8; ++e) y[i][e] = l[e];
        }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((i * 32 + lane) * 8 < c) {
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(y[i][e]));
      }
    const float scale = quant_scale(warp_max(amax));
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((i * 32 + lane) * 8 < c) {
        uint2 packed;
        int8_t* e8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; ++e) e8[e] = (int8_t)quant(y[i][e], scale);
        *reinterpret_cast<uint2*>(xq + base + (i * 32 + lane) * 8) = packed;
      }
    if (lane == 0) xs[row] = scale;
  } else {
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
}

// One warp per (row, chunk) of the fp32 hidden v (MLP1's dequantised product
// + bias): h = GELU(v), s = quant_scale(max |h| over the chunk), hq =
// quant(h, s), hs[row, chunk] = s. With CH > 0 (chunk <= 256 CH) a lane holds
// its CH 8-value groups of the chunk in registers; with CH = 0 it reads them
// twice, from L1.
template <int CH>
__global__ void __launch_bounds__(256)
    gelu_quant_kernel(const float* __restrict__ hf, int8_t* __restrict__ hq,
                      float* __restrict__ hs, int m, int n, int chunk) {
  const int nch = n / chunk;
  const long unit = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (unit >= (long)m * nch) return;
  const long base = unit / nch * n + unit % nch * chunk;  // the chunk's first value
  auto gelu8 = [&](int j, float v[8]) {
    const float4 a = *reinterpret_cast<const float4*>(hf + base + j);
    const float4 b = *reinterpret_cast<const float4*>(hf + base + j + 4);
    const float u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu(u[e]);
  };
  auto store8 = [&](int j, const float v[8], float scale) {
    uint2 packed;
    int8_t* e8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) e8[e] = (int8_t)quant(v[e], scale);
    *reinterpret_cast<uint2*>(hq + base + j) = packed;
  };
  float amax = 0.f;
  if constexpr (CH > 0) {
    float v[CH][8];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((i * 32 + lane) * 8 < chunk) {
        gelu8((i * 32 + lane) * 8, v[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[i][e]));
      }
    const float scale = quant_scale(warp_max(amax));
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((i * 32 + lane) * 8 < chunk) store8((i * 32 + lane) * 8, v[i], scale);
    if (lane == 0) hs[unit] = scale;
  } else {
    float v[8];
    for (int j = lane * 8; j < chunk; j += 256) {
      gelu8(j, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    const float scale = quant_scale(warp_max(amax));
    for (int j = lane * 8; j < chunk; j += 256) {
      gelu8(j, v);
      store8(j, v, scale);
    }
    if (lane == 0) hs[unit] = scale;
  }
}

// Ping-pong: consumer warpgroup wg of a block takes the block's tiles wg,
// wg + 2, ... (tiles row-major over (M / BM, N / BN)), as in gemm_bf16.cu.
// Cooperative (MLP2): both take every tile of the block, warpgroup wg its
// rows 64 wg..64 wg + 63. A thread holds rows r0 + 64 h + 16 warp + g (+ 8)
// and columns 8 j + 2 tl (+ 1) of the tile.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_int8_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, Args p) {
  using T = Tile<MODE>;
  constexpr int BN = T::BN, NA = BN / 2, H = T::HALVES;  // NA: accumulators a 64-row half
  constexpr bool COOP = T::COOP;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + STAGES * T::A_STAGE;
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(Bs + STAGES * T::B_STAGE);
  float* Ws = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Cs) + T::C_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(Ws) + T::WS_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;  // turn[w]: the other warpgroup has issued its products

  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = (p.m + BM - 1) / BM * tiles_n;
  const int nk = (p.k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], COOP ? 8 : 4);  // one arrive per warp that reads the stage
    }
    mbar_init(&turn[0], 128);
    mbar_init(&turn[1], 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer warp: one thread issues every copy
    if (threadIdx.x % 32 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the consumers have released it
          mbar_expect_tx(&full[stage], T::A_STAGE + T::B_STAGE);
          tma_load(As + stage * T::A_STAGE, &map_a, &full[stage], kt * BK, m0);
          tma_load(Bs + stage * T::B_STAGE, &map_b, &full[stage], kt * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups (see gemm_bf16.cu for the turn[] handover)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tl = lane % 4;
  const int r0 = COOP ? 64 * wg : 0;                // this warpgroup's first row of a tile
  // this warpgroup's C tile (MLP2: its residual x's, then h's)
  __nv_bfloat16* cw = Cs + wg * (COOP ? 2 : 1) * H * 64 * T::LDC;
  float* wsw = Ws + wg * BN;  // MLP2: this tile's column scales
  int acc[H][NA];
  constexpr int SN = MODE == MLP2 ? NA : 1;
  float sum[H][SN];  // MLP2: the fp32 sum over chunks
  const int kpc = MODE == MLP2 ? p.chunk / BK : 1;  // k-tiles per chunk
  // row (h, hr) of this thread in the tile: r0 + 64 h + 16 warp + g + 8 hr
  auto tile_row = [&](int h, int hr) { return r0 + 64 * h + 16 * warp + g + 8 * hr; };
  int local = 0;       // this block's tiles so far
  uint32_t turns = 0;  // handovers this warpgroup has waited for
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
    if (!COOP && local % CONSUMERS != wg) continue;
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[h][i] = 0;
    if constexpr (MODE == MLP2) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * tl;
        const float b0 = col < p.n ? __ldg(p.bias + col) : 0.f;
        const float b1 = col < p.n ? __ldg(p.bias + col + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          sum[h][4 * j] = sum[h][4 * j + 2] = b0;
          sum[h][4 * j + 1] = sum[h][4 * j + 3] = b1;
        }
      }
    }
    if constexpr (MODE == MLP2) {
      // the epilogue's residual rows into shared memory while the products
      // run (the C tile was freed at the end of the last tile); zeros outside
      for (int v = tid; v < 64 * BN / 8; v += 128) {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        const int row = m0 + r0 + r, col = n0 + c;
        const bool in = row < p.m && col < p.n;
        const long idx = in ? (long)row * p.n + col : 0;
        cp_async16(cw + r * T::LDC + c, p.r1 + idx, in);
        if (p.r2) cp_async16(cw + (64 + r) * T::LDC + c, p.r2 + idx, in);
      }
      cp_async_commit();
      wsw[tid] = n0 + tid < p.n ? __ldg(p.w_scale + n0 + tid) : 0.f;  // BN == 128 threads
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    if (!COOP && local > 0) mbar_wait(&turn[wg], turns++ & 1);
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = local * nk + kt;  // the ring's k-tile count: stage and phase
      const int stage = slot % STAGES;
      mbar_wait(&full[stage], (slot / STAGES) & 1);
      const int8_t* at = As + stage * T::A_STAGE + r0 * BK;
      const int8_t* bt = Bs + stage * T::B_STAGE;
#pragma unroll
      for (int h = 0; h < H; ++h) fence_acc(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BK / 32; ++s) {
        // 8-row groups 1024 bytes apart, k-step s 32 bytes into the swizzled row
        const uint64_t db = smem_desc(bt + s * 32, 16, 1024);
#pragma unroll
        for (int h = 0; h < H; ++h)
          wgmma_s8<BN>(acc[h], smem_desc(at + h * 64 * BK + s * 32, 16, 1024), db, 1);
      }
      wgmma_commit();
      if (MODE == MLP2 && (kt + 1) % kpc == 0) {
        // a chunk ends: sum += acc * (s[row, chunk] * w_scale[col]); acc = 0.
        // The rows' scales are read before the products are waited for.
        float sa[H][2];  // this thread's rows' scales of the chunk
        if constexpr (MODE == MLP2) {
          const int nch = p.k / p.chunk, ci = (kt + 1) / kpc - 1;
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = m0 + tile_row(h, hr);
              sa[h][hr] = row < p.m ? __ldg(p.a_scale + (long)row * nch + ci) : 0.f;
            }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < H; ++h) fence_acc(acc[h]);
        if constexpr (MODE == MLP2) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float w0 = wsw[j * 8 + 2 * tl], w1 = wsw[j * 8 + 2 * tl + 1];
#pragma unroll
            for (int h = 0; h < H; ++h)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int e = 4 * j + 2 * hr;
                sum[h][e] = __fadd_rn(sum[h][e], __fmul_rn(__int2float_rn(acc[h][e]),
                                                           __fmul_rn(sa[h][hr], w0)));
                sum[h][e + 1] = __fadd_rn(sum[h][e + 1], __fmul_rn(__int2float_rn(acc[h][e + 1]),
                                                                   __fmul_rn(sa[h][hr], w1)));
                acc[h][e] = acc[h][e + 1] = 0;
              }
          }
        }
      } else {
        wgmma_wait<1>();  // the previous k-tile's products are done: release its stage
#pragma unroll
        for (int h = 0; h < H; ++h) fence_acc(acc[h]);
      }
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
    }
    if (!COOP) mbar_arrive(&turn[wg ^ 1]);  // every thread: the other warpgroup's turn
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_acc(acc[h]);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // dequant + bias on the accumulators, with this thread's rows' scales and
    // each column pair's scales and biases read once
    float sa[H][2] = {};
    if constexpr (MODE != MLP2) {
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + tile_row(h, hr);
          sa[h][hr] = row < p.m ? __ldg(p.a_scale + row) : 0.f;
        }
    }
    if constexpr (MODE == MLP1) {
      // the fp32 hidden straight from the registers (a quad writes a 32-byte sector)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * tl;
        if (col >= p.n) continue;  // N % 8 == 0: col + 1 is in range too
        const float w0 = __ldg(p.w_scale + col), w1 = __ldg(p.w_scale + col + 1);
        const float b0 = __ldg(p.bias + col), b1 = __ldg(p.bias + col + 1);
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = m0 + tile_row(h, hr), e = 4 * j + 2 * hr;
            if (row < p.m)
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) + (long)row * p.n + col) =
                  make_float2(dequant(acc[h][e], sa[h][hr], w0, b0),
                              dequant(acc[h][e + 1], sa[h][hr], w1, b1));
          }
      }
      continue;
    }

    // the bf16 result into the C tile (GELU: of the rounded value; MLP2: y +
    // the rounded fp32 sum, over the residual x, y = x (+ h) rounded to bf16)
    if constexpr (MODE == MLP2) {
      cp_async_wait<0>();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // every copy has landed
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = j * 8 + 2 * tl, col = n0 + cl;
      float w0 = 0.f, w1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (MODE != MLP2 && col < p.n) {  // N % 8 == 0: col + 1 is in range too
        w0 = __ldg(p.w_scale + col);
        w1 = __ldg(p.w_scale + col + 1);
        b0 = __ldg(p.bias + col);
        b1 = __ldg(p.bias + col + 1);
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int rl = tile_row(h, hr) - r0, e = 4 * j + 2 * hr;
          float v0, v1;
          if constexpr (MODE == MLP2) {
            const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(cw + rl * T::LDC + cl);
            float y0 = __low2float(x2), y1 = __high2float(x2);
            if (p.r2) {
              const __nv_bfloat162 h2 =
                  *reinterpret_cast<const __nv_bfloat162*>(cw + (64 + rl) * T::LDC + cl);
              y0 = round_bf16(__fadd_rn(y0, __low2float(h2)));
              y1 = round_bf16(__fadd_rn(y1, __high2float(h2)));
            }
            v0 = __fadd_rn(y0, round_bf16(sum[h][e]));
            v1 = __fadd_rn(y1, round_bf16(sum[h][e + 1]));
          } else {  // rows and columns outside the matrix are masked at the store
            v0 = dequant(acc[h][e], sa[h][hr], w0, b0);
            v1 = dequant(acc[h][e + 1], sa[h][hr], w1, b1);
            if constexpr (MODE == GELU) {
              v0 = gelu(round_bf16(v0));
              v1 = gelu(round_bf16(v1));
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(cw + rl * T::LDC + cl) = __floats2bfloat162_rn(v0, v1);
        }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the C tile is written

    // store, 16 bytes per thread
    for (int v = tid; v < H * 64 * BN / 8; v += 128) {
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const int row = m0 + r0 + r, col = n0 + c;
      if (row < p.m && col < p.n)
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + (long)row * p.n + col) =
            *reinterpret_cast<const uint4*>(cw + r * T::LDC + c);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the C tile is free
  }
}

template <int MODE>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gemm_int8_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Tile<MODE>::SMEM);
}

int num_sms = 0;

template <int MODE>
int launch(const void* a, const void* bt, const Args& p, cudaStream_t st) {
  using T = Tile<MODE>;
  CUtensorMap map_a, map_b;
  cudaError_t err = make_map_s8(&map_a, a, p.m, p.k, BM);
  if (err == cudaSuccess) err = make_map_s8(&map_b, bt, p.n, p.k, T::BN);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.m + BM - 1) / BM * ((p.n + T::BN - 1) / T::BN);
  gemm_int8_kernel<MODE><<<tiles < num_sms ? tiles : num_sms, THREADS, T::SMEM, st>>>(map_a,
                                                                                     map_b, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once, when the library is loaded: the tensor-map encoder, the SM
// count for the persistent grid, and the shared memory above the 48 KB default.
extern "C" int ysi_gemm_int8_init(void) {
  cudaError_t err = load_encode_tiled();
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem<QKV>();
  if (err == cudaSuccess) err = allow_smem<MLP1>();
  if (err == cudaSuccess) err = allow_smem<MLP2>();
  if (err == cudaSuccess) err = allow_smem<GELU>();
  return (int)err;
}

extern "C" int ysi_ln_quant(const void* x, const void* h, const void* ln_s, const void* ln_b,
                            void* xq, void* xs, int m, int c, float eps, void* stream) {
  if (m <= 0 || c <= 0 || c % 8 || (ln_s == nullptr) != (ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* x16 = static_cast<const __nv_bfloat16*>(x);
  const auto* h16 = static_cast<const __nv_bfloat16*>(h);
  const auto* sp = static_cast<const float*>(ln_s);
  const auto* bp = static_cast<const float*>(ln_b);
  auto* q = static_cast<int8_t*>(xq);
  auto* sc = static_cast<float*>(xs);
  const int blocks = (m + 7) / 8;  // a warp per row
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 768)
    ln_quant_kernel<3><<<blocks, 256, 0, st>>>(x16, h16, sp, bp, q, sc, m, c, eps);
  else if (c <= 1024)
    ln_quant_kernel<4><<<blocks, 256, 0, st>>>(x16, h16, sp, bp, q, sc, m, c, eps);
  else if (c <= 1280)
    ln_quant_kernel<5><<<blocks, 256, 0, st>>>(x16, h16, sp, bp, q, sc, m, c, eps);
  else
    ln_quant_kernel<0><<<blocks, 256, 0, st>>>(x16, h16, sp, bp, q, sc, m, c, eps);
  return (int)cudaGetLastError();
}

// hf: the fp32 (M, N) hidden before its GELU; hq, hs: its int8 form and the
// (M, N / chunk) scales.
extern "C" int ysi_gelu_quant(const void* hf, void* hq, void* hs, int m, int n, int chunk,
                              void* stream) {
  if (m <= 0 || n <= 0 || chunk <= 0 || chunk % 8 || n % chunk) return (int)cudaErrorInvalidValue;
  const auto* f = static_cast<const float*>(hf);
  auto* q = static_cast<int8_t*>(hq);
  auto* sc = static_cast<float*>(hs);
  const long units = (long)m * (n / chunk);
  const unsigned blocks = (unsigned)((units + 7) / 8);  // a warp per (row, chunk)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk <= 768)
    gelu_quant_kernel<3><<<blocks, 256, 0, st>>>(f, q, sc, m, n, chunk);
  else if (chunk <= 1024)
    gelu_quant_kernel<4><<<blocks, 256, 0, st>>>(f, q, sc, m, n, chunk);
  else if (chunk <= 1280)
    gelu_quant_kernel<5><<<blocks, 256, 0, st>>>(f, q, sc, m, n, chunk);
  else if (chunk <= 1536)
    gelu_quant_kernel<6><<<blocks, 256, 0, st>>>(f, q, sc, m, n, chunk);
  else
    gelu_quant_kernel<0><<<blocks, 256, 0, st>>>(f, q, sc, m, n, chunk);
  return (int)cudaGetLastError();
}

// a: (M, K) int8 rows; bt: the int8 weight transposed, (N, K) row-major.
extern "C" int ysi_gemm_int8(int mode, const void* a, const void* bt, const void* a_scale,
                             const void* w_scale, const void* bias, const void* r1, const void* r2,
                             void* out, int m, int n, int k, int chunk, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 8) return (int)cudaErrorInvalidValue;
  if (mode == MLP2 && (chunk <= 0 || chunk % BK || k % chunk || r1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.a_scale = static_cast<const float*>(a_scale);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.r1 = static_cast<const __nv_bfloat16*>(r1);
  p.r2 = static_cast<const __nv_bfloat16*>(r2);
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == QKV) return launch<QKV>(a, bt, p, st);
  if (mode == MLP1) return launch<MLP1>(a, bt, p, st);
  if (mode == MLP2) return launch<MLP2>(a, bt, p, st);
  if (mode == GELU) return launch<GELU>(a, bt, p, st);
  return (int)cudaErrorInvalidValue;
}
