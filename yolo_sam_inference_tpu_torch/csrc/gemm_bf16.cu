// bf16 GEMM for Hopper (sm_90a) on TMA and wgmma, with an optional LayerNorm
// of its A operand and a bias / exact-erf GELU / residual epilogue.
//
//   out[m, n] = epilogue( sum_k A'[m, k] * W[k, n] )
//   A'        = LN(A (+ A2))   when ln_scale is given, else A (+ A2)
//   epilogue  = + bias[n], then GELU (erff) if gelu, then + R1 (+ R2)
//
// A, A2, R1, R2, out: row-major bf16 (rows, features); W: row-major bf16
// (K, N), the JAX package's (in, out) layout; bias, ln_scale, ln_bias: fp32;
// scratch: bf16 (M, K), written with A' when ln_scale or A2 is given. Every
// pointer but A, W and out may be null (scratch must be given with ln_scale
// or A2).
//
// Replaces (yolo_sam_inference_tpu/ops/fused_ln.py):
//   * fused_ln_matmul (:645)  LN1 + qkv projection: LN + bias;
//   * fused_ln_mlp (:202)     LN2 over y = x + h + mlp1 + bias + GELU, then a
//                             second launch mlp2 + bias + residual y = x + h;
//   * fused_ln_mlp_tiled (:302) the same function at the ViT-L/H widths;
//   * the output projection fused into flash_attention_grid
//     (ops/flash_attention.py:608): bias only.
// The TPU kernels keep the (rows, 3072) MLP hidden in VMEM; here it passes
// through device memory between the two launches (B*1024 x 3072 bf16, about
// 200 MB at batch 32). Keeping it on chip is later work.
//
// What bounds it on the H100: at the encoder's shapes (M = B*1024 rows,
// K = 768 to 5120) the products do about 500 flop per byte they must move,
// so the tensor cores are the limit (989 TFLOP/s dense bf16), and only wgmma
// reaches their rate. The first design issued mma.sync from a cp.async ring
// and normalised each A tile in place in shared memory once per block along
// N (18 times per row at qkv, 24 at mlp1): it was 0.9431 ms for K1 at ViT-B
// (bf16 torch.addmm of the bare product: 0.2136), 2.3332 for K4 (0.4823),
// 5.9052 for K10 at ViT-H (1.1698), on an H100 80GB HBM3 at 700 W.
//
// This design:
//   * one producer warp keeps a ring of STAGES k-tiles (A 128 x 64, W 64 x
//     128) in flight with TMA (128-byte swizzle, out-of-bounds rows and
//     columns zero-filled), each stage guarded by a full and an empty
//     mbarrier;
//   * two consumer warpgroups take the block's 128 x 128 tiles in turn
//     ("ping-pong"): each multiplies a whole tile with two wgmma m64n128k16
//     per k-step (bf16 in, fp32 accumulation), A K-major and W read as it
//     lies, N-major (wgmma's transpose flag for B), both straight from the
//     swizzled tiles, while the other runs its epilogue; a turn barrier
//     starts one's products only after the other has issued its own;
//   * the grid is persistent (one block per SM, tiles strided over it), so
//     the producer loads the next tile while the current one finishes;
//   * the epilogue adds the bias and applies the GELU on the accumulators,
//     stages the bf16 tile in shared memory, then adds the residuals and
//     stores with 16-byte coalesced accesses, rows and columns masked.
// Two alternatives measured slower at the encoder's shapes on the H100, in
// turns within one call: a 128 x 256 tile shared by both warpgroups
// (m64n256k16, the epilogue exposed) by 1.03-1.37x (bench/gemm_shapes.py),
// and an epilogue stored straight from the registers, which freed the C
// tiles' shared memory for 6 ring stages, by 1.3-1.95x (it spilled;
// bench/kernel_turns.py). What still bounds this one:
// a fixed cost per tile, which the products at K = 768 do not hide (the
// bare product runs at about 380-400 TFLOP/s there, 500-630 at K = 3072 and
// 5120); PERF.md holds the numbers.
//
// LayerNorm: one pass before the product, one warp per row, reads A (+ A2)
// once from device memory and holds the row in registers (K <= 2048; wider
// rows are read again from L1), takes the fp32 mean and centred variance and
// writes A' = LN(A (+ A2)) in bf16 to the scratch, which the product then
// reads as A. Each element is normalised once, not once per block along N;
// with A2 the sum is rounded to bf16 before the LN, like the stored residual
// sum of the JAX block tail. Normalising in the consumers instead (A from
// registers) could save at most this pass's write and re-read of A'.
//
// Ragged edges: M, N and K need not be multiples of the tile (TMA fills
// zeros, the epilogue masks). K and N must be multiples of 8 (TMA's 16-byte
// row strides) and the pointers 16-byte aligned; the Python wrapper checks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                   // warpgroups, alternate tiles
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int BOX = 64;                        // bf16 elements in a 128-byte swizzled row
constexpr int A_STAGE = BM * BK;               // elements per stage
constexpr int B_STAGE = BK * BN;               // BN / 64 boxes of 64 k-rows x 64 columns
constexpr uint32_t STAGE_BYTES = 2 * (A_STAGE + B_STAGE);
constexpr int LDC = BN + 8;                    // bf16 row stride of the staged C tile
constexpr size_t SMEM_BYTES = 1024 /* alignment slack */ + 2 * STAGES * (A_STAGE + B_STAGE) +
                              2 * CONSUMERS * BM * LDC + (2 * STAGES + 2) * sizeof(uint64_t);
static_assert(BK == BOX && BN % BOX == 0, "one swizzle atom across K for A, BN / 64 for W");

struct Epilogue {
  const float* bias;
  const __nv_bfloat16* r1;
  const __nv_bfloat16* r2;
  __nv_bfloat16* out;
  int m, n, gelu;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// Eight A values at element idx as the product sees them: A, or A + A2
// rounded to bf16.
__device__ __forceinline__ void load_a8(const __nv_bfloat16* a, const __nv_bfloat16* a2, long idx,
                                        float v[8]) {
  unpack8(*reinterpret_cast<const uint4*>(a + idx), v);
  if (a2) {
    float w[8];
    unpack8(*reinterpret_cast<const uint4*>(a2 + idx), w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i] + w[i]);
  }
}

// Eight values of A' at column c of the row: the LN of v, or v itself.
__device__ __forceinline__ void store_a8(__nv_bfloat16* out, long base, int c, float v[8],
                                         const float* ln_scale, const float* ln_bias, float mean,
                                         float rstd) {
  if (ln_scale) {
    const float4 g0 = *reinterpret_cast<const float4*>(ln_scale + c);
    const float4 g1 = *reinterpret_cast<const float4*>(ln_scale + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(ln_bias + c);
    const float4 b1 = *reinterpret_cast<const float4*>(ln_bias + c + 4);
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = fmaf((v[e] - mean) * rstd, gv[e], bv[e]);
  }
  *reinterpret_cast<uint4*>(out + base + c) = pack8(v);
}

// One warp per row: A' = LN(A (+ A2)) with fp32 mean and centred variance,
// or A + A2 without ln_scale, into out (bf16, the product's A). With CH > 0
// the row waits in registers (CH 8-element chunks a lane: K <= 256 CH), so it
// is read once; with CH = 0 (wider rows) the statistics read it again, from L1.
template <int CH>
__global__ void __launch_bounds__(256)
    ln_rows_kernel(const __nv_bfloat16* a, const __nv_bfloat16* a2, const float* ln_scale,
                   const float* ln_bias, __nv_bfloat16* out, int m, int k, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const long base = (long)row * k;
  float mean = 0.f, rstd = 1.f;
  if constexpr (CH > 0) {
    float x[CH][8];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((i * 32 + lane) * 8 < k) load_a8(a, a2, base + (i * 32 + lane) * 8, x[i]);
    if (ln_scale) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if ((i * 32 + lane) * 8 < k) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s += x[i][e];
        }
      mean = warp_sum(s) / k;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if ((i * 32 + lane) * 8 < k) {
#pragma unroll
          for (int e = 0; e < 8; ++e) q += (x[i][e] - mean) * (x[i][e] - mean);
        }
      rstd = rsqrtf(warp_sum(q) / k + eps);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((i * 32 + lane) * 8 < k)
        store_a8(out, base, (i * 32 + lane) * 8, x[i], ln_scale, ln_bias, mean, rstd);
  } else {
    if (ln_scale) {
      float s = 0.f;
      for (int c = lane * 8; c < k; c += 256) {
        float v[8];
        load_a8(a, a2, base + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[e];
      }
      mean = warp_sum(s) / k;
      float q = 0.f;
      for (int c = lane * 8; c < k; c += 256) {
        float v[8];
        load_a8(a, a2, base + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) q += (v[e] - mean) * (v[e] - mean);
      }
      rstd = rsqrtf(warp_sum(q) / k + eps);
    }
    for (int c = lane * 8; c < k; c += 256) {
      float v[8];
      load_a8(a, a2, base + c, v);
      store_a8(out, base, c, v, ln_scale, ln_bias, mean, rstd);
    }
  }
}

// Tensor maps in kernel parameter space (__grid_constant__), as TMA needs.
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, Epilogue p, int k) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;
  __nv_bfloat16* Cs = Bs + STAGES * B_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Cs + CONSUMERS * BM * LDC);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;  // turn[w]: the other warpgroup has issued its products

  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = (p.m + BM - 1) / BM * tiles_n;
  const int nk = (k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                 // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 4);                // one arrive per warp of its consumer
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
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load(As + stage * A_STAGE, &map_a, &full[stage], kt * BK, m0);
#pragma unroll
          for (int j = 0; j < BN / BOX; ++j)
            tma_load(Bs + stage * B_STAGE + j * BK * BOX, &map_w, &full[stage], n0 + j * BOX,
                     kt * BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup w takes this block's tiles w, w + 2,
  // ... whole, and the two take turns on the tensor cores: one's epilogue
  // runs under the other's products. A warpgroup starts a tile's products
  // only after the other has issued all of its own (turn[]), so it never
  // waits on a ring slot more than one barrier phase ahead: the parity
  // waits cannot alias.
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tl = lane % 4;
  __nv_bfloat16* cw = Cs + wg * BM * LDC;  // this warpgroup's C tile
  float acc[2][64];                        // rows 0-63 and 64-127 of the tile
  int local = 0;                           // this block's tiles so far
  uint32_t turns = 0;                      // handovers this warpgroup has waited for
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
    if (local % CONSUMERS != wg) continue;
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    if (local > 0) mbar_wait(&turn[wg], turns++ & 1);
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = local * nk + kt;  // the ring's k-tile count: stage and phase
      const int stage = slot % STAGES;
      mbar_wait(&full[stage], (slot / STAGES) & 1);
      const __nv_bfloat16* at = As + stage * A_STAGE;
      const __nv_bfloat16* bt = Bs + stage * B_STAGE;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        // A: 8-row groups 1024 bytes apart, k-step s 32 bytes into the
        // swizzled row; W: 8-row groups 1024 bytes apart, 64-column boxes
        // BK * 128 bytes apart, k-step s 16 rows down
        const uint64_t db = smem_desc(bt + s * 16 * BOX, BK * BOX * 2, 1024);
        wgmma_m64n128k16(acc[0], smem_desc(at + s * 16, 16, 1024), db);
        wgmma_m64n128k16(acc[1], smem_desc(at + 64 * BK + s * 16, 16, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's products are done: release its stage
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
    }
    mbar_arrive(&turn[wg ^ 1]);  // every thread: the other warpgroup's turn
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // bias and GELU on the accumulators (rows 64 h + 16 warp + g, + 8;
    // columns 8 j + 2 tl, + 1), the bf16 result into the C tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = h * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = j * 8 + 2 * tl;
        const bool in = n0 + cl < p.n;  // N % 8 == 0: cl + 1 is in range too
        const float b0 = p.bias && in ? __ldg(p.bias + n0 + cl) : 0.f;
        const float b1 = p.bias && in ? __ldg(p.bias + n0 + cl + 1) : 0.f;
        float v[4] = {acc[h][4 * j] + b0, acc[h][4 * j + 1] + b1, acc[h][4 * j + 2] + b0,
                      acc[h][4 * j + 3] + b1};
        if (p.gelu) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
        }
        *reinterpret_cast<uint32_t*>(cw + rl * LDC + cl) = pack_bf16(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(cw + (rl + 8) * LDC + cl) = pack_bf16(v[2], v[3]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the C tile is written

    // residual and store, 16 bytes per thread, rows contiguous across threads
    for (int v = tid; v < BM * BN / 8; v += 128) {
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row >= p.m || col >= p.n) continue;
      const long idx = (long)row * p.n + col;
      uint4 raw = *reinterpret_cast<const uint4*>(cw + r * LDC + c);
      if (p.r1) {
        float y[8], x[8];
        unpack8(*reinterpret_cast<const uint4*>(p.r1 + idx), y);
        if (p.r2) {
          float y2[8];
          unpack8(*reinterpret_cast<const uint4*>(p.r2 + idx), y2);
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = round_bf16(y[e] + y2[e]);
        }
        unpack8(raw, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] += y[e];
        raw = pack8(x);
      }
      *reinterpret_cast<uint4*>(p.out + idx) = raw;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the C tile is free
  }
}


// ------------------------------------------------------------------ host side

int num_sms = 0;

}  // namespace

// Called once, when the library is loaded: the CUDA driver API's tensor-map encoder
// (through the runtime, so the library links no libcuda), the SM count for
// the persistent grid, and the kernel's shared memory above the 48 KB default.
extern "C" int ysi_gemm_init(void) {
  cudaError_t err = load_encode_tiled();
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
  return (int)err;
}

extern "C" int ysi_gemm_bf16(const void* a, const void* a2, const void* w, const void* bias,
                             const void* ln_scale, const void* ln_bias, void* scratch,
                             const void* r1, const void* r2, void* out, int m, int n, int k,
                             float eps, int gelu, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8) return (int)cudaErrorInvalidValue;
  const bool ln = ln_scale != nullptr;
  if (ln && ln_bias == nullptr) return (int)cudaErrorInvalidValue;
  if ((ln || a2) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* a_in = a;
  if (ln || a2) {
    const auto* a16 = static_cast<const __nv_bfloat16*>(a);
    const auto* a216 = static_cast<const __nv_bfloat16*>(a2);
    const auto* g = static_cast<const float*>(ln_scale);
    const auto* b = static_cast<const float*>(ln_bias);
    auto* o = static_cast<__nv_bfloat16*>(scratch);
    const int blocks = (m + 7) / 8;  // a warp per row
    if (k <= 256)
      ln_rows_kernel<1><<<blocks, 256, 0, st>>>(a16, a216, g, b, o, m, k, eps);
    else if (k <= 512)
      ln_rows_kernel<2><<<blocks, 256, 0, st>>>(a16, a216, g, b, o, m, k, eps);
    else if (k <= 1024)
      ln_rows_kernel<4><<<blocks, 256, 0, st>>>(a16, a216, g, b, o, m, k, eps);
    else if (k <= 2048)
      ln_rows_kernel<8><<<blocks, 256, 0, st>>>(a16, a216, g, b, o, m, k, eps);
    else
      ln_rows_kernel<0><<<blocks, 256, 0, st>>>(a16, a216, g, b, o, m, k, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a_in = scratch;
  }
  CUtensorMap map_a, map_w;
  cudaError_t err = make_map(&map_a, a_in, m, k, BM);
  if (err == cudaSuccess) err = make_map(&map_w, w, k, n, BK);
  if (err != cudaSuccess) return (int)err;
  Epilogue p;
  p.bias = static_cast<const float*>(bias);
  p.r1 = static_cast<const __nv_bfloat16*>(r1);
  p.r2 = static_cast<const __nv_bfloat16*>(r2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.n = n;
  p.gelu = gelu;
  const int tiles = (m + BM - 1) / BM * ((n + BN - 1) / BN);
  gemm_bf16_kernel<<<tiles < num_sms ? tiles : num_sms, THREADS, SMEM_BYTES, st>>>(map_a, map_w,
                                                                                    p, k);
  return (int)cudaGetLastError();
}
