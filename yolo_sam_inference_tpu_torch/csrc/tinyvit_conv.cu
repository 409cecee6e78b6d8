// TinyViT's depthwise 3x3 of the window blocks' tails (Hopper, sm_90a). The
// MBConv blocks (stride 1) and the patch merges (stride 2) run on mbconv.cu's
// kernel; this file's first mbconv_kernel (mma.sync, both strides) is gone.
//
// dw3x3_ln_kernel: y = dw3x3(x) + bd in fp32, rounded to bf16 where the TPU
// kernel rounds it, and, for the tail of TinyViT's window blocks, LN(y) in
// the same pass; the tail's MLP is then two gemm_bf16 launches on LN(y)
// (replaces the depthwise and LayerNorm of ops/dw_ln_mlp.py:88 dw_ln_mlp).
// Bound by device memory: x read once, y and LN(y) written once (18 flop per
// value of the depthwise). The first design took a thread per pixel and 8
// channels, re-read its 9 taps' weights and inputs from L1/L2 and left the
// LayerNorm to a separate pass over y (0.1445 ms at stage 3, F.conv2d(groups
// = C) 0.0725, on an H100 80GB HBM3 at 700 W). This one stages a tile with all
// C channels once and reads each input value about 3 times from shared
// memory (stage 3: 0.028 ms on the device for y alone, 0.042 with LN(y),
// against the first design's 0.108 for y; bench/kernel_turns.py); the LN's
// statistics come from the bf16-rounded y in fp32, as in the
// TPU kernel's _ln_rows (fused_ln.py:27), and its affine is applied in fp32 to
// (y - mean) rstd before one rounding to bf16, where _ln_rows rounds
// (y - mean) rstd to bf16 first and applies the affine after (a difference of
// at most one bf16 step of the normalised value, times the scale).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

// dw3x3_ln_kernel: a block takes DW_TH x DW_TW output pixels and all C
// channels; thread (column, 8-channel group) owns its column's DW_TH pixels
// in its 8 channels throughout. The input tile with its one-pixel halo
// ((DW_TH + 2) x (DW_TW + 2) x C, zero outside the image) comes by cp.async
// into shared memory. Each thread keeps its channels' 9 fp32 taps and bias
// in registers and walks down its column with the 3 x 3 input neighbourhood
// in registers (one new input row of 3 pixels a step); y = dw3x3(x) + bd,
// rounded to bf16, stays in its registers and is stored with 16-byte
// stores. With ln, the LN statistics (fp32 mean, then centred variance, of
// the bf16 y, as the TPU kernel's _ln_rows) come from per-thread partial
// sums over its 8 channels, reduced over the C / 8 threads of each pixel in
// shared memory, and each thread stores its LN(y) with 16-byte stores.
constexpr int DW_TH = 8, DW_TW = 8, DW_PIX = DW_TH * DW_TW;
constexpr int DW_MAX_C = 320;  // 73 KB of shared memory, 320 threads

__host__ __device__ inline size_t dw_smem_bytes(int c) {
  return sizeof(__nv_bfloat16) * (size_t)c * (DW_TH + 2) * (DW_TW + 2) +
         sizeof(float) * ((size_t)DW_PIX * (c / 8) + 2 * DW_PIX);
}

__device__ __forceinline__ void fma8(float acc[8], const uint4& raw, const float w[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = fmaf(__bfloat162float(e[i]), w[i], acc[i]);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__global__ void __launch_bounds__(DW_TW * DW_MAX_C / 8)
    dw3x3_ln_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ wd,
                    const float* __restrict__ bd, const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_shift, __nv_bfloat16* __restrict__ y,
                    __nv_bfloat16* __restrict__ ln, int hgt, int wid, int c, float eps) {
  constexpr int IW = DW_TW + 2, PIN = (DW_TH + 2) * IW;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  const int cg = c / 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dw_smem);  // (PIN, C) input tile
  float* part = reinterpret_cast<float*>(xs + PIN * c);            // (DW_PIX, C / 8) partials
  float* mean = part + DW_PIX * cg;                                 // (DW_PIX,)
  float* rstd = mean + DW_PIX;                                      // (DW_PIX,)
  const int tiles_x = (wid + DW_TW - 1) / DW_TW, tiles_y = (hgt + DW_TH - 1) / DW_TH;
  int bid = blockIdx.x;
  const int ox0 = (bid % tiles_x) * DW_TW;
  bid /= tiles_x;
  const int oy0 = (bid % tiles_y) * DW_TH;
  const int b = bid / tiles_y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const __nv_bfloat16* xb = x + (long)b * hgt * wid * c;

  for (int v = tid; v < PIN * cg; v += nthreads) {
    const int pix = v / cg, d = (v % cg) * 8;
    const int sy = oy0 - 1 + pix / IW, sx = ox0 - 1 + pix % IW;
    const bool ok = sy >= 0 && sy < hgt && sx >= 0 && sx < wid;
    cp_async16(xs + pix * c + d, ok ? xb + ((long)sy * wid + sx) * c + d : x, ok);
  }
  cp_async_commit();

  // this thread's column and 8 channels (a block has DW_TW C / 8 threads,
  // rounded up to whole warps: the others walk column 0 too and store nothing)
  const bool owner = tid < DW_TW * cg;
  const int col = owner ? tid / cg : 0, gi = tid % cg, d = gi * 8;
  float w[9][8], bias[8];
#pragma unroll
  for (int t = 0; t < 9; ++t) load8(wd + t * c + d, w[t]);
  load8(bd + d, bias);
  cp_async_wait<0>();
  __syncthreads();
  auto at = [&](int iy, int ix) {
    return *reinterpret_cast<const uint4*>(xs + (iy * IW + ix) * c + d);
  };
  const int ox = ox0 + col;
  uint4 yv[DW_TH];  // y of this thread's pixels (rows oy0 + r), 8 bf16 each
  uint4 win[3][3];  // input rows r .. r + 2 of the tile, columns col .. col + 2
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q) win[r + 1][q] = at(r, col + q);
#pragma unroll
  for (int r = 0; r < DW_TH; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      win[0][q] = win[1][q];
      win[1][q] = win[2][q];
      win[2][q] = at(r + 2, col + q);
    }
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = bias[i];
#pragma unroll
    for (int t = 0; t < 9; ++t) fma8(acc, win[t / 3][t % 3], w[t]);
    uint32_t* o = reinterpret_cast<uint32_t*>(&yv[r]);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
    const int oy = oy0 + r;
    if (owner && oy < hgt && ox < wid)
      *reinterpret_cast<uint4*>(y + (((long)b * hgt + oy) * wid + ox) * c + d) = yv[r];
  }
  if (!ln_scale) return;

  // the LN statistics: partial sums over this thread's 8 channels, then one
  // thread per pixel over the pixel's C / 8 partials; twice (mean, variance)
  auto reduce = [&](float* out, bool var) {
    if (owner) {
#pragma unroll
      for (int r = 0; r < DW_TH; ++r) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&yv[r]);
        const float mu = var ? mean[r * DW_TW + col] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = __bfloat162float(e[i]) - mu;
          s += var ? v * v : v;
        }
        part[(r * DW_TW + col) * cg + gi] = s;
      }
    }
    __syncthreads();
    if (tid < DW_PIX) {
      float s = 0.f;
      for (int j = 0; j < cg; ++j) s += part[tid * cg + j];
      out[tid] = var ? rsqrtf(s / c + eps) : s / c;
    }
    __syncthreads();
  };
  reduce(mean, false);
  reduce(rstd, true);
  if (!owner) return;
  float g[8], h[8];
  load8(ln_scale + d, g);
  load8(ln_shift + d, h);
#pragma unroll
  for (int r = 0; r < DW_TH; ++r) {
    const int oy = oy0 + r;
    if (oy >= hgt || ox >= wid) continue;
    const float mu = mean[r * DW_TW + col], rs = rstd[r * DW_TW + col];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&yv[r]);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = pack_bf16(fmaf((__bfloat162float(e[2 * i]) - mu) * rs, g[2 * i], h[2 * i]),
                       fmaf((__bfloat162float(e[2 * i + 1]) - mu) * rs, g[2 * i + 1],
                            h[2 * i + 1]));
    *reinterpret_cast<uint4*>(ln + (((long)b * hgt + oy) * wid + ox) * c + d) = out;
  }
}

}  // namespace

// Called once, when the library is loaded: the depthwise kernel may take up
// to the card's opt-in shared memory per block.
extern "C" int ysi_tinyvit_conv_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dw3x3_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return (int)err;
}

// y = dw3x3(x) + bd and, with ln_scale (and ln_shift), ln = LN(y); C a
// multiple of 8, at most DW_MAX_C (the tile's shared memory and threads).
extern "C" int ysi_dw_conv3x3(const void* x, const void* wd, const void* bd, const void* ln_scale,
                              const void* ln_shift, void* y, void* ln, int b, int hgt, int wid,
                              int c, float eps, void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || c <= 0 || c % 8 || c > DW_MAX_C)
    return (int)cudaErrorInvalidValue;
  if (ln_scale && (ln_shift == nullptr || ln == nullptr)) return (int)cudaErrorInvalidValue;
  const long blocks = (long)b * ((hgt + DW_TH - 1) / DW_TH) * ((wid + DW_TW - 1) / DW_TW);
  const int threads = DW_TW * (c / 8);  // a thread per output column and 8 channels
  dw3x3_ln_kernel<<<(unsigned)blocks, (threads + 31) / 32 * 32, dw_smem_bytes(c),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_shift), static_cast<__nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(ln), hgt, wid, c, eps);
  return (int)cudaGetLastError();
}
