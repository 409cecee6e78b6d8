// TinyViT's convolution blocks (Hopper, sm_90a): the patch merges at stride
// 2, and the depthwise 3x3 of the window blocks' tails. The stride-1 MBConv
// blocks (stage 0, merge2) run on mbconv.cu's kernel; this
// kernel's stride-1 instantiations (with and without the residual) are gone.
//
// mbconv_kernel<STRIDE, BF16> (STRIDE 2), for x (B, H, W, C) bf16, w1 (C, E)
// and w3 (E, Co) bf16 (the JAX (in, out) layout), wd (3, 3, E) and the biases
// fp32:
//   h1  = gelu(x @ w1 + b1)                         rounded to bf16
//   h2  = gelu(dw3x3_STRIDE(h1) + bd)               zero 'same' padding, fp32 taps, bf16
//   out = h2 @ w3 + b3
// The expansion of a pixel outside the image is zero (the reference pads the
// expanded tensor), not gelu(b1). At stride 2 (even H, W) only the top and
// left padding is ever read. GELU is the exact erf form.
//
// BF16 is the JAX kernels' compute="bf16" (mbconv_fused.py:68-72, :94,
// :108-114, :126; merge_fused.py:65): the VPU-bound stretch runs in bf16. It
// rounds to bf16 where they do: x @ w1 + b1 before its GELU; the depthwise
// bias, weights and every tap's accumulator (packed bf16x2 FMAs, __hfma2, on
// channel pairs: the CUDA cores' bf16x2 rate is twice their fp32 rate); and
// (in mbconv.cu's stride-1 kernel) x + out before its GELU. Each GELU evaluates the erf in fp32
// on its bf16-rounded input and rounds its output to bf16 (the JAX kernels
// evaluate the GELU's arithmetic in bf16 too); the products keep their fp32
// accumulation, as there.
//
// Replaces (yolo_sam_inference_tpu/ops/): merge_fused.py:125
// patch_merge_block (stride 2: merge0, merge1).
//
// What bounds it on the H100: at TinyViT's widths a pixel costs 4 (C E + E Co)
// flop of products against 2 (C + Co) bytes in and out: 128 flop per byte at
// stage 0 (C 64, E 256) and up to 480 at merge2 (C 160, E Co 320), so the
// tensor cores bound the wide blocks and memory the narrow ones, once the
// 4x-expanded activation stays on chip, which is the point of both TPU
// kernels and of this one. The design: a block takes a tile of output pixels
// (4 x 8 at stride 2) and cp.asyncs the input tile with its halo (9 x 17
// pixels) into shared memory; the expansion runs
// as an mma.sync m16n8k16 product (bf16 in, fp32 accumulation) over that
// tile, its GELU'd bf16 result stays in shared memory (zeroed outside the
// image); the depthwise reads it in fp32 into a second bf16 tile; the
// projection is a second product whose epilogue adds the bias (and the
// residual read back from the input tile, and the GELU) and stores bf16. The
// weights stream through a two-stage cp.async ring of 32 x 64 tiles, so no
// weight matrix is held whole (merge2's are 200 KB). 8 warps: 4 along the
// pixels, 2 along 32-column halves of each 64-column chunk. The halo costs
// 1.2x of the expansion's products. No wgmma or TMA yet (Queue 2).
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

constexpr int THREADS = 256;  // 8 warps
constexpr int NC = 64;        // output columns per chunk (2 warp halves of 32)
constexpr int KTW = 32;       // weight rows per streamed tile
constexpr int LDW = NC + 8;   // 144 B rows: ldmatrix conflict-free
constexpr int MTW = 3;        // m16 tiles per warp row (up to 12 m-tiles of pixels)

template <int STRIDE>
struct Tile {
  static constexpr int TH = 4, TW = 8;  // output pixels
  static constexpr int IH = (TH - 1) * STRIDE + 3, IW = (TW - 1) * STRIDE + 3;  // input tile
  static constexpr int PIN = IH * IW;                 // 153 input pixels
  static constexpr int MIN = (PIN + 15) / 16 * 16;    // 160 rows
  static constexpr int MOUT = TH * TW;                // 32 rows
  static_assert(MIN / 16 <= 4 * MTW && MOUT / 16 <= 4 * MTW, "pixel tiles fit the warp rows");
};

template <int STRIDE>
size_t conv_smem_bytes(int c, int e) {
  using T = Tile<STRIDE>;
  return sizeof(__nv_bfloat16) *
         ((size_t)T::MIN * (c + 8) + (size_t)T::MIN * (e + 8) + (size_t)T::MOUT * (e + 8) +
          2 * KTW * LDW);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// C[m, n] = A[m, :k] @ W[:k, n] for m < rows (a multiple of 16), n < n_total
// (a multiple of 8); A in shared memory (row stride lda, a multiple of 8), W
// in device memory (k x n_total row-major, k a multiple of KTW). Calls
// epi(row, col, v0, v1) for the fp32 pair (col, col + 1). Ends with the
// block synchronised; every thread must call it.
template <class Epi>
__device__ __forceinline__ void block_gemm(const __nv_bfloat16* A, int lda, int rows, int k,
                                           const __nv_bfloat16* __restrict__ w, int n_total,
                                           __nv_bfloat16* ring, Epi epi) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
  const int nk = k / KTW;
  for (int n0 = 0; n0 < n_total; n0 += NC) {
    auto issue = [&](int kt, int buf) {
      for (int v = tid; v < KTW * NC / 8; v += THREADS) {
        const int r = v / (NC / 8), col = (v % (NC / 8)) * 8;
        const bool ok = n0 + col < n_total;
        cp_async16(ring + (buf * KTW + r) * LDW + col,
                   w + (ok ? (long)(kt * KTW + r) * n_total + n0 + col : 0), ok);
      }
    };
    float acc[MTW][4][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    issue(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) issue(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile kt has landed (this thread's copies)
      __syncthreads();     // and everyone's
      const __nv_bfloat16* wt = ring + (kt & 1) * KTW * LDW;
#pragma unroll
      for (int kk = 0; kk < KTW; kk += 16) {
        uint32_t bf[4][2];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, wt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW + wc * 32 +
                                   jp * 16 + (lane >> 4) * 8);
          bf[2 * jp][0] = r[0];
          bf[2 * jp][1] = r[1];
          bf[2 * jp + 1][0] = r[2];
          bf[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
          const int mt = wr + 4 * i;
          if (mt * 16 >= rows) break;
          uint32_t af[4];
          ldmatrix_x4(af, A + (mt * 16 + (lane & 15)) * lda + kt * KTW + kk + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af, bf[j][0], bf[j][1]);
        }
      }
      __syncthreads();  // the stage is consumed before it is refilled
    }
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int mt = wr + 4 * i;
      if (mt * 16 >= rows) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wc * 32 + j * 8 + 2 * t;
        if (col >= n_total) continue;
        epi(mt * 16 + g, col, acc[i][j][0], acc[i][j][1]);
        epi(mt * 16 + g + 8, col, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
  __syncthreads();  // every epilogue write is visible
}

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w1;
  const float* b1;
  const float* wd;
  const float* bd;
  const __nv_bfloat16* w3;
  const float* b3;
  __nv_bfloat16* out;
  int hgt, wid, c, e, co;
};

template <int STRIDE, bool BF16>
__global__ void __launch_bounds__(THREADS) mbconv_kernel(ConvArgs p) {
  using T = Tile<STRIDE>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = p.c + 8, lde = p.e + 8;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Es = Xs + T::MIN * ldx;
  __nv_bfloat16* Hs = Es + T::MIN * lde;
  __nv_bfloat16* ring = Hs + T::MOUT * lde;

  const int ho = p.hgt / STRIDE, wo = p.wid / STRIDE;
  const int tiles_x = (wo + T::TW - 1) / T::TW, tiles_y = (ho + T::TH - 1) / T::TH;
  int bid = blockIdx.x;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int b = bid / tiles_y;
  const int oy0 = ty * T::TH, ox0 = tx * T::TW;
  const int iy0 = oy0 * STRIDE - 1, ix0 = ox0 * STRIDE - 1;  // input tile origin (halo)
  const int tid = threadIdx.x;

  // input pixel p of the tile inside the image?
  auto inside = [&](int pix, int& y, int& x) {
    y = iy0 + pix / T::IW;
    x = ix0 + pix % T::IW;
    return pix < T::PIN && y >= 0 && y < p.hgt && x >= 0 && x < p.wid;
  };
  for (int v = tid; v < T::MIN * (p.c / 8); v += THREADS) {
    const int pix = v / (p.c / 8), d = (v % (p.c / 8)) * 8;
    int y, x;
    const bool ok = inside(pix, y, x);
    cp_async16(Xs + pix * ldx + d, p.x + (ok ? (((long)b * p.hgt + y) * p.wid + x) * p.c + d : 0),
               ok);
  }
  cp_async_commit();  // waited on, with the first weight tile, inside block_gemm

  // the expansion over the tile and its halo; zero outside the image
  block_gemm(Xs, ldx, T::MIN, p.c, p.w1, p.e, ring, [&](int row, int col, float v0, float v1) {
    int y, x;
    const bool ok = inside(row, y, x);
    float a = v0 + p.b1[col], c1 = v1 + p.b1[col + 1];
    if (BF16) {
      a = round_bf16(a);
      c1 = round_bf16(c1);
    }
    a = ok ? gelu(a) : 0.f;
    c1 = ok ? gelu(c1) : 0.f;
    *reinterpret_cast<uint32_t*>(Es + row * lde + col) = pack_bf16(a, c1);
  });

  // the depthwise 3x3 (stride STRIDE) in fp32, or in bf16x2, GELU, into Hs;
  // two channels a thread
  for (int v = tid; v < T::MOUT * (p.e / 2); v += THREADS) {
    const int o = v / (p.e / 2), ch = (v % (p.e / 2)) * 2;
    const int oy = o / T::TW, ox = o % T::TW;
    float a0, a1;
    if (BF16) {
      __nv_bfloat162 acc = __floats2bfloat162_rn(p.bd[ch], p.bd[ch + 1]);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(
              Es + ((oy * STRIDE + dy) * T::IW + ox * STRIDE + dx) * lde + ch);
          const float* wt = p.wd + (dy * 3 + dx) * p.e + ch;
          acc = __hfma2(hv, __floats2bfloat162_rn(wt[0], wt[1]), acc);
        }
      a0 = __low2float(acc);
      a1 = __high2float(acc);
    } else {
      a0 = p.bd[ch];
      a1 = p.bd[ch + 1];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(
              Es + ((oy * STRIDE + dy) * T::IW + ox * STRIDE + dx) * lde + ch);
          const float* wt = p.wd + (dy * 3 + dx) * p.e + ch;
          a0 = fmaf(__low2float(hv), wt[0], a0);
          a1 = fmaf(__high2float(hv), wt[1], a1);
        }
    }
    *reinterpret_cast<uint32_t*>(Hs + o * lde + ch) = pack_bf16(gelu(a0), gelu(a1));
  }
  __syncthreads();

  // the projection and its bias, store
  block_gemm(Hs, lde, T::MOUT, p.e, p.w3, p.co, ring, [&](int row, int col, float v0, float v1) {
    const int oy = oy0 + row / T::TW, ox = ox0 + row % T::TW;
    if (oy >= ho || ox >= wo) return;
    const float a = v0 + p.b3[col], c1 = v1 + p.b3[col + 1];
    *reinterpret_cast<uint32_t*>(p.out + (((long)b * ho + oy) * wo + ox) * p.co + col) =
        pack_bf16(a, c1);
  });
}

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

template <int STRIDE, bool BF16>
int launch_conv(const ConvArgs& p, int b, cudaStream_t st) {
  using T = Tile<STRIDE>;
  const int ho = p.hgt / STRIDE, wo = p.wid / STRIDE;
  const long blocks = (long)b * ((ho + T::TH - 1) / T::TH) * ((wo + T::TW - 1) / T::TW);
  // above the opt-in maximum set by ysi_tinyvit_conv_init, the launch is refused and reported
  mbconv_kernel<STRIDE, BF16>
      <<<(unsigned)blocks, THREADS, conv_smem_bytes<STRIDE>(p.c, p.e), st>>>(p);
  return (int)cudaGetLastError();
}

template <int STRIDE>
cudaError_t allow_conv_smem(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(mbconv_kernel<STRIDE, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mbconv_kernel<STRIDE, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

}  // namespace

// Called once, when the library is loaded: the conv kernels may take up to the
// card's opt-in shared memory per block.
extern "C" int ysi_tinyvit_conv_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = allow_conv_smem<2>(optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dw3x3_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return (int)err;
}

// The stride-2 patch merge (even H and W).
extern "C" int ysi_patch_merge(int bf16, const void* x, const void* w1, const void* b1,
                               const void* wd, const void* bd, const void* w3, const void* b3,
                               void* out, int b, int hgt, int wid, int c, int e, int co,
                               void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || c % 32 || e % 32 || co % 32 || c <= 0 || e <= 0 || co <= 0)
    return (int)cudaErrorInvalidValue;
  if (hgt % 2 || wid % 2) return (int)cudaErrorInvalidValue;
  ConvArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.w3 = static_cast<const __nv_bfloat16*>(w3);
  p.b3 = static_cast<const float*>(b3);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hgt = hgt;
  p.wid = wid;
  p.c = c;
  p.e = e;
  p.co = co;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_conv<2, true>(p, b, st) : launch_conv<2, false>(p, b, st);
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
