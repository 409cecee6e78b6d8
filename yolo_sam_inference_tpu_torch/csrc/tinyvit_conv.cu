// TinyViT's convolution blocks (Hopper, sm_90a): the MBConv block and the
// patch merges, and the depthwise 3x3 of the window blocks' tails.
//
// mbconv_kernel<STRIDE, RESIDUAL, BF16>, for x (B, H, W, C) bf16, w1 (C, E)
// and w3 (E, Co) bf16 (the JAX (in, out) layout), wd (3, 3, E) and the biases
// fp32:
//   h1  = gelu(x @ w1 + b1)                         rounded to bf16
//   h2  = gelu(dw3x3_STRIDE(h1) + bd)               zero 'same' padding, fp32 taps, bf16
//   out = h2 @ w3 + b3, then gelu(x + out) when RESIDUAL
// The expansion of a pixel outside the image is zero (the reference pads the
// expanded tensor), not gelu(b1). At stride 2 (even H, W) only the top and
// left padding is ever read. GELU is the exact erf form.
//
// BF16 is the JAX kernels' compute="bf16" (mbconv_fused.py:68-72, :94,
// :108-114, :126; merge_fused.py:65): the VPU-bound stretch runs in bf16. It
// rounds to bf16 where they do: x @ w1 + b1 before its GELU; the depthwise
// bias, weights and every tap's accumulator (packed bf16x2 FMAs, __hfma2, on
// channel pairs: the CUDA cores' bf16x2 rate is twice their fp32 rate); and
// with RESIDUAL, x + out before its GELU. Each GELU evaluates the erf in fp32
// on its bf16-rounded input and rounds its output to bf16 (the JAX kernels
// evaluate the GELU's arithmetic in bf16 too); the products keep their fp32
// accumulation, as there.
//
// Replaces (yolo_sam_inference_tpu/ops/): mbconv_fused.py:134 mbconv_block
// (stride 1, with and without the residual: stage 0 and TinyViT's stride-1
// merge2) and merge_fused.py:125 patch_merge_block (stride 2: merge0, merge1).
//
// What bounds it on the H100: at TinyViT's widths a pixel costs 4 (C E + E Co)
// flop of products against 2 (C + Co) bytes in and out: 128 flop per byte at
// stage 0 (C 64, E 256) and up to 480 at merge2 (C 160, E Co 320), so the
// tensor cores bound the wide blocks and memory the narrow ones, once the
// 4x-expanded activation stays on chip, which is the point of both TPU
// kernels and of this one. The design: a block takes a tile of output pixels
// (8 x 8 at stride 1, 4 x 8 at stride 2) and cp.asyncs the input tile with
// its halo (10 x 10 or 9 x 17 pixels) into shared memory; the expansion runs
// as an mma.sync m16n8k16 product (bf16 in, fp32 accumulation) over that
// tile, its GELU'd bf16 result stays in shared memory (zeroed outside the
// image); the depthwise reads it in fp32 into a second bf16 tile; the
// projection is a second product whose epilogue adds the bias (and the
// residual read back from the input tile, and the GELU) and stores bf16. The
// weights stream through a two-stage cp.async ring of 32 x 64 tiles, so no
// weight matrix is held whole (merge2's are 200 KB). 8 warps: 4 along the
// pixels, 2 along 32-column halves of each 64-column chunk. The halo costs
// 1.56x (stride 1) and 1.2x (stride 2) of the expansion's products. No wgmma
// or TMA yet.
//
// dw3x3_kernel: y = dw3x3(x) + bd in fp32, rounded to bf16 where the TPU
// kernel rounds it (ops/dw_ln_mlp.py:80), for the tail of TinyViT's window
// blocks (its LayerNorm and MLP are gemm_bf16 launches). A streaming pass:
// 18 flop per value against 4 bytes, bound by device memory; one thread per
// pixel and 8 channels (16-byte loads, neighbouring threads on neighbouring
// channels), the 9 taps' rows come from L1/L2.

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
  static constexpr int TH = STRIDE == 1 ? 8 : 4, TW = 8;  // output pixels
  static constexpr int IH = (TH - 1) * STRIDE + 3, IW = (TW - 1) * STRIDE + 3;  // input tile
  static constexpr int PIN = IH * IW;                 // 100 or 153 input pixels
  static constexpr int MIN = (PIN + 15) / 16 * 16;    // 112 or 160 rows
  static constexpr int MOUT = TH * TW;                // 64 or 32 rows
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

template <int STRIDE, bool RESIDUAL, bool BF16>
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

  // the projection; bias, the residual and GELU (MBConv), store
  block_gemm(Hs, lde, T::MOUT, p.e, p.w3, p.co, ring, [&](int row, int col, float v0, float v1) {
    const int oy = oy0 + row / T::TW, ox = ox0 + row % T::TW;
    if (oy >= ho || ox >= wo) return;
    float a = v0 + p.b3[col], c1 = v1 + p.b3[col + 1];
    if (RESIDUAL) {  // stride 1, Co == C: x at this pixel is input tile pixel (r + 1, c + 1)
      const int pin = (row / T::TW + 1) * T::IW + row % T::TW + 1;
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(Xs + pin * ldx + col);
      a = __low2float(xv) + a;
      c1 = __high2float(xv) + c1;
      if (BF16) {
        a = round_bf16(a);
        c1 = round_bf16(c1);
      }
      a = gelu(a);
      c1 = gelu(c1);
    }
    *reinterpret_cast<uint32_t*>(p.out + (((long)b * ho + oy) * wo + ox) * p.co + col) =
        pack_bf16(a, c1);
  });
}

__global__ void __launch_bounds__(256)
    dw3x3_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ wd,
                 const float* __restrict__ bd, __nv_bfloat16* __restrict__ y, int b, int hgt,
                 int wid, int c) {
  const int cg = c / 8;
  const long v = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= (long)b * hgt * wid * cg) return;
  const int d = (int)(v % cg) * 8;
  long pix = v / cg;
  const int xx = (int)(pix % wid);
  pix /= wid;
  const int yy = (int)(pix % hgt);
  const int bb = (int)(pix / hgt);
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = bd[d + i];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int sy = yy + dy - 1;
    if (sy < 0 || sy >= hgt) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int sx = xx + dx - 1;
      if (sx < 0 || sx >= wid) continue;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(x + (((long)bb * hgt + sy) * wid + sx) * c + d);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float* wt = wd + (dy * 3 + dx) * c + d;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(__bfloat162float(xv[i]), wt[i], acc[i]);
    }
  }
  uint4 raw;
  uint32_t* o = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
  *reinterpret_cast<uint4*>(y + (((long)bb * hgt + yy) * wid + xx) * c + d) = raw;
}

template <int STRIDE, bool RESIDUAL, bool BF16>
int launch_conv(const ConvArgs& p, int b, cudaStream_t st) {
  using T = Tile<STRIDE>;
  const int ho = p.hgt / STRIDE, wo = p.wid / STRIDE;
  const long blocks = (long)b * ((ho + T::TH - 1) / T::TH) * ((wo + T::TW - 1) / T::TW);
  // above the opt-in maximum set by ysi_tinyvit_conv_init, the launch is refused and reported
  mbconv_kernel<STRIDE, RESIDUAL, BF16>
      <<<(unsigned)blocks, THREADS, conv_smem_bytes<STRIDE>(p.c, p.e), st>>>(p);
  return (int)cudaGetLastError();
}

template <int STRIDE, bool RESIDUAL>
cudaError_t allow_conv_smem(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(mbconv_kernel<STRIDE, RESIDUAL, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mbconv_kernel<STRIDE, RESIDUAL, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

template <bool BF16>
int launch_conv_mode(int stride, int residual, const ConvArgs& p, int b, cudaStream_t st) {
  if (stride == 1 && residual) return launch_conv<1, true, BF16>(p, b, st);
  if (stride == 1) return launch_conv<1, false, BF16>(p, b, st);
  if (stride == 2) return launch_conv<2, false, BF16>(p, b, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Called once, when the library is loaded: the conv kernels may take up to the
// card's opt-in shared memory per block (162 KB at merge2's widths).
extern "C" int ysi_tinyvit_conv_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = allow_conv_smem<1, true>(optin);
  if (err == cudaSuccess) err = allow_conv_smem<1, false>(optin);
  if (err == cudaSuccess) err = allow_conv_smem<2, false>(optin);
  return (int)err;
}

extern "C" int ysi_mbconv(int stride, int residual, int bf16, const void* x, const void* w1,
                          const void* b1, const void* wd, const void* bd, const void* w3,
                          const void* b3, void* out, int b, int hgt, int wid, int c, int e, int co,
                          void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || c % 32 || e % 32 || co % 32 || c <= 0 || e <= 0 || co <= 0)
    return (int)cudaErrorInvalidValue;
  if ((residual && (stride != 1 || co != c)) || (stride == 2 && (hgt % 2 || wid % 2)))
    return (int)cudaErrorInvalidValue;
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
  return bf16 ? launch_conv_mode<true>(stride, residual, p, b, st)
              : launch_conv_mode<false>(stride, residual, p, b, st);
}

extern "C" int ysi_dw_conv3x3(const void* x, const void* wd, const void* bd, void* y, int b,
                              int hgt, int wid, int c, void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || c <= 0 || c % 8) return (int)cudaErrorInvalidValue;
  const long n = (long)b * hgt * wid * (c / 8);
  dw3x3_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<__nv_bfloat16*>(y), b, hgt, wid, c);
  return (int)cudaGetLastError();
}
