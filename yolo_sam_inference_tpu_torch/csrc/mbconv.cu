// TinyViT's stride-1 MBConv block (Hopper, sm_90a): stage 0's blocks with
// the residual and the stride-1 merge2 without it.
//
// mbconv_s1_kernel, for x (B, H, W, C) bf16, w1 (C, E) and w3 (E, Co) bf16
// in the JAX (in, out) layout, wd (3, 3, E) and the biases fp32:
//   h1  = gelu(x @ w1 + b1)               rounded to bf16; zero outside the image
//   h2  = gelu(dw3x3(h1) + bd)            zero 'same' padding, fp32 taps, bf16
//   out = h2 @ w3 + b3, then gelu(x + out) with the residual (Co == C)
// GELU is the exact erf form (erf in fp32 by erf_fit below). bf16 is the JAX kernels' compute="bf16"
// (mbconv_fused.py:68-72, :94, :108-114, :126) with the roundings listed in
// tinyvit_conv.cu's note: x @ w1 + b1 before its GELU; the depthwise bias,
// weights and every tap's accumulator (packed bf16x2 FMAs, in (dy, dx) order);
// x + out before the last GELU; every GELU takes its erf in fp32.
//
// Replaces yolo_sam_inference_tpu/ops/mbconv_fused.py:134 mbconv_block at
// stride 1 (stage 0, and TinyViT's stride-1 merge2). The stride-2 merges
// (merge_fused.py:125) stay on tinyvit_conv.cu's mbconv_kernel, whose
// stride-1 instantiations this kernel replaced.
//
// What bounds it on the H100: at stage 0 (C 64, E 256) a pixel costs 128 KFLOP
// of products for 256 bytes in and out, so the products alone would bound it
// at 0.010 ms for a batch of 32 x 128 x 128 and the bytes at 0.040 ms. What
// sets its pace is the CUDA cores: about 2.7 erf GELUs and 9 depthwise taps
// per expanded value (the expansion over the tile's halo, the depthwise, the
// residual), about 340 erf evaluations a pixel. The first design
// (tinyvit_conv.cu's mbconv_kernel) took 64 output pixels a block with 118 KB of shared memory,
// so one block of 8 warps an SM ran load, expansion, depthwise and projection
// in series, each block streaming all of w1 and w3 through a cp.async ring
// with two block barriers per 32-row tile: 2.2647 ms at stage 0 (fp32) and
// 0.3267 at merge2 on an H100 80GB HBM3 at 700 W.
//
// This design:
//   * a block is WGS warpgroups that never wait for one another: each walks
//     its own 8 x 8 output tiles (a persistent grid, one block an SM), so one
//     warpgroup's CUDA-core stretch (GELUs, depthwise) runs beside another's
//     products and loads;
//   * the weights come by TMA (128-byte swizzle) into shared memory: at
//     stage 0 all of w1 and w3 (64 KB) once per block, shared by its 4
//     warpgroups (RESIDENT); where they do not fit (merge2's 300 KB), each
//     warpgroup streams its own 64-channel E chunks through one w1 slot and
//     one w3 slot, each refilled as soon as its products are done, so a
//     chunk's weights load under the previous chunk's depthwise (2 warpgroups);
//   * per 64-channel E chunk: the expansion over the 10 x 10 halo (two m64
//     tiles, rows past the 100 halo pixels discarded) on wgmma m64n64k16 with
//     A from registers (ldmatrix of the cp.async'd halo tile, zero-filled
//     outside the image) and B, w1's chunk, by descriptor; its bias and GELU
//     into the warpgroup's chunk tile Es (zero outside the image); then the
//     depthwise + GELU computed straight into the projection's A fragments
//     (thread = 2 pixels x 4 channels of each 16-channel k-step, mma.sync's
//     A layout, which wgmma's register form takes), and the projection
//     accumulates h2 @ w3[chunk] on wgmma with B by descriptor; the 4x
//     expanded activation never leaves the chunk tile;
//   * epilogue: bias, the residual from the halo tile, GELU, bf16 stores.
// The halo costs 100 / 64 of the expansion's GELUs.
// Measured on an H100 80GB HBM3 at 700 W (bench/kernel_turns.py, device
// time, batch 32, in turns with the first design): stage 0 0.835 ms (0.772
// in bf16 mode) against 2.00 (1.92); merge2 0.154 (0.148) against 0.27
// (0.26). Variants of this kernel: without any GELU stage 0 took 0.393 ms,
// with one depthwise tap 0.787, without the expansion's products 0.911 (of
// 0.906 then): the erf GELUs set its pace, the products hide. ptxas: 127
// registers at 4 warpgroups, 254 at 2 (Co 320's five accumulator boxes),
// no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int TW = 8, TH = 8;                       // a warpgroup's output tile (m64)
constexpr int IW = TW + 2, IH = TH + 2, PIN = IW * IH;  // its 10 x 10 input halo
constexpr int EC = 64;                              // channels of an E chunk (a TMA box)
constexpr int LDE = EC + 8;                         // chunk tile rows: conflict-free
constexpr int NB_MAX = 5;                           // Co up to 320 (64-column boxes)
constexpr int SMEM_BUDGET = 227 * 1024;             // a block's opt-in maximum on the H100

// Shared memory of a block: 1024 bytes of alignment slack, the weights (all
// of them, or each warpgroup's two slots), each warpgroup's halo and chunk
// tiles, the barriers. ops/mbconv_fused.py:s1_plan mirrors it.
__host__ __device__ inline size_t weight_bytes(bool resident, int wgs, int c, int e, int co) {
  return resident ? 2 * ((size_t)c * e + (size_t)e * co)
                  : (size_t)wgs * 2 * ((size_t)c * EC + (size_t)EC * co);
}
__host__ __device__ inline size_t halo_bytes(int c) { return 2 * (size_t)PIN * (c + 8); }
constexpr size_t CHUNK_BYTES = 2 * (size_t)PIN * LDE;

__host__ __device__ inline size_t s1_smem(bool resident, int wgs, int c, int e, int co) {
  return 1024 + weight_bytes(resident, wgs, c, e, co) + wgs * (halo_bytes(c) + CHUNK_BYTES) +
         2 * wgs * sizeof(uint64_t);
}

struct S1Args {
  const __nv_bfloat16* x;
  const float* b1;
  const float* wd;
  const float* bd;
  const float* b3;
  __nv_bfloat16* out;
  int hgt, wid, c, e, co, tiles_x, tiles_y, tiles;
  int residual, bf16;  // the MBConv's residual and GELU; compute="bf16"
};

// erf(x) in fp32 without a branch, so that a thread's many GELUs interleave:
// x + x P(x^2) for |x| < 0.9, else sign(x) (1 - 2^Q(min(|x|, 4) - 2.45));
// P and Q are least-squares fits of degree 5 and 8, 2^ on the MUFU unit
// (ex2.approx, relative error about 2^-22). ops/mbconv_fused.py ERF_FIT holds
// the same coefficients, and tests/test_torch_tinyvit.py holds the fit within
// 2e-7 of erf (3.1 ulp) evaluated in fp32 with an exact 2^. CUDA's erff
// (within 2 ulp) took stage 0 0.941 ms against this one's 0.838 on the
// device (in one call on an H100 80GB HBM3 at 700 W, bench/kernel_turns.py).
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float erf_fit(float x) {
  const float a = fabsf(x), s = x * x;
  float p = -6.106991787e-04f;
  p = fmaf(p, s, 5.015359726e-03f);
  p = fmaf(p, s, -2.678134292e-02f);
  p = fmaf(p, s, 1.128221229e-01f);
  p = fmaf(p, s, -3.761253059e-01f);
  p = fmaf(p, s, 1.283791512e-01f);
  const float small = fmaf(p, x, x);
  const float u = fminf(a, 4.f) - 2.45f;
  float q = 2.323069111e-06f;
  q = fmaf(q, u, -2.012857476e-05f);
  q = fmaf(q, u, 1.185633591e-04f);
  q = fmaf(q, u, -6.406772882e-04f);
  q = fmaf(q, u, 3.279443365e-03f);
  q = fmaf(q, u, -1.630568318e-02f);
  q = fmaf(q, u, -1.359353185e+00f);
  q = fmaf(q, u, -7.586229801e+00f);
  q = fmaf(q, u, -1.088014221e+01f);
  const float large = copysignf(1.f - ex2_approx(q), x);
  return a < 0.9f ? small : large;
}
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erf_fit(v * 0.70710678118654752f));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int WGS, bool RESIDENT>
__global__ void __launch_bounds__(WGS * 128, 1)
    mbconv_s1_kernel(const __grid_constant__ CUtensorMap map_w1,
                     const __grid_constant__ CUtensorMap map_w3, S1Args p) {
  constexpr int NB = RESIDENT ? 1 : NB_MAX;  // accumulator boxes of 64 output columns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c = p.c, nch = p.e / EC, nbox = p.co / 64, ksx = c / 16, ldx = c + 8;
  const bool bf16 = p.bf16;

  // weights: resident, w1 as E / 64 boxes of C rows and w3 as Co / 64 boxes
  // of E rows; streamed, this warpgroup's w1 slot (one box of C rows) and w3
  // slot (Co / 64 boxes of 64 rows)
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);
  if (!RESIDENT) w1s += (size_t)wg * (c * EC + EC * p.co);
  __nv_bfloat16* w3s = w1s + (RESIDENT ? c * p.e : c * EC);
  const int w3_box = (RESIDENT ? p.e : EC) * 64;  // elements between w3's column boxes
  unsigned char* own = smem + weight_bytes(RESIDENT, WGS, c, p.e, p.co) +
                       wg * (halo_bytes(c) + CHUNK_BYTES);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(own);            // (PIN, C + 8)
  __nv_bfloat16* es = reinterpret_cast<__nv_bfloat16*>(own + halo_bytes(c));  // (PIN, LDE)
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + weight_bytes(RESIDENT, WGS, c, p.e, p.co) + WGS * (halo_bytes(c) + CHUNK_BYTES));
  uint64_t* bar1 = bars + 2 * wg;  // resident: bars[0] holds all the weights
  uint64_t* bar3 = bar1 + 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * WGS; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int gw = blockIdx.x * WGS + wg, nw = gridDim.x * WGS;  // this warpgroup's first tile
  auto load_w1 = [&](int ch) {  // streamed: chunk ch's w1 box into the slot
    mbar_expect_tx(bar1, c * 128);
    tma_load(w1s, &map_w1, bar1, ch * EC, 0);
  };
  auto load_w3 = [&](int ch) {  // streamed: chunk ch's rows of every w3 box
    mbar_expect_tx(bar3, nbox * EC * 128);
    for (int nb = 0; nb < nbox; ++nb) tma_load(w3s + nb * w3_box, &map_w3, bar3, nb * 64, ch * EC);
  };
  if (RESIDENT && threadIdx.x == 0) {
    mbar_expect_tx(&bars[0], (uint32_t)weight_bytes(true, WGS, c, p.e, p.co));
    for (int ch = 0; ch < nch; ++ch) tma_load(w1s + ch * c * 64, &map_w1, &bars[0], ch * EC, 0);
    for (int nb = 0; nb < nbox; ++nb) tma_load(w3s + nb * w3_box, &map_w3, &bars[0], nb * 64, 0);
  }
  if (!RESIDENT && tid == 0 && gw < p.tiles) {
    load_w1(0);
    load_w3(0);
  }

  int use = 0;  // streamed: chunks this warpgroup has taken (the slots' phases)
  for (int tile = gw; tile < p.tiles; tile += nw) {
    const int ox0 = (tile % p.tiles_x) * TW;
    const int oy0 = (tile / p.tiles_x % p.tiles_y) * TH;
    const int b = tile / (p.tiles_x * p.tiles_y);
    const int iy0 = oy0 - 1, ix0 = ox0 - 1;
    const __nv_bfloat16* xb = p.x + (long)b * p.hgt * p.wid * c;
    for (int v = tid; v < PIN * (c / 8); v += 128) {
      const int pix = v / (c / 8), d = (v % (c / 8)) * 8;
      const int y = iy0 + pix / IW, xx = ix0 + pix % IW;
      const bool ok = y >= 0 && y < p.hgt && xx >= 0 && xx < p.wid;
      cp_async16(xs + pix * ldx + d, ok ? xb + ((long)y * p.wid + xx) * c + d : p.x, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    wg_sync(wg);  // the halo tile is in
    if (RESIDENT) mbar_wait(&bars[0], 0);

    float acc[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

    for (int ch = 0; ch < nch; ++ch, ++use) {
      const bool more = ch + 1 < nch || tile + nw < p.tiles;  // streamed: a next chunk to load
      const int next = ch + 1 < nch ? ch + 1 : 0;
      // ---- expansion of the halo: Es = gelu(xs @ w1[:, chunk] + b1)
      if (!RESIDENT) mbar_wait(bar1, use & 1);
      const __nv_bfloat16* wb1 = RESIDENT ? w1s + ch * c * 64 : w1s;
#pragma unroll 1
      for (int mt = 0; mt < 2; ++mt) {
        float ea[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) ea[i] = 0.f;
        const int arow = min(mt * 64 + warp * 16 + (lane & 15), PIN - 1);
        const __nv_bfloat16* ap = xs + arow * ldx + (lane >> 4) * 8;
#pragma unroll 1
        for (int k0 = 0; k0 < ksx; k0 += 4) {  // four k-steps' fragments a group
          uint32_t af[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + i < ksx) ldmatrix_x4(af[i], ap + (k0 + i) * 16);
          fence_acc(ea);
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + i < ksx)
              wgmma_rs_m64n64k16(ea, af[i], smem_desc(wb1 + (k0 + i) * 16 * 64, c * 128, 1024));
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(ea);
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_regs(af[i]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 64 + warp * 16 + g + 8 * h;  // halo pixel
          if (row >= PIN) continue;
          const int y = iy0 + row / IW, xx = ix0 + row % IW;
          const bool in = y >= 0 && y < p.hgt && xx >= 0 && xx < p.wid;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = j * 8 + 2 * t;
            const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b1 + ch * EC + col));
            float a0 = ea[4 * j + 2 * h] + bb.x, a1 = ea[4 * j + 2 * h + 1] + bb.y;
            if (bf16) {
              a0 = round_bf16(a0);
              a1 = round_bf16(a1);
            }
            *reinterpret_cast<uint32_t*>(es + row * LDE + col) =
                in ? pack_bf16(gelu(a0), gelu(a1)) : 0u;
          }
        }
      }
      wg_sync(wg);  // the chunk tile is written; the w1 slot is read
      if (!RESIDENT && tid == 0 && more) load_w1(next);

      // ---- depthwise + GELU into the projection's A fragments: warp w holds
      // output pixels 16 w + g (row 2 w) and 16 w + g + 8 (row 2 w + 1)
      uint32_t hf[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const int lc = ks * 16 + hc * 8 + 2 * t, ech = ch * EC + lc;
          float2 wt[9];
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            wt[tap] = __ldg(reinterpret_cast<const float2*>(p.wd + tap * p.e + ech));
          const float2 bias = __ldg(reinterpret_cast<const float2*>(p.bd + ech));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int oy = 2 * warp + r, ox = g;  // in the tile
            const __nv_bfloat16* src = es + (oy * IW + ox) * LDE + lc;
            float a0, a1;
            if (bf16) {
              __nv_bfloat162 s = __floats2bfloat162_rn(bias.x, bias.y);
#pragma unroll
              for (int tap = 0; tap < 9; ++tap) {
                const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(
                    src + ((tap / 3) * IW + tap % 3) * LDE);
                s = __hfma2(hv, __floats2bfloat162_rn(wt[tap].x, wt[tap].y), s);
              }
              a0 = __low2float(s);
              a1 = __high2float(s);
            } else {
              a0 = bias.x;
              a1 = bias.y;
#pragma unroll
              for (int tap = 0; tap < 9; ++tap) {
                const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    src + ((tap / 3) * IW + tap % 3) * LDE));
                a0 = fmaf(hv.x, wt[tap].x, a0);
                a1 = fmaf(hv.y, wt[tap].y, a1);
              }
            }
            hf[ks][2 * hc + r] = pack_bf16(gelu(a0), gelu(a1));
          }
        }
      }

      // ---- projection: acc += h2 @ w3[chunk rows]
      if (!RESIDENT) mbar_wait(bar3, use & 1);
      const __nv_bfloat16* wb3 = RESIDENT ? w3s + ch * EC * 64 : w3s;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_acc(acc[nb]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          if (nb < nbox)
            wgmma_rs_m64n64k16(acc[nb], hf[ks],
                               smem_desc(wb3 + nb * w3_box + ks * 16 * 64, w3_box * 2, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_acc(acc[nb]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(hf[ks]);
      wg_sync(wg);  // the chunk tile and the w3 slot are read
      if (!RESIDENT && tid == 0 && more) load_w3(next);
    }

    // ---- bias, the residual and GELU (MBConv), bf16 stores
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = warp * 16 + g + 8 * h, oy = oy0 + px / TW, ox = ox0 + px % TW;
      if (oy >= p.hgt || ox >= p.wid) continue;
      __nv_bfloat16* dst = p.out + (((long)b * p.hgt + oy) * p.wid + ox) * p.co;
      const __nv_bfloat16* xr = xs + ((px / TW + 1) * IW + px % TW + 1) * ldx;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb >= nbox) break;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = nb * 64 + j * 8 + 2 * t;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b3 + col));
          float a0 = acc[nb][4 * j + 2 * h] + bb.x, a1 = acc[nb][4 * j + 2 * h + 1] + bb.y;
          if (p.residual) {  // Co == C: x at this pixel is halo pixel (r + 1, c + 1)
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + col));
            a0 = xv.x + a0;
            a1 = xv.y + a1;
            if (bf16) {
              a0 = round_bf16(a0);
              a1 = round_bf16(a1);
            }
            a0 = gelu(a0);
            a1 = gelu(a1);
          }
          *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(a0, a1);
        }
      }
    }
    wg_sync(wg);  // every read of the halo tile is done before the next tile's
  }
}

int num_sms = 0;

template <int WGS, bool RESIDENT>
int launch_s1(const S1Args& p, const void* w1, const void* w3, cudaStream_t st) {
  CUtensorMap map_w1, map_w3;
  cudaError_t err = make_map(&map_w1, w1, p.c, p.e, p.c);  // boxes of 64 columns x C rows
  if (err == cudaSuccess) err = make_map(&map_w3, w3, p.e, p.co, RESIDENT ? p.e : EC);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.tiles + WGS - 1) / WGS;
  const int grid = blocks < num_sms ? blocks : num_sms;  // one block an SM, persistent
  mbconv_s1_kernel<WGS, RESIDENT><<<grid, WGS * 128, s1_smem(RESIDENT, WGS, p.c, p.e, p.co), st>>>(map_w1, map_w3, p);
  return (int)cudaGetLastError();
}

template <int WGS, bool RESIDENT>
cudaError_t allow_s1(int bytes) {
  return cudaFuncSetAttribute(mbconv_s1_kernel<WGS, RESIDENT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Called once, when the library is loaded: the tensor-map encoder, the SM
// count and the kernels' shared memory (up to the card's opt-in maximum).
extern "C" int ysi_mbconv_s1_init(void) {
  cudaError_t err = load_encode_tiled();
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = allow_s1<4, true>(optin);
  if (err == cudaSuccess) err = allow_s1<2, false>(optin);
  return (int)err;
}

// Stride-1 MBConv: C a multiple of 16 up to 256, E and Co multiples of 64,
// Co up to 320. Resident weights (4 warpgroups a block) where Co is one box
// and they fit; else each of 2 warpgroups streams its chunks' weights.
extern "C" int ysi_mbconv_s1(int residual, int bf16, const void* x, const void* w1,
                             const void* b1, const void* wd, const void* bd, const void* w3,
                             const void* b3, void* out, int b, int hgt, int wid, int c, int e,
                             int co, void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || c <= 0 || c % 16 || c > 256 || e <= 0 || e % EC ||
      co <= 0 || co % 64 || co > 64 * NB_MAX || (residual && co != c))
    return (int)cudaErrorInvalidValue;
  S1Args p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.b1 = static_cast<const float*>(b1);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.b3 = static_cast<const float*>(b3);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hgt = hgt;
  p.wid = wid;
  p.c = c;
  p.e = e;
  p.co = co;
  p.tiles_x = (wid + TW - 1) / TW;
  p.tiles_y = (hgt + TH - 1) / TH;
  p.tiles = b * p.tiles_x * p.tiles_y;
  p.residual = residual;
  p.bf16 = bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (co == 64 && e <= 256 && s1_smem(true, 4, c, e, co) <= SMEM_BUDGET)
    return launch_s1<4, true>(p, w1, w3, st);
  if (s1_smem(false, 2, c, e, co) <= SMEM_BUDGET) return launch_s1<2, false>(p, w1, w3, st);
  return (int)cudaErrorInvalidValue;
}
