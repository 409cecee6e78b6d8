// TinyViT's MBConv block and its patch merges (Hopper, sm_90a): stage 0's
// blocks with the residual and the stride-1 merge2 without it (K14), and the
// stride-2 merges merge0 and merge1 (K15), on one kernel.
//
// mbconv_kernel<S, ...>, for x (B, H, W, C) bf16, w1 (C, E) and w3 (E, Co)
// bf16 in the JAX (in, out) layout, wd (3, 3, E) and the biases fp32:
//   h1  = gelu(x @ w1 + b1)               rounded to bf16; zero outside the image
//   h2  = gelu(dw3x3_S(h1) + bd)          zero 'same' padding, fp32 taps, bf16
//   out = h2 @ w3 + b3, then gelu(x + out) with the residual (S 1, Co == C)
// GELU is the exact erf form (erf in fp32 by erf_fit below). bf16 is the JAX kernels' compute="bf16"
// (mbconv_fused.py:68-72, :94, :108-114, :126; merge_fused.py:65), rounding
// to bf16 where they do: x @ w1 + b1 before its GELU; the depthwise bias,
// weights and every tap's accumulator (packed bf16x2 FMAs, in (dy, dx) order:
// the CUDA cores' bf16x2 rate is twice their fp32 rate); x + out before the
// last GELU; every GELU takes its erf in fp32 on its bf16-rounded input and
// rounds its output to bf16; the products keep their fp32 accumulation.
//
// Replaces yolo_sam_inference_tpu/ops/mbconv_fused.py:134 mbconv_block
// (stride 1: stage 0, and TinyViT's stride-1 merge2) and
// yolo_sam_inference_tpu/ops/merge_fused.py:125 patch_merge_block (stride 2:
// merge0, merge1). Both first ran on tinyvit_conv.cu's mbconv_kernel
// (mma.sync, one block of 8 warps a 4 x 8 or 8 x 8 tile), which this kernel
// replaced, the stride-1 forms first and the stride-2 ones after.
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
// The halo costs 100 / 64 of the expansion's GELUs at stride 1.
//
// At stride 2 (K15) the same kernel takes an 8 x 8 tile of output pixels and
// its 17 x 17 input halo (289 pixels, five m64 expansion tiles: 289 / 64 of
// the expansion's GELUs, which the halo of a stride-2 tile needs); the
// depthwise reads every other pixel of the chunk tile. The expansion's A
// fragments come straight from device memory (L1 and L2 hold the halo),
// not from a halo tile, so more warpgroups fit beside the chunk tiles:
// merge0 (C 64, E Co 128) runs 3 warpgroups a block on resident weights
// (178 KB), merge1 (C 128, E Co 160) 2 (207 KB); the first version of this
// kernel, with the halo tile in shared memory, fitted 2 and 1 and took 0.338
// and 0.230 ms (device time, the card below). C is compiled in at both (the wgmma then sit on no path
// ptxas must treat as divergent, which serialises them). Measured
// (bench/kernel_turns.py, device time, batch 32, in turns with the first
// design; NVIDIA H100 80GB HBM3, 700.00 W): merge0 0.2870-0.2909 ms (bf16
// mode 0.2836-0.2840) against 0.3753-0.3761 (0.3733-0.3735), merge1
// 0.1307-0.1310 (0.1285-0.1290) against 0.2399-0.2412 (0.2410-0.2420).
// ptxas: 168 registers at merge0, 223 at merge1, no spill. Merge1's E and Co of
// 160 are not whole 64-channel boxes: TMA fills the last box past the matrix
// with zeros, its GELUs and depthwise are skipped, so a tail of 32 channels
// costs products only. What bounds K15 is what bounds K14: its erf GELUs
// (about 93 M a call at merge0, 29 M at merge1) and the latency each
// warpgroup's phases leave uncovered.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int TW = 8, TH = 8;            // a warpgroup's output tile (m64)
constexpr int EC = 64;                   // channels of an E chunk (a TMA box)
constexpr int NB_MAX = 5;                // Co up to 320 (64-column boxes)
constexpr int SMEM_BUDGET = 227 * 1024;  // a block's opt-in maximum on the H100

// A tile's input halo at stride S (10 x 10 at stride 1, 17 x 17 at 2: a
// stride-2 'same' 3x3 reads only the top and left padding), its m64 tiles of
// the expansion, and the chunk tile's row stride (bf16): 72 at stride 1; 76 at
// stride 2, where the depthwise's lanes read every other pixel and 72 would
// put two of them on one bank.
template <int S>
struct Geo {
  static constexpr int IW = (TW - 1) * S + 3, IH = (TH - 1) * S + 3, PIN = IW * IH;
  static constexpr int MTH = (PIN + 63) / 64;
  static constexpr int LDE = S == 1 ? EC + 8 : EC + 12;
};

__host__ __device__ inline int pad64(int v) { return (v + 63) / 64 * 64; }

// Shared memory of a block: 1024 bytes of alignment slack, the weights (all
// of them, or each warpgroup's two slots), each warpgroup's halo and chunk
// tiles, the barriers. E and Co count in 64-channel boxes (TMA fills a box
// past the matrix with zeros). ops/mbconv_fused.py:s1_plan and s2_plan
// mirror it.
__host__ __device__ inline size_t weight_bytes(bool resident, int wgs, int c, int e, int co) {
  return resident ? 2 * ((size_t)c * pad64(e) + (size_t)pad64(e) * pad64(co))
                  : (size_t)wgs * 2 * ((size_t)c * EC + (size_t)EC * pad64(co));
}
// (each rounded up to 16 bytes: the next tile's cp.async and ldmatrix rows).
// At stride 2 the expansion reads x straight from device memory (L1 and L2
// hold a tile's 17 x 17 halo): no halo tile, so more warpgroups fit.
template <int S>
__host__ __device__ inline size_t halo_bytes(int c) {
  return S == 2 ? 0 : (2 * (size_t)Geo<S>::PIN * (c + 8) + 15) / 16 * 16;
}
template <int S>
__host__ __device__ inline size_t chunk_bytes() {
  return (2 * (size_t)Geo<S>::PIN * Geo<S>::LDE + 15) / 16 * 16;
}

template <int S>
__host__ __device__ inline size_t conv_smem(bool resident, int wgs, int c, int e, int co) {
  return 1024 + weight_bytes(resident, wgs, c, e, co) +
         wgs * (halo_bytes<S>(c) + chunk_bytes<S>()) + 2 * wgs * sizeof(uint64_t);
}

struct ConvArgs {
  const __nv_bfloat16* x;
  const float* b1;
  const float* wd;
  const float* bd;
  const float* b3;
  __nv_bfloat16* out;
  int hgt, wid, ho, wo, c, e, co, tiles_x, tiles_y, tiles;
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

template <int S, int WGS, bool RESIDENT, int NB, int CT>
__global__ void __launch_bounds__(WGS * 128, 1)
    mbconv_kernel(const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_w3, ConvArgs p) {
  using G = Geo<S>;
  constexpr int IW = G::IW, PIN = G::PIN, LDE = G::LDE;
  // NB: accumulator boxes of 64 output columns (at least Co / 64, exactly at
  // stride 2); CT: C compiled in at stride 2, 0 (C from p) at stride 1
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c = CT > 0 ? CT : p.c, ep = pad64(p.e), nch = ep / EC, nbox = pad64(p.co) / 64;
  const int ksx = c / 16;
  const int ldx = c + 8;
  const bool bf16 = p.bf16;

  // weights: resident, w1 as E / 64 boxes of C rows and w3 as Co / 64 boxes
  // of E rows; streamed, this warpgroup's w1 slot (one box of C rows) and w3
  // slot (Co / 64 boxes of 64 rows); E and Co rounded up to 64 (zero-filled)
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem);
  if (!RESIDENT) w1s += (size_t)wg * (c * EC + EC * nbox * 64);
  __nv_bfloat16* w3s = w1s + (RESIDENT ? c * ep : c * EC);
  const int w3_box = (RESIDENT ? ep : EC) * 64;  // elements between w3's column boxes
  const size_t wbytes = weight_bytes(RESIDENT, WGS, c, p.e, p.co);
  unsigned char* own = smem + wbytes + wg * (halo_bytes<S>(c) + chunk_bytes<S>());
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(own);                     // (PIN, C + 8)
  __nv_bfloat16* es = reinterpret_cast<__nv_bfloat16*>(own + halo_bytes<S>(c));  // (PIN, LDE)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + wbytes +
                                               WGS * (halo_bytes<S>(c) + chunk_bytes<S>()));
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
    mbar_expect_tx(&bars[0], (uint32_t)wbytes);
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
    const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
    const __nv_bfloat16* xb = p.x + (long)b * p.hgt * p.wid * c;
    if constexpr (S == 1) {
      for (int v = tid; v < PIN * (c / 8); v += 128) {
        const int pix = v / (c / 8), d = (v % (c / 8)) * 8;
        const int y = iy0 + pix / IW, xx = ix0 + pix % IW;
        const bool ok = y >= 0 && y < p.hgt && xx >= 0 && xx < p.wid;
        cp_async16(xs + pix * ldx + d, ok ? xb + ((long)y * p.wid + xx) * c + d : p.x, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      wg_sync(wg);  // the halo tile is in
    }
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
      for (int mt = 0; mt < G::MTH; ++mt) {
        float ea[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) ea[i] = 0.f;
        const int arow = min(mt * 64 + warp * 16 + (lane & 15), PIN - 1);
        const __nv_bfloat16* ap = xs + arow * ldx + (lane >> 4) * 8;
        if constexpr (S == 2) {  // C compiled in: no wgmma on a divergent path
          constexpr int KSX = CT / 16;
          // stride 2: this thread's two halo pixels (rows g, g + 8 of its
          // warp's 16) from device memory, zero outside the image; a fragment
          // is mma.sync's A layout: (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
          const int pa = min(mt * 64 + warp * 16 + g, PIN - 1), pb = min(pa + 8, PIN - 1);
          const int ya = iy0 + pa / IW, xa = ix0 + pa % IW, yb = iy0 + pb / IW, xb2 = ix0 + pb % IW;
          const bool oka = ya >= 0 && ya < p.hgt && xa >= 0 && xa < p.wid;
          const bool okb = yb >= 0 && yb < p.hgt && xb2 >= 0 && xb2 < p.wid;
          const __nv_bfloat16* ra = (oka ? xb + ((long)ya * p.wid + xa) * c : p.x) + 2 * t;
          const __nv_bfloat16* rb = (okb ? xb + ((long)yb * p.wid + xb2) * c : p.x) + 2 * t;
          auto load_a = [&](uint32_t(&a)[4], int k) {
            const uint32_t v0 = __ldg(reinterpret_cast<const unsigned*>(ra + k));
            const uint32_t v1 = __ldg(reinterpret_cast<const unsigned*>(rb + k));
            const uint32_t v2 = __ldg(reinterpret_cast<const unsigned*>(ra + k + 8));
            const uint32_t v3 = __ldg(reinterpret_cast<const unsigned*>(rb + k + 8));
            a[0] = oka ? v0 : 0u;
            a[1] = okb ? v1 : 0u;
            a[2] = oka ? v2 : 0u;
            a[3] = okb ? v3 : 0u;
          };
#pragma unroll
          for (int k0 = 0; k0 < KSX; k0 += 4) {
            uint32_t af[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (k0 + i < KSX) load_a(af[i], (k0 + i) * 16);
            fence_acc(ea);
            wgmma_fence();
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (k0 + i < KSX)
                wgmma_rs_m64n64k16(ea, af[i], smem_desc(wb1 + (k0 + i) * 16 * 64, CT * 128, 1024));
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(ea);
#pragma unroll
            for (int i = 0; i < 4; ++i) fence_regs(af[i]);
          }
        } else {
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
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 64 + warp * 16 + g + 8 * h;  // halo pixel
          if (row >= PIN) continue;
          const int y = iy0 + row / IW, xx = ix0 + row % IW;
          const bool in = y >= 0 && y < p.hgt && xx >= 0 && xx < p.wid;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // branch-free, so that the 16 GELUs of a row interleave; zero
            // outside the image and past E (stride 2's tail box, whose bias
            // read is clamped inside b1)
            const int col = j * 8 + 2 * t, ech = ch * EC + col;
            const bool keep = in && (S == 1 || ech < p.e);
            const float2 bb = __ldg(reinterpret_cast<const float2*>(
                p.b1 + (S == 1 ? ech : min(ech, p.e - 2))));
            float a0 = ea[4 * j + 2 * h] + bb.x, a1 = ea[4 * j + 2 * h + 1] + bb.y;
            if (bf16) {
              a0 = round_bf16(a0);
              a1 = round_bf16(a1);
            }
            *reinterpret_cast<uint32_t*>(es + row * LDE + col) =
                keep ? pack_bf16(gelu(a0), gelu(a1)) : 0u;
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
          if (S == 2 && ech >= p.e) {  // a channel past E (zero-filled w3 rows)
            hf[ks][2 * hc] = hf[ks][2 * hc + 1] = 0u;
            continue;
          }
          float2 wt[9];
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            wt[tap] = __ldg(reinterpret_cast<const float2*>(p.wd + tap * p.e + ech));
          const float2 bias = __ldg(reinterpret_cast<const float2*>(p.bd + ech));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int oy = 2 * warp + r, ox = g;  // in the tile
            const __nv_bfloat16* src = es + (oy * S * IW + ox * S) * LDE + lc;
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
          if (S == 2 || nb < nbox)
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
      if (oy >= p.ho || ox >= p.wo) continue;
      __nv_bfloat16* dst = p.out + (((long)b * p.ho + oy) * p.wo + ox) * p.co;
      const __nv_bfloat16* xr = xs + ((px / TW + 1) * IW + px % TW + 1) * ldx;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb >= nbox) break;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = nb * 64 + j * 8 + 2 * t;
          if (S == 2 && col >= p.co) continue;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b3 + col));
          float a0 = acc[nb][4 * j + 2 * h] + bb.x, a1 = acc[nb][4 * j + 2 * h + 1] + bb.y;
          if (S == 1 && p.residual) {  // Co == C: x at this pixel is halo pixel (r + 1, c + 1)
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

template <int S, int WGS, bool RESIDENT, int NB, int CT = 0>
int launch_conv(const ConvArgs& p, const void* w1, const void* w3, cudaStream_t st) {
  CUtensorMap map_w1, map_w3;
  cudaError_t err = make_map(&map_w1, w1, p.c, p.e, p.c);  // boxes of 64 columns x C rows
  if (err == cudaSuccess) err = make_map(&map_w3, w3, p.e, p.co, RESIDENT ? pad64(p.e) : EC);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.tiles + WGS - 1) / WGS;
  const int grid = blocks < num_sms ? blocks : num_sms;  // one block an SM, persistent
  mbconv_kernel<S, WGS, RESIDENT, NB, CT>
      <<<grid, WGS * 128, conv_smem<S>(RESIDENT, WGS, p.c, p.e, p.co), st>>>(map_w1, map_w3, p);
  return (int)cudaGetLastError();
}

template <int S, int WGS, bool RESIDENT, int NB, int CT = 0>
cudaError_t allow_conv(int bytes) {
  return cudaFuncSetAttribute(mbconv_kernel<S, WGS, RESIDENT, NB, CT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

ConvArgs conv_args(int s, int residual, int bf16, const void* x, const void* b1, const void* wd,
                   const void* bd, const void* b3, void* out, int b, int hgt, int wid, int c,
                   int e, int co) {
  ConvArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.b1 = static_cast<const float*>(b1);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.b3 = static_cast<const float*>(b3);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hgt = hgt;
  p.wid = wid;
  p.ho = hgt / s;
  p.wo = wid / s;
  p.c = c;
  p.e = e;
  p.co = co;
  p.tiles_x = (p.wo + TW - 1) / TW;
  p.tiles_y = (p.ho + TH - 1) / TH;
  p.tiles = b * p.tiles_x * p.tiles_y;
  p.residual = residual;
  p.bf16 = bf16;
  return p;
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
  if (err == cudaSuccess) err = allow_conv<1, 4, true, 1>(optin);
  if (err == cudaSuccess) err = allow_conv<1, 2, false, NB_MAX>(optin);
  if (err == cudaSuccess) err = allow_conv<2, 3, true, 2, 64>(optin);
  if (err == cudaSuccess) err = allow_conv<2, 2, true, 3, 128>(optin);
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
  const ConvArgs p = conv_args(1, residual, bf16, x, b1, wd, bd, b3, out, b, hgt, wid, c, e, co);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (co == 64 && e <= 256 && conv_smem<1>(true, 4, c, e, co) <= SMEM_BUDGET)
    return launch_conv<1, 4, true, 1>(p, w1, w3, st);
  if (conv_smem<1>(false, 2, c, e, co) <= SMEM_BUDGET)
    return launch_conv<1, 2, false, NB_MAX>(p, w1, w3, st);
  return (int)cudaErrorInvalidValue;
}

// Stride-2 patch merge (no residual), at TinyViT-5M's merge widths: even H
// and W, E a multiple of 32 up to 256 (a last box of 32 channels is
// zero-filled to 64), resident weights and C compiled in: 3 warpgroups a
// block at merge0's C 64 with Co in (64, 128], 2 at merge1's C 128 with Co in
// (128, 192]. Other widths are refused.
extern "C" int ysi_patch_merge(int bf16, const void* x, const void* w1, const void* b1,
                               const void* wd, const void* bd, const void* w3, const void* b3,
                               void* out, int b, int hgt, int wid, int c, int e, int co,
                               void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || hgt % 2 || wid % 2 || e <= 0 || e % 32 || co <= 0 ||
      co % 32)
    return (int)cudaErrorInvalidValue;
  const ConvArgs p = conv_args(2, 0, bf16, x, b1, wd, bd, b3, out, b, hgt, wid, c, e, co);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbox = pad64(co) / 64;
  if (c == 64 && nbox == 2 && pad64(e) <= 256 && conv_smem<2>(true, 3, c, e, co) <= SMEM_BUDGET)
    return launch_conv<2, 3, true, 2, 64>(p, w1, w3, st);
  if (c == 128 && nbox == 3 && pad64(e) <= 256 && conv_smem<2>(true, 2, c, e, co) <= SMEM_BUDGET)
    return launch_conv<2, 2, true, 3, 128>(p, w1, w3, st);
  return (int)cudaErrorInvalidValue;
}
