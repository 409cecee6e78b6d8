// TinyViT window attention with a learned per-offset bias (Hopper, sm_90a).
//
//   qkv (B, H, W, 3C) bf16, the unpadded grid's fused q | k | v, head-major;
//   pad (3C,) bf16, the qkv of a zero pad token (LN(0) Wqkv + b);
//   bias (heads, (2ws-1)^2) bf16, the raw learned table;
//   out (B, H, W, C) bf16, heads concatenated.
//
// The grid is split into ws x ws windows after padding it to window
// multiples; a window that reaches outside the grid reads the pad row there:
// the official TinyViT pads the pre-norm input with zeros and normalises
// after windowing, so pad tokens are real keys. For queries i and keys j of
// one window (local coordinates (qy, qx), (ky, kx)):
//   logit = (q_i * 32^-0.5) . k_j + bias[h][(qy - ky + ws - 1)(2ws - 1) + qx - kx + ws - 1]
// and the softmax runs over the window's ws^2 keys in fp32.
//
// Replaces the attention of tinyvit_window_block and
// tinyvit_window_block_cells (yolo_sam_inference_tpu/ops/tinyvit_attention.py
// :143 and :384). Their LN + qkv prologue and projection + residual epilogue
// are gemm_bf16 launches here (csrc/gemm_bf16.cu). The TPU kernel
// exponentiates bf16 logits; this one keeps exp in fp32.
//
// What bounds it on the H100: per (window, head) it reads 3 x T x 32 bf16
// values and writes T x 32, and does 4 T^2 x 32 flop (T = 49 or 196): about
// 33 flop per byte at ws 7 and 130 at ws 14, under the card's ~295, so it is
// bound by device memory when it runs well. The design: one block per
// (image, window, head), 4 warps. The block gathers its window's Q, K and V
// (32 columns each) into shared memory with cp.async (the pad row where the
// window leaves the grid, zeros for the mma padding of T: 49 -> 64 queries
// and keys, 196 -> 208 queries and 256 keys). Each warp takes 16-query tiles;
// scores, probabilities and the output stay in registers in the mma.sync
// m16n8k16 fragment layout (bf16 in, fp32 accumulation), with an online
// softmax over 64-key tiles (max subtraction, exp2f of log2(e)-scaled
// logits). The bias comes from the raw table in shared memory, indexed per
// (query, key); no (heads, T, T) tensor is gathered (at ws 14 that would be
// 154 KB a head). Keys past T are masked; pad queries are never written.
// The qkv rows of one window are not contiguous, so the gather is the
// costly part; no wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int HD = 32;            // head dim of every TinyViT-5M stage
constexpr int LD = HD + 8;        // bf16 row stride of the Q/K/V tiles (80 B: conflict-free)
constexpr int THREADS = 128;      // 4 warps
constexpr int KTILE = 64;         // keys per online-softmax step
constexpr float LOG2E = 1.4426950408889634f;
constexpr float QK_SCALE = 0.17677669529663687f * LOG2E;  // 32^-0.5, log2 domain

template <int WS>
struct TvGeo {
  static constexpr int T = WS * WS;
  static constexpr int QT = (T + 15) / 16 * 16;            // 64 or 208 query rows
  static constexpr int KT = (T + KTILE - 1) / KTILE * KTILE;  // 64 or 256 key rows
  static constexpr int NB = (2 * WS - 1) * (2 * WS - 1);   // bias table entries
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (QT + 2 * KT) * LD + sizeof(float) * NB;
  static_assert(KT - KTILE < T, "every key tile holds a real key (finite row maxima)");
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layouts: mma_frag.cuh.
template <int WS>
__global__ void __launch_bounds__(THREADS)
    tinyvit_attn_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ pad,
                        const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                        int hgt, int wid, int heads) {
  using G = TvGeo<WS>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + G::QT * LD;
  __nv_bfloat16* Vs = Ks + G::KT * LD;
  float* Bs = reinterpret_cast<float*>(Vs + G::KT * LD);

  const int nwx = (wid + WS - 1) / WS, nwy = (hgt + WS - 1) / WS;
  int bid = blockIdx.x;
  const int h = bid % heads;
  bid /= heads;
  const int wx = bid % nwx;
  bid /= nwx;
  const int wy = bid % nwy;
  const int b = bid / nwy;
  const int c = heads * HD;
  const long c3 = 3L * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // the qkv row of window token i: the grid's, or the pad row outside it
  auto src_row = [&](int i) -> const __nv_bfloat16* {
    const int y = wy * WS + i / WS, x = wx * WS + i % WS;
    if (y < hgt && x < wid) return qkv + (((long)b * hgt + y) * wid + x) * c3;
    return pad;
  };
  for (int v = tid; v < G::QT * (HD / 8); v += THREADS) {
    const int r = v / (HD / 8), d = (v % (HD / 8)) * 8;
    const bool ok = r < G::T;
    cp_async16(Qs + r * LD + d, (ok ? src_row(r) : qkv) + h * HD + d, ok);
  }
  for (int v = tid; v < G::KT * (HD / 8); v += THREADS) {
    const int r = v / (HD / 8), d = (v % (HD / 8)) * 8;
    const bool ok = r < G::T;
    const __nv_bfloat16* row = (ok ? src_row(r) : qkv) + h * HD + d;
    cp_async16(Ks + r * LD + d, row + c, ok);
    cp_async16(Vs + r * LD + d, row + 2 * c, ok);
  }
  cp_async_commit();
  for (int i = tid; i < G::NB; i += THREADS)
    Bs[i] = __bfloat162float(bias[(long)h * G::NB + i]) * LOG2E;
  cp_async_wait<0>();
  __syncthreads();

  for (int mt = warp; mt < G::QT / 16; mt += THREADS / 32) {
    const int r0 = mt * 16;
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const __nv_bfloat16* q = Qs + (r0 + g) * LD + ks * 16 + 2 * t;
      qa[ks][0] = ld32(q);
      qa[ks][1] = ld32(q + 8 * LD);
      qa[ks][2] = ld32(q + 8);
      qa[ks][3] = ld32(q + 8 * LD + 8);
    }
    // rows A = r0 + g, B = r0 + g + 8 (pad queries clamp to a real one: never written)
    const int qia = min(r0 + g, G::T - 1), qib = min(r0 + g + 8, G::T - 1);
    const int ba = (qia / WS + WS - 1) * (2 * WS - 1) + qia % WS + WS - 1;
    const int bb = (qib / WS + WS - 1) * (2 * WS - 1) + qib % WS + WS - 1;

    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int kt = 0; kt < G::KT / KTILE; ++kt) {
      const __nv_bfloat16* Kt = Ks + kt * KTILE * LD;
      const __nv_bfloat16* Vt = Vs + kt * KTILE * LD;
      float sc[KTILE / 8][4];
#pragma unroll
      for (int n = 0; n < KTILE / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const __nv_bfloat16* kp = Kt + (n * 8 + g) * LD + ks * 16 + 2 * t;
          mma16816(sc[n], qa[ks], ld32(kp), ld32(kp + 8));
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < KTILE / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = kt * KTILE + n * 8 + 2 * t + e;
          if (j < G::T) {
            // offset code of (query, key) = code(query) - code(key) + the centre's
            const int kc = (j / WS) * (2 * WS - 1) + j % WS;
            sc[n][e] = fmaf(sc[n][e], QK_SCALE, Bs[ba - kc]);
            sc[n][2 + e] = fmaf(sc[n][2 + e], QK_SCALE, Bs[bb - kc]);
          } else {
            sc[n][e] = sc[n][2 + e] = -INFINITY;
          }
          mx_a = fmaxf(mx_a, sc[n][e]);
          mx_b = fmaxf(mx_b, sc[n][2 + e]);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);  // 0 on the first tile
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < KTILE / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = exp2f(sc[n][e] - mn_a);
          sc[n][2 + e] = exp2f(sc[n][2 + e] - mn_b);
          sum_a += sc[n][e];
          sum_b += sc[n][2 + e];
        }
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
      }
      // O += P V: score fragments of n-tiles 2ks, 2ks + 1 are k-step ks's A fragment
#pragma unroll
      for (int ks = 0; ks < KTILE / 16; ++ks) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sc[2 * ks][0], sc[2 * ks][1]);
        pa[1] = pack_bf16(sc[2 * ks][2], sc[2 * ks][3]);
        pa[2] = pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
        pa[3] = pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t vb[4];
          const int key = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(vb, Vt + key * LD + np * 16 + (lane >> 4) * 8);
          mma16816(o[2 * np], pa, vb[0], vb[1]);
          mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }

    // normalise into this tile's own rows of Qs (read only by this warp), then
    // store 16 B per lane for the real queries inside the grid
    const float inv_a = 1.f / quad_sum(l_a), inv_b = 1.f / quad_sum(l_b);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      __nv_bfloat16* p = Qs + (r0 + g) * LD + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[n][0] * inv_a, o[n][1] * inv_a);
      *reinterpret_cast<uint32_t*>(p + 8 * LD) = pack_bf16(o[n][2] * inv_b, o[n][3] * inv_b);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * HD / 8 / 32; ++i) {
      const int v = lane + 32 * i;
      const int r = v / (HD / 8), d = (v % (HD / 8)) * 8;
      const int q = r0 + r;
      const int y = wy * WS + q / WS, x = wx * WS + q % WS;
      if (q < G::T && y < hgt && x < wid)
        *reinterpret_cast<uint4*>(out + (((long)b * hgt + y) * wid + x) * c + h * HD + d) =
            *reinterpret_cast<const uint4*>(Qs + q * LD + d);
    }
    __syncwarp();
  }
}

template <int WS>
int launch(const void* qkv, const void* pad, const void* bias, void* out, int b, int hgt, int wid,
           int heads, cudaStream_t stream) {
  const long blocks = (long)b * ((hgt + WS - 1) / WS) * ((wid + WS - 1) / WS) * heads;
  tinyvit_attn_kernel<WS><<<(unsigned)blocks, THREADS, TvGeo<WS>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(pad),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), hgt, wid, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once, when the library is loaded: ws 14 takes 61 KB of shared memory.
extern "C" int ysi_tinyvit_attn_init(void) {
  cudaError_t err = cudaFuncSetAttribute(tinyvit_attn_kernel<7>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TvGeo<7>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tinyvit_attn_kernel<14>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)TvGeo<14>::SMEM);
  return (int)err;
}

extern "C" int ysi_tinyvit_attn(const void* qkv, const void* pad, const void* bias, void* out,
                                int b, int hgt, int wid, int heads, int ws, void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws == 7) return launch<7>(qkv, pad, bias, out, b, hgt, wid, heads, st);
  if (ws == 14) return launch<14>(qkv, pad, bias, out, b, hgt, wid, heads, st);
  return (int)cudaErrorInvalidValue;
}
