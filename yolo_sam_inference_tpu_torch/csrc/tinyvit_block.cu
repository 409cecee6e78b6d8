// TinyViT's window attention block as one kernel (Hopper, sm_90a).
//
//   x (B, H, W, C) bf16, the block's pre-norm input;
//   wqkv_t (3C, C) bf16, the qkv projection transposed, its rows in head
//     slabs: [q_h | k_h | v_h] (96 output channels) for h = 0..heads - 1;
//   wproj_t (C, C) bf16, the output projection transposed;
//   table (heads, (2ws-1)^2) fp32, the learned per-offset bias;
//   LN scale and shift, bqkv (3C, JAX's q | k | v order), bproj fp32;
//   out (B, H, W, C) bf16 = x + proj(attn(LN(pad(x)))).
//
// The grid is padded with zero tokens to window multiples and split into
// ws x ws windows (head dim 32; TinyViT-5M's stage 1, C 128 at ws 7, and
// stage 2, C 160 at ws 14, each a kernel instantiation).
// A pad token's LN is the LN shift (a zero row), so it is a real key, as in
// the official TinyViT, which pads the pre-norm input and normalises after
// windowing. For queries i and keys j of a window:
//   logit = (q_i * 32^-0.5) . k_j + bias[h][(qy - ky + ws - 1)(2ws - 1) + qx - kx + ws - 1]
// with the softmax over the window's ws^2 keys in fp32 (exp and the bias
// too). Rounded to bf16 where the JAX kernel rounds: LN(x), qkv, the
// concatenated heads, and the projection (+ bias) before the residual.
//
// Replaces yolo_sam_inference_tpu/ops/tinyvit_attention.py:143
// tinyvit_window_block and :384 tinyvit_window_block_cells: the whole block,
// which the TPU kernel computes in one pass with qkv and the attention output
// in VMEM. The first port (tinyvit_attn.cu) ran it as four launches: an LN
// pass, gemm_bf16 for qkv, the attention, gemm_bf16 for the projection with
// the residual, with qkv (3C wide) and the attention output going to device
// memory and back (at stage 1, batch 32, 100 MB of qkv alone, where the block
// needs 67 MB in and out).
//
// What bounds it on the H100: a real token costs 8 C^2 flop of products (qkv
// and the projection) and, as a query against the window's T = ws^2 keys,
// 4 T hd flop a head of attention, for 4 C bytes in and out (pad tokens are
// keys only): at batch 32 the operations bound it at 0.0207 / 0.0109 / 0.0292
// ms (stages 1 / 2 / 3, chip_smoke.py's count) and the bytes at 0.0201 /
// 0.0063 / 0.0128.
// What it has to beat is latency: small products (64 rows a window tile, K
// of 128-320), a softmax per (window, head) and the loads of each window's
// tokens.
//
// The design: a persistent grid of blocks, one an SM, the widths
// compile-time (no wgmma on a path ptxas must treat as divergent: that
// serialises them). The weights (K-major: each output channel's C inputs
// contiguous) come by TMA (128-byte swizzle) in boxes of 64 input channels:
// a head's slab [q | k | v] (96 rows), a projection chunk (64 rows).
//   * ws 7 (tinyvit_block_kernel, stage 1): 2 warpgroups, each walking its
//     own windows; all of Wqkv and Wproj (128 KB) loaded once a block.
//   * ws 14 (tinyvit_block_coop_kernel, stage 2): both warpgroups on one
//     window (174 KB of tiles: one window a block): the gather and the LN
//     split by rows, qkv by m64 tile, the attention and the projection by
//     the window's real query tiles in turn; the weights in rounds (a slab or
//     a projection chunk) that thread 0 issues after the block barrier
//     ending the previous round, so a slab loads under the previous head's
//     attention.
// Stage 3 (C 320 at ws 7) keeps the first design's three launches
// (ops/tinyvit_attention.py): a form of this kernel with 2 warpgroups on
// their own windows, streaming the 820 KB of weights through a ring of 12 KB
// slots, took 0.2527-0.2576 ms there against their 0.2401-0.2404 (device
// time, batch 32, in turns; NVIDIA H100 80GB HBM3, 700.00 W).
// Measured (bench/kernel_turns.py, device time, batch 32, in turns; NVIDIA
// H100 80GB HBM3, 700.00 W): stage 1 0.2315-0.2340 ms, stage 2 0.1973-0.2011
// (an earlier form with C and the slot count at run time: 0.2341-0.2353,
// 0.1959-0.1976; the three launches this kernel replaced took 0.3655-0.3671
// and 0.2535-0.2536 in turns with that form). What holds it: a window's
// phases run in series in its warpgroup, each wgmma group waited for, 8
// warps an SM. ptxas: 172 registers (ws 7), 255 (ws 14), no spill.
// Per window:
//   * its tokens (zero outside the grid) by cp.async into the LN tile,
//     normalised in place (a quad a row, fp32 statistics);
//   * per head: [q | k | v] = LN(x) @ slab + b on wgmma m64n96k16, A from
//     registers (ldmatrix of the LN tile), B the slab by descriptor, an m64
//     tile at a time (rows past the window's tokens repeat its last row), a
//     K chunk's group issued while the previous one runs; k and q into a
//     128-byte-swizzled QK tile (a key row = k | q), v transposed into a V^T
//     tile, both in bf16;
//   * per query tile (pad-only tiles skipped; their tokens stay keys): S =
//     q k^T over all keys of the window in one wgmma (N = 56 or 200, the key
//     count rounded up to 8), q by ldmatrix from the QK tile; the bias from
//     the raw table in shared memory (fp32); the softmax in registers in one
//     pass (exp2 of log2(e)-scaled logits); P V on wgmma with P from
//     registers (K = 64 or 208) and V^T by descriptor; the head's 32 output
//     columns, normalised, into the O tile in bf16;
//   * after the last head: O @ Wproj on wgmma (64-column chunks), + bproj,
//     rounded, + x re-read from L2, stores of the real tokens only.
// qkv and the attention output never leave the chip.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int HD = 32;                   // head dim of every TinyViT-5M stage
constexpr int QKV_BOX = 3 * HD * 128;    // a slab's 64-channel K chunk: 96 rows x 128 B
constexpr int PRJ_BOX = 64 * 128;        // a projection box: 64 outputs x 64 inputs
constexpr int SLOT = QKV_BOX;            // a weight slot holds either
constexpr int SMEM_BUDGET = 227 * 1024;  // a block's opt-in maximum on the H100
constexpr float LOG2E = 1.4426950408889634f;
constexpr float QK_SCALE = 0.17677669529663687f * LOG2E;  // 32^-0.5, log2 domain

template <int WS>
struct Win {
  static constexpr int T = WS * WS;                // tokens: 49, 196
  static constexpr int MT = (T + 63) / 64;         // m64 tiles: 1, 4
  static constexpr int NS = (T + 7) / 8 * 8;       // score columns (keys): 56, 200
  static constexpr int KPV = (T + 15) / 16 * 16;   // P.V depth: 64, 208
  static constexpr int NB = (2 * WS - 1) * (2 * WS - 1);  // bias table entries a head
  static constexpr int QK_BYTES = NS * 128;        // QK tile: a key row = k | q
  static constexpr int VT_BYTES = (KPV + 63) / 64 * HD * 128;  // V^T: 64-key chunks
};

// Shared memory of a block (ops/tinyvit_attention.py block_plan mirrors it):
// 1024 bytes of alignment slack, the weights (all boxes, or a round's
// slots), a set of QK, V^T, LN and O tiles (rounded up to 1024 bytes) for
// each window in flight, the bias table, the barriers. Resident: 2 windows
// in flight (a warpgroup each), one barrier; else 1 window, kch slots with a
// barrier pair each.
template <int WS, int C, bool RESIDENT>
struct Plan {
  using W = Win<WS>;
  static constexpr int HEADS = C / HD, KCH = (C + 63) / 64;
  static constexpr int SETS = RESIDENT ? 2 : 1, SLOTS = RESIDENT ? 0 : KCH;
  static constexpr size_t WEIGHTS = RESIDENT ? (size_t)HEADS * KCH * QKV_BOX +
                                                   (size_t)KCH * KCH * PRJ_BOX
                                             : (size_t)SLOTS * SLOT;
  static constexpr size_t TILES =
      (W::QK_BYTES + W::VT_BYTES + (size_t)4 * W::T * (C + 8) + 1023) / 1024 * 1024;
  static constexpr size_t TABLE = ((size_t)HEADS * W::NB * 4 + 15) / 16 * 16;
  static constexpr size_t SMEM =
      1024 + WEIGHTS + SETS * TILES + TABLE + (RESIDENT ? 1 : 2 * SLOTS) * sizeof(uint64_t);
  static_assert(SMEM <= SMEM_BUDGET, "a block's tiles and weights exceed shared memory");
};

struct BlockArgs {
  const __nv_bfloat16* x;
  const float* table;  // (heads, NB)
  const float* ln_s;
  const float* ln_b;
  const float* bqkv;   // (3C): q | k | v
  const float* bproj;  // (C)
  __nv_bfloat16* out;
  int hgt, wid, nwx, nwy, windows;
  float eps;
};

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void st32(void* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }

// Byte offset of 16-byte unit u of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

// Whether m64 query tile mt of a window holds a query inside the grid (the
// window's first `rows` rows and `cols` columns are).
template <int WS>
__device__ __forceinline__ bool real_tile(int mt, int rows, int cols) {
  const int i0 = mt * 64, i1 = min(i0 + 64, Win<WS>::T) - 1;
  const int r0 = i0 / WS, r1 = i1 / WS;
  return r0 < rows && (i0 % WS < cols || (r0 + 1 <= r1 && r0 + 1 < rows));
}

// acc (64 x N) += A (64 rows of a tile at ap, KSX 16-channel k-steps) @ B^T,
// B in 64-channel K-chunk boxes (box(kc), K-major): a wgmma group a chunk,
// the next chunk's fragments loaded and its group issued while the previous
// group runs (two fragment buffers); every product is done on return. The
// widths are compile-time, so no wgmma sits on a path ptxas must treat as
// divergent (which serialises them).
template <int N, int KSX, class Box>
__device__ __forceinline__ void k_chunks(float (&acc)[N / 2], const __nv_bfloat16* ap, Box box) {
  constexpr int KCH = (KSX + 3) / 4;
  uint32_t af[2][4][4];
  fence_acc(acc);
#pragma unroll
  for (int kc = 0; kc < KCH; ++kc) {
    const unsigned char* wb = box(kc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kc * 4 + i < KSX) ldmatrix_x4(af[kc & 1][i], ap + (kc * 4 + i) * 16);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kc * 4 + i < KSX)
        wgmma_rs_k<N>(acc, af[kc & 1][i], smem_desc(wb + i * 32, 16, 1024));
    wgmma_commit();
    if (kc > 0) {
      wgmma_wait<1>();  // chunk kc - 1's group is done: its fragments are free
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_regs(af[(kc - 1) & 1][i]);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fence_regs(af[0][i]);
    fence_regs(af[1][i]);
  }
}

// A consumer's tiles for one window: QK (NS rows of 128 B, k | q, swizzled),
// V^T (32 rows of 64-key chunks, swizzled), the LN tile and the O tile
// (T x (C + 8) bf16 each).
struct Tiles {
  unsigned char* qk;
  unsigned char* vt;
  __nv_bfloat16* xs;
  __nv_bfloat16* os;
};

template <int WS, int C>
__device__ __forceinline__ Tiles tiles_at(unsigned char* base) {
  Tiles tl;
  tl.qk = base;
  tl.vt = base + Win<WS>::QK_BYTES;
  tl.xs = reinterpret_cast<__nv_bfloat16*>(tl.vt + Win<WS>::VT_BYTES);
  tl.os = tl.xs + Win<WS>::T * (C + 8);
  return tl;
}

// A window's place in the grid: image, window row and column, and how many
// of its rows and columns lie inside the grid.
struct Window {
  int b, wy, wx, rows, cols;
};

template <int WS>
__device__ __forceinline__ Window window_at(const BlockArgs& p, int win) {
  Window w;
  w.wx = win % p.nwx;
  w.wy = win / p.nwx % p.nwy;
  w.b = win / (p.nwx * p.nwy);
  w.rows = min(WS, p.hgt - w.wy * WS);
  w.cols = min(WS, p.wid - w.wx * WS);
  return w;
}

// The window's tokens into the LN tile by cp.async (zero outside the grid),
// thread tid of n; waits for this thread's copies.
template <int WS, int C>
__device__ __forceinline__ void gather_tokens(const BlockArgs& p, __nv_bfloat16* xs,
                                              const Window& w, int tid, int n) {
  constexpr int c = C, ld = C + 8;
  const __nv_bfloat16* xb = p.x + (long)w.b * p.hgt * p.wid * c;
  for (int v = tid; v < Win<WS>::T * (c / 8); v += n) {
    const int tok = v / (c / 8), d = (v % (c / 8)) * 8;
    const int ty = tok / WS, tx = tok % WS;
    const bool ok = ty < w.rows && tx < w.cols;
    cp_async16(xs + tok * ld + d,
               ok ? xb + ((long)(w.wy * WS + ty) * p.wid + w.wx * WS + tx) * c + d : p.x, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// LN of the tile's rows in place: a quad a row, 8 rows a warp at a time (the
// rows' loads and reductions interleave), each lane C / 4 channels in
// 16-byte vectors; warp wid of nw takes rows 8 wid.. and every 8 nw after.
template <int WS, int C>
__device__ __forceinline__ void layer_norm_tile(const BlockArgs& p, __nv_bfloat16* xs, int wid,
                                                int nw, int lane) {
  constexpr int T = Win<WS>::T, c = C, ld = C + 8, cq = C / 4, nv = cq / 8;
  const int q = lane % 4;
  for (int r0 = wid * 8; r0 < T; r0 += nw * 8) {
    const int r = r0 + lane / 4;
    __nv_bfloat16* row = xs + min(r, T - 1) * ld + q * cq;  // past T: read, not stored
    uint4 v[nv];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < nv; ++i) {
      v[i] = *reinterpret_cast<const uint4*>(row + 8 * i);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(e[k]);
        sum += f.x + f.y;
      }
    }
    const float mean = quad_sum(sum) / c;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < nv; ++i) {
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(e[k]);
        sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
      }
    }
    const float rstd = rsqrtf(quad_sum(sq) / c + p.eps);
    if (r >= T) continue;
#pragma unroll
    for (int i = 0; i < nv; ++i) {
      const float* sc = p.ln_s + q * cq + 8 * i;
      const float* sh = p.ln_b + q * cq + 8 * i;
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(e[k]);
        const float2 g2 = __ldg(reinterpret_cast<const float2*>(sc + 2 * k));
        const float2 h2 = __ldg(reinterpret_cast<const float2*>(sh + 2 * k));
        o[k] = pack_bf16((f.x - mean) * rstd * g2.x + h2.x, (f.y - mean) * rstd * g2.y + h2.y);
      }
      *reinterpret_cast<uint4*>(row + 8 * i) = out;
    }
  }
}

// [q | k | v] of head h for m64 tile mt of the window's tokens (rows past
// the tokens repeat the last): LN(x) @ slab on wgmma, + bias, rounded to
// bf16; k and q into the QK tile, v into V^T. box(kc) is the slab's K chunk
// kc.
template <int WS, int C, class Box>
__device__ __forceinline__ void qkv_tile(const BlockArgs& p, const Tiles& tl, int h, int mt,
                                         Box box, int warp, int lane) {
  using W = Win<WS>;
  constexpr int c = C, ld = C + 8;
  const int g = lane / 4, t = lane % 4;
  float acc[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = 0.f;
  const int arow = min(mt * 64 + warp * 16 + (lane & 15), W::T - 1);
  k_chunks<96, C / 16>(acc, tl.xs + arow * ld + (lane >> 4) * 8, box);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = mt * 64 + warp * 16 + g + 8 * hh;  // the token
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = jj * 8 + 2 * t;
      const float* bb = p.bqkv + h * HD + col;
      if (r < W::NS) {
        const float2 bq = __ldg(reinterpret_cast<const float2*>(bb));
        const float2 bk = __ldg(reinterpret_cast<const float2*>(bb + c));
        st32(tl.qk + swz(r, jj) + 4 * t,
             pack_bf16(acc[4 * (4 + jj) + 2 * hh] + bk.x, acc[4 * (4 + jj) + 2 * hh + 1] + bk.y));
        st32(tl.qk + swz(r, 4 + jj) + 4 * t,
             pack_bf16(acc[4 * jj + 2 * hh] + bq.x, acc[4 * jj + 2 * hh + 1] + bq.y));
      }
      if (r < W::KPV) {
        const float2 bv = __ldg(reinterpret_cast<const float2*>(bb + 2 * c));
        const float v0 = acc[4 * (8 + jj) + 2 * hh] + bv.x;
        const float v1 = acc[4 * (8 + jj) + 2 * hh + 1] + bv.y;
        unsigned char* vc = tl.vt + (r / 64) * HD * 128 + (r % 8) * 2;
        const int u = (r % 64) / 8;
        *reinterpret_cast<__nv_bfloat16*>(vc + swz(col, u)) = __float2bfloat16(v0);
        *reinterpret_cast<__nv_bfloat16*>(vc + swz(col + 1, u)) = __float2bfloat16(v1);
      }
    }
  }
}

// Head h's attention for query tile mt: S = q k^T over all the window's keys
// (one wgmma, N 56 or 200), the bias from the table tb (log2 domain), a
// one-pass softmax in registers, O = P V on wgmma, normalised, into the O
// tile's 32 columns of the head.
template <int WS, int C>
__device__ __forceinline__ void attend_tile(const Tiles& tl, const float* tb, int h, int mt,
                                            int warp, int lane) {
  using W = Win<WS>;
  constexpr int T = W::T, NJ = W::NS / 8, PK = W::KPV / 16, ld = C + 8;
  const int g = lane / 4, t = lane % 4;
  uint32_t qf[2][4];
  const int qrow = min(mt * 64 + warp * 16 + (lane & 15), T - 1);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldmatrix_x4(qf[ks], reinterpret_cast<const __nv_bfloat16*>(
                            tl.qk + swz(qrow, 4 + 2 * ks + (lane >> 4))));
  float sc[W::NS / 2];
#pragma unroll
  for (int i = 0; i < W::NS / 2; ++i) sc[i] = 0.f;
  fence_acc(sc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    wgmma_rs_k<W::NS>(sc, qf[ks], smem_desc(tl.qk + ks * 32, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) fence_regs(qf[ks]);

  // logits in the log2 domain with the bias; one-pass softmax per row
  const int qa = min(mt * 64 + warp * 16 + g, T - 1), qb = min(mt * 64 + warp * 16 + g + 8, T - 1);
  const int ca = (qa / WS + WS - 1) * (2 * WS - 1) + qa % WS + WS - 1;
  const int cb = (qb / WS + WS - 1) * (2 * WS - 1) + qb % WS + WS - 1;
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = 8 * j + 2 * t + e;
      if (key < T) {
        const int kc = (key / WS) * (2 * WS - 1) + key % WS;
        sc[4 * j + e] = fmaf(sc[4 * j + e], QK_SCALE, tb[ca - kc]);
        sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], QK_SCALE, tb[cb - kc]);
      } else {
        sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
      }
      mxa = fmaxf(mxa, sc[4 * j + e]);
      mxb = fmaxf(mxb, sc[4 * j + 2 + e]);
    }
  mxa = quad_max(mxa);
  mxb = quad_max(mxb);
  float la = 0.f, lb = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = exp2f(sc[4 * j + e] - mxa);
      sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mxb);
      la += sc[4 * j + e];
      lb += sc[4 * j + 2 + e];
    }
  la = quad_sum(la);
  lb = quad_sum(lb);

  // O = P V: the score fragments of n8 blocks 2 ks, 2 ks + 1 are k-step ks's
  // A fragment (zero past the score columns)
  uint32_t pf[PK][4];
#pragma unroll
  for (int ks = 0; ks < PK; ++ks) {
    pf[ks][0] = pack_bf16(sc[8 * ks], sc[8 * ks + 1]);
    pf[ks][1] = pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
    if (2 * ks + 1 < NJ) {
      pf[ks][2] = pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
      pf[ks][3] = pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
    } else {
      pf[ks][2] = pf[ks][3] = 0u;
    }
  }
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  fence_acc(o);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < PK; ++ks)
    wgmma_rs_k<HD>(o, pf[ks], smem_desc(tl.vt + (ks / 4) * HD * 128 + (ks % 4) * 32, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
#pragma unroll
  for (int ks = 0; ks < PK; ++ks) fence_regs(pf[ks]);
  const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = mt * 64 + warp * 16 + g + 8 * hh;
    if (r >= T) continue;
    const float inv = hh ? ib : ia;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      st32(tl.os + r * ld + h * HD + jj * 8 + 2 * t,
           pack_bf16(o[4 * jj + 2 * hh] * inv, o[4 * jj + 2 * hh + 1] * inv));
  }
}

// out = x + round(O @ Wproj + bproj) for output columns 64 nc.. of query tile
// mt, at the window's tokens inside the grid; box(kc) is the projection's
// box (nc, kc).
template <int WS, int C, class Box>
__device__ __forceinline__ void proj_tile(const BlockArgs& p, const Tiles& tl, const Window& w,
                                          int nc, int mt, Box box, int warp, int lane) {
  using W = Win<WS>;
  constexpr int c = C, ld = C + 8;
  const int g = lane / 4, t = lane % 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int arow = min(mt * 64 + warp * 16 + (lane & 15), W::T - 1);
  k_chunks<64, C / 16>(acc, tl.os + arow * ld + (lane >> 4) * 8, box);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = mt * 64 + warp * 16 + g + 8 * hh;
    const int ty = r / WS, tx = r % WS;
    if (r >= W::T || ty >= w.rows || tx >= w.cols) continue;
    const long base = ((long)(w.b * p.hgt + w.wy * WS + ty) * p.wid + w.wx * WS + tx) * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nc * 64 + j * 8 + 2 * t;
      if (col >= c) continue;
      const float2 bp = __ldg(reinterpret_cast<const float2*>(p.bproj + col));
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + base + col));
      st32(p.out + base + col, pack_bf16(xv.x + round_bf16(acc[4 * j + 2 * hh] + bp.x),
                                         xv.y + round_bf16(acc[4 * j + 2 * hh + 1] + bp.y)));
    }
  }
}

// Shared memory's parts at the start of a kernel: the weights' boxes or
// slots, the tile sets, the bias table (fp32, log2 domain, loaded here) and
// the barriers.
template <class P>
__device__ __forceinline__ unsigned char* block_start(const BlockArgs& p, float** tab,
                                                      uint64_t** bars) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  *tab = reinterpret_cast<float*>(smem + P::WEIGHTS + P::SETS * P::TILES);
  *bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(*tab) + P::TABLE);
  for (int i = threadIdx.x; i < P::HEADS * P::W::NB; i += blockDim.x)
    (*tab)[i] = p.table[i] * LOG2E;
  return smem;
}

// ws 7 (a window is one m64 tile): 2 warpgroups, each walking its own
// windows; all the weights loaded once a block by thread 0 (TMA).
template <int WS, int C>
__global__ void __launch_bounds__(256, 1)
    tinyvit_block_kernel(const __grid_constant__ CUtensorMap map_qkv,
                         const __grid_constant__ CUtensorMap map_prj, BlockArgs p) {
  using W = Win<WS>;
  static_assert(W::MT == 1, "a window is one m64 tile");
  using P = Plan<WS, C, true>;
  float* tab;
  uint64_t* full;
  unsigned char* wgt = block_start<P>(p, &tab, &full);
  constexpr int heads = P::HEADS, kch = P::KCH, nqkv = heads * kch;
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);  // thread 0's arrive + all the weights' bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&full[0], (uint32_t)P::WEIGHTS);
    for (int i = 0; i < nqkv; ++i)
      tma_load(wgt + i * QKV_BOX, &map_qkv, &full[0], (i % kch) * 64, (i / kch) * 3 * HD);
    for (int i = 0; i < kch * kch; ++i)
      tma_load(wgt + nqkv * QKV_BOX + i * PRJ_BOX, &map_prj, &full[0], (i % kch) * 64,
               (i / kch) * 64);
  }
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const Tiles tl = tiles_at<WS, C>(wgt + P::WEIGHTS + wg * P::TILES);
  auto box = [&](int i) -> const unsigned char* {  // box i of the weights, once they landed
    mbar_wait(&full[0], 0);
    return wgt + (i < nqkv ? (size_t)i * QKV_BOX
                           : (size_t)nqkv * QKV_BOX + (size_t)(i - nqkv) * PRJ_BOX);
  };

  for (int win = blockIdx.x * 2 + wg; win < p.windows; win += gridDim.x * 2) {
    const Window w = window_at<WS>(p, win);
    gather_tokens<WS, C>(p, tl.xs, w, tid, 128);
    wg_sync(wg);  // the window's tokens are in
    layer_norm_tile<WS, C>(p, tl.xs, warp, 4, lane);
    wg_sync(wg);  // the LN tile is complete
    for (int h = 0; h < heads; ++h) {
      qkv_tile<WS, C>(p, tl, h, 0, [&](int kc) { return box(h * kch + kc); }, warp, lane);
      fence_proxy_async();  // the QK and V^T stores, before wgmma reads them
      wg_sync(wg);
      attend_tile<WS, C>(tl, tab + h * W::NB, h, 0, warp, lane);
      wg_sync(wg);  // the QK and V^T tiles are read; the head's O columns written
    }
#pragma unroll 1
    for (int nc = 0; nc < kch; ++nc)
      proj_tile<WS, C>(p, tl, w, nc, 0, [&](int kc) { return box(nqkv + nc * kch + kc); }, warp,
                       lane);
  }
}

// ws 14: both consumer warpgroups of a block on one window (one tile set):
// the gather and the LN split by rows, qkv by m64 tile (0, 2 and 1, 3), the
// attention and the projection by the window's real query tiles in turn.
// No producer warpgroup: the weights come in rounds, a head's slab or a
// projection chunk, kch boxes each in kch slots; thread 0 issues round r + 1
// right after the block barrier that ends round r's products, so a slab
// loads under the previous head's attention.
template <int WS, int C>
__global__ void __launch_bounds__(256, 1)
    tinyvit_block_coop_kernel(const __grid_constant__ CUtensorMap map_qkv,
                              const __grid_constant__ CUtensorMap map_prj, BlockArgs p) {
  using W = Win<WS>;
  using P = Plan<WS, C, false>;
  float* tab;
  uint64_t* full;
  unsigned char* wgt = block_start<P>(p, &tab, &full);
  constexpr int heads = P::HEADS, kch = P::KCH;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kch; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int i) {  // round i of a window: head i's slab, or projection chunk i - heads
    if (threadIdx.x != 0) return;
    for (int kc = 0; kc < kch; ++kc) {
      if (i < heads) {
        mbar_expect_tx(&full[kc], QKV_BOX);
        tma_load(wgt + kc * SLOT, &map_qkv, &full[kc], kc * 64, i * 3 * HD);
      } else {
        mbar_expect_tx(&full[kc], PRJ_BOX);
        tma_load(wgt + kc * SLOT, &map_prj, &full[kc], kc * 64, (i - heads) * 64);
      }
    }
  };
  uint32_t ph = 0;  // parity of the round being consumed
  auto box = [&](int kc) -> const unsigned char* {
    mbar_wait(&full[kc], ph);
    return wgt + kc * SLOT;
  };
  const Tiles tl = tiles_at<WS, C>(wgt + P::WEIGHTS);

  if (blockIdx.x < p.windows) issue(0);
  for (int win = blockIdx.x; win < p.windows; win += gridDim.x) {
    const Window w = window_at<WS>(p, win);
    gather_tokens<WS, C>(p, tl.xs, w, threadIdx.x, 256);
    __syncthreads();  // the window's tokens are in
    layer_norm_tile<WS, C>(p, tl.xs, threadIdx.x / 32, 8, lane);
    __syncthreads();  // the LN tile is complete
    for (int h = 0; h < heads; ++h) {
      for (int mt = wg; mt < W::MT; mt += 2) qkv_tile<WS, C>(p, tl, h, mt, box, warp, lane);
      fence_proxy_async();  // the QK and V^T stores, before wgmma reads them
      __syncthreads();      // both warpgroups' products of the slab are done
      ph ^= 1;
      issue(h + 1);         // the next slab, or the first projection chunk
      int k = 0;
#pragma unroll 1
      for (int mt = 0; mt < W::MT; ++mt)
        if (real_tile<WS>(mt, w.rows, w.cols) && k++ % 2 == wg)
          attend_tile<WS, C>(tl, tab + h * W::NB, h, mt, warp, lane);
      __syncthreads();  // the QK and V^T tiles are read; the head's O columns written
    }
#pragma unroll 1
    for (int nc = 0; nc < kch; ++nc) {
      int k = 0;
#pragma unroll 1
      for (int mt = 0; mt < W::MT; ++mt)
        if (real_tile<WS>(mt, w.rows, w.cols) && k++ % 2 == wg)
          proj_tile<WS, C>(p, tl, w, nc, mt, box, warp, lane);
      __syncthreads();  // the chunk's products are done
      ph ^= 1;
      if (nc + 1 < kch)
        issue(heads + nc + 1);
      else if (win + gridDim.x < p.windows)
        issue(0);  // the next window's first slab, under its gather and LN
    }
  }
}

int num_sms = 0;

template <class P, class Kernel>
int launch(Kernel kernel, const BlockArgs& p, int items, const void* wqkv_t, const void* wproj_t,
           cudaStream_t st) {
  constexpr int c = P::HEADS * HD;
  CUtensorMap map_qkv, map_prj;
  cudaError_t err = make_map(&map_qkv, wqkv_t, 3 * c, c, 3 * HD);  // head slabs' K chunks
  if (err == cudaSuccess) err = make_map(&map_prj, wproj_t, c, c, 64);
  if (err != cudaSuccess) return (int)err;
  const int grid = items < num_sms ? items : num_sms;  // one block an SM, persistent
  kernel<<<grid, 256, P::SMEM, st>>>(map_qkv, map_prj, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Called once, when the library is loaded: the tensor-map encoder, the SM
// count and the kernels' shared memory (up to the card's opt-in maximum).
extern "C" int ysi_tinyvit_block_init(void) {
  cudaError_t err = load_encode_tiled();
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (err == cudaSuccess) err = cudaFuncSetAttribute(tinyvit_block_kernel<7, 128>, a, optin);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(tinyvit_block_coop_kernel<14, 160>, a, optin);
  return (int)err;
}

// The whole block, one launch, at TinyViT-5M's stages 1 (C 128, ws 7: 2
// windows a block at a time, the weights resident) and 2 (C 160, ws 14: 1
// window a block on both warpgroups, its weights in rounds). Other widths are
// refused (stage 3, C 320 at ws 7, keeps the first design's three launches,
// which were faster there).
extern "C" int ysi_tinyvit_block(const void* x, const void* wqkv_t, const void* wproj_t,
                                 const void* table, const void* ln_s, const void* ln_b,
                                 const void* bqkv, const void* bproj, void* out, int b, int hgt,
                                 int wid, int c, int ws, float eps, void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0) return (int)cudaErrorInvalidValue;
  BlockArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.table = static_cast<const float*>(table);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bproj = static_cast<const float*>(bproj);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hgt = hgt;
  p.wid = wid;
  p.nwx = (wid + ws - 1) / ws;
  p.nwy = (hgt + ws - 1) / ws;
  p.windows = b * p.nwx * p.nwy;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws == 7 && c == 128)
    return launch<Plan<7, 128, true>>(tinyvit_block_kernel<7, 128>, p, (p.windows + 1) / 2,
                                      wqkv_t, wproj_t, st);
  if (ws == 14 && c == 160)
    return launch<Plan<14, 160, false>>(tinyvit_block_coop_kernel<14, 160>, p, p.windows,
                                        wqkv_t, wproj_t, st);
  return (int)cudaErrorInvalidValue;
}
