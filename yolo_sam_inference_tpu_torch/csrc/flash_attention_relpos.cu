// Attention over a whole S x S token grid with SAM's decomposed relative
// position bias, read in place from strided q, k and v (Hopper, sm_90a):
// kernel K12.
//
//   q (B, NQ, C), k and v (B, N, C) bf16, N = S * S, C = heads * hd: strided
//   views with contiguous channels (a base pointer, a token stride and an
//   image stride; the head is a channel offset), e.g. the thirds of the
//   fused qkv (B, S, S, 3C), or a sequence-parallel rank's own q rows beside
//   the group's all-gathered k and v;
//   rel_h, rel_w (2S-1, hd) bf16: the raw rel-pos tables;
//   out (B, NQ, C) bf16, contiguous, heads concatenated:
//     out_i = softmax_j(hd^-0.5 q_i . k_j + q_i . Rh[y_i - ky_j + S - 1]
//                       + q_i . Rw[x_i - kx_j + S - 1]) . V
// with (y_i, x_i) the query's absolute grid position: the NQ queries are
// whole grid rows from row row0 (0 for a whole grid). The rel-pos terms use
// the UNSCALED q, as SAM does.
//
// Replaces yolo_sam_inference_tpu/ops/flash_attention.py:186
// flash_attention_relpos (pallas_call at :266), which the JAX encoder runs
// on its global layers off the grid route and on the sequence-parallel
// ones, with the score tables rh, rw built outside it by XLA einsums
// (models/sam/model.py:230-236, parallel/sp.py:146-164). That kernel folds
// the bias into the contraction (q' = [q s, rh, rw], k' = [k, onehot(ky),
// onehot(kx)]) for the MXU and exponentiates bf16-rounded logits (:166).
// Neither is copied: the bias is added to the fp32 scores, and exp stays
// fp32.
//
// What bounds it on the H100: 4 NQ N hd flop per head (and 4 NQ S hd for
// the q.R terms the bias needs; the kernel computes the 2S-1 rows its tile
// covers) against (2 NQ + 2 N) hd bf16 bytes. At the flat route's
// 14 x 14 windows that is about 50 flop per byte: bytes bound (q, k, v read
// once, out written once). At the 40 x 40 global grid and a
// sequence-parallel rank's share of the 64 x 64 grid it is 400-1000 flop per
// byte: operations bound, and only wgmma reaches the tensor cores' rate.
//
// The design, against what held the first one (mma.sync, 4 warps, fp32
// tables made outside and read per score, q/k/v split and permuted by
// copies) back:
//   * no copies around it: q, k and v are read in place through TMA tensor
//     maps of their strided views, and the output is written in the
//     (B, NQ, C) layout the projection reads;
//   * the q.R terms are built inside: the block's producer loads the raw
//     (2S-1, hd) tables with TMA, each consumer warpgroup multiplies its 64
//     queries by them with wgmma (fp32, scaled by log2(e)) and keeps, per
//     query row, rh[ky] for every key row in shared memory and its rw[kx]
//     terms in registers;
//   * key tiles are R whole key rows of SP keys (SP = S rounded up to 8;
//     R by SP: a 4-D TMA box (64 channels, SP kx, R ky, 1 image) whose kx
//     and ky past S read as zeros). A thread's score columns then hold fixed
//     kx values for the whole loop, so its rw terms sit in registers (SP / 2
//     floats), with -inf where kx >= S, and rh is one value per key row of
//     the tile, -inf past the grid's last row: the bias is two fp32 adds a
//     score, with no divide, no compare and no shared-memory load per score;
//   * one producer warp keeps a ring of 2-4 K/V stages in flight with TMA
//     (128-byte swizzle; hd 80 as two 64-channel boxes, the second one's
//     last 48 channels unused), full and empty mbarriers per stage, the
//     first loads in flight during the q.R products where the shared memory
//     holds both; two consumer warpgroups of 64 queries each take every
//     stage: S = Q.K^T by wgmma from shared memory (K-major both), the
//     online softmax in fp32 on the accumulators (ex2.approx of
//     log2(e)-scaled logits, max subtraction), P rounded to bf16 in
//     registers, O += P.V by wgmma with P from registers (V read N-major
//     through the transpose flag). Where the registers hold two score
//     tiles (64 keys a tile, or 80 at hd 64), a tile's Q.K^T is issued one tile
//     ahead and each P.V waited for only after the next tile's softmax, so
//     the tensor cores run under the softmax (FlashAttention-3's overlap
//     within a warpgroup; ping-pong barriers between the warpgroups
//     measured slower); wider tiles issue each Q.K^T with its own tile;
//   * the prologue builds each warpgroup's rh table with two threads a row
//     and no integer division (dividing per entry cost a fifth of the
//     kernel's time at 40 x 40);
//   * at windows of 14: 7 key rows of 16 a tile (two tiles, 224 key slots
//     for 196 keys), both tiles resident in the ring, and one block takes
//     both 128-query tiles of a window and head over them (256 query slots
//     for 196), so the products are 1.49x what the window needs (the first
//     design: 1.7x) and the K/V tiles, the raw tables and a block's fixed
//     latencies are paid once a window and head.
//
// Keys past N score -inf; queries past NQ read as zeros and are not stored.
// Supported: hd 64 or 80, S from 1 to 64, NQ a whole number of grid rows
// from row0, strides and pointers 16-byte aligned; anything else returns
// cudaErrorInvalidValue (the Python wrapper raises before that).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int BOX = 64;                        // bf16 channels in a 128-byte swizzled row
constexpr int QROWS = 64;                      // queries per consumer warpgroup
constexpr int CONSUMERS = 2;                   // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int LDS = BOX + 4;                   // fp32 stride of the q.R scratch rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_LIMIT = 232448;          // what a block may opt in to

// key rows per tile by SP: R * SP keys, a multiple of 16, at most 160 (the
// widest that holds its scores, probabilities and O in registers unspilled)
constexpr int rows_per_tile(int hd, int sp) {
  return sp == 8 ? 8 : sp == 16 ? 7 : sp == 24 ? 4 : sp == 64 ? 1
         : sp == 40 && hd == 64 ? 4 : 2;
}

template <int HD, int SP>
struct Geo {
  static constexpr int NB = HD > BOX ? 2 : 1;        // 64-channel boxes per row
  static constexpr int KS = HD / 16;                 // k-steps of the q.k and q.R products
  static constexpr int R = rows_per_tile(HD, SP);
  static constexpr int N = R * SP;                   // key slots per tile
  static constexpr int KROWS = (SP + R - 1) / R * R; // key rows the rh table holds
  static constexpr int RH_LD = KROWS + 1;            // odd: a warp's 8 rows on 8 banks
  static constexpr int TCH = (2 * SP - 1 + BOX - 1) / BOX;  // 64-row chunks of a table
  static constexpr size_t BOX_BYTES = 64 * 128;      // a Q or table box: 64 rows of 128 B
  static constexpr size_t Q_BYTES = CONSUMERS * NB * BOX_BYTES;
  static constexpr size_t RH_BYTES = (CONSUMERS * QROWS * RH_LD * 4 + 1023) / 1024 * 1024;
  static constexpr size_t KV_BYTES = (size_t)NB * N * 128;  // a K or V tile
  static constexpr size_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t TAB_BYTES = 2 * TCH * NB * BOX_BYTES;
  static constexpr size_t SCR_BYTES = CONSUMERS * QROWS * LDS * 4;
  static constexpr size_t FREE = SMEM_LIMIT - 1024 - 256 - Q_BYTES - RH_BYTES;
  static constexpr int STAGES = FREE / STAGE_BYTES >= 4 ? 4 : (int)(FREE / STAGE_BYTES);
  // the tables and the q.R scratch sit after the K/V stages where all fits,
  // so the first K/V loads fly during the q.R products; else they share the
  // stages' bytes and the K/V loads wait for the products
  static constexpr bool ALIAS =
      STAGES * STAGE_BYTES + TAB_BYTES + SCR_BYTES > FREE;
  static constexpr size_t TAB_OFF = ALIAS ? 0 : STAGES * STAGE_BYTES;
  static constexpr size_t RING = ALIAS ? (STAGES * STAGE_BYTES > TAB_BYTES + SCR_BYTES
                                              ? STAGES * STAGE_BYTES
                                              : TAB_BYTES + SCR_BYTES)
                                       : STAGES * STAGE_BYTES + TAB_BYTES + SCR_BYTES;
  // a second Q area where all fits: a block whose K/V tiles all stay in the
  // ring then takes two 128-query tiles over them (windows of 14)
  static constexpr int QP =
      !ALIAS && STAGES * STAGE_BYTES + TAB_BYTES + SCR_BYTES + Q_BYTES <= FREE ? 2 : 1;
  static constexpr size_t SMEM =
      1024 /* alignment slack */ + QP * Q_BYTES + RH_BYTES + RING + 256;
  static_assert(N % 16 == 0 && N <= 160, "a tile is whole k-steps of the P.V product");
  static_assert(STAGES >= 2, "at least two K/V stages");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

template <int HD>
struct Head;
template <>
struct Head<64> {
  static constexpr float SCALE = 0.125f;  // hd^-0.5
};
template <>
struct Head<80> {
  static constexpr float SCALE = 0.11180339887498948f;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// K-major operand (rows x hd, 64-channel boxes `box_elems` apart): k-step ks
__device__ __forceinline__ uint64_t kmajor_desc(const __nv_bfloat16* base, int box_elems, int ks) {
  return smem_desc(base + (ks / 4) * box_elems + (ks % 4) * 16, 16, 1024);
}

struct Params {
  int nq, s, row0, heads, q_blocks, tch;
  int passes;       // 128-query tiles a block takes (1, or 2 where QP and the ring allow)
  long out_tokens;  // NQ * C: an image of the output
  __nv_bfloat16* out;
};

// Fragment and accumulator layouts: hopper.cuh, mma_frag.cuh. A thread of
// consumer warp w holds rows A = 16 w + g and B = A + 8 of its warpgroup's
// 64 queries and, of every n8 tile u of a score tile, columns 8 u + 2 t + e.
template <int HD, int SP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attn_relpos_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_th,
                             const __grid_constant__ CUtensorMap map_tw, Params p) {
  using G = Geo<HD, SP>;
  constexpr int NB = G::NB, KS = G::KS, R = G::R, N = G::N;
  constexpr int BOXE = (int)(G::BOX_BYTES / 2);  // elements of a Q or table box
  constexpr int KVBOXE = N * BOX;                // elements of a K or V box
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* RH = reinterpret_cast<float*>(smem + G::QP * G::Q_BYTES);
  unsigned char* ring = smem + G::QP * G::Q_BYTES + G::RH_BYTES;
  __nv_bfloat16* Tabs = reinterpret_cast<__nv_bfloat16*>(ring + G::TAB_OFF);
  float* Scr = reinterpret_cast<float*>(ring + G::TAB_OFF + G::TAB_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + G::RING);
  uint64_t* full = bars;                 // [STAGES]
  uint64_t* empty = bars + G::STAGES;    // [STAGES]
  uint64_t* qbar = empty + G::STAGES;    // Q and the tables have landed
  uint64_t* tabfree = qbar + 1;          // the consumers are done with the tables

  const int s = p.s;
  const int qb = blockIdx.x % p.q_blocks;
  const int bh = blockIdx.x / p.q_blocks;
  const int h = bh % p.heads, b = bh / p.heads;
  const int q0 = qb * p.passes * CONSUMERS * QROWS;
  const int tiles = (s + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int i = 0; i < G::STAGES; ++i) {
      mbar_init(&full[i], 1);                 // the producer's arrive + the TMA bytes
      mbar_init(&empty[i], CONSUMERS * 4);    // one arrive per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init(tabfree, CONSUMERS * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // ---- producer warp: one thread issues every copy
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(qbar,
                     (uint32_t)(p.passes * G::Q_BYTES + 2 * p.tch * NB * G::BOX_BYTES));
      for (int w = 0; w < p.passes * CONSUMERS; ++w)
        for (int nb = 0; nb < NB; ++nb)
          tma_load_3d(Qs + (w * NB + nb) * BOXE, &map_q, qbar, h * HD + nb * BOX,
                      q0 + w * QROWS, b);
      for (int tab = 0; tab < 2; ++tab)
        for (int ch = 0; ch < p.tch; ++ch)
          for (int nb = 0; nb < NB; ++nb)
            tma_load(Tabs + ((tab * G::TCH + ch) * NB + nb) * BOXE, tab ? &map_tw : &map_th,
                     qbar, nb * BOX, ch * 64);
      if (G::ALIAS) mbar_wait(tabfree, 0);  // the ring's bytes are free for K and V
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < tiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);  // both warpgroups have released it
        mbar_expect_tx(&full[stage], (uint32_t)G::STAGE_BYTES);
        __nv_bfloat16* kt_s = reinterpret_cast<__nv_bfloat16*>(ring + stage * G::STAGE_BYTES);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(kt_s + nb * KVBOXE, &map_k, &full[stage], h * HD + nb * BOX, 0, kt * R, b);
          tma_load_4d(kt_s + (NB + nb) * KVBOXE, &map_v, &full[stage], h * HD + nb * BOX, 0,
                      kt * R, b);
        }
        if (++stage == G::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's rows in the warpgroup's tile
  float* rhw = RH + wg * QROWS * G::RH_LD;  // [row][ky]: log2(e) q . Rh[y - ky + S - 1]
  float* scr = Scr + wg * QROWS * LDS;
  mbar_wait(qbar, 0);
  const int passes = G::QP == 2 ? p.passes : 1;  // a constant 1 where QP is 1
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
    const bool first = pass == 0, last = pass + 1 == passes;  // the K/V waits and releases
    const __nv_bfloat16* Qw = Qs + (pass * CONSUMERS + wg) * NB * BOXE;
    const int qw0 = q0 + (pass * CONSUMERS + wg) * QROWS;  // the warpgroup's first query
    const int xa = (qw0 + ra) % s, xb = (qw0 + rb) % s;

    // rw terms of this thread's columns: kx = (8 u + 2 t + e) for u < SP / 8,
    // -inf past the grid's last column
    float rwa[SP / 8][2], rwb[SP / 8][2];
#pragma unroll
    for (int u = 0; u < SP / 8; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) rwa[u][e] = rwb[u][e] = -INFINITY;

    // q.R for both tables, a 64-row chunk of table rows at a time, through the
    // warpgroup's scratch
#pragma unroll 1
    for (int tab = 0; tab < 2; ++tab) {
#pragma unroll 1
      for (int ch = 0; ch < p.tch; ++ch) {
        const __nv_bfloat16* T = Tabs + (tab * G::TCH + ch) * NB * BOXE;
        float acc[32];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_ss_kk<64>(acc, kmajor_desc(Qw, BOXE, ks), kmajor_desc(T, BOXE, ks), ks > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* pa = scr + ra * LDS + 8 * j + 2 * t;
          pa[0] = acc[4 * j] * LOG2E;
          pa[1] = acc[4 * j + 1] * LOG2E;
          pa[8 * LDS] = acc[4 * j + 2] * LOG2E;
          pa[8 * LDS + 1] = acc[4 * j + 3] * LOG2E;
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        const int j0 = ch * 64;
        if (tab == 1) {
#pragma unroll
          for (int u = 0; u < SP / 8; ++u)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kx = 8 * u + 2 * t + e;
              if (kx < s) {
                const int ja = xa - kx + s - 1 - j0, jb = xb - kx + s - 1 - j0;
                if (ja >= 0 && ja < 64) rwa[u][e] = scr[ra * LDS + ja];
                if (jb >= 0 && jb < 64) rwb[u][e] = scr[rb * LDS + jb];
              }
            }
        } else {
          // two threads a row, alternate key rows
          const int r = tid / 2, jy = p.row0 + (qw0 + r) / s + s - 1 - j0;
          for (int ky = tid % 2; ky < tiles * R; ky += 2) {
            if (ky >= s) {
              if (ch == 0) rhw[r * G::RH_LD + ky] = -INFINITY;
            } else if (jy - ky >= 0 && jy - ky < 64) {
              rhw[r * G::RH_LD + ky] = scr[r * LDS + jy - ky];
            }
          }
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
    }
    if (G::ALIAS && first && lane == 0) mbar_arrive(tabfree);  // the ring may take K/V

    constexpr float QK_SCALE = Head<HD>::SCALE * LOG2E;  // hd^-0.5, log2 domain
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

    // A tile's S = Q K^T is issued one tile ahead (into the other score
    // registers) where the registers hold two score tiles (OVERLAP), so the
    // tensor cores run it under this tile's softmax; else with this tile.
    // O += P V follows each softmax, asynchronously, and is waited for just
    // before the next tile's rescale of O.
    constexpr bool OVERLAP = N + N / 4 + HD / 2 <= 136;
    float scA[N / 2], scB[OVERLAP ? N / 2 : 1];
    uint32_t pa[N / 16][4];  // bf16 P: the A operand of the P.V product
    auto issue_s = [&](float (&sc)[N / 2], int kt) {
      const int st = kt % G::STAGES;
      if (first) mbar_wait(&full[st], (kt / G::STAGES) & 1);
      const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(ring + st * G::STAGE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_ss_kk<N>(sc, kmajor_desc(Qw, BOXE, ks), kmajor_desc(Kt, KVBOXE, ks), ks > 0);
      wgmma_commit();
    };
    auto step = [&](float (&sc)[N / 2], float (&next)[N / 2], int kt) {
      const bool more = kt + 1 < tiles;
      // pending products, oldest first: S(kt), P.V(kt - 1), S(kt + 1) with
      // OVERLAP; P.V(kt - 1), S(kt) without
      if constexpr (OVERLAP) {
        if (more) issue_s(next, kt + 1);
        if (kt > 0 && more)
          wgmma_wait<2>();
        else if (kt > 0 || more)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
      } else {
        issue_s(sc, kt);
        wgmma_wait<0>();
      }
      fence_acc(sc);

      // logits (log2 domain) = scale * q.k + rh[ky] + rw[kx]; -inf off the grid
      float ha[R], hb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ha[r] = rhw[ra * G::RH_LD + kt * R + r];
        hb[r] = rhw[rb * G::RH_LD + kt * R + r];
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int u = 0; u < N / 8; ++u) {
        const int kyl = (8 * u) / SP, ux = (8 * u) % SP / 8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * u + e] = fmaf(sc[4 * u + e], QK_SCALE, ha[kyl] + rwa[ux][e]);
          sc[4 * u + 2 + e] = fmaf(sc[4 * u + 2 + e], QK_SCALE, hb[kyl] + rwb[ux][e]);
          mx_a = fmaxf(mx_a, sc[4 * u + e]);
          mx_b = fmaxf(mx_b, sc[4 * u + 2 + e]);
        }
      }
      // tile 0 holds key (0, 0), so the running maxima are finite from then on
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);  // 0 on the first tile
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int u = 0; u < N / 8; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * u + e] = ex2(sc[4 * u + e] - mn_a);  // 0 off the grid
          sc[4 * u + 2 + e] = ex2(sc[4 * u + 2 + e] - mn_b);
          sum_a += sc[4 * u + e];
          sum_b += sc[4 * u + 2 + e];
        }
      l_a = l_a * al_a + sum_a;  // this thread's partial row sums
      l_b = l_b * al_b + sum_b;
      if (kt > 0) {  // P.V(kt - 1) is done: its stage is free
        if (OVERLAP && more)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
        fence_acc(o);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) fence_regs(pa[kk]);
        if (last && lane == 0) mbar_arrive(&empty[(kt - 1) % G::STAGES]);
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }
      // the probabilities of n8 tiles 2 kk and 2 kk + 1 are the A fragment of
      // k-step kk (16 key slots); V N-major by descriptor
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      const __nv_bfloat16* Vt =
          reinterpret_cast<const __nv_bfloat16*>(ring + (kt % G::STAGES) * G::STAGE_BYTES) +
          NB * KVBOXE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_rs_mn<HD>(o, pa[kk], smem_desc(Vt + kk * 16 * BOX, KVBOXE * 2, 1024));
      wgmma_commit();
    };
    if constexpr (OVERLAP) {
      issue_s(scA, 0);
#pragma unroll 1
      for (int kt = 0; kt < tiles; kt += 2) {
        step(scA, scB, kt);
        if (kt + 1 < tiles) step(scB, scA, kt + 1);
      }
    } else {
#pragma unroll 1
      for (int kt = 0; kt < tiles; ++kt) step(scA, scA, kt);
    }
    wgmma_wait<0>();  // the last P.V
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) fence_regs(pa[kk]);
    if (last && lane == 0) mbar_arrive(&empty[(tiles - 1) % G::STAGES]);

    // normalise, stage the warpgroup's rows over its Q tile (16-byte chunks
    // XOR-swizzled by row at hd 64, rows padded at hd 80), store 16 B a lane,
    // rows past NQ skipped
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // every Q read is done
    constexpr int LDO = HD == 64 ? 64 : HD + 8;
    __nv_bfloat16* Os = const_cast<__nv_bfloat16*>(Qw);
    auto chunk = [](int r, int c) { return HD == 64 ? (c ^ (r & 7)) : c; };
    const float inv_a = 1.f / quad_sum(l_a), inv_b = 1.f / quad_sum(l_b);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(Os + ra * LDO + chunk(ra, j) * 8 + 2 * t) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(Os + rb * LDO + chunk(rb, j) * 8 + 2 * t) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
    __syncwarp();
    const long c = (long)p.heads * HD;
    __nv_bfloat16* og = p.out + b * p.out_tokens + h * HD;
#pragma unroll
    for (int i = 0; i < 16 * HD / 8 / 32; ++i) {
      const int idx = lane + 32 * i;
      const int r = warp * 16 + idx / (HD / 8), cc = idx % (HD / 8);
      const int row = qw0 + r;
      if (row < p.nq)
        *reinterpret_cast<uint4*>(og + (long)row * c + cc * 8) =
            *reinterpret_cast<const uint4*>(Os + r * LDO + chunk(r, cc) * 8);
    }
  }  // pass
}

template <int HD, int SP>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_attn_relpos_kernel<HD, SP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Geo<HD, SP>::SMEM);
}

template <int HD>
cudaError_t allow_smem_all() {
  cudaError_t err = allow_smem<HD, 8>();
  if (err == cudaSuccess) err = allow_smem<HD, 16>();
  if (err == cudaSuccess) err = allow_smem<HD, 24>();
  if (err == cudaSuccess) err = allow_smem<HD, 32>();
  if (err == cudaSuccess) err = allow_smem<HD, 40>();
  if (err == cudaSuccess) err = allow_smem<HD, 48>();
  if (err == cudaSuccess) err = allow_smem<HD, 56>();
  if (err == cudaSuccess) err = allow_smem<HD, 64>();
  return err;
}

struct View {
  const void* ptr;
  int tokens, token_stride, image_stride;  // strides in elements
};

template <int HD, int SP>
int launch(View q, View k, View v, const void* rel_h, const void* rel_w, void* out, int b,
           int heads, int s, int row0, cudaStream_t stream) {
  using G = Geo<HD, SP>;
  const cuuint64_t c = (cuuint64_t)heads * HD;
  CUtensorMap mq, mk, mv, mth, mtw;
  const cuuint64_t dq[3] = {c, (cuuint64_t)q.tokens, (cuuint64_t)b};
  const cuuint64_t sq[2] = {(cuuint64_t)q.token_stride * 2, (cuuint64_t)q.image_stride * 2};
  const cuuint32_t bq[3] = {BOX, QROWS, 1};
  cudaError_t err = make_map_nd(&mq, q.ptr, 3, dq, sq, bq);
  const cuuint64_t dk[4] = {c, (cuuint64_t)s, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint32_t bk[4] = {BOX, SP, G::R, 1};
  const cuuint64_t sk[3] = {(cuuint64_t)k.token_stride * 2, (cuuint64_t)k.token_stride * 2 * s,
                            (cuuint64_t)k.image_stride * 2};
  const cuuint64_t sv[3] = {(cuuint64_t)v.token_stride * 2, (cuuint64_t)v.token_stride * 2 * s,
                            (cuuint64_t)v.image_stride * 2};
  if (err == cudaSuccess) err = make_map_nd(&mk, k.ptr, 4, dk, sk, bk);
  if (err == cudaSuccess) err = make_map_nd(&mv, v.ptr, 4, dk, sv, bk);
  const cuuint64_t dt[2] = {(cuuint64_t)HD, (cuuint64_t)(2 * s - 1)};
  const cuuint64_t st[1] = {(cuuint64_t)HD * 2};
  const cuuint32_t bt[2] = {BOX, 64};
  if (err == cudaSuccess) err = make_map_nd(&mth, rel_h, 2, dt, st, bt);
  if (err == cudaSuccess) err = make_map_nd(&mtw, rel_w, 2, dt, st, bt);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.nq = q.tokens;
  p.s = s;
  p.row0 = row0;
  p.heads = heads;
  const int q_tiles = (q.tokens + CONSUMERS * QROWS - 1) / (CONSUMERS * QROWS);
  p.passes = G::QP == 2 && (s + G::R - 1) / G::R <= G::STAGES && q_tiles > 1 ? 2 : 1;
  p.q_blocks = (q_tiles + p.passes - 1) / p.passes;
  p.tch = (2 * s - 1 + 63) / 64;
  p.out_tokens = (long)q.tokens * (long)c;
  p.out = static_cast<__nv_bfloat16*>(out);
  const long blocks = (long)b * heads * p.q_blocks;
  flash_attn_relpos_kernel<HD, SP><<<(unsigned)blocks, THREADS, G::SMEM, stream>>>(
      mq, mk, mv, mth, mtw, p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_sp(View q, View k, View v, const void* rel_h, const void* rel_w, void* out, int b,
              int heads, int s, int row0, cudaStream_t st) {
  switch ((s + 7) / 8 * 8) {
    case 8: return launch<HD, 8>(q, k, v, rel_h, rel_w, out, b, heads, s, row0, st);
    case 16: return launch<HD, 16>(q, k, v, rel_h, rel_w, out, b, heads, s, row0, st);
    case 24: return launch<HD, 24>(q, k, v, rel_h, rel_w, out, b, heads, s, row0, st);
    case 32: return launch<HD, 32>(q, k, v, rel_h, rel_w, out, b, heads, s, row0, st);
    case 40: return launch<HD, 40>(q, k, v, rel_h, rel_w, out, b, heads, s, row0, st);
    case 48: return launch<HD, 48>(q, k, v, rel_h, rel_w, out, b, heads, s, row0, st);
    case 56: return launch<HD, 56>(q, k, v, rel_h, rel_w, out, b, heads, s, row0, st);
    case 64: return launch<HD, 64>(q, k, v, rel_h, rel_w, out, b, heads, s, row0, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Called once, when the library is loaded: the tensor-map encoder and the
// kernels' shared memory above the 48 KB default.
extern "C" int ysi_flash_attn_relpos_init(void) {
  cudaError_t err = load_encode_tiled();
  if (err == cudaSuccess) err = allow_smem_all<64>();
  if (err == cudaSuccess) err = allow_smem_all<80>();
  return (int)err;
}

// q: NQ tokens at q_ts elements apart, images q_is apart; k and v: S * S
// tokens each at kv_ts apart, images kv_is apart; channel h * hd + d of a
// token is head h's element d. out: contiguous (B, NQ, heads * hd).
extern "C" int ysi_flash_attn_relpos(const void* q, const void* k, const void* v,
                                     const void* rel_h, const void* rel_w, void* out, int b,
                                     int heads, int nq, int s, int row0, int hd, int q_ts,
                                     int q_is, int kv_ts, int kv_is, void* stream) {
  if (b <= 0 || heads <= 0 || nq <= 0 || s <= 0 || s > 64 || nq % s || row0 < 0 ||
      row0 + nq / s > s || q_ts % 8 || q_is % 8 || kv_ts % 8 || kv_is % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View qv{q, nq, q_ts, q_is}, kv{k, s * s, kv_ts, kv_is}, vv{v, s * s, kv_ts, kv_is};
  if (hd == 64) return launch_sp<64>(qv, kv, vv, rel_h, rel_w, out, b, heads, s, row0, st);
  if (hd == 80) return launch_sp<80>(qv, kv, vv, rel_h, rel_w, out, b, heads, s, row0, st);
  return (int)cudaErrorInvalidValue;
}
