// Attention over a whole S x S token grid with SAM's decomposed relative
// position bias given as score tables (Hopper, sm_90a): kernel K12.
//
//   q (BH, NQ, hd) bf16, k and v (BH, N, hd) bf16 with N = S * S;
//   rh, rw (BH, NQ, S) fp32: rh[i][ky] = q_i . Rh[y_i - ky + S - 1] and
//   rw[i][kx] = q_i . Rw[x_i - kx + S - 1], built from the unscaled q
//   outside (ops/flash_attention.py: relpos_score_tables);
//   out (BH, NQ, hd) bf16, for every query i
//     out_i = softmax_j(hd^-0.5 q_i . k_j + rh[i][j / S] + rw[i][j % S]) . V.
// NQ may be any count of whole grid rows (a sequence-parallel rank's own
// rows); nothing here depends on where they sit in the grid, since their
// tables carry that.
//
// Replaces yolo_sam_inference_tpu/ops/flash_attention.py:186
// flash_attention_relpos (pallas_call at :266), which the JAX encoder runs
// on its global layers off the grid route and on the sequence-parallel
// ones. That kernel folds the bias into the contraction (q' = [q s, rh, rw],
// k' = [k, onehot(ky), onehot(kx)]) for the MXU, and exponentiates
// bf16-rounded logits (:166). Neither is copied: the bias is added to the
// fp32 score fragments, and exp stays fp32.
//
// What bounds it on the H100: 4 NQ N hd flop per head against
// (2 NQ + 2 N) hd bf16 and 2 NQ S fp32 bytes read, so it is compute bound
// at every shape of the encoder (about 1000 flop per byte at N = 4096). The
// design follows FlashAttention-2 and the window kernel of this directory
// (window_attn_relpos.cu): one block per (head, 64-query tile), 4 warps of
// 16 queries on mma.sync m16n8k16 (bf16 in, fp32 accumulation), Q fragments,
// scores, probabilities and the running output in registers; K and V tiles
// of 64 keys stream through a two-stage cp.async ring, V read transposed
// with ldmatrix.trans. The query tile's rh and rw rows are staged once in
// shared memory, transposed ([S][64 queries], stride 68: the lanes of one
// score fragment read 32 distinct banks) and scaled by log2(e); key j's
// bias is rh[j / S] + rw[j % S] of the fragment's row, added to the fp32
// score. The softmax is online, in fp32, with max subtraction; exp is
// exp2f of log2(e)-scaled fp32 logits. The probabilities are rounded to
// bf16 for the P.V product. No wgmma or TMA yet.
//
// N need not be a multiple of 64 (windows of 14 x 14 = 196 tokens): keys
// past N load as zeros and take -inf scores; queries past NQ load as zeros
// and are not stored. Supported: hd in {64, 80}, S up to 64; anything else
// returns cudaErrorInvalidValue (the Python wrapper raises before that).
// Shared memory: 5 bf16 tiles of 64 x (hd + 8) and two fp32 tables of
// 64 x 68: 89 KB at hd 80, 79 KB at hd 64 (opted in at load time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int BQ = 64;         // queries per block
constexpr int BKV = 64;        // keys per streamed tile
constexpr int THREADS = 128;   // 4 warps x 16 query rows
constexpr int MAX_S = 64;      // grid side: rows of the staged tables
constexpr int LDT = BQ + 4;    // fp32 stride of a table row ([S][query])
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Geo;
template <>
struct Geo<64> {
  static constexpr float SCALE = 0.125f;  // hd^-0.5
};
template <>
struct Geo<80> {
  static constexpr float SCALE = 0.11180339887498948f;
};

template <int HD>
struct Tiles {
  static constexpr int LDH = HD + 8;  // bf16 row stride of Q/K/V tiles (conflict-free fragments)
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * 5 * BQ * LDH  // Q, K[2], V[2]
                                 + sizeof(float) * 2 * MAX_S * LDT;    // rh, rw tables
  static_assert(HD % 16 == 0, "hd splits into m16n8k16 k-steps");
  static_assert((BKV * HD / 8) % THREADS == 0 && (BQ * HD / 8) % THREADS == 0,
                "tile copies divide evenly over the threads");
  static_assert((16 * HD / 8) % 32 == 0, "the output rows divide evenly over a warp");
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

// Fragment layouts: mma_frag.cuh. inv_s = 1 / s in fp32: key / s is
// (key + 0.5) * inv_s rounded down, exact for key < 2^16 and s <= 64 (the
// fraction stays at least 0.5 / s from an integer, the rounding error under
// 1e-4).
template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_attn_relpos_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ rh, const float* __restrict__ rw,
                             __nv_bfloat16* __restrict__ out, int nq, int n, int s,
                             int q_tiles, float inv_s) {
  constexpr int LDH = Tiles<HD>::LDH;
  constexpr int KS = HD / 16;  // k-steps of the q.k product
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LDH;       // two stages
  __nv_bfloat16* Vs = Ks + 2 * BKV * LDH;  // two stages
  float* Th = reinterpret_cast<float*>(Vs + 2 * BKV * LDH);  // [ky][query] log2(e) rh
  float* Tw = Th + MAX_S * LDT;                              // [kx][query] log2(e) rw

  const int qt = blockIdx.x % q_tiles;
  const long bh = blockIdx.x / q_tiles;
  const int q0 = qt * BQ;
  const __nv_bfloat16* qg = q + bh * nq * HD;
  const __nv_bfloat16* kg = k + bh * n * HD;
  const __nv_bfloat16* vg = v + bh * n * HD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;

  auto issue_kv = [&](int kt, int stage) {
#pragma unroll
    for (int i = 0; i < BKV * HD / 8 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
      const int key = kt * BKV + r;
      const bool ok = key < n;
      const long off = ok ? (long)key * HD + d : 0;
      cp_async16(Ks + (stage * BKV + r) * LDH + d, kg + off, ok);
      cp_async16(Vs + (stage * BKV + r) * LDH + d, vg + off, ok);
    }
  };

  // group 0: the Q tile (rows past NQ zero-filled); group 1: KV tile 0
#pragma unroll
  for (int i = 0; i < BQ * HD / 8 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
    const bool ok = q0 + r < nq;
    cp_async16(Qs + r * LDH + d, qg + (ok ? (long)(q0 + r) * HD + d : 0), ok);
  }
  cp_async_commit();
  issue_kv(0, 0);
  cp_async_commit();

  // the tile's score tables, transposed and scaled by log2(e), while the
  // copies fly; rows past NQ are zero (their queries are not stored)
  {
    const long base = (bh * nq + q0) * s;
    const int valid = min(BQ, nq - q0) * s;
    for (int i = tid; i < BQ * s; i += THREADS) {
      const int r = i / s, c = i - r * s;
      const bool ok = i < valid;
      Th[c * LDT + r] = ok ? rh[base + i] * LOG2E : 0.f;
      Tw[c * LDT + r] = ok ? rw[base + i] * LOG2E : 0.f;
    }
  }
  cp_async_wait<1>();  // the Q tile has landed (this thread's copies)
  __syncthreads();     // everyone's, and the tables are written

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* qp = Qs + (r0 + g) * LDH + ks * 16 + 2 * t;
    qa[ks][0] = ld32(qp);
    qa[ks][1] = ld32(qp + 8 * LDH);
    qa[ks][2] = ld32(qp + 8);
    qa[ks][3] = ld32(qp + 8 * LDH + 8);
  }
  const float* tha = Th + r0 + g;  // this thread's rows A = r0 + g and B = A + 8
  const float* twa = Tw + r0 + g;

  constexpr float QK_SCALE = Geo<HD>::SCALE * LOG2E;  // hd^-0.5, log2 domain
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int nn = 0; nn < HD / 8; ++nn) o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.f;

  const int n_tiles = (n + BKV - 1) / BKV;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) issue_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed (this thread's copies)
    __syncthreads();     // and everyone's
    const __nv_bfloat16* Kt = Ks + (kt & 1) * BKV * LDH;
    const __nv_bfloat16* Vt = Vs + (kt & 1) * BKV * LDH;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[BKV / 8][4];
#pragma unroll
    for (int nn = 0; nn < BKV / 8; ++nn) {
      sc[nn][0] = sc[nn][1] = sc[nn][2] = sc[nn][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kp = Kt + (nn * 8 + g) * LDH + ks * 16 + 2 * t;
        mma16816(sc[nn], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // logits (log2 domain) = scale * q.k + rh[ky] + rw[kx]; keys past N -> -inf
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nn = 0; nn < BKV / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * BKV + nn * 8 + 2 * t + e;
        if (key < n) {
          const int ky = (int)(((float)key + 0.5f) * inv_s);
          const int kx = key - ky * s;
          const float* hy = tha + ky * LDT;
          const float* wx = twa + kx * LDT;
          sc[nn][e] = fmaf(sc[nn][e], QK_SCALE, hy[0] + wx[0]);
          sc[nn][2 + e] = fmaf(sc[nn][2 + e], QK_SCALE, hy[8] + wx[8]);
        } else {
          sc[nn][e] = -INFINITY;
          sc[nn][2 + e] = -INFINITY;
        }
        mx_a = fmaxf(mx_a, sc[nn][e]);
        mx_b = fmaxf(mx_b, sc[nn][2 + e]);
      }
    }
    // tile 0 always holds key 0, so the running maxima are finite from then on
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);  // 0 on the first tile
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nn = 0; nn < BKV / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nn][e] = exp2f(sc[nn][e] - mn_a);  // exp2f(-inf) = 0 for masked keys
        sc[nn][2 + e] = exp2f(sc[nn][2 + e] - mn_b);
        sum_a += sc[nn][e];
        sum_b += sc[nn][2 + e];
      }
    }
    l_a = l_a * al_a + sum_a;  // this thread's partial row sums
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      o[nn][0] *= al_a;
      o[nn][1] *= al_a;
      o[nn][2] *= al_b;
      o[nn][3] *= al_b;
    }

    // O += P V: the score fragments of n-tiles 2ks, 2ks+1 are the A fragment
    // of k-step ks; V^T fragments come from ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * ks][0], sc[2 * ks][1]);
      pa[1] = pack_bf16(sc[2 * ks][2], sc[2 * ks][3]);
      pa[2] = pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
      pa[3] = pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t vb[4];
        const int key = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vb, Vt + key * LDH + np * 16 + (lane >> 4) * 8);
        mma16816(o[2 * np], pa, vb[0], vb[1]);
        mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage kt & 1 fully consumed before it is refilled
  }
  cp_async_wait<0>();

  // normalise, stage the warp's 16 rows in its own rows of Qs, store 16 B per
  // lane, rows past NQ skipped
  const float inv_a = 1.f / quad_sum(l_a), inv_b = 1.f / quad_sum(l_b);
#pragma unroll
  for (int nn = 0; nn < HD / 8; ++nn) {
    __nv_bfloat16* p = Qs + (r0 + g) * LDH + nn * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[nn][0] * inv_a, o[nn][1] * inv_a);
    *reinterpret_cast<uint32_t*>(p + 8 * LDH) = pack_bf16(o[nn][2] * inv_b, o[nn][3] * inv_b);
  }
  __syncwarp();
  __nv_bfloat16* og = out + bh * nq * HD;
#pragma unroll
  for (int i = 0; i < 16 * HD / 8 / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
    const int row = q0 + r0 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(og + (long)row * HD + d) =
          *reinterpret_cast<const uint4*>(Qs + (r0 + r) * LDH + d);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw,
           void* out, int bh, int nq, int n, int s, cudaStream_t stream) {
  const int q_tiles = (nq + BQ - 1) / BQ;
  const long blocks = (long)bh * q_tiles;
  flash_attn_relpos_kernel<HD><<<(unsigned)blocks, THREADS, Tiles<HD>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(rh),
      static_cast<const float*>(rw), static_cast<__nv_bfloat16*>(out), nq, n, s, q_tiles,
      1.0f / (float)s);
  return (int)cudaGetLastError();
}

template <int HD>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_attn_relpos_kernel<HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Tiles<HD>::SMEM);
}

}  // namespace

// Called once, when the library is loaded: the shared memory is above the
// 48 KB default.
extern "C" int ysi_flash_attn_relpos_init(void) {
  cudaError_t err = allow_smem<64>();
  if (err == cudaSuccess) err = allow_smem<80>();
  return (int)err;
}

extern "C" int ysi_flash_attn_relpos(const void* q, const void* k, const void* v,
                                     const void* rh, const void* rw, void* out, int bh, int nq,
                                     int n, int s, int hd, void* stream) {
  if (bh <= 0 || nq <= 0 || s <= 0 || s > MAX_S || n != s * s || nq % s)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, rh, rw, out, bh, nq, n, s, st);
  if (hd == 80) return launch<80>(q, k, v, rh, rw, out, bh, nq, n, s, st);
  return (int)cudaErrorInvalidValue;
}
