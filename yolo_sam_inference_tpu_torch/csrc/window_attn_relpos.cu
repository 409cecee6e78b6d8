// Window-confined multi-head attention with SAM's decomposed relative
// position bias at windows of 16, read straight from the fused qkv tensor
// (Hopper, sm_90a): the grid route's windowed layers (kernels K2 + K3).
//
//   qkv (B, S, S, 3C) bf16, channels [q | k | v], head-major inside each;
//   rel_h, rel_w (31, hd) bf16 raw tables (the pipeline's bf16 weights);
//   out (B, S, S, C) bf16, heads concatenated (the output projection
//   follows as a separate GEMM).
//
// For a query q and a key k of the same 16 x 16 window (local coordinates
// (qy, qx), (ky, kx)):
//   logit = (q * hd^-0.5) . k + q . Rh[qy - ky + 15] + q . Rw[qx - kx + 15]
// The rel-pos terms use the UNSCALED q, as SAM does
// (yolo_sam_inference_tpu/models/sam/model.py:259-264 and :192-207).
//
// Replaces two TPU kernels (yolo_sam_inference_tpu/ops/flash_attention.py)
// at window 16: relpos_tables (:1085), which writes the score tables to
// device memory (here each warp multiplies its 16 queries by the whole
// tables on the tensor cores into shared memory), and flash_attention_grid
// (:608), the window attention itself. Every other window, 32 to 64 (the
// global layers), runs on flash_attention_relpos.cu's TMA + wgmma kernel.
//
// Why windows of 16 stay here: a 16 x 16 window is 256 queries over 256
// keys, about 17 MFLOP a window and head, so a block of the wgmma kernel
// (one a window, head and 256 queries; 1 block an SM for its shared memory
// and registers) spends most of its time on fixed latencies: the Q and
// table loads, the q.R products and their shared-memory round trip, two key
// tiles a pass. On an H100 80GB HBM3 at 700 W it took 0.2065 ms at ViT-B's
// batch of 32 (12 heads of 64) against this kernel's 0.1595, and 0.342-0.348
// against 0.273-0.279 at ViT-H's 16 heads of 80 (device times, in turns;
// PERF.md). This kernel keeps three blocks of 4 warps an SM, which
// hides those latencies.
//
// Design (FlashAttention-2 on mma.sync): one block per (image, window, head,
// 64-query tile), 4 warps of 16 queries. Each warp keeps its Q fragments,
// the scores, the probabilities and the running output in registers, in
// the mma.sync m16n8k16 fragment layout (bf16 in, fp32 accumulation). K and
// V tiles of 64 keys (4 window rows) stream through a two-stage cp.async
// ring; V is read transposed with ldmatrix.trans. The softmax is online, in
// fp32, with max subtraction; exp is exp2f of log2(e)-scaled fp32 logits.
// (The TPU kernel's default clamp mode exponentiates bf16-rounded logits;
// that is not copied.) The probabilities are rounded to bf16 for the P.V
// product. The (31, hd) tables pass through the second stages of the K and
// V buffers before the loop; a thread's rw terms sit in registers (a key
// tile starts at a window row, so its columns hold fixed kx).
//
// Supported: hd in {64, 80} (ViT-B/L and ViT-H), window 16, S a multiple of
// 16; anything else returns cudaErrorInvalidValue, and the Python wrapper
// raises before that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BKV = 64;         // keys per streamed tile
constexpr int THREADS = 128;    // 4 warps x 16 query rows
constexpr float LOG2E = 1.4426950408889634f;

// hd^-0.5 of the supported head widths
template <int HD>
struct Head;
template <>
struct Head<64> {
  static constexpr float SCALE = 0.125f;
};
template <>
struct Head<80> {
  static constexpr float SCALE = 0.11180339887498948f;
};

template <int W, int HD>
struct Geo {
  static constexpr int LDH = HD + 8;  // bf16 row stride of Q/K/V/table tiles (144 or 176 B:
                                      // ldmatrix and the fragment loads are conflict-free)
  static constexpr int NT = W * W;    // tokens per window
  static constexpr int NQT = NT / BQ;
  static constexpr int NKV = NT / BKV;
  static constexpr int LDR = 2 * W + 4;  // fp32 row stride of the QR tables
  static constexpr int TROWS = 2 * W;    // table rows (2w - 1, and one zero row)
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * 5 * BQ * LDH       // Q, K[2], V[2] (tables pass through K[1], V[1])
      + sizeof(float) * 2 * BQ * LDR;            // QRh, QRw
  static_assert(W % 8 == 0 && BKV % W == 0, "key tiles of whole window rows, one a n8 tile");
  static_assert(TROWS <= BKV, "the tables pass through one stage");
  static_assert(TROWS % 8 == 0, "the table chunks split into n8 tiles");
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

// Fragment layouts: mma_frag.cuh.
template <int W, int HD>
__global__ void __launch_bounds__(THREADS)
    window_attn_relpos_kernel(const __nv_bfloat16* __restrict__ qkv,
                              const __nv_bfloat16* __restrict__ rel_h,
                              const __nv_bfloat16* __restrict__ rel_w,
                              __nv_bfloat16* __restrict__ out, int s, int heads) {
  using G = Geo<W, HD>;
  constexpr int LDH = G::LDH;
  constexpr int KS = HD / 16;  // k-steps of the q.k and q.R products
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LDH;        // two stages
  __nv_bfloat16* Vs = Ks + 2 * BKV * LDH;   // two stages
  float* QRh = reinterpret_cast<float*>(Vs + 2 * BKV * LDH);
  float* QRw = QRh + BQ * G::LDR;
  __nv_bfloat16* Th = Ks + BKV * LDH;       // rel_h table chunk in stage 1 of K (before the loop)
  __nv_bfloat16* Tw = Vs + BKV * LDH;       // rel_w table chunk in stage 1 of V

  int bid = blockIdx.x;
  const int qt = bid % G::NQT;
  bid /= G::NQT;
  const int h = bid % heads;
  bid /= heads;
  const int nw = s / W;
  const int wx = bid % nw;
  bid /= nw;
  const int wy = bid % nw;
  const int b = bid / nw;

  const int c = heads * HD;
  const long c3 = 3L * c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;

  // element offset of window token i's qkv row
  auto row_of = [&](int i) -> long {
    const int y = wy * W + i / W, x = wx * W + i % W;
    return (((long)b * s + y) * s + x) * c3;
  };
  auto issue_kv = [&](int kt, int stage) {
#pragma unroll
    for (int i = 0; i < BKV * HD / 8 / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (HD / 8), d = (v % (HD / 8)) * 8;
      const long base = row_of(kt * BKV + r) + h * HD + d;
      cp_async16(Ks + (stage * BKV + r) * LDH + d, qkv + base + c, true);
      cp_async16(Vs + (stage * BKV + r) * LDH + d, qkv + base + 2 * c, true);
    }
  };

  // the table rows into Th, Tw (row 2w - 1 zero-filled)
  auto issue_tables = [&]() {
    for (int v = tid; v < G::TROWS * (HD / 8); v += THREADS) {
      const int r = v / (HD / 8), d = (v % (HD / 8)) * 8;
      const bool ok = r < 2 * W - 1;
      const long off = ok ? (long)r * HD + d : 0;
      cp_async16(Th + r * LDH + d, rel_h + off, ok);
      cp_async16(Tw + r * LDH + d, rel_w + off, ok);
    }
  };

  // group 0: the Q tile and the first table chunk; group 1: KV tile 0
#pragma unroll
  for (int i = 0; i < BQ * HD / 8 / THREADS; ++i) {
    const int v = tid + i * THREADS;
    const int r = v / (HD / 8), d = (v % (HD / 8)) * 8;
    cp_async16(Qs + r * LDH + d, qkv + row_of(qt * BQ + r) + h * HD + d, true);
  }
  issue_tables();
  cp_async_commit();
  issue_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // this warp's Q fragments, hd in KS k-steps of 16
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* q = Qs + (r0 + g) * LDH + ks * 16 + 2 * t;
    qa[ks][0] = ld32(q);
    qa[ks][1] = ld32(q + 8 * LDH);
    qa[ks][2] = ld32(q + 8);
    qa[ks][3] = ld32(q + 8 * LDH + 8);
  }

  // QR[r][j] = log2(e) * q_r . R[j] for the warp's 16 rows, all 2w table rows
#pragma unroll
  for (int tab = 0; tab < 2; ++tab) {
    const __nv_bfloat16* T = tab ? Tw : Th;
    float* QR = tab ? QRw : QRh;
#pragma unroll
    for (int n = 0; n < G::TROWS / 8; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* rp = T + (n * 8 + g) * LDH + ks * 16 + 2 * t;
        mma16816(acc, qa[ks], ld32(rp), ld32(rp + 8));
      }
      float* o = QR + (r0 + g) * G::LDR + n * 8 + 2 * t;
      o[0] = acc[0] * LOG2E;
      o[1] = acc[1] * LOG2E;
      o[8 * G::LDR] = acc[2] * LOG2E;
      o[8 * G::LDR + 1] = acc[3] * LOG2E;
    }
  }
  __syncwarp();

  // rows A = r0 + g and B = r0 + g + 8 of this thread, as window coordinates
  const int tqa = qt * BQ + r0 + g, tqb = tqa + 8;
  const float* qrh_a = QRh + (r0 + g) * G::LDR + tqa / W + W - 1;  // [-ky]
  const float* qrh_b = QRh + (r0 + g + 8) * G::LDR + tqb / W + W - 1;
  const float* qrw_a = QRw + (r0 + g) * G::LDR + tqa % W + W - 1;  // [-kx]
  const float* qrw_b = QRw + (r0 + g + 8) * G::LDR + tqb % W + W - 1;
  // rw terms: with a key tile starting at a window row, a thread only ever
  // sees kx = u * 8 + 2t + e (u < w / 8, e < 2), kept in registers
  constexpr int NU = W / 8;
  float rwa[NU][2], rwb[NU][2];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kx = u * 8 + 2 * t + e;
      rwa[u][e] = qrw_a[-kx];
      rwb[u][e] = qrw_b[-kx];
    }
  __syncthreads();  // every warp is done with the tables before stage 1 is refilled

  constexpr float QK_SCALE = Head<HD>::SCALE * LOG2E;  // hd^-0.5, log2 domain
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kt = 0; kt < G::NKV; ++kt) {
    if (kt + 1 < G::NKV) issue_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed (this thread's copies)
    __syncthreads();     // and everyone's
    const __nv_bfloat16* Kt = Ks + (kt & 1) * BKV * LDH;
    const __nv_bfloat16* Vt = Vs + (kt & 1) * BKV * LDH;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kp = Kt + (n * 8 + g) * LDH + ks * 16 + 2 * t;
        mma16816(sc[n], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // logits (log2 domain) = scale * q.k + rh + rw; row maxima
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
      const int key0 = kt * BKV + n * 8;
      const int ky = key0 / W;  // one key row per n-tile (8 | w)
      const float ha = qrh_a[-ky], hb = qrh_b[-ky];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float wa = rwa[n % NU][e], wb = rwb[n % NU][e];
        sc[n][e] = fmaf(sc[n][e], QK_SCALE, ha + wa);
        sc[n][2 + e] = fmaf(sc[n][2 + e], QK_SCALE, hb + wb);
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
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = exp2f(sc[n][e] - mn_a);
        sc[n][2 + e] = exp2f(sc[n][2 + e] - mn_b);
        sum_a += sc[n][e];
        sum_b += sc[n][2 + e];
      }
    }
    l_a = l_a * al_a + sum_a;  // this thread's partial row sums
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
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

  // normalise, stage the warp's 16 rows in its own rows of Qs, store 16 B per lane
  const float inv_a = 1.f / quad_sum(l_a), inv_b = 1.f / quad_sum(l_b);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    __nv_bfloat16* p = Qs + (r0 + g) * LDH + n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[n][0] * inv_a, o[n][1] * inv_a);
    *reinterpret_cast<uint32_t*>(p + 8 * LDH) = pack_bf16(o[n][2] * inv_b, o[n][3] * inv_b);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * HD / 8 / 32; ++i) {
    const int v = lane + 32 * i;
    const int r = v / (HD / 8), d = (v % (HD / 8)) * 8;
    const int tq = qt * BQ + r0 + r;
    const long off = (((long)b * s + wy * W + tq / W) * s + wx * W + tq % W) * c + h * HD + d;
    *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(Qs + (r0 + r) * LDH + d);
  }
}

template <int W, int HD>
int launch(const void* qkv, const void* rel_h, const void* rel_w, void* out, int b, int s,
           int heads, cudaStream_t stream) {
  constexpr size_t bytes = Geo<W, HD>::SMEM;  // allowed once, by ysi_window_attn_init
  const int nw = s / W;
  const long blocks = (long)b * nw * nw * heads * Geo<W, HD>::NQT;
  window_attn_relpos_kernel<W, HD><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(rel_h),
      static_cast<const __nv_bfloat16*>(rel_w), static_cast<__nv_bfloat16*>(out), s, heads);
  return (int)cudaGetLastError();
}

template <int W, int HD>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(window_attn_relpos_kernel<W, HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Geo<W, HD>::SMEM);
}

}  // namespace

// Called once, when the library is loaded: the kernels' shared memory is
// above the 48 KB default.
extern "C" int ysi_window_attn_init(void) {
  cudaError_t err = allow_smem<16, 64>();
  if (err == cudaSuccess) err = allow_smem<16, 80>();
  return (int)err;
}

extern "C" int ysi_window_attn_relpos(const void* qkv, const void* rel_h, const void* rel_w,
                                      void* out, int b, int s, int heads, int hd, int window,
                                      void* stream) {
  if (b <= 0 || s <= 0 || heads <= 0 || window <= 0 || s % window) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define YSI_ATTN_CASE(W_, HD_) \
  if (hd == HD_ && window == W_) return launch<W_, HD_>(qkv, rel_h, rel_w, out, b, s, heads, st);
  YSI_ATTN_CASE(16, 64)
  YSI_ATTN_CASE(16, 80)
#undef YSI_ATTN_CASE
  return (int)cudaErrorInvalidValue;
}
