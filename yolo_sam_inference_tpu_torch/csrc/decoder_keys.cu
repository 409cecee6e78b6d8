// The SAM mask decoder's passes over the image-token ("keys") stream, for
// Hopper (sm_90a): two kernels.
//
// keys_stream_kernel, one 64-token tile of one prompt stream per block:
//
//   [i2t]  kk   = keys + pe
//          q    = ((kk @ Wq + bq) * hd^-0.5)                  -> bf16
//          p    = softmax_j(q_h . kq[j]_h)  per head, over the tq tokens -> bf16
//          attn = p @ vq                                       -> bf16
//          keys = LayerNorm(keys + (attn @ Wout + bout))       -> bf16, stored
//   [next] kp   = (keys + pe) @ Wk + bk,  vp = keys @ Wv + bv  -> bf16
//          then, with [i2t], this tile's share of the next token-to-image
//          attention of the tq2 (<= 8) next queries qn (already scaled):
//          per (head, query) m = max_tile(qn . kp), l = sum_tile e,
//          o = sum_tile e * vp with e = exp(qn . kp - m), stored as fp32
//          partials; without [i2t], kp and vp are stored.
//
// Without [i2t] the kernel is the per-image k/v projection of decoder layer
// 0's token-to-image attention. With k_share = K, prompt n reads keys row
// n / K (layer 0: the K prompts of an image share its untouched tokens).
//
// t2i_combine_kernel, one prompt per block: the next attention's output from
// the partials of the ceil(T / 64) tiles, out = sum o e^(m - M) / sum l e^(m - M).
//
// T need not be a multiple of 64 (SAM's grids of 14, 28, 20, 36, 50 and 60
// give T = 196, 784, 400, 1296, 2500, 3600): the last tile's rows at T and
// beyond are zero-filled on load, score -inf in the next attention (so they
// add nothing to its max, o or l) and store no keys, kp or vp row.
//
// t2i_attend_kernel, one (image, head) per block: the token-to-image
// attention of the image's K prompts x tq (<= 8) tokens over all T image
// tokens from stored kp/vp, out = softmax_T(q_h . kp_h) @ vp_h, with q
// already scaled; per-image kp/vp with k_share = K serve all K prompts.
//
// Replace (yolo_sam_inference_tpu/ops/decoder_fused.py):
//   * i2t_keys_update (:298): keys_stream_kernel with [i2t] is its one pass
//     over the keys stream, the next stage's softmax included (split over
//     the tiles), and t2i_combine_kernel joins the tiles;
//   * t2i_shared_attend (:231): keys_stream_kernel without [i2t] (the k/v
//     projections once per image) + t2i_attend_kernel.
//
// What bounds them on the H100: at config 1 the keys stream is B*K prompts x
// 1024 tokens x 256 channels (268 MB in bf16 at B*K = 512), and each pass
// carries four (rows x 256) x (256 x 128)-sized products, about 137 GFLOP, so
// a pass is compute bound (about 250 flop per byte) once the stream is read
// once. The TPU kernel reads the keys once and writes them once; this one does
// the same for the keys, and keeps q, the 7-token softmax and the attention
// output on chip: q and the output projection run on mma.sync (m16n8k16,
// bf16 in, fp32 accumulation); q waits in shared memory (registers hold the
// 16 x 256 output accumulators of each warp); the per-head 7-token logits
// and softmax run on the CUDA cores, a quad of lanes holding one row's 16
// head channels; and the attention output, formed in the mma accumulator
// layout, is the A fragment of the output projection without leaving
// registers. Weights are read as B fragments straight from global
// memory, stored by the wrapper in fragment order so that each warp load is
// 256 contiguous bytes (they stay in L1/L2: the four matrices are 256 KB in
// all, shared by every block). The residual add and
// LayerNorm run on the accumulators (fp32 row statistics over each lane
// quad). The TPU kernel holds a prompt's whole 1024-token stream in one
// grid step, so the next stage's softmax is local there; here a prompt spans
// 16 blocks, so each block keeps its tile's kp/vp in shared memory, takes
// the softmax over its own 64 tokens (max, exponentials, sums and the
// product with vp on the CUDA cores) and stores those partials, 4.5 KB per
// tile instead of 64 KB of kp/vp; t2i_combine_kernel rescales and adds them.
// t2i_attend_kernel is bound by bytes: it must read each image's kp/vp once
// (16.8 MB at config 1's batch of 32 images, T 1024: 0.0056 ms at 3.35 TB/s)
// for about 0.5 GFLOP. Its first design ran one block per (prompt, head), so
// an image's 16 prompts read its kp/vp 16 times, and it took the logits on
// the CUDA cores through a (tq, T) fp32 buffer in shared memory: it was
// 0.4688 ms at T 1024 and 0.2198 at T 196 on an H100 80GB HBM3 at 700 W,
// against 0.0587 for PyTorch's SDPA at T 1024. Its note below says what the
// present design does about that.
//
// Shapes: C = 256 channels, 128 internal channels, 8 heads of 16, tq <= 8,
// any T - SAM's decoder at every encoder size.
// The Python wrappers check them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int C = 256;        // decoder channels
constexpr int DH = 128;       // attention internal channels (downsample rate 2)
constexpr int HEADS = 8, HD = 16;
constexpr int TQ_MAX = 8;
constexpr int ROWS = 64;      // tokens per block
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int LDX = C + 8;    // 528-byte smem rows: ldmatrix stays conflict-free
constexpr int LDQ = DH + 8;   // q rows (bf16)
constexpr int PART = HD + 2;  // a partial: o[HD], m, l
constexpr int HQ = HEADS * TQ_MAX;  // (head, next query) columns
constexpr int LDS = HQ + 1;         // fp32 row stride of the tile's logits: no bank conflicts
static_assert(DH == HEADS * HD && HD == 16, "one m16n8k16 k-tile per head");
static_assert(HQ <= THREADS && (HQ * HD) % THREADS == 0, "partials map onto the block");

struct KeysArgs {
  const __nv_bfloat16* keys;  // (nsrc, T, C)
  const __nv_bfloat16* pe;    // (T, C)
  const __nv_bfloat16* kq;    // (N, tq, DH)  i2t keys of the prompt tokens
  const __nv_bfloat16* vq;    // (N, tq, DH)
  const uint2* wq_f;          // (C -> DH) weights in B-fragment order, see load_b
  const float* bq;            // (DH,)
  const uint2* wo_f;          // (DH -> C)
  const float* bo;            // (C,)
  const float* ln_s;          // (C,)
  const float* ln_b;          // (C,)
  const uint2* wk_f;          // (C -> DH)  next t2i
  const float* bk;
  const uint2* wv_f;          // (C -> DH)
  const float* bv;
  const __nv_bfloat16* qn;    // (N, tq2, DH)  next queries, already scaled
  __nv_bfloat16* out_keys;    // (N, T, C)
  __nv_bfloat16* out_kp;      // (N, T, DH)   without [i2t]
  __nv_bfloat16* out_vp;      // (N, T, DH)
  float* part;                // (N, ceil(T / ROWS), HEADS, TQ_MAX, PART)  with [i2t]
  int t, tq, tq2, k_share;
  float scale, eps;
  int do_i2t;
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

// bf16 pair sum, rounded once to bf16 (as a bf16 tensor add computes it)
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  const float2 x = unpack2(a), y = unpack2(b);
  return pack_bf16(x.x + y.x, x.y + y.y);
}

// B fragment of n-tile j, k-tile kt of a weight stored in fragment order
// (the wrapper's layout): for each (n-tile, k-tile), 32 lanes x {b0, b1}, so
// a warp reads 256 contiguous bytes per fragment. kt_count = in / 16.
__device__ __forceinline__ void load_b(const uint2* wf, int kt_count, int j, int kt, int lane,
                                       uint32_t& b0, uint32_t& b1) {
  const uint2 v = __ldg(wf + ((long)j * kt_count + kt) * 32 + lane);
  b0 = v.x;
  b1 = v.y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store the first `rows` (<= 16) of this warp's staged rows (ncols bf16
// each, from smem row stride LDX) to global rows of length ld, 16 bytes per
// lane.
__device__ __forceinline__ void store_rows(const __nv_bfloat16* s, __nv_bfloat16* gdst, int ld,
                                           int ncols, int rows, int lane) {
  const int chunks = ncols / 8;
  for (int v = lane; v < rows * chunks; v += 32) {
    const int r = v / chunks, c = (v % chunks) * 8;
    *reinterpret_cast<uint4*>(gdst + (long)r * ld + c) =
        *reinterpret_cast<const uint4*>(s + r * LDX + c);
  }
}

__global__ void __launch_bounds__(THREADS) keys_stream_kernel(KeysArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);  // keys tile, then new keys
  __nv_bfloat16* Ps = Xs + ROWS * LDX;                          // pe tile, then kp | vp
  float* kqs = reinterpret_cast<float*>(Ps + ROWS * LDX);      // (TQ_MAX, DH)
  float* vqs = kqs + TQ_MAX * DH;
  float* qns = vqs + TQ_MAX * DH;                                         // (TQ_MAX, DH)
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(qns + TQ_MAX * DH);  // (ROWS, LDQ) q

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n = blockIdx.y, t0 = blockIdx.x * ROWS;
  const int valid = min(ROWS, p.t - t0);  // rows of this tile below T
  const long row0 = (long)n * p.t + t0;  // first output row of this tile
  const __nv_bfloat16* xg = p.keys + ((long)(n / p.k_share) * p.t + t0) * C;
  const __nv_bfloat16* pg = p.pe + (long)t0 * C;

  for (int v = tid; v < ROWS * C / 8; v += THREADS) {
    const int r = v / (C / 8), c = (v % (C / 8)) * 8;
    const bool in = r < valid;  // rows at T and beyond: zero-filled, nothing read
    const long off = (long)(in ? r : 0) * C + c;
    cp_async16(Xs + r * LDX + c, xg + off, in);
    cp_async16(Ps + r * LDX + c, pg + off, in);
  }
  cp_async_commit();
  if (p.do_i2t) {
    const long q0 = (long)n * p.tq * DH;
    for (int v = tid; v < p.tq * DH; v += THREADS) {
      kqs[v] = bf(p.kq[q0 + v]);
      vqs[v] = bf(p.vq[q0 + v]);
    }
    const long n0 = (long)n * p.tq2 * DH;
    for (int v = tid; v < p.tq2 * DH; v += THREADS) qns[v] = bf(p.qn[n0 + v]);
  }
  cp_async_wait<0>();
  __syncthreads();  // from here on each warp touches only its own 16 rows

  const int wr = warp * 16;
  const int wrows = max(0, min(16, valid - wr));  // this warp's rows below T
  const __nv_bfloat16* xa = Xs + (wr + (lane & 15)) * LDX + (lane >> 4) * 8;  // ldmatrix rows
  const __nv_bfloat16* pa = Ps + (wr + (lane & 15)) * LDX + (lane >> 4) * 8;

  if (p.do_i2t) {
    // ---- q = (kk @ Wq + bq) * scale for all heads, in bf16, into this
    // warp's rows of Qs (registers are kept for the output accumulators)
    {
      float acc[DH / 8][4];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
      for (int kt = 0; kt < C / 16; ++kt) {
        uint32_t ax[4], ap[4], a[4];
        ldmatrix_x4(ax, xa + kt * 16);
        ldmatrix_x4(ap, pa + kt * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = add2(ax[i], ap[i]);
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          uint32_t b0, b1;
          load_b(p.wq_f, C / 16, j, kt, lane, b0, b1);
          mma16816(acc[j], a, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float b0 = p.bq[j * 8 + 2 * t], b1 = p.bq[j * 8 + 2 * t + 1];
        __nv_bfloat16* q0 = Qs + (wr + g) * LDQ + j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(q0) =
            pack_bf16((acc[j][0] + b0) * p.scale, (acc[j][1] + b1) * p.scale);
        *reinterpret_cast<uint32_t*>(q0 + 8 * LDQ) =
            pack_bf16((acc[j][2] + b0) * p.scale, (acc[j][3] + b1) * p.scale);
      }
    }
    __syncwarp();

    // ---- per head: 7-token softmax, attn = p @ vq, out += attn_h @ Wout[h rows]
    float oacc[C / 8][4];
#pragma unroll
    for (int j = 0; j < C / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
#pragma unroll 1
    for (int h = 0; h < HEADS; ++h) {
      // this lane's q: rows g (r = 0) and g + 8 (r = 1), head channels
      // e = 0..3 at 2t, 2t + 1, 8 + 2t, 9 + 2t
      float q[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat16* qr = Qs + (wr + g + 8 * r) * LDQ + h * HD + 2 * t;
        const float2 lo = unpack2(*reinterpret_cast<const uint32_t*>(qr));
        const float2 hi = unpack2(*reinterpret_cast<const uint32_t*>(qr + 8));
        q[r][0] = lo.x;
        q[r][1] = lo.y;
        q[r][2] = hi.x;
        q[r][3] = hi.y;
      }
      const int cbase = h * HD + 2 * t;
      const int col[4] = {cbase, cbase + 1, cbase + 8, cbase + 9};
      float s[2][TQ_MAX];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < TQ_MAX; ++j) {
        if (j < p.tq) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) d = fmaf(q[r][e], kqs[j * DH + col[e]], d);
            s[r][j] = quad_sum(d);
            mx[r] = fmaxf(mx[r], s[r][j]);
          }
        }
      }
      float den[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < TQ_MAX; ++j) {
        if (j < p.tq) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            s[r][j] = expf(s[r][j] - mx[r]);
            den[r] += s[r][j];
          }
        }
      }
      float at[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float inv = 1.f / den[r];
#pragma unroll
        for (int j = 0; j < TQ_MAX; ++j) {
          if (j < p.tq) {
            const float pj = round_bf16(s[r][j] * inv);
#pragma unroll
            for (int e = 0; e < 4; ++e) at[r][e] = fmaf(pj, vqs[j * DH + col[e]], at[r][e]);
          }
        }
      }
      // the attention output in the accumulator layout is the A fragment of
      // k-tile h of the output projection
      uint32_t a[4];
      a[0] = pack_bf16(at[0][0], at[0][1]);
      a[1] = pack_bf16(at[1][0], at[1][1]);
      a[2] = pack_bf16(at[0][2], at[0][3]);
      a[3] = pack_bf16(at[1][2], at[1][3]);
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        uint32_t b0, b1;
        load_b(p.wo_f, DH / 16, j, h, lane, b0, b1);
        mma16816(oacc[j], a, b0, b1);
      }
    }

    // ---- y = keys + (out + bout); LayerNorm over the 256 channels, fp32
    const __nv_bfloat16* x0 = Xs + (wr + g) * LDX;
    const __nv_bfloat16* x1 = x0 + 8 * LDX;
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int cl = j * 8 + 2 * t;
      const float b0 = p.bo[cl], b1 = p.bo[cl + 1];
      const float2 k0 = unpack2(*reinterpret_cast<const uint32_t*>(x0 + cl));
      const float2 k1 = unpack2(*reinterpret_cast<const uint32_t*>(x1 + cl));
      oacc[j][0] = k0.x + (oacc[j][0] + b0);
      oacc[j][1] = k0.y + (oacc[j][1] + b1);
      oacc[j][2] = k1.x + (oacc[j][2] + b0);
      oacc[j][3] = k1.y + (oacc[j][3] + b1);
      sum[0] += oacc[j][0] + oacc[j][1];
      sum[1] += oacc[j][2] + oacc[j][3];
    }
    const float mean0 = quad_sum(sum[0]) / C, mean1 = quad_sum(sum[1]) / C;
    float var[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      oacc[j][0] -= mean0;
      oacc[j][1] -= mean0;
      oacc[j][2] -= mean1;
      oacc[j][3] -= mean1;
      var[0] += oacc[j][0] * oacc[j][0] + oacc[j][1] * oacc[j][1];
      var[1] += oacc[j][2] * oacc[j][2] + oacc[j][3] * oacc[j][3];
    }
    const float rstd0 = rsqrtf(quad_sum(var[0]) / C + p.eps);
    const float rstd1 = rsqrtf(quad_sum(var[1]) / C + p.eps);
    __syncwarp();  // every lane has read its residual before the rows are overwritten
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int cl = j * 8 + 2 * t;
      const float s0 = p.ln_s[cl], s1 = p.ln_s[cl + 1];
      const float b0 = p.ln_b[cl], b1 = p.ln_b[cl + 1];
      *reinterpret_cast<uint32_t*>(Xs + (wr + g) * LDX + cl) =
          pack_bf16(oacc[j][0] * rstd0 * s0 + b0, oacc[j][1] * rstd0 * s1 + b1);
      *reinterpret_cast<uint32_t*>(Xs + (wr + g + 8) * LDX + cl) =
          pack_bf16(oacc[j][2] * rstd1 * s0 + b0, oacc[j][3] * rstd1 * s1 + b1);
    }
    __syncwarp();
    store_rows(Xs + wr * LDX, p.out_keys + (row0 + wr) * C, C, C, wrows, lane);
  }

  // ---- next stage's k/v projections: kp = (x + pe) @ Wk + bk, vp = x @ Wv + bv
  {
    float ka[DH / 8][4], va[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      ka[j][0] = ka[j][1] = ka[j][2] = ka[j][3] = 0.f;
      va[j][0] = va[j][1] = va[j][2] = va[j][3] = 0.f;
    }
#pragma unroll 1
    for (int kt = 0; kt < C / 16; ++kt) {
      uint32_t ax[4], ap[4], ak[4];
      ldmatrix_x4(ax, xa + kt * 16);
      ldmatrix_x4(ap, pa + kt * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) ak[i] = add2(ax[i], ap[i]);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        uint32_t b0, b1;
        load_b(p.wk_f, C / 16, j, kt, lane, b0, b1);
        mma16816(ka[j], ak, b0, b1);
        load_b(p.wv_f, C / 16, j, kt, lane, b0, b1);
        mma16816(va[j], ax, b0, b1);
      }
    }
    __syncwarp();  // the pe rows are read; they now stage kp | vp
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int cl = j * 8 + 2 * t;
      const float k0 = p.bk[cl], k1 = p.bk[cl + 1], v0 = p.bv[cl], v1 = p.bv[cl + 1];
      __nv_bfloat16* r0 = Ps + (wr + g) * LDX;
      __nv_bfloat16* r1 = r0 + 8 * LDX;
      *reinterpret_cast<uint32_t*>(r0 + cl) = pack_bf16(ka[j][0] + k0, ka[j][1] + k1);
      *reinterpret_cast<uint32_t*>(r1 + cl) = pack_bf16(ka[j][2] + k0, ka[j][3] + k1);
      *reinterpret_cast<uint32_t*>(r0 + DH + cl) = pack_bf16(va[j][0] + v0, va[j][1] + v1);
      *reinterpret_cast<uint32_t*>(r1 + DH + cl) = pack_bf16(va[j][2] + v0, va[j][3] + v1);
    }
    __syncwarp();
    if (!p.do_i2t) {
      store_rows(Ps + wr * LDX, p.out_kp + (row0 + wr) * DH, DH, DH, wrows, lane);
      store_rows(Ps + wr * LDX + DH, p.out_vp + (row0 + wr) * DH, DH, DH, wrows, lane);
      return;
    }
  }

  // ---- this tile's share of the next token-to-image attention
  float* S = reinterpret_cast<float*>(Qs);  // (ROWS, LDS) logits, then e; q is consumed
  float* ml = kqs;                          // (HQ, 2) tile max and sum; kq is consumed
  __syncthreads();  // every warp's kp | vp rows are staged, and q, kq are no longer read
  {
    // logits: thread -> row tid / 2, heads 4 * (tid % 2) .. + 3, every query;
    // a row at T or beyond scores -inf
    const int r = tid / 2;
    const bool in = r < valid;
    const __nv_bfloat16* kr = Ps + r * LDX;
#pragma unroll
    for (int hh = 0; hh < HEADS / 2; ++hh) {
      const int h = (tid % 2) * (HEADS / 2) + hh;
      float kv[HD];
#pragma unroll
      for (int c = 0; c < HD; c += 2) {
        const float2 f = unpack2(*reinterpret_cast<const uint32_t*>(kr + h * HD + c));
        kv[c] = f.x;
        kv[c + 1] = f.y;
      }
#pragma unroll
      for (int q = 0; q < TQ_MAX; ++q) {
        float d = 0.f;
        if (q < p.tq2) {
#pragma unroll
          for (int c = 0; c < HD; ++c) d = fmaf(qns[q * DH + h * HD + c], kv[c], d);
        }
        S[r * LDS + h * TQ_MAX + q] = in ? d : -INFINITY;
      }
    }
  }
  __syncthreads();
  if (tid < HQ) {  // column tid = (head, query): max and sum over the tile's rows
    // (row 0 is below T in every tile, so m is finite and e is 0 past T)
    float m = -INFINITY, l = 0.f;
    for (int r = 0; r < ROWS; ++r) m = fmaxf(m, S[r * LDS + tid]);
    for (int r = 0; r < ROWS; ++r) {
      const float e = expf(S[r * LDS + tid] - m);
      S[r * LDS + tid] = e;
      l += e;
    }
    ml[2 * tid] = m;
    ml[2 * tid + 1] = l;
  }
  __syncthreads();
  {
    // o[(h, q)][d] = sum_r e[r][(h, q)] * vp[r][h, d]: 16 lanes per column,
    // neighbouring lanes on neighbouring vp channels
    const int d = tid % HD;
    float* out = p.part + ((long)n * gridDim.x + blockIdx.x) * HQ * PART;
#pragma unroll
    for (int i = 0; i < HQ * HD / THREADS; ++i) {
      const int col = tid / HD + i * (THREADS / HD);
      const int h = col / TQ_MAX, q = col % TQ_MAX;
      if (q >= p.tq2) continue;
      float acc = 0.f;
      for (int r = 0; r < ROWS; ++r)
        acc = fmaf(S[r * LDS + col], bf(Ps[r * LDX + DH + h * HD + d]), acc);
      out[col * PART + d] = acc;
      if (d == 0) {
        out[col * PART + HD] = ml[2 * col];
        out[col * PART + HD + 1] = ml[2 * col + 1];
      }
    }
  }
}

// One prompt per block: join the partials of its ceil(T / ROWS) tiles.
__global__ void __launch_bounds__(THREADS)
    t2i_combine_kernel(const float* part, __nv_bfloat16* out, int tiles, int tq2) {
  const int n = blockIdx.x;
  const float* base = part + (long)n * tiles * HQ * PART;
  for (int o = threadIdx.x; o < HQ * HD; o += THREADS) {
    const int col = o / HD, d = o % HD;
    const int h = col / TQ_MAX, q = col % TQ_MAX;
    if (q >= tq2) continue;
    float mx = -INFINITY;
    for (int k = 0; k < tiles; ++k) mx = fmaxf(mx, base[(k * HQ + col) * PART + HD]);
    float num = 0.f, den = 0.f;
    for (int k = 0; k < tiles; ++k) {
      const float* pk = base + (k * HQ + col) * PART;
      const float w = expf(pk[HD] - mx);
      num = fmaf(pk[d], w, num);
      den = fmaf(pk[HD + 1], w, den);
    }
    out[((long)n * tq2 + q) * DH + h * HD + d] = __float2bfloat16(num / den);
  }
}

constexpr size_t KEYS_SMEM = sizeof(__nv_bfloat16) * (2 * ROWS * LDX + ROWS * LDQ) +
                             sizeof(float) * 3 * TQ_MAX * DH;
static_assert(ROWS * LDS * sizeof(float) <= ROWS * LDQ * sizeof(__nv_bfloat16), "S fits in Qs");
static_assert(2 * HQ <= TQ_MAX * DH, "the tile's max and sum fit in kqs");

// ----------------------------------------------------------------- t2i attend
//
// One block per (image, head[, query block]): the image's k_share * tq query
// rows (112 at config 1: 16 prompts x 7 tokens), one or more m16 row tiles
// per warp, against the image's kp/vp head slice, which streams through a
// cp.async ring of 64-key tiles and is read once for all of them. q.k^T and
// P.V run on mma.sync m16n8k16 (head dim 16 is one k-step); the softmax is
// online, its running max and sum in fp32 registers, exp2 in fp32 on
// log2(e)-scaled logits. The probabilities leave the q.k^T accumulators as
// the A fragments of P.V without touching shared memory; they are the
// unnormalised e rounded to bf16, and the output is divided by the fp32 sum
// at the end (JAX rounds the normalised p to bf16 instead: both are one bf16
// rounding of a value in [0, 1], within the 2% gate against the fp32 plain
// version). Keys at T and beyond (the last tile may be short) load as zeros
// and score -inf; tile 0 always holds key 0, so the running max is finite
// from the first tile on. Query rows past k_share * tq are zero and are not
// stored, so k_share = 1 (7 rows) is one warp with 9 idle rows.

constexpr int AT_KEYS = 64;                 // keys per streamed tile
constexpr int AT_STAGES = 4;                // cp.async ring depth
constexpr int AT_WARPS = 8;                 // at most; the launch uses what the rows need
constexpr int AT_STAGE = 2 * AT_KEYS * HD;  // bf16 elements per stage: K, then V
constexpr float LOG2E = 1.4426950408889634f;

// Element offset of (key, 8-channel half) in a K or V tile: 32-byte rows whose
// two 16-byte halves swap on every other group of 4 keys, so that the 8 rows
// of each ldmatrix fall on distinct banks.
__device__ __forceinline__ int at_off(int key, int half) {
  return key * HD + (half ^ ((key >> 2) & 1)) * 8;
}

template <int MT>  // m16 row tiles per warp
__global__ void __launch_bounds__(AT_WARPS * 32)
    t2i_attend_kernel(const __nv_bfloat16* qp, const __nv_bfloat16* kp,
                      const __nv_bfloat16* vp, __nv_bfloat16* out, int rows, int t) {
  __shared__ __align__(128) __nv_bfloat16 ring[AT_STAGES][AT_STAGE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tl = lane % 4;
  const long kv0 = (long)blockIdx.x * t * DH + blockIdx.y * HD;       // image, head
  const long q0 = (long)blockIdx.x * rows * DH + blockIdx.y * HD;     // k_share * tq rows
  const int row0 = (blockIdx.z * (blockDim.x / 32) + warp) * MT * 16 + g;  // tile 0, row g
  const int ntiles = (t + AT_KEYS - 1) / AT_KEYS;

  auto issue = [&](int kt) {
    __nv_bfloat16* s = ring[kt % AT_STAGES];
    const int k0 = kt * AT_KEYS;
    for (int v = tid; v < 4 * AT_KEYS; v += blockDim.x) {  // K and V, two halves a key
      const int which = v / (2 * AT_KEYS), key = (v / 2) % AT_KEYS, half = v % 2;
      const bool in = k0 + key < t;  // keys at T and beyond: zero-filled, nothing read
      const __nv_bfloat16* src =
          (which ? vp : kp) + kv0 + (long)(in ? k0 + key : 0) * DH + half * 8;
      cp_async16(s + which * AT_KEYS * HD + at_off(key, half), src, in);
    }
  };

  // this warp's query rows as A fragments (held for the whole pass), and the
  // online-softmax state of rows g and g + 8 of each row tile
  uint32_t qa[MT][4];
  float o[MT][2][4], mx[MT][2], sum[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + mt * 16 + (i & 1) * 8;
      qa[mt][i] = r < rows ? *reinterpret_cast<const uint32_t*>(qp + q0 + (long)r * DH +
                                                                 (i >> 1) * 8 + 2 * tl)
                           : 0u;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[mt][r] = -INFINITY;
      sum[mt][r] = 0.f;
      o[mt][r][0] = o[mt][r][1] = o[mt][r][2] = o[mt][r][3] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < AT_STAGES - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<AT_STAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();                 // everyone's have; tile kt - 1 is consumed
    if (kt + AT_STAGES - 1 < ntiles) issue(kt + AT_STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* ks = ring[kt % AT_STAGES];
    const __nv_bfloat16* vs = ks + AT_KEYS * HD;
    const int kvalid = t - kt * AT_KEYS;  // keys of this tile below T (>= 1)

    // B fragments: K for the 8 eight-key n-tiles of q.k^T; V (transposed)
    // for the 4 sixteen-key k-steps x 2 eight-channel n-tiles of P.V
    uint32_t kf[AT_KEYS / 8][2], vf[AT_KEYS / 16][2][2];
#pragma unroll
    for (int jp = 0; jp < AT_KEYS / 16; ++jp) {
      uint32_t r[4];
      ldmatrix_x4(r, ks + at_off(16 * jp + (lane >> 4) * 8 + (lane & 7), (lane >> 3) & 1));
      kf[2 * jp][0] = r[0];
      kf[2 * jp][1] = r[1];
      kf[2 * jp + 1][0] = r[2];
      kf[2 * jp + 1][1] = r[3];
      ldmatrix_x4_trans(r, vs + at_off(16 * jp + ((lane >> 3) & 1) * 8 + (lane & 7), lane >> 4));
      vf[jp][0][0] = r[0];
      vf[jp][0][1] = r[1];
      vf[jp][1][0] = r[2];
      vf[jp][1][1] = r[3];
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float s[AT_KEYS / 8][4];
#pragma unroll
      for (int j = 0; j < AT_KEYS / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        mma16816(s[j], qa[mt], kf[j][0], kf[j][1]);
      }
      float tmax[2] = {mx[mt][0], mx[mt][1]};
#pragma unroll
      for (int j = 0; j < AT_KEYS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = 8 * j + 2 * tl + (e & 1) < kvalid;
          s[j][e] = in ? s[j][e] * LOG2E : -INFINITY;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float corr = exp2f(mx[mt][r] - tmax[r]);  // 0 on the first tile (mx = -inf)
        mx[mt][r] = tmax[r];
        sum[mt][r] *= corr;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          o[mt][n][2 * r] *= corr;
          o[mt][n][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < AT_KEYS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - tmax[e >> 1]);
          sum[mt][e >> 1] += s[j][e];
        }
      }
      // P . V: the accumulators of n-tiles 2kk, 2kk + 1 are the A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < AT_KEYS / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        mma16816(o[mt][0], a, vf[kk][0][0], vf[kk][0][1]);
        mma16816(o[mt][1], a, vf[kk][1][0], vf[kk][1][1]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(sum[mt][r]);
      const int row = row0 + mt * 16 + 8 * r;
      if (row >= rows) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
        *reinterpret_cast<uint32_t*>(out + q0 + (long)row * DH + n * 8 + 2 * tl) =
            pack_bf16(o[mt][n][2 * r] * inv, o[mt][n][2 * r + 1] * inv);
    }
  }
}

}  // namespace

extern "C" int ysi_decoder_init(void) {
  return (int)cudaFuncSetAttribute(keys_stream_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KEYS_SMEM);
}

extern "C" int ysi_keys_stream(const void* keys, const void* pe, const void* kq, const void* vq,
                               const void* wq_f, const void* bq, const void* wo_f, const void* bo,
                               const void* ln_s, const void* ln_b, const void* wk_f,
                               const void* bk, const void* wv_f, const void* bv, const void* qn,
                               void* out_keys, void* out_kp, void* out_vp, void* part, int n,
                               int t, int tq, int tq2, int k_share, float scale, float eps,
                               int do_i2t, void* stream) {
  if (n <= 0 || t <= 0 || k_share <= 0 || n % k_share) return (int)cudaErrorInvalidValue;
  if (do_i2t && (tq <= 0 || tq > TQ_MAX || tq2 <= 0 || tq2 > TQ_MAX))
    return (int)cudaErrorInvalidValue;
  KeysArgs p;
  p.keys = static_cast<const __nv_bfloat16*>(keys);
  p.pe = static_cast<const __nv_bfloat16*>(pe);
  p.kq = static_cast<const __nv_bfloat16*>(kq);
  p.vq = static_cast<const __nv_bfloat16*>(vq);
  p.wq_f = static_cast<const uint2*>(wq_f);
  p.bq = static_cast<const float*>(bq);
  p.wo_f = static_cast<const uint2*>(wo_f);
  p.bo = static_cast<const float*>(bo);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.wk_f = static_cast<const uint2*>(wk_f);
  p.bk = static_cast<const float*>(bk);
  p.wv_f = static_cast<const uint2*>(wv_f);
  p.bv = static_cast<const float*>(bv);
  p.qn = static_cast<const __nv_bfloat16*>(qn);
  p.out_keys = static_cast<__nv_bfloat16*>(out_keys);
  p.out_kp = static_cast<__nv_bfloat16*>(out_kp);
  p.out_vp = static_cast<__nv_bfloat16*>(out_vp);
  p.part = static_cast<float*>(part);
  p.t = t;
  p.tq = tq;
  p.tq2 = tq2;
  p.k_share = k_share;
  p.scale = scale;
  p.eps = eps;
  p.do_i2t = do_i2t;
  dim3 grid((t + ROWS - 1) / ROWS, n);
  keys_stream_kernel<<<grid, THREADS, KEYS_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ysi_t2i_attend(const void* qp, const void* kp, const void* vp, void* out, int n,
                              int tq, int t, int k_share, void* stream) {
  if (n <= 0 || t <= 0 || tq <= 0 || tq > TQ_MAX || k_share <= 0 || n % k_share)
    return (int)cudaErrorInvalidValue;
  // all k_share * tq rows of an image in one block while 8 warps of up to 4
  // row tiles hold them (k_share <= 73 at tq 7), so its k/v are read once
  const int rows = k_share * tq;
  const int mt = rows <= 16 * AT_WARPS ? 1 : 4;
  const int need = (rows + 16 * mt - 1) / (16 * mt);  // warps the rows need
  const int warps = need < AT_WARPS ? need : AT_WARPS;
  const dim3 grid(n / k_share, HEADS, (rows + 16 * mt * warps - 1) / (16 * mt * warps));
  const auto* q = static_cast<const __nv_bfloat16*>(qp);
  const auto* k = static_cast<const __nv_bfloat16*>(kp);
  const auto* v = static_cast<const __nv_bfloat16*>(vp);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mt == 1)
    t2i_attend_kernel<1><<<grid, warps * 32, 0, st>>>(q, k, v, o, rows, t);
  else
    t2i_attend_kernel<4><<<grid, warps * 32, 0, st>>>(q, k, v, o, rows, t);
  return (int)cudaGetLastError();
}

extern "C" int ysi_t2i_combine(const void* part, void* out, int n, int tiles, int tq2,
                               void* stream) {
  if (n <= 0 || tiles <= 0 || tq2 <= 0 || tq2 > TQ_MAX) return (int)cudaErrorInvalidValue;
  t2i_combine_kernel<<<n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), tiles, tq2);
  return (int)cudaGetLastError();
}
