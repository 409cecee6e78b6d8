// The SAM mask decoder's passes over the image-token ("keys") stream, for
// Hopper (sm_90a): three kernels.
//
// keys_stream_kernel, one 128-token tile of one prompt stream per block:
//
//   [i2t]  kk   = keys + pe                                    -> bf16
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
// the partials of the ceil(T / 128) tiles, out = sum o e^(m - M) / sum l e^(m - M).
//
// T need not be a multiple of 128 (SAM's grids of 14, 28, 20, 36, 50 and 60
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
// What bounds keys_stream on the H100: at config 1 the keys stream is B*K
// prompts x 1024 tokens x 256 channels (268 MB in bf16 at B*K = 512), read
// once and written once, and each pass carries four (rows x 256) x
// (256 x 128)-sized products, about 137 GFLOP: 0.139 ms at the tensor cores'
// 989 TFLOP/s against 0.17 ms for the bytes, so a pass is bound by both.
// The first design took 64 tokens a block as 4 warps of 16 rows on
// mma.sync, each warp reading all four weights (256 KB) as B fragments from
// global memory (a fragment-order copy): 4 x 256 KB of L1/L2 reads per 64
// tokens, 8.6 GB a config-1 pass; 1.638 ms for the layer-1 pass on an H100
// 80GB HBM3 at 700 W. This design:
//   * 128 tokens a block, two warpgroups of 64 rows, one block an SM (209 KB
//     of shared memory: the keys and pe tiles, a weight ring, the prompt
//     tokens);
//   * the four products on wgmma (m64n128k16 for q, kp, vp; m64n256k16 for
//     the output projection), A from registers: ldmatrix of the cp.async'd
//     keys and pe tiles (kk = keys + pe added in the fragments, one bf16
//     rounding), and for the output projection the attention output; B, the
//     weights in their (in, out) layout, by descriptor from a 4-stage ring
//     of 16 KB slabs (64 or 32 weight rows x all columns) that one thread
//     fills by TMA (128-byte swizzle) under full / empty mbarriers: Wq's 4
//     slabs, Wo's 4, then Wk's and Wv's 4 each in turn (without [i2t] only
//     the last 8). Both warpgroups take each slab, so the weights leave L2
//     once per 128 tokens (1 GB a config-1 pass, against 8.6 GB before);
//   * the small per-head products on mma.sync m16n8k16, each warp on its 16
//     rows: q_h . kq^T (16 x 8 tokens) from q kept in registers as bf16
//     pairs, the softmax over the tq tokens within each lane quad, p rounded
//     to bf16, p @ vq_h (tokens padded to 16 with zeros) in the accumulator
//     layout, which is the output projection's A fragment; and for the next
//     attention kp_h . qn^T from kp's accumulators. The first design took
//     these dot products on the CUDA cores (quad shuffles per token): its
//     i2t part and its partials were 42% and 19% of its time (variants of
//     it in PERF.md);
//   * the residual add and LayerNorm on the output projection's
//     accumulators (fp32 row statistics over each lane quad); the new keys
//     go back into the keys tile for the k/v products and out to device
//     memory;
//   * the next attention's partials: the tile max per (head, query) over the
//     block's 128 rows (lanes, then warps through shared memory), e = exp(s -
//     max) in fp32 staged in the keys tile, o = e^T vp in fp32 on the CUDA
//     cores (a thread per head, query pair and channel pair, vp staged in the
//     pe tile). A prompt spans T / 128 blocks, so each block stores its
//     tile's (m, l, o), 4.5 KB, and t2i_combine_kernel rescales and adds them.
// Measured on an H100 80GB HBM3 at 700 W (bench/kernel_turns.py, device
// time, batch 32, in turns with the first design): the layer-1 pass 0.981 ms
// at T 1024 against 1.57 (0.834 against 1.28 at T 784, 3.86 against 6.16 at
// T 4096), layer 0 (k_share 16) 0.987 against 1.55, the k/v pass 0.0246
// against 0.031; t2i_combine over 8 tiles 0.0104 against 0.029 over 16.
// Variants of this kernel (the layer-1 pass at T 1024, 0.974): without the
// partials 0.765, without the i2t softmax 0.852, without the keys and pe
// loads about 10% less; issuing a phase's slabs back to back, or one slab's
// products in flight with the tiles loaded in channel groups, was 6-11%
// slower (more registers, a barrier a slab). ptxas: 255 registers, 4 bytes
// spilled.
//
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int C = 256;        // decoder channels
constexpr int DH = 128;       // attention internal channels (downsample rate 2)
constexpr int HEADS = 8, HD = 16;
constexpr int TQ_MAX = 8;
constexpr int ROWS = 128;     // tokens per keys_stream block: 2 warpgroups of 64
constexpr int THREADS = 256;
constexpr int LDX = C + 8;    // 528-byte smem rows: ldmatrix stays conflict-free
constexpr int PART = HD + 2;  // a partial: o[HD], m, l
constexpr int HQ = HEADS * TQ_MAX;  // (head, next query) columns
constexpr int LDS = HQ + 2;         // fp32 row stride of the tile's e (8-byte pairs)
constexpr int LDT = DH + 8;         // prompt-token rows (bf16): conflict-free B fragments
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;           // weight ring depth
constexpr int SLAB = 8 * 1024;      // bf16 elements of a ring stage (16 KB)
constexpr int BOX = 64;             // bf16 columns of a 128-byte swizzled row
static_assert(DH == HEADS * HD && HD == 16, "one k16 step per head");
static_assert(HQ <= THREADS && (HQ * HD) % THREADS == 0, "partials map onto the block");

struct KeysArgs {
  const __nv_bfloat16* keys;  // (nsrc, T, C)
  const __nv_bfloat16* pe;    // (T, C)
  const __nv_bfloat16* kq;    // (N, tq, DH)  i2t keys of the prompt tokens
  const __nv_bfloat16* vq;    // (N, tq, DH)
  const float* bq;            // (DH,)
  const float* bo;            // (C,)
  const float* ln_s;          // (C,)
  const float* ln_b;          // (C,)
  const float* bk;            // (DH,)  next t2i
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

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

// bf16 pair sum, rounded once to bf16 (as a bf16 tensor add computes it)
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  const float2 x = unpack2(a), y = unpack2(b);
  return pack_bf16(x.x + y.x, x.y + y.y);
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

// The ring's slabs, in the order the block takes them: with [i2t] Wq's rows
// 64 s.. (2 boxes of 64 columns), Wo's rows 32 s.. (4 boxes), then Wk's and
// Wv's rows 64 s.. in turn; without it only Wk's and Wv's.
struct Maps {
  CUtensorMap q, o, k, v;
};

__device__ __forceinline__ void issue_slab(const Maps& m, int i, bool i2t, __nv_bfloat16* ring,
                                           uint64_t* full) {
  const int stage = i % STAGES;
  __nv_bfloat16* dst = ring + stage * SLAB;
  mbar_expect_tx(&full[stage], SLAB * 2);
  if (i2t && i < 8) {
    if (i < 4) {
      for (int b = 0; b < DH / BOX; ++b) tma_load(dst + b * 64 * BOX, &m.q, &full[stage], b * BOX, 64 * i);
    } else {
      for (int b = 0; b < C / BOX; ++b)
        tma_load(dst + b * 32 * BOX, &m.o, &full[stage], b * BOX, 32 * (i - 4));
    }
    return;
  }
  const int j = i2t ? i - 8 : i;
  const CUtensorMap* map = j % 2 ? &m.v : &m.k;
  for (int b = 0; b < DH / BOX; ++b) tma_load(dst + b * 64 * BOX, map, &full[stage], b * BOX, 64 * (j / 2));
}

__global__ void __launch_bounds__(THREADS, 1)
    keys_stream_kernel(const __grid_constant__ Maps maps, KeysArgs p) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: the ring starts on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // STAGES weight slabs
  __nv_bfloat16* Xs = ring + STAGES * SLAB;                       // keys tile, then new keys
  __nv_bfloat16* Ps = Xs + ROWS * LDX;                            // pe tile, then kp | vp
  // the prompt tokens in bf16, zero past tq / tq2: kq and qn (token, LDT),
  // vq transposed (channel, token); then the warps' column max and sum
  __nv_bfloat16* kqb = Ps + ROWS * LDX;
  __nv_bfloat16* qnb = kqb + TQ_MAX * LDT;
  __nv_bfloat16* vqt = qnb + TQ_MAX * LDT;
  float* red = reinterpret_cast<float*>(vqt + DH * TQ_MAX);  // (2, WARPS, HQ)
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * WARPS * HQ);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n = blockIdx.y, t0 = blockIdx.x * ROWS;
  const int valid = min(ROWS, p.t - t0);  // rows of this tile below T
  const long row0 = (long)n * p.t + t0;  // first output row of this tile
  const __nv_bfloat16* xg = p.keys + ((long)(n / p.k_share) * p.t + t0) * C;
  const __nv_bfloat16* pg = p.pe + (long)t0 * C;
  const bool i2t = p.do_i2t;
  const int nslabs = i2t ? 16 : 8;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], THREADS / 32);    // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < STAGES; ++i) issue_slab(maps, i, i2t, ring, full);

  for (int v = tid; v < ROWS * C / 8; v += THREADS) {
    const int r = v / (C / 8), c = (v % (C / 8)) * 8;
    const bool in = r < valid;  // rows at T and beyond: zero-filled, nothing read
    const long off = (long)(in ? r : 0) * C + c;
    cp_async16(Xs + r * LDX + c, xg + off, in);
    cp_async16(Ps + r * LDX + c, pg + off, in);
  }
  cp_async_commit();
  if (i2t) {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    const long q0 = (long)n * p.tq * DH, n0 = (long)n * p.tq2 * DH;
    for (int v = tid; v < TQ_MAX * DH; v += THREADS) {
      const int j = v / DH, c = v % DH;
      kqb[j * LDT + c] = j < p.tq ? p.kq[q0 + v] : zero;
      vqt[c * TQ_MAX + j] = j < p.tq ? p.vq[q0 + v] : zero;
      qnb[j * LDT + c] = j < p.tq2 ? p.qn[n0 + v] : zero;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // from here on each warp touches only its own 16 rows

  // slab i: wait until it has landed; release: every warp has done with it,
  // and the producer (thread 0) refills its stage with slab i + STAGES
  auto take = [&](int i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    return ring + (i % STAGES) * SLAB;
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
    if (tid == 0 && i + STAGES < nslabs) {
      mbar_wait(&empty[i % STAGES], (i / STAGES) & 1);
      issue_slab(maps, i + STAGES, i2t, ring, full);
    }
  };

  const int wr = warp * 16;  // warpgroup warp / 4 holds rows 64 (warp / 4) ..
  const int wrows = max(0, min(16, valid - wr));  // this warp's rows below T
  const __nv_bfloat16* xa = Xs + (wr + (lane & 15)) * LDX + (lane >> 4) * 8;  // ldmatrix rows
  const __nv_bfloat16* pa = Ps + (wr + (lane & 15)) * LDX + (lane >> 4) * 8;
  int slab = 0;

  if (i2t) {
    // ---- q = (kk @ Wq + bq) * scale for all heads, kept as bf16 pairs
    uint32_t q2[DH / 8][2];  // (j, row g / g + 8): columns 8 j + 2 t, + 1
    {
      float qa[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) qa[i] = 0.f;
#pragma unroll 1
      for (int s = 0; s < 4; ++s, ++slab) {
        const __nv_bfloat16* w = take(slab);
        uint32_t a[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ax[4], ap[4];
          ldmatrix_x4(ax, xa + (s * 4 + ks) * 16);
          ldmatrix_x4(ap, pa + (s * 4 + ks) * 16);
#pragma unroll
          for (int i = 0; i < 4; ++i) a[ks][i] = add2(ax[i], ap[i]);
        }
        fence_acc(qa);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_m64n128k16(qa, a[ks], smem_desc(w + ks * 16 * BOX, 64 * BOX * 2, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(qa);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_regs(a[ks]);
        release(slab);
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float b0 = p.bq[j * 8 + 2 * t], b1 = p.bq[j * 8 + 2 * t + 1];
        q2[j][0] = pack_bf16((qa[4 * j] + b0) * p.scale, (qa[4 * j + 1] + b1) * p.scale);
        q2[j][1] = pack_bf16((qa[4 * j + 2] + b0) * p.scale, (qa[4 * j + 3] + b1) * p.scale);
      }
    }

    // ---- per head h, on this warp's 16 rows (mma.sync m16n8k16): the
    // logits q_h . kq^T (16 x 8 tokens), their softmax over the tq tokens
    // within each lane quad (p rounded to bf16), and attn_h = p @ vq_h (the
    // tokens padded to k 16 with zeros) in the accumulator layout, which is
    // the A fragment of k-step h of the output projection
    uint32_t af[HEADS][4];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      const uint32_t qf[4] = {q2[2 * h][0], q2[2 * h][1], q2[2 * h + 1][0], q2[2 * h + 1][1]};
      const __nv_bfloat16* kr = kqb + g * LDT + h * HD + 2 * t;  // token g
      float sc[4] = {0.f, 0.f, 0.f, 0.f};  // rows g, g + 8 x tokens 2 t, 2 t + 1
      mma16816(sc, qf, *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
      uint32_t pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float s0 = 2 * t < p.tq ? sc[2 * r] : -INFINITY;
        float s1 = 2 * t + 1 < p.tq ? sc[2 * r + 1] : -INFINITY;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        s0 = expf(s0 - mx);
        s1 = expf(s1 - mx);
        const float inv = 1.f / quad_sum(s0 + s1);
        pa[r] = pack_bf16(s0 * inv, s1 * inv);  // p rounded to bf16
      }
      float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* vr = vqt + (h * HD + g) * TQ_MAX + 2 * t;  // channel g, tokens 2 t..
      mma16816(o0, pa, *reinterpret_cast<const uint32_t*>(vr), 0u);
      mma16816(o1, pa, *reinterpret_cast<const uint32_t*>(vr + 8 * TQ_MAX), 0u);
      af[h][0] = pack_bf16(o0[0], o0[1]);
      af[h][1] = pack_bf16(o0[2], o0[3]);
      af[h][2] = pack_bf16(o1[0], o1[1]);
      af[h][3] = pack_bf16(o1[2], o1[3]);
    }

    // ---- out = attn @ Wout: slab 4 + s holds Wout's rows of heads 2 s, 2 s + 1
    float oa[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) oa[i] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s, ++slab) {
      const __nv_bfloat16* w = take(slab);
      fence_acc(oa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs_m64n256k16(oa, af[2 * s + kk], smem_desc(w + kk * 16 * BOX, 32 * BOX * 2, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(oa);
      fence_regs(af[2 * s]);
      fence_regs(af[2 * s + 1]);
      release(slab);
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
      oa[4 * j] = k0.x + (oa[4 * j] + b0);
      oa[4 * j + 1] = k0.y + (oa[4 * j + 1] + b1);
      oa[4 * j + 2] = k1.x + (oa[4 * j + 2] + b0);
      oa[4 * j + 3] = k1.y + (oa[4 * j + 3] + b1);
      sum[0] += oa[4 * j] + oa[4 * j + 1];
      sum[1] += oa[4 * j + 2] + oa[4 * j + 3];
    }
    const float mean0 = quad_sum(sum[0]) / C, mean1 = quad_sum(sum[1]) / C;
    float var[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      oa[4 * j] -= mean0;
      oa[4 * j + 1] -= mean0;
      oa[4 * j + 2] -= mean1;
      oa[4 * j + 3] -= mean1;
      var[0] += oa[4 * j] * oa[4 * j] + oa[4 * j + 1] * oa[4 * j + 1];
      var[1] += oa[4 * j + 2] * oa[4 * j + 2] + oa[4 * j + 3] * oa[4 * j + 3];
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
          pack_bf16(oa[4 * j] * rstd0 * s0 + b0, oa[4 * j + 1] * rstd0 * s1 + b1);
      *reinterpret_cast<uint32_t*>(Xs + (wr + g + 8) * LDX + cl) =
          pack_bf16(oa[4 * j + 2] * rstd1 * s0 + b0, oa[4 * j + 3] * rstd1 * s1 + b1);
    }
    __syncwarp();
    store_rows(Xs + wr * LDX, p.out_keys + (row0 + wr) * C, C, C, wrows, lane);
  }

  // ---- next stage's k/v projections: kp = (x + pe) @ Wk + bk, vp = x @ Wv + bv
  {
    float ka[DH / 2], va[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) ka[i] = va[i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int which = 0; which < 2; ++which, ++slab) {  // Wk's slab s, then Wv's
        const __nv_bfloat16* w = take(slab);
        uint32_t a[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          ldmatrix_x4(a[ks], xa + (s * 4 + ks) * 16);
          if (which == 0) {
            uint32_t ap[4];
            ldmatrix_x4(ap, pa + (s * 4 + ks) * 16);
#pragma unroll
            for (int i = 0; i < 4; ++i) a[ks][i] = add2(a[ks][i], ap[i]);
          }
        }
        if (which) fence_acc(va); else fence_acc(ka);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t d = smem_desc(w + ks * 16 * BOX, 64 * BOX * 2, 1024);
          if (which) wgmma_rs_m64n128k16(va, a[ks], d); else wgmma_rs_m64n128k16(ka, a[ks], d);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if (which) fence_acc(va); else fence_acc(ka);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_regs(a[ks]);
        release(slab);
      }
    }
    // kp | vp with their biases, in bf16: staged in the pe rows (read by now),
    // and kp kept as the A fragments of the next attention's logits
    __syncwarp();
    uint32_t kf[HEADS][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int cl = j * 8 + 2 * t;
      const float k0 = p.bk[cl], k1 = p.bk[cl + 1], v0 = p.bv[cl], v1 = p.bv[cl + 1];
      __nv_bfloat16* r0 = Ps + (wr + g) * LDX;
      __nv_bfloat16* r1 = r0 + 8 * LDX;
      const uint32_t ka0 = pack_bf16(ka[4 * j] + k0, ka[4 * j + 1] + k1);
      const uint32_t ka1 = pack_bf16(ka[4 * j + 2] + k0, ka[4 * j + 3] + k1);
      kf[j / 2][2 * (j % 2)] = ka0;      // (row g, head j / 2's channels 8 (j % 2) + 2 t..)
      kf[j / 2][2 * (j % 2) + 1] = ka1;  // (row g + 8, the same)
      *reinterpret_cast<uint32_t*>(r0 + cl) = ka0;
      *reinterpret_cast<uint32_t*>(r1 + cl) = ka1;
      *reinterpret_cast<uint32_t*>(r0 + DH + cl) = pack_bf16(va[4 * j] + v0, va[4 * j + 1] + v1);
      *reinterpret_cast<uint32_t*>(r1 + DH + cl) = pack_bf16(va[4 * j + 2] + v0, va[4 * j + 3] + v1);
    }
    __syncwarp();
    if (!i2t) {
      store_rows(Ps + wr * LDX, p.out_kp + (row0 + wr) * DH, DH, DH, wrows, lane);
      store_rows(Ps + wr * LDX + DH, p.out_vp + (row0 + wr) * DH, DH, DH, wrows, lane);
      return;
    }

    // ---- this tile's share of the next token-to-image attention: per head,
    // the logits kp_h . qn^T of this warp's rows (mma.sync, 16 x 8 queries;
    // rows at T or beyond score -inf), the tile's max per (head, query) over
    // the block's 128 rows (lanes, then warps through shared memory), and
    // e = exp(s - max) in fp32, staged for o; l = sum e the same way
    float sc[HEADS][4];  // rows g, g + 8 x queries 2 t, 2 t + 1
    const bool in0 = wr + g < valid, in1 = wr + g + 8 < valid;
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      const __nv_bfloat16* qr = qnb + g * LDT + h * HD + 2 * t;  // query g
      // A fragment of k-step h: (row g, 2t..), (row g + 8, 2t..), (g, 8 + 2t..), (g + 8, 8 + 2t..)
      const uint32_t a[4] = {kf[h][0], kf[h][1], kf[h][2], kf[h][3]};
      sc[h][0] = sc[h][1] = sc[h][2] = sc[h][3] = 0.f;
      mma16816(sc[h], a, *reinterpret_cast<const uint32_t*>(qr),
               *reinterpret_cast<const uint32_t*>(qr + 8));
      sc[h][0] = in0 ? sc[h][0] : -INFINITY;
      sc[h][1] = in0 ? sc[h][1] : -INFINITY;
      sc[h][2] = in1 ? sc[h][2] : -INFINITY;
      sc[h][3] = in1 ? sc[h][3] : -INFINITY;
    }
    float* rmax = red;               // (WARPS, HQ)
    float* rsum = red + WARPS * HQ;  // (WARPS, HQ)
    auto warp_reduce = [&](float v, bool is_max) {  // over the 8 lanes of a quad column
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v, m);
        v = is_max ? fmaxf(v, o) : v + o;
      }
      return v;
    };
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m = warp_reduce(fmaxf(sc[h][e], sc[h][2 + e]), true);
        if (g == 0) rmax[warp * HQ + h * TQ_MAX + 2 * t + e] = m;
      }
    __syncthreads();  // every warp's maxima are in; every warp is done with the keys tile
    float* S = reinterpret_cast<float*>(Xs);  // (ROWS, LDS) e
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = h * TQ_MAX + 2 * t + e;
        float m = rmax[col];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) m = fmaxf(m, rmax[w * HQ + col]);
        // (row 0 is below T in every tile, so m is finite and e is 0 past T)
        const float e0 = expf(sc[h][e] - m), e1 = expf(sc[h][2 + e] - m);
        S[(wr + g) * LDS + col] = e0;
        S[(wr + g + 8) * LDS + col] = e1;
        const float l = warp_reduce(e0 + e1, false);
        if (g == 0) rsum[warp * HQ + col] = l;
      }
  }
  __syncthreads();
  {
    // o[(h, q)][d] = sum_r e[r][(h, q)] * vp[r][h, d] in fp32: thread ->
    // head h, queries 2 a, 2 a + 1 and channels 2 b, 2 b + 1 of the head
    const float* S = reinterpret_cast<const float*>(Xs);
    const int b = tid % 8, a = tid / 8 % 4, h = tid / 32;
    const int col = h * TQ_MAX + 2 * a;
    if (2 * a < p.tq2) {
      float o[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      const __nv_bfloat16* vr = Ps + DH + h * HD + 2 * b;
#pragma unroll 4
      for (int r = 0; r < ROWS; ++r) {
        const float2 e = *reinterpret_cast<const float2*>(S + r * LDS + col);
        const float2 v = unpack2(*reinterpret_cast<const uint32_t*>(vr + r * LDX));
        o[0][0] = fmaf(e.x, v.x, o[0][0]);
        o[0][1] = fmaf(e.x, v.y, o[0][1]);
        o[1][0] = fmaf(e.y, v.x, o[1][0]);
        o[1][1] = fmaf(e.y, v.y, o[1][1]);
      }
      float* out = p.part + ((long)n * gridDim.x + blockIdx.x) * HQ * PART;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (2 * a + q >= p.tq2) continue;
        float* oc = out + (col + q) * PART;
        oc[2 * b] = o[q][0];
        oc[2 * b + 1] = o[q][1];
        if (b == 0) {
          float m = red[col + q], l = 0.f;
          for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w * HQ + col + q]);
          for (int w = 0; w < WARPS; ++w) l += red[WARPS * HQ + w * HQ + col + q];
          oc[HD] = m;
          oc[HD + 1] = l;
        }
      }
    }
  }
}

// One prompt per block: join the partials of its ceil(T / ROWS) tiles.
constexpr int CB_THREADS = 128;

__global__ void __launch_bounds__(CB_THREADS)
    t2i_combine_kernel(const float* part, __nv_bfloat16* out, int tiles, int tq2) {
  const int n = blockIdx.x;
  const float* base = part + (long)n * tiles * HQ * PART;
  for (int o = threadIdx.x; o < HQ * HD; o += CB_THREADS) {
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

// keys_stream's shared memory: alignment slack, the weight ring, the keys and
// pe tiles, the prompt tokens (bf16), the warps' column max and sum, the
// ring's barriers
constexpr size_t KEYS_SMEM = 1024 +
                             sizeof(__nv_bfloat16) * (STAGES * SLAB + 2 * ROWS * LDX +
                                                      2 * TQ_MAX * LDT + DH * TQ_MAX) +
                             sizeof(float) * 2 * WARPS * HQ + 2 * STAGES * sizeof(uint64_t);
static_assert(ROWS * LDS * sizeof(float) <= ROWS * LDX * sizeof(__nv_bfloat16), "S fits in Xs");
static_assert(HEADS * 4 * 8 == THREADS, "o: a thread per head, query pair and channel pair");

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
  cudaError_t err = load_encode_tiled();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(keys_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)KEYS_SMEM);
  return (int)err;
}

// Weights in their (in, out) layout: wq, wk, wv (C, DH), wo (DH, C), bf16.
extern "C" int ysi_keys_stream(const void* keys, const void* pe, const void* kq, const void* vq,
                               const void* wq, const void* bq, const void* wo, const void* bo,
                               const void* ln_s, const void* ln_b, const void* wk,
                               const void* bk, const void* wv, const void* bv, const void* qn,
                               void* out_keys, void* out_kp, void* out_vp, void* part, int n,
                               int t, int tq, int tq2, int k_share, float scale, float eps,
                               int do_i2t, void* stream) {
  if (n <= 0 || t <= 0 || k_share <= 0 || n % k_share) return (int)cudaErrorInvalidValue;
  if (do_i2t && (tq <= 0 || tq > TQ_MAX || tq2 <= 0 || tq2 > TQ_MAX))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  cudaError_t err = make_map(&maps.k, wk, C, DH, 64);
  if (err == cudaSuccess) err = make_map(&maps.v, wv, C, DH, 64);
  if (err == cudaSuccess && do_i2t) err = make_map(&maps.q, wq, C, DH, 64);
  if (err == cudaSuccess && do_i2t) err = make_map(&maps.o, wo, DH, C, 32);
  if (err != cudaSuccess) return (int)err;
  KeysArgs p;
  p.keys = static_cast<const __nv_bfloat16*>(keys);
  p.pe = static_cast<const __nv_bfloat16*>(pe);
  p.kq = static_cast<const __nv_bfloat16*>(kq);
  p.vq = static_cast<const __nv_bfloat16*>(vq);
  p.bq = static_cast<const float*>(bq);
  p.bo = static_cast<const float*>(bo);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.bk = static_cast<const float*>(bk);
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
  keys_stream_kernel<<<grid, THREADS, KEYS_SMEM, static_cast<cudaStream_t>(stream)>>>(maps, p);
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
  t2i_combine_kernel<<<n, CB_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), tiles, tq2);
  return (int)cudaGetLastError();
}
