// Dense k x k convolution + bias + activation (Hopper, sm_90a): YOLOv8's 3x3
// convs, the SAM and TinyViT necks' 3x3 and TinyViT's stems.
//
// For x (B, H, W, Ci) bf16 NHWC whose pixels lie xs elements apart (xs >= Ci,
// so x may be a channel slice of a wider NHWC tensor: YOLO's C2f halves),
// w (K, K, Ci, Co) bf16 HWIO, read as a (K K Ci, Co) matrix, and bias (Co,)
// fp32 or null (zero):
//   out[b, oy, ox, n] = act(bias[n] + sum_{dy, dx, c}
//                           x[b, oy S - 1 + dy, ox S - 1 + dx, c] w[dy, dx, c, n])
// with zeros outside the image. K = 3 pads (1, 1) ("same", stride 1 or 2);
// K = 2 pads (1, 0) (stride 1: output row r reads input rows r - 1 and r).
// fp32 accumulation; the bias and act (none, SiLU, the exact erf GELU) on the
// fp32 sum, rounded once to bf16.
//
// Replaces yolo_sam_inference_tpu/ops/conv2d_fused.py:428 conv2d_act
// (pallas_call :524), whose strip kernels assemble an im2row in VMEM.
//
// What bounds it on the H100: an output pixel costs 2 K^2 Ci Co flop against
// about 2 (Ci / S^2 + Co) bytes in and out. At YOLOv8n's widths that is
// 72-144 flop per byte for Ci = Co = 16-32 (bound by device memory, under
// the card's 295), about 290 at 64 and above it at 128-256 and at the necks'
// 256 -> 256 (the tensor cores). The stems (Ci = 3) do 27 products per output
// value and are bound by their bytes.
//
// conv2d_act_kernel<K, S, BN> (Ci a multiple of 8, Co above 64) is an
// implicit GEMM: M = output pixels, N = Co, depth K^2 Ci. The first design
// took 64 output channels a block on mma.sync, refilling a two-stage ring
// with the halo and the weights of every 16-channel slice; at the SAM neck
// (Co 256) four blocks staged the same halo, each over the whole depth
// (0.1822 ms against F.conv2d's 0.0683 on an H100 80GB HBM3 at 700 W). This
// one:
//   * a block takes 8 x 16 output pixels and BN = 128 or 256 output channels:
//     all of Co up to 256, so the halo leaves L2 once per pixel tile (BN
//     halves, down to 64, while the grid would leave SMs idle: down5's 64
//     tiles);
//   * two consumer warpgroups, 64 pixels each (a warp per output row), issue
//     wgmma m64nBNk16 (bf16 in, fp32 accumulation) with A from registers: an
//     ldmatrix_x4 of the shared-memory halo tile at the tap's shift (the
//     im2row exists only as addresses) in mma.sync's fragment layout, which
//     wgmma's register form takes; the A fragments of two steps alternate, so
//     one step's products run while the next step's fragments load; the
//     producer warpgroup hands registers to the consumers (setmaxnreg 40 /
//     232), though ptxas still compiles the kernel to 168 registers and
//     spills 304 bytes at BN 256, stride 1;
//   * B, the weights, by descriptor from a ring of up to 8 stages (as many as
//     fit beside the halo) that one producer thread fills by TMA (128-byte
//     swizzle, zero fill past the matrix) under full / empty mbarriers; a
//     ring step is one tap of a KC-channel chunk (KC 64, 32 at stride 2):
//     KC x BN weights, KC / 16 wgmmas a warpgroup;
//   * the halo tile of a chunk (10 x 18 pixels at stride 1, 17 x 33 at
//     stride 2, 9 x 17 for K = 2; zero-filled outside the image and past Ci)
//     comes by cp.async from the consumers, double-buffered over the chunks,
//     so the next chunk's halo loads under this chunk's K^2 steps;
//   * epilogue: bias and act on the accumulators, the bf16 tile staged in the
//     (then free) ring, 16-byte coalesced stores masked at the ragged edges.
// It runs at about 320 TFLOP/s at the SAM neck (0.119 ms on the device),
// a third of the tensor cores' rate. Two variants, timed in turns with this
// one on the H100 (bench/kernel_turns.py), did not remove the limit: no
// producer warp (256 threads, thread 0 issues the TMA; no spill) was 6%
// faster at the neck and 35% slower at down5; 16 x 16 pixels a block at
// stride 1 (two m64 row tiles a warpgroup, BN 128: half the weights' L2
// traffic a pixel) was 7% slower at the neck. What is left is the cost of
// a ring step itself (ldmatrix, fence, KC / 16 wgmmas, a wait), not
// measured inside the kernel.
// The weight matrix's column count must be a multiple of 64 and its row count
// at least 64 (TMA boxes of 64 columns): the wrapper pads a copy once per
// tensor where Co is not (ops/conv2d_fused.py conv_weight_matrix).
//
// conv2d_act_narrow_kernel<K, S> takes Co up to 64: the first design's
// mma.sync body (below), which measured faster than the wgmma kernel there
// (the C2f slice 0.0310 ms on the device against 0.0802, a detect tower
// 0.0547 against 0.0670, in turns on the H100: a short depth and a
// one-block-per-SM kernel leave the wgmma kernel's fixed costs exposed).
//
// conv2d_act_small_kernel<K, S> takes Ci that is not a multiple of 8 with
// K^2 Ci <= 64: the stems, bound by their bytes. A block takes 8 x 64 output
// pixels and up to 64 output channels; it stages each input row of its tile
// as the row's contiguous bytes with 16-byte loads, the (K^2 Ci, 64) weight
// block transposed with 16-byte loads once, builds the 512 x K^2 Ci im2row
// (depth padded to 16 with zeros) in shared memory, runs it on mma.sync
// m16n8k16 (each warp an output row), and stores each 16-pixel run through a
// per-warp staging tile with 16-byte accesses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace {

enum { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float activate(int act, float v) {
  if (act == ACT_SILU) return v / (1.f + expf(-v));
  if (act == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;  // the small kernel's (K K Ci, wld) weight matrix
  const float* bias;       // null: zero bias
  __nv_bfloat16* out;
  int hgt, wid, ci, xs, co, ho, wo, act, wld;
  int xoff;  // the stems' kernel: x's elements past the 16-byte boundary x points below
};

// ------------------------------------------------------------- main kernel

constexpr int CONSUMERS = 2;                    // warpgroups, 64 output pixels each
constexpr int THREADS = CONSUMERS * 128 + 128;  // + a producer warpgroup (one thread issues)
constexpr int SMEM_BUDGET = 220 * 1024;         // of the card's 227 KB a block may take
constexpr int TH = 8, TW = 16, BM = TH * TW;   // output tile (a warp per row)
constexpr int BOX = 64;                        // bf16 columns of a 128-byte swizzled row

template <int K, int S>
struct Main {
  static constexpr int KC = S == 1 ? 64 : 32;  // input channels of a chunk
  static constexpr int LDA = KC + 8;           // halo pixel rows: ldmatrix conflict-free at S 1
  static constexpr int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K;
  static constexpr int PIN = IH * IW;
  static constexpr int HALO = PIN * LDA;       // elements of one halo buffer

  // weight ring depth: as many KC x BN stages as fit beside the two halo
  // buffers, at most 8 (the ring must run a TMA's L2 latency ahead)
  template <int BN>
  __host__ __device__ static constexpr int stages() {
    const int fit = (SMEM_BUDGET - 2048 - 4 * HALO) / (2 * KC * BN);
    return fit < 8 ? fit : 8;
  }
  template <int BN>
  __host__ __device__ static constexpr size_t smem() {
    return 1024 /* alignment slack */ +
           2 * ((size_t)stages<BN>() * KC * BN + 2 * (size_t)HALO) +
           2 * stages<BN>() * sizeof(uint64_t);
  }
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (BN == 256) wgmma_rs_m64n256k16(d, a, db);
  else if constexpr (BN == 128) wgmma_rs_m64n128k16(d, a, db);
  else wgmma_rs_m64n64k16(d, a, db);
}

template <int K, int S, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv2d_act_kernel(const __grid_constant__ CUtensorMap map_w, ConvArgs p) {
  using G = Main<K, S>;
  constexpr int KC = G::KC, KS = KC / 16, NACC = BN / 2, WSTAGE = KC * BN;
  constexpr int STAGES = G::template stages<BN>();
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static_assert(BM * (BN + 8) <= STAGES * WSTAGE + 2 * G::HALO, "C tile fits the ring");
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: the ring starts on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* halo = ring + STAGES * WSTAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(halo + 2 * G::HALO);
  uint64_t* empty = full + STAGES;

  const int tiles_x = (p.wo + TW - 1) / TW, tiles_y = (p.ho + TH - 1) / TH;
  int bid = blockIdx.x;
  const int ox0 = (bid % tiles_x) * TW;
  bid /= tiles_x;
  const int oy0 = (bid % tiles_y) * TH;
  const int b = bid / tiles_y;
  const int n0 = blockIdx.y * BN;
  const int chunks = (p.ci + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);              // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], CONSUMERS * 4); // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // ---- producer warpgroup: it hands its registers to the consumers; one
    // thread issues every weight copy; step st is tap st % K^2 of chunk
    // st / K^2, rows tap Ci + chunk KC of the matrix
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      const int steps = chunks * K * K;
      for (int st = 0; st < steps; ++st) {
        const int stage = st % STAGES;
        mbar_wait(&empty[stage], ((st / STAGES) & 1) ^ 1);  // the consumers have released it
        mbar_expect_tx(&full[stage], WSTAGE * 2);
        const int row = (st % (K * K)) * p.ci + (st / (K * K)) * KC;
#pragma unroll
        for (int j = 0; j < BN / BOX; ++j)
          tma_load(ring + stage * WSTAGE + j * KC * BOX, &map_w, &full[stage], n0 + j * BOX, row);
      }
    }
    return;
  }

  // ---- consumers: warp w computes output row w of the tile, with up to 232
  // registers a thread (BN 256's accumulators alone take 128)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;  // both geometries pad 1 at the top and left
  const __nv_bfloat16* xb = p.x + (long)b * p.hgt * p.wid * p.xs;
  auto load_halo = [&](int chunk, int buf) {
    __nv_bfloat16* hs = halo + buf * G::HALO;
    const int c0 = chunk * KC;
    for (int v = tid; v < G::PIN * (KC / 8); v += CONSUMERS * 128) {
      const int pix = v / (KC / 8), d = (v % (KC / 8)) * 8;
      const int y = iy0 + pix / G::IW, x = ix0 + pix % G::IW;
      const bool ok = y >= 0 && y < p.hgt && x >= 0 && x < p.wid && c0 + d < p.ci;
      cp_async16(hs + pix * G::LDA + d, ok ? xb + ((long)y * p.wid + x) * p.xs + c0 + d : p.x, ok);
    }
  };
  // this lane's A row (output pixel lane % 16 of row warp) at tap (0, 0), and
  // its 8-channel half of a 16-channel k-step
  const int arow = warp * S * G::IW + (lane & 15) * S, acol = (lane >> 4) * 8;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  uint32_t af[2][KS][4];  // the A fragments of two consecutive steps

  load_halo(0, 0);
  cp_async_commit();
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<0>();
    consumers_sync();  // the chunk's halo is in, and every read of the previous buffer done
    if (chunk + 1 < chunks) load_halo(chunk + 1, (chunk + 1) & 1);
    cp_async_commit();
    const __nv_bfloat16* hs = halo + (chunk & 1) * G::HALO;
    const int st0 = chunk * K * K;
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) {
      const int st = st0 + tap, stage = st % STAGES;
      const __nv_bfloat16* ap = hs + (arow + (tap / K) * G::IW + tap % K) * G::LDA + acol;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(af[tap & 1][ks], ap + ks * 16);
      mbar_wait(&full[stage], (st / STAGES) & 1);
      const __nv_bfloat16* wt = ring + stage * WSTAGE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)  // 64-column boxes KC * 128 bytes apart, k-step ks 16 rows down
        wgmma_rs<BN>(acc, af[tap & 1][ks], smem_desc(wt + ks * 16 * BOX, KC * BOX * 2, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: its stage and fragments are free
      fence_acc(acc);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) fence_regs(af[(tap & 1) ^ 1][ks]);
      if (tap > 0 && lane == 0) mbar_arrive(&empty[(st - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) fence_regs(af[(K * K - 1) & 1][ks]);
    if (lane == 0) mbar_arrive(&empty[(st0 + K * K - 1) % STAGES]);
  }
  consumers_sync();  // every product is done: the ring and the halo are free

  // bias and act on the accumulators (rows 16 warp + g, + 8; columns 8 j +
  // 2 t, + 1), the bf16 tile into shared memory, then 16-byte stores
  constexpr int LDC = BN + 8;
  __nv_bfloat16* cs = ring;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + 2 * t, n = n0 + col;
    const bool in = p.bias && n < p.co;  // Co % 8 == 0: n + 1 is in range too
    const float b0 = in ? __ldg(p.bias + n) : 0.f, b1 = in ? __ldg(p.bias + n + 1) : 0.f;
    *reinterpret_cast<uint32_t*>(cs + r0 * LDC + col) =
        pack_bf16(activate(p.act, acc[4 * j] + b0), activate(p.act, acc[4 * j + 1] + b1));
    *reinterpret_cast<uint32_t*>(cs + (r0 + 8) * LDC + col) =
        pack_bf16(activate(p.act, acc[4 * j + 2] + b0), activate(p.act, acc[4 * j + 3] + b1));
  }
  consumers_sync();
  for (int v = tid; v < BM * (BN / 8); v += CONSUMERS * 128) {
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    const int oy = oy0 + r / TW, ox = ox0 + r % TW, n = n0 + c;
    if (oy < p.ho && ox < p.wo && n < p.co)
      *reinterpret_cast<uint4*>(p.out + (((long)b * p.ho + oy) * p.wo + ox) * p.co + n) =
          *reinterpret_cast<const uint4*>(cs + r * LDC + c);
  }
}

// ------------------------------------------------- narrow kernel (Co <= 64)

// The first design's body, kept for Co <= 64 (YOLOv8n's early and detect
// convs, bound by their bytes), where it beats the wgmma kernel: a block
// takes NTH x 16 output pixels (8 x 16, 4 x 16 at stride 2) and 64 output
// channels; 8 warps, 4 along the pixels and 2 along 32-channel halves, on
// mma.sync m16n8k16; the depth runs over 16-channel slices, each slice's
// halo tile and K^2 weight tiles cp.async'd into a two-stage ring; A
// fragments are ldmatrix loads from the halo tile at each tap's shift.
constexpr int NTHREADS = 256;
constexpr int NKC = 16;         // input channels per slice
constexpr int NLDA = NKC + 8;   // 48-byte halo pixel rows: ldmatrix conflict-free
constexpr int NBN = 64;
constexpr int NLDB = NBN + 8;   // 144-byte weight rows: ldmatrix.trans conflict-free

template <int K, int S>
struct Narrow {
  static constexpr int TH = S == 1 ? 8 : 4, TW = 16, BM = TH * TW;
  static constexpr int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K, PIN = IH * IW;
  static constexpr int STAGE = PIN * NLDA + K * K * NKC * NLDB;  // elements
  static constexpr size_t SMEM = 2 * sizeof(__nv_bfloat16) * (size_t)STAGE;
};

template <int K, int S>
__global__ void __launch_bounds__(NTHREADS) conv2d_act_narrow_kernel(ConvArgs p) {
  using G = Narrow<K, S>;
  constexpr int MT = G::BM / 64;  // m16 tiles per warp (4 warps along the pixels)
  extern __shared__ __align__(128) unsigned char smem_n[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem_n);

  const int tiles_x = (p.wo + G::TW - 1) / G::TW, tiles_y = (p.ho + G::TH - 1) / G::TH;
  int bid = blockIdx.x;
  const int ox0 = (bid % tiles_x) * G::TW;
  bid /= tiles_x;
  const int oy0 = (bid % tiles_y) * G::TH;
  const int b = bid / tiles_y;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;  // both geometries pad 1 at the top and left
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
  const __nv_bfloat16* xb = p.x + (long)b * p.hgt * p.wid * p.xs;

  auto load = [&](int slice, int buf) {
    __nv_bfloat16* hs = base + buf * G::STAGE;
    __nv_bfloat16* ws = hs + G::PIN * NLDA;
    const int c0 = slice * NKC;
    for (int v = tid; v < G::PIN * 2; v += NTHREADS) {  // two 8-channel halves a pixel
      const int pix = v >> 1, d = (v & 1) * 8;
      const int y = iy0 + pix / G::IW, x = ix0 + pix % G::IW;
      const bool ok = y >= 0 && y < p.hgt && x >= 0 && x < p.wid && c0 + d < p.ci;
      cp_async16(hs + pix * NLDA + d, ok ? xb + ((long)y * p.wid + x) * p.xs + c0 + d : p.x, ok);
    }
    for (int v = tid; v < K * K * NKC * (NBN / 8); v += NTHREADS) {
      const int row = v / (NBN / 8), col = (v % (NBN / 8)) * 8;  // row = tap * NKC + channel
      const int c = c0 + row % NKC;
      const bool ok = c < p.ci && col < p.co;
      cp_async16(ws + row * NLDB + col,
                 ok ? p.w + ((long)(row / NKC) * p.ci + c) * p.wld + col : p.w, ok);
    }
  };

  // each lane's A row for tap (0, 0): halo pixel of output pixel m
  int abase[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = (wr + 4 * i) * 16 + (lane & 15);
    abase[i] = (m / G::TW) * S * G::IW + (m % G::TW) * S;
  }
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const bool active = wc * 32 < p.co;  // this warp's 32 channels exist

  const int slices = (p.ci + NKC - 1) / NKC;
  load(0, 0);
  cp_async_commit();
  for (int sl = 0; sl < slices; ++sl) {
    if (sl + 1 < slices) load(sl + 1, (sl + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // slice sl has landed (this thread's copies)
    __syncthreads();     // and everyone's
    const __nv_bfloat16* hs = base + (sl & 1) * G::STAGE;
    const __nv_bfloat16* ws = hs + G::PIN * NLDA;
    if (active) {
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap) {
        const int shift = (tap / K) * G::IW + tap % K;
        uint32_t bf[4][2];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ws + (tap * NKC + (lane & 7) + ((lane >> 3) & 1) * 8) * NLDB +
                                   wc * 32 + jp * 16 + (lane >> 4) * 8);
          bf[2 * jp][0] = r[0];
          bf[2 * jp][1] = r[1];
          bf[2 * jp + 1][0] = r[2];
          bf[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4];
          ldmatrix_x4(af, hs + (abase[i] + shift) * NLDA + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // bias, act and the bf16 store of each pair (col, col + 1)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wr + 4 * i) * 16 + g + 8 * h, col = wc * 32 + j * 8 + 2 * t;
        const int oy = oy0 + m / G::TW, ox = ox0 + m % G::TW;
        if (oy >= p.ho || ox >= p.wo || col >= p.co) continue;
        const float b0 = p.bias ? __ldg(p.bias + col) : 0.f;
        const float b1 = p.bias ? __ldg(p.bias + col + 1) : 0.f;
        *reinterpret_cast<uint32_t*>(p.out + (((long)b * p.ho + oy) * p.wo + ox) * p.co + col) =
            pack_bf16(activate(p.act, acc[i][j][2 * h] + b0),
                      activate(p.act, acc[i][j][2 * h + 1] + b1));
      }
}

// ------------------------------------------------------------- stems' kernel

constexpr int STH = 8, STW = 64, SBM = STH * STW;  // output tile: a warp per row
constexpr int STHREADS = STH * 32;
constexpr int SBN = 64;                            // output channels a block, at most
constexpr int KPMAX = 64;                          // K^2 Ci, at most
constexpr int LDC_S = SBN + 8;                     // per-warp staging rows

template <int K, int S>
struct Small {
  static constexpr int IH = (STH - 1) * S + K, IW = (STW - 1) * S + K;
};

// Elements of one staged input row (the row's IW xs elements, 16-byte aligned
// at both ends), of the im2row tile's rows (depth kp + 8) and the weights'.
__host__ __device__ inline int raw_ld(int iw, int xs) { return ((iw * xs + 7) / 8 + 2) * 8; }

template <int K, int S>
size_t small_smem(int xs, int kp) {
  using G = Small<K, S>;
  const size_t lds = kp + 8;
  return 2 * ((size_t)G::IH * raw_ld(G::IW, xs) + SBM * lds + SBN * lds + STH * 16 * LDC_S);
}

template <int K, int S>
__global__ void __launch_bounds__(STHREADS) conv2d_act_small_kernel(ConvArgs p, long total) {
  using G = Small<K, S>;
  extern __shared__ __align__(16) unsigned char smem_s[];
  const int rld = raw_ld(G::IW, p.xs);
  const int depth = K * K * p.ci, kp = (depth + 15) / 16 * 16, lds = kp + 8;
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem_s);
  __nv_bfloat16* As = raw + G::IH * rld;  // the im2row tile (pixel, depth)
  __nv_bfloat16* Ws = As + SBM * lds;     // the weights transposed (n, depth)
  __nv_bfloat16* Cs = Ws + SBN * lds;     // a 16 x 64 staging tile per warp

  const int tiles_x = (p.wo + STW - 1) / STW, tiles_y = (p.ho + STH - 1) / STH;
  int bid = blockIdx.x;
  const int ox0 = (bid % tiles_x) * STW;
  bid /= tiles_x;
  const int oy0 = (bid % tiles_y) * STH;
  const int b = bid / tiles_y;
  const int n0 = blockIdx.y * SBN, nb = min(SBN, p.co - n0);
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // each input row of the tile inside the image: its pixels' contiguous
  // elements, with 16-byte loads from the aligned chunk before the first;
  // rbase[r]: where pixel x's element c of staged row r lies (+ x xs + c)
  __shared__ int rbase[G::IH];
  __shared__ bool rok[G::IH];
  const int px0 = max(ix0, 0), px1 = min(ix0 + G::IW, p.wid);
  const int chunks = px1 > px0 ? rld / 8 : 0;
  if (tid < G::IH) {
    const int y = iy0 + tid;
    rok[tid] = y >= 0 && y < p.hgt && px1 > px0;
    const long row = ((long)b * p.hgt + y) * p.wid;
    const long a0 = ((row + px0) * p.xs + p.xoff) & ~7L;
    rbase[tid] = tid * rld + (int)(row * p.xs + p.xoff - a0);
  }
  for (int v = tid; v < G::IH * chunks; v += STHREADS) {
    const int r = v / chunks, q = v % chunks;
    const int y = iy0 + r;
    if (y < 0 || y >= p.hgt) continue;
    const long row = ((long)b * p.hgt + y) * p.wid;
    const long a0 = ((row + px0) * p.xs + p.xoff) & ~7L, end = (row + px1) * p.xs + p.xoff;
    const long a = a0 + q * 8;
    if (a >= end) continue;
    uint4 val;
    if (a + 8 <= total) {
      val = *reinterpret_cast<const uint4*>(p.x + a);
    } else {  // the tensor's last elements: no read past its end
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
      for (int i = 0; i < 8; ++i) e[i] = a + i < total ? p.x[a + i] : zero;
    }
    *reinterpret_cast<uint4*>(raw + r * rld + q * 8) = val;
  }
  // the weights, transposed, with 16-byte loads of each depth row
  for (int v = tid; v < kp * (SBN / 8); v += STHREADS) {
    const int kc = v / (SBN / 8), n = (v % (SBN / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (kc < depth && n < nb) val = *reinterpret_cast<const uint4*>(p.w + (long)kc * p.wld + n0 + n);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) Ws[(n + i) * lds + kc] = e[i];
  }
  // zeros past the depth
  for (int v = tid; v < SBM * (kp - depth); v += STHREADS) {
    const int m = v / (kp - depth);
    As[m * lds + depth + v % (kp - depth)] = zero;
  }
  __syncthreads();
  // the im2row tile, a (pixel, tap) pair a step: its Ci values, zero outside
  // the image
  for (int v = tid; v < SBM * K * K; v += STHREADS) {
    const int m = v / (K * K), tap = v % (K * K);
    const int r = (m / STW) * S + tap / K, x = ix0 + (m % STW) * S + tap % K;
    const bool ok = rok[r] && x >= 0 && x < p.wid;
    const __nv_bfloat16* src = raw + rbase[r] + x * p.xs;
    __nv_bfloat16* dst = As + m * lds + tap * p.ci;
    for (int c = 0; c < p.ci; ++c) dst[c] = ok ? src[c] : zero;
  }
  __syncthreads();

  // warp w: output row w, four runs of 16 pixels, all nb channels
  const int g = lane / 4, t = lane % 4;
  const int oy = oy0 + warp;
  __nv_bfloat16* cw = Cs + warp * 16 * LDC_S;
  for (int i = 0; i < STW / 16; ++i) {
    const int m0 = warp * STW + i * 16;
    float acc[SBN / 8][4];
#pragma unroll
    for (int j = 0; j < SBN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t af[4];
      af[0] = ld32(As + (m0 + g) * lds + k0 + 2 * t);
      af[1] = ld32(As + (m0 + g + 8) * lds + k0 + 2 * t);
      af[2] = ld32(As + (m0 + g) * lds + k0 + 2 * t + 8);
      af[3] = ld32(As + (m0 + g + 8) * lds + k0 + 2 * t + 8);
#pragma unroll
      for (int j = 0; j < SBN / 8; ++j) {
        if (j * 8 < nb) {
          const __nv_bfloat16* bp = Ws + (j * 8 + g) * lds + k0 + 2 * t;
          mma16816(acc[j], af, ld32(bp), ld32(bp + 8));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SBN / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= nb) continue;
      const float b0 = p.bias ? __ldg(p.bias + n0 + col) : 0.f;
      const float b1 = p.bias ? __ldg(p.bias + n0 + col + 1) : 0.f;
      *reinterpret_cast<uint32_t*>(cw + g * LDC_S + col) =
          pack_bf16(activate(p.act, acc[j][0] + b0), activate(p.act, acc[j][1] + b1));
      *reinterpret_cast<uint32_t*>(cw + (g + 8) * LDC_S + col) =
          pack_bf16(activate(p.act, acc[j][2] + b0), activate(p.act, acc[j][3] + b1));
    }
    __syncwarp();
    // the run's 16 pixels x nb channels: 16-byte stores, neighbouring lanes
    // on neighbouring addresses
    for (int v = lane; v < 16 * (nb / 8); v += 32) {
      const int r = v / (nb / 8), c = (v % (nb / 8)) * 8;
      const int ox = ox0 + i * 16 + r;
      if (oy < p.ho && ox < p.wo)
        *reinterpret_cast<uint4*>(p.out + (((long)b * p.ho + oy) * p.wo + ox) * p.co + n0 + c) =
            *reinterpret_cast<const uint4*>(cw + r * LDC_S + c);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------- host side

int num_sms = 0;

template <int K, int S, int BN>
int launch_main(const ConvArgs& p, const void* wmat, int wrows, int b, cudaStream_t st) {
  CUtensorMap map_w;
  const cudaError_t err = make_map(&map_w, wmat, wrows, p.wld, Main<K, S>::KC);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)b * ((p.ho + TH - 1) / TH) * ((p.wo + TW - 1) / TW);
  const dim3 grid((unsigned)tiles, (unsigned)((p.co + BN - 1) / BN));
  // above the shared memory allowed by ysi_conv2d_act_init the launch is refused and reported
  conv2d_act_kernel<K, S, BN><<<grid, THREADS, Main<K, S>::template smem<BN>(), st>>>(map_w, p);
  return (int)cudaGetLastError();
}

// BN: all of Co up to 256, halved (down to 64) while the grid has fewer
// blocks than the card has SMs.
template <int K, int S>
int dispatch_main(const ConvArgs& p, const void* wmat, int wrows, int b, cudaStream_t st) {
  if (p.co <= NBN) {  // the narrow kernel
    using G = Narrow<K, S>;
    const long blocks = (long)b * ((p.ho + G::TH - 1) / G::TH) * ((p.wo + G::TW - 1) / G::TW);
    conv2d_act_narrow_kernel<K, S><<<(unsigned)blocks, NTHREADS, G::SMEM, st>>>(p);
    return (int)cudaGetLastError();
  }
  const long tiles = (long)b * ((p.ho + TH - 1) / TH) * ((p.wo + TW - 1) / TW);
  int bn = p.co <= 128 ? 128 : 256;
  while (bn > 64 && tiles * ((p.co + bn - 1) / bn) < num_sms) bn /= 2;
  if (bn == 256) return launch_main<K, S, 256>(p, wmat, wrows, b, st);
  if (bn == 128) return launch_main<K, S, 128>(p, wmat, wrows, b, st);
  return launch_main<K, S, 64>(p, wmat, wrows, b, st);
}

template <int K, int S>
int launch_small(const ConvArgs& p, int b, cudaStream_t st) {
  const long tiles = (long)b * ((p.ho + STH - 1) / STH) * ((p.wo + STW - 1) / STW);
  const int kp = (K * K * p.ci + 15) / 16 * 16;
  const size_t smem = small_smem<K, S>(p.xs, kp);
  // elements readable from the 16-byte boundary at or below x
  const long total = ((long)b * p.hgt * p.wid - 1) * p.xs + p.ci + p.xoff;
  const dim3 grid((unsigned)tiles, (unsigned)((p.co + SBN - 1) / SBN));
  conv2d_act_small_kernel<K, S><<<grid, STHREADS, smem, st>>>(p, total);
  return (int)cudaGetLastError();
}

template <int K, int S>
cudaError_t allow_smem(int small_bytes) {
  cudaError_t err = cudaFuncSetAttribute(conv2d_act_kernel<K, S, 64>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Main<K, S>::template smem<64>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv2d_act_kernel<K, S, 128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Main<K, S>::template smem<128>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv2d_act_kernel<K, S, 256>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Main<K, S>::template smem<256>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv2d_act_narrow_kernel<K, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Narrow<K, S>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv2d_act_small_kernel<K, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, small_bytes);
  return err;
}

}  // namespace

// Called once, when the library is loaded: the tensor-map encoder, the SM
// count, and the shared memory of every instantiation above the 48 KB
// default (the main kernel's ring and halo buffers take 73-184 KB; the stems'
// kernel up to the card's opt-in maximum, which bounds its pixel stride).
extern "C" int ysi_conv2d_act_init(void) {
  cudaError_t err = load_encode_tiled();
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the stems' kernel's static row table counts against the same limit
  if (err == cudaSuccess) err = allow_smem<3, 1>(optin - 1024);
  if (err == cudaSuccess) err = allow_smem<3, 2>(optin - 1024);
  if (err == cudaSuccess) err = allow_smem<2, 1>(optin - 1024);
  return (int)err;
}

// w: the main kernel's (wrows, wld) weight matrix (wld a multiple of 64,
// wrows >= 64, the first K K Ci rows the HWIO weights), or the stems'
// (K K Ci, wld) matrix (wld >= Co, a multiple of 8).
extern "C" int ysi_conv2d_act(const void* x, const void* w, const void* bias, void* out, int b,
                              int hgt, int wid, int ci, int xs, int co, int wrows, int wld, int k,
                              int stride, int act, void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || ci <= 0 || co <= 0 || co % 8 || xs < ci || act < 0 ||
      act > ACT_GELU || wld < co || wld % 8 || wrows < k * k * ci)
    return (int)cudaErrorInvalidValue;
  const bool small = ci % 8 != 0;
  if (small ? k * k * ci > KPMAX : (xs % 8 != 0 || wld % BOX != 0 || wrows < BOX))
    return (int)cudaErrorInvalidValue;
  ConvArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.xoff = 0;
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hgt = hgt;
  p.wid = wid;
  p.ci = ci;
  p.xs = xs;
  p.co = co;
  p.act = act;
  p.wld = wld;
  const int pad = k == 3 ? 2 : 1;  // (1, 1) or (1, 0)
  p.ho = (hgt + pad - k) / stride + 1;
  p.wo = (wid + pad - k) / stride + 1;
  if (p.ho <= 0 || p.wo <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (small) {  // its 16-byte loads start at the boundary below x
    p.xoff = (int)(reinterpret_cast<uintptr_t>(x) % 16) / 2;
    p.x -= p.xoff;
    if (k == 3 && stride == 1) return launch_small<3, 1>(p, b, st);
    if (k == 3 && stride == 2) return launch_small<3, 2>(p, b, st);
    if (k == 2 && stride == 1) return launch_small<2, 1>(p, b, st);
  } else {
    if (k == 3 && stride == 1) return dispatch_main<3, 1>(p, w, wrows, b, st);
    if (k == 3 && stride == 2) return dispatch_main<3, 2>(p, w, wrows, b, st);
    if (k == 2 && stride == 1) return dispatch_main<2, 1>(p, w, wrows, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
