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
// conv2d_act_kernel<K, S, ACT> (Ci a multiple of 8) is an implicit GEMM: M =
// output pixels, N = Co, depth K^2 Ci. A block takes 8 x 16 output pixels (4 x
// 16 at stride 2) and 64 output channels; 8 warps, 4 along the pixels and 2
// along 32-channel halves, on mma.sync m16n8k16 (bf16 in, fp32 accumulators).
// The depth runs over 16-channel slices of Ci. For each slice the block
// cp.asyncs the input tile with its halo (10 x 18 pixels at stride 1, 9 x 33
// at stride 2, 9 x 17 for K = 2; zero-filled outside the image) and the K^2
// taps' 16 x 64 weight tiles into shared memory, double-buffered. A tap's A
// fragments are ldmatrix loads from the halo tile at that tap's shift (each
// pixel's 16 channels are one 48-byte row: conflict-free at stride 1, 2-way
// at stride 2), so the im2row exists only as addresses into shared memory
// and each input value comes from L2 once per block, not K^2 times. No
// wgmma or TMA yet.
//
// conv2d_act_small_kernel<K, S, ACT> takes Ci that is not a multiple of 8
// with K^2 Ci <= 64: the stems. A block stages its 8 x 16 output pixels' raw
// input tile (17 x 33 x Ci values at stride 2) as scalars, builds the 128 x
// K^2 Ci im2row tile (depth padded to 16 with zeros) in shared memory once,
// and runs it against the weights in 64-column passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int BN = 64;        // output channels per block (a pass of the small kernel)
constexpr int KC = 16;        // input channels per slice of the depth
constexpr int LDA = KC + 8;   // 48-byte halo pixel rows: ldmatrix conflict-free
constexpr int LDB = BN + 8;   // 144-byte weight rows: ldmatrix.trans conflict-free
constexpr int KPMAX = 64;     // the small kernel's depth K^2 Ci, at most
constexpr int LDS = KPMAX + 8;

enum { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_SILU) return v / (1.f + expf(-v));
  if (ACT == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

// An output tile of TH x 16 pixels and the input tile (with its halo) it reads.
template <int K, int S, int TH_>
struct Geo {
  static constexpr int TH = TH_, TW = 16;
  static constexpr int BM = TH * TW;
  static constexpr int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K;
  static constexpr int PIN = IH * IW;
};

// The main kernel's tile and its double-buffered shared memory: a stage
// holds one 16-channel slice of the halo tile and the K^2 taps' weights.
template <int K, int S>
struct MainGeo : Geo<K, S, S == 1 ? 8 : 4> {
  using Base = Geo<K, S, S == 1 ? 8 : 4>;
  static constexpr int STAGE = Base::PIN * LDA + K * K * KC * LDB;  // elements
  static constexpr size_t SMEM = 2 * sizeof(__nv_bfloat16) * (size_t)STAGE;
};

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* bias;  // null: zero bias
  __nv_bfloat16* out;
  int hgt, wid, ci, xs, co, ho, wo;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The block's (image, tile origin) from blockIdx.x.
template <class G>
__device__ __forceinline__ void tile_of(const ConvArgs& p, int& b, int& oy0, int& ox0) {
  const int tiles_x = (p.wo + G::TW - 1) / G::TW, tiles_y = (p.ho + G::TH - 1) / G::TH;
  int bid = blockIdx.x;
  ox0 = (bid % tiles_x) * G::TW;
  bid /= tiles_x;
  oy0 = (bid % tiles_y) * G::TH;
  b = bid / tiles_y;
}

// Bias, activation and the bf16 store of the pair (col, col + 1) at tile row m.
template <class G, int ACT>
__device__ __forceinline__ void store_pair(const ConvArgs& p, int b, int oy0, int ox0, int m,
                                           int col, float v0, float v1) {
  const int oy = oy0 + m / G::TW, ox = ox0 + m % G::TW;
  if (oy >= p.ho || ox >= p.wo || col >= p.co) return;
  if (p.bias) {
    v0 += p.bias[col];
    v1 += p.bias[col + 1];
  }
  *reinterpret_cast<uint32_t*>(p.out + (((long)b * p.ho + oy) * p.wo + ox) * p.co + col) =
      pack_bf16(activate<ACT>(v0), activate<ACT>(v1));
}

template <int K, int S, int ACT>
__global__ void __launch_bounds__(THREADS) conv2d_act_kernel(ConvArgs p) {
  using G = MainGeo<K, S>;
  constexpr int MT = G::BM / 64;  // m16 tiles per warp (4 warps along the pixels)
  constexpr int STAGE = G::STAGE;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);

  int b, oy0, ox0;
  tile_of<G>(p, b, oy0, ox0);
  const int n0 = blockIdx.y * BN;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;  // both geometries pad 1 at the top and left
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
  const __nv_bfloat16* xb = p.x + (long)b * p.hgt * p.wid * p.xs;

  auto load = [&](int slice, int buf) {
    __nv_bfloat16* hs = base + buf * STAGE;
    __nv_bfloat16* ws = hs + G::PIN * LDA;
    const int c0 = slice * KC;
    for (int v = tid; v < G::PIN * 2; v += THREADS) {  // two 8-channel halves a pixel
      const int pix = v >> 1, d = (v & 1) * 8;
      const int y = iy0 + pix / G::IW, x = ix0 + pix % G::IW;
      const bool ok = y >= 0 && y < p.hgt && x >= 0 && x < p.wid && c0 + d < p.ci;
      cp_async16(hs + pix * LDA + d, ok ? xb + ((long)y * p.wid + x) * p.xs + c0 + d : p.x, ok);
    }
    for (int v = tid; v < K * K * KC * (BN / 8); v += THREADS) {
      const int row = v / (BN / 8), col = (v % (BN / 8)) * 8;  // row = tap * KC + channel
      const int c = c0 + row % KC;
      const bool ok = c < p.ci && n0 + col < p.co;
      cp_async16(ws + row * LDB + col,
                 ok ? p.w + ((long)(row / KC) * p.ci + c) * p.co + n0 + col : p.w, ok);
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
  const bool active = n0 + wc * 32 < p.co;  // this warp's 32 channels exist

  const int slices = (p.ci + KC - 1) / KC;
  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // slice s has landed (this thread's copies)
    __syncthreads();     // and everyone's
    const __nv_bfloat16* hs = base + (s & 1) * STAGE;
    const __nv_bfloat16* ws = hs + G::PIN * LDA;
    if (active) {
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap) {
        const int shift = (tap / K) * G::IW + tap % K;
        uint32_t bf[4][2];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ws + (tap * KC + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                                   wc * 32 + jp * 16 + (lane >> 4) * 8);
          bf[2 * jp][0] = r[0];
          bf[2 * jp][1] = r[1];
          bf[2 * jp + 1][0] = r[2];
          bf[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4];
          ldmatrix_x4(af, hs + (abase[i] + shift) * LDA + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = (wr + 4 * i) * 16 + g, col = n0 + wc * 32 + j * 8 + 2 * t;
      store_pair<G, ACT>(p, b, oy0, ox0, m, col, acc[i][j][0], acc[i][j][1]);
      store_pair<G, ACT>(p, b, oy0, ox0, m + 8, col, acc[i][j][2], acc[i][j][3]);
    }
}

template <int K, int S, int ACT>
__global__ void __launch_bounds__(THREADS) conv2d_act_small_kernel(ConvArgs p) {
  using G = Geo<K, S, 8>;
  constexpr int CMAX = KPMAX / (K * K);  // the most input channels it takes
  __shared__ __align__(16) __nv_bfloat16 raw[G::PIN * CMAX];
  __shared__ __align__(16) __nv_bfloat16 As[G::BM * LDS];  // the im2row tile (pixel, depth)
  __shared__ __align__(16) __nv_bfloat16 Ws[BN * LDS];     // weights transposed (n, depth)

  int b, oy0, ox0;
  tile_of<G>(p, b, oy0, ox0);
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* xb = p.x + (long)b * p.hgt * p.wid * p.xs;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int depth = K * K * p.ci, kp = (depth + 15) / 16 * 16;

  for (int v = tid; v < G::PIN * p.ci; v += THREADS) {
    const int pix = v / p.ci, c = v - pix * p.ci;
    const int y = iy0 + pix / G::IW, x = ix0 + pix % G::IW;
    raw[v] = (y >= 0 && y < p.hgt && x >= 0 && x < p.wid) ? xb[((long)y * p.wid + x) * p.xs + c]
                                                          : zero;
  }
  __syncthreads();
  for (int v = tid; v < G::BM * kp; v += THREADS) {
    const int m = v / kp, kc = v - m * kp;
    __nv_bfloat16 val = zero;
    if (kc < depth) {
      const int tap = kc / p.ci, c = kc - tap * p.ci;
      val = raw[(((m / G::TW) * S + tap / K) * G::IW + (m % G::TW) * S + tap % K) * p.ci + c];
    }
    As[m * LDS + kc] = val;
  }

  const int r0 = warp * 16;  // each warp: 16 pixels, all 64 channels of a pass
  for (int n0 = 0; n0 < p.co; n0 += BN) {
    for (int v = tid; v < kp * BN; v += THREADS) {  // neighbouring threads, neighbouring n
      const int kc = v / BN, n = v % BN;
      Ws[n * LDS + kc] = (kc < depth && n0 + n < p.co) ? p.w[(long)kc * p.co + n0 + n] : zero;
    }
    __syncthreads();  // As (first pass) and Ws are complete
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t af[4];
      af[0] = ld32(As + (r0 + g) * LDS + k0 + 2 * t);
      af[1] = ld32(As + (r0 + g + 8) * LDS + k0 + 2 * t);
      af[2] = ld32(As + (r0 + g) * LDS + k0 + 2 * t + 8);
      af[3] = ld32(As + (r0 + g + 8) * LDS + k0 + 2 * t + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (n0 + j * 8 < p.co) {
          const __nv_bfloat16* bp = Ws + (j * 8 + g) * LDS + k0 + 2 * t;
          mma16816(acc[j], af, ld32(bp), ld32(bp + 8));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      store_pair<G, ACT>(p, b, oy0, ox0, r0 + g, col, acc[j][0], acc[j][1]);
      store_pair<G, ACT>(p, b, oy0, ox0, r0 + g + 8, col, acc[j][2], acc[j][3]);
    }
    __syncthreads();  // Ws is read before the next pass refills it
  }
}

template <int K, int S, int ACT>
int launch(const ConvArgs& p, int b, bool small, cudaStream_t st) {
  if (small) {
    using G = Geo<K, S, 8>;
    const long blocks = (long)b * ((p.ho + G::TH - 1) / G::TH) * ((p.wo + G::TW - 1) / G::TW);
    conv2d_act_small_kernel<K, S, ACT><<<(unsigned)blocks, THREADS, 0, st>>>(p);
  } else {
    using G = MainGeo<K, S>;
    const long blocks = (long)b * ((p.ho + G::TH - 1) / G::TH) * ((p.wo + G::TW - 1) / G::TW);
    const dim3 grid((unsigned)blocks, (unsigned)((p.co + BN - 1) / BN));
    // above the shared memory allowed by ysi_conv2d_act_init the launch is refused and reported
    conv2d_act_kernel<K, S, ACT><<<grid, THREADS, G::SMEM, st>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int K, int S>
int dispatch(const ConvArgs& p, int b, bool small, int act, cudaStream_t st) {
  if (act == ACT_SILU) return launch<K, S, ACT_SILU>(p, b, small, st);
  if (act == ACT_GELU) return launch<K, S, ACT_GELU>(p, b, small, st);
  return launch<K, S, ACT_NONE>(p, b, small, st);
}

template <int K, int S>
cudaError_t allow_smem() {
  const int bytes = (int)MainGeo<K, S>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(conv2d_act_kernel<K, S, ACT_NONE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv2d_act_kernel<K, S, ACT_SILU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv2d_act_kernel<K, S, ACT_GELU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

}  // namespace

// Called once, when the library is loaded: the main kernel's two stages take
// 57 KB (K 3, stride 1), 68 KB (stride 2) and 32 KB (K 2) of shared memory.
extern "C" int ysi_conv2d_act_init(void) {
  cudaError_t err = allow_smem<3, 1>();
  if (err == cudaSuccess) err = allow_smem<3, 2>();
  if (err == cudaSuccess) err = allow_smem<2, 1>();
  return (int)err;
}

extern "C" int ysi_conv2d_act(const void* x, const void* w, const void* bias, void* out, int b,
                              int hgt, int wid, int ci, int xs, int co, int k, int stride,
                              int act, void* stream) {
  if (b <= 0 || hgt <= 0 || wid <= 0 || ci <= 0 || co <= 0 || co % 8 || xs < ci || act < 0 ||
      act > ACT_GELU)
    return (int)cudaErrorInvalidValue;
  const bool small = ci % 8 != 0;
  if (small ? k * k * ci > KPMAX : xs % 8 != 0) return (int)cudaErrorInvalidValue;
  ConvArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hgt = hgt;
  p.wid = wid;
  p.ci = ci;
  p.xs = xs;
  p.co = co;
  const int pad = k == 3 ? 2 : 1;  // (1, 1) or (1, 0)
  p.ho = (hgt + pad - k) / stride + 1;
  p.wo = (wid + pad - k) / stride + 1;
  if (p.ho <= 0 || p.wo <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && stride == 1) return dispatch<3, 1>(p, b, small, act, st);
  if (k == 3 && stride == 2) return dispatch<3, 2>(p, b, small, act, st);
  if (k == 2 && stride == 1) return dispatch<2, 1>(p, b, small, act, st);
  return (int)cudaErrorInvalidValue;
}
