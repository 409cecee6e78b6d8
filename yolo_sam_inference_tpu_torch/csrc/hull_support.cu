// Convex-hull support points of cell masks, from the masks, for Hopper
// (sm_90a).
//
//   candidates: for each row i with a pixel, (i, minc - 0.5) and
//               (i, maxc + 0.5); for each column j with one, (minr - 0.5, j)
//               and (maxr + 0.5, j): the boundary edge midpoints
//   s[n, i, d] = r[n, i] * dir[d, 0] + c[n, i] * dir[d, 1]
//   out[n, d]  = the candidate (r, c) with the largest s, ties broken by the
//                largest r, then the largest c
//   any[n]     = whether mask n has a pixel
//
// masks (N, h, w) bool, h and w up to 2048; dirs (D, 2) fp32 unit
// directions; out (N, D, 2) fp32; any (N,) bool. The score is two products
// and a sum, each rounded to fp32 (no fused multiply-add), which is what the
// plain PyTorch version computes, so the two pick the same candidate on
// every tie.
//
// Replaces yolo_sam_inference_tpu/ops/hull_support.py:55
// (support_vertices_tpu) together with the candidates' front end of
// yolo_sam_inference_tpu/ops/metrics.py:148 (_hull_candidate_scores). The
// TPU kernel takes the candidates made by XLA and forms the (P, D) score
// tile with a matmul in VMEM; the first CUDA design took them from some 25
// plain launches over fp32 copies of the masks (about 33 MB each at config
// 1) and walked them with a thread per direction. Here one block takes a
// cell's mask, staged in shared memory a tile of up to 256 x 256 at a time
// with 16-byte loads (one 16 KB tile for a 128 x 128 crop; tiles let the
// single-cell API measure whole frames), and finds each row's and column's
// extremes in one pass over it, a warp a row and a lane a 32-bit word of it
// (four columns). It writes the candidates of the rows and columns that
// have a pixel (compacted by a block scan; about 190 of the 512 slots at
// config 1) into shared memory, and a thread then takes a direction over
// all of them, the warp's lanes reading the same candidate. The key
// (2r + 1) * 2^13 + (2c + 1) breaks a score tie by r then c in one compare.
// The plain version also holds, for each empty row or column, the mask's
// centroid, and that is never the maximum of a non-empty mask: along a unit
// direction the best candidate scores at least half the larger component
// (>= 0.35) above the best pixel centre, the centroid at most at it, and the
// fp32 roundings are below 1e-4 at these coordinates. So the kernel leaves
// the centroid out and gives an empty mask's points as the plain version
// does, all (0, 0) (its centroid, 0 / max(area, 1)).
// What bounds it on the H100: its bytes, the crops (8 MB at config 1) and
// the points (1 MB); its flops, a score (2 mul, 1 add) for each live
// candidate and direction (about 0.075 GFLOP at config 1: 512 cells x ~192
// x 256), take less than half as long at the fp32 peak. Its time goes to
// issue (about 10 instructions a candidate and direction, the compares and
// selects included) and to a block's phases in series. A block takes a
// share of the directions when there are few cells (grid y), so the
// classical batch's 95 cells still spread over the card.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 256;       // the crop is staged in tiles of up to TILE x TILE bytes
constexpr int MAX_SIDE = 2048;  // keys and shared memory hold sides up to this
constexpr int KEY_SHIFT = 13;   // 2r + 1 and 2c + 1 are below 2^13
int num_sms = 0;

struct __align__(16) Cand {  // a candidate: its coordinates and its tie-break key
  float r, c;
  int key, pad;
};

__device__ __forceinline__ bool beats(float s, int k, float bs, int bk) {
  return s > bs || (s == bs && k > bk);
}

__device__ __forceinline__ int key_of(int r2, int c2) {  // r2 = 2r + 1, c2 = 2c + 1
  return (r2 << KEY_SHIFT) | c2;
}

__global__ void __launch_bounds__(THREADS)
    hull_support_kernel(const uint8_t* masks, const float* dirs, float* out, uint8_t* any, int h,
                        int w, int d, int dchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int th_max = min(h, TILE), tw_max = min(w, TILE);
  Cand* cand = reinterpret_cast<Cand*>(smem);              // (2h + 2w,)
  uint8_t* tile = reinterpret_cast<uint8_t*>(cand + 2 * (h + w));  // (th, tw)
  int* rmin = reinterpret_cast<int*>(tile + ((th_max * tw_max + 15) & ~15));  // (h,) each
  int* rmax = rmin + h;
  int* cmin = rmax + h;  // (w,) each
  int* cmax = cmin + w;
  int* wsum = cmax + w;  // (WARPS,)
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = blockIdx.x;
  const uint8_t* src = masks + (size_t)n * h * w;

  for (int i = t; i < h; i += THREADS) {
    rmin[i] = INT_MAX;
    rmax[i] = -1;
  }
  for (int i = t; i < w; i += THREADS) {
    cmin[i] = INT_MAX;
    cmax[i] = -1;
  }
  // each row's extreme columns and each column's extreme rows, a tile at a
  // time (one tile at the crops' sizes)
  for (int r0 = 0; r0 < h; r0 += TILE)
    for (int c0 = 0; c0 < w; c0 += TILE) {
      const int th = min(TILE, h - r0), tw = min(TILE, w - c0);
      const uint8_t* tsrc = src + (size_t)r0 * w + c0;
      __syncthreads();  // the last tile's readers are done (and the arrays set)
      if ((tw & 15) == 0 && (w & 15) == 0 && (reinterpret_cast<uintptr_t>(tsrc) & 15) == 0) {
        const int per_row = tw >> 4;  // 16 bytes a load
        for (int i = t; i < th * per_row; i += THREADS) {
          const int r = i / per_row, v = i - r * per_row;
          reinterpret_cast<uint4*>(tile)[i] =
              reinterpret_cast<const uint4*>(tsrc + (size_t)r * w)[v];
        }
      } else {
        for (int i = t; i < th * tw; i += THREADS) tile[i] = tsrc[(size_t)(i / tw) * w + i % tw];
      }
      __syncthreads();
      if ((tw & 3) == 0) {
        // a warp a row, a lane a 32-bit word (4 columns) of it at a time:
        // the row's extremes by warp reductions; each lane keeps its
        // columns' first and last row over its warp's rows, merged across
        // the warps by atomics
        const int wr = tw >> 2;  // words a row, up to 64
        const uint32_t* tile32 = reinterpret_cast<const uint32_t*>(tile);
        int cmn[2][4], cmx[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            cmn[jj][b] = INT_MAX;
            cmx[jj][b] = -1;
          }
        for (int r = warp; r < th; r += WARPS) {
          int lo = INT_MAX, hi = -1;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = lane + 32 * jj;
            const uint32_t v = j < wr ? tile32[r * wr + j] : 0u;
            if (v) {  // bytes are 0 or 1: byte b of the word is column 4j + b
              lo = min(lo, 4 * j + ((__ffs(v) - 1) >> 3));
              hi = max(hi, 4 * j + ((31 - __clz(v)) >> 3));
            }
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if ((v >> (8 * b)) & 0xffu) {
                cmn[jj][b] = min(cmn[jj][b], r);
                cmx[jj][b] = r;
              }
          }
          lo = __reduce_min_sync(0xffffffffu, lo);
          hi = __reduce_max_sync(0xffffffffu, hi);
          if (lane == 0 && hi >= 0) {  // this warp owns row r0 + r
            rmin[r0 + r] = min(rmin[r0 + r], c0 + lo);
            rmax[r0 + r] = c0 + hi;
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (cmx[jj][b] >= 0) {
              atomicMin(&cmin[c0 + 4 * (lane + 32 * jj) + b], r0 + cmn[jj][b]);
              atomicMax(&cmax[c0 + 4 * (lane + 32 * jj) + b], r0 + cmx[jj][b]);
            }
      } else {  // any width: a warp a row byte by byte, a thread a column
        for (int r = warp; r < th; r += WARPS) {
          int lo = INT_MAX, hi = -1;
          for (int c = lane; c < tw; c += 32)
            if (tile[r * tw + c]) {
              lo = min(lo, c);
              hi = c;
            }
          lo = __reduce_min_sync(0xffffffffu, lo);
          hi = __reduce_max_sync(0xffffffffu, hi);
          if (lane == 0 && hi >= 0) {
            rmin[r0 + r] = min(rmin[r0 + r], c0 + lo);
            rmax[r0 + r] = c0 + hi;
          }
        }
        if (t < tw) {
          int lo = INT_MAX, hi = -1;
          for (int r = 0; r < th; ++r)
            if (tile[r * tw + t]) {
              lo = min(lo, r);
              hi = r;
            }
          if (hi >= 0) {  // this thread owns column c0 + t
            cmin[c0 + t] = min(cmin[c0 + t], r0 + lo);
            cmax[c0 + t] = r0 + hi;
          }
        }
      }
    }
  __syncthreads();

  // the candidates of the rows and columns with a pixel, compacted: thread t
  // writes row i0 + t's two and column i0 + t's two at its offset of a block
  // scan, for i0 = 0, THREADS, ...
  int total = 0;
  for (int i0 = 0; i0 < max(h, w); i0 += THREADS) {
    const int i = i0 + t;
    const bool row_ok = i < h && rmax[i] >= 0, col_ok = i < w && cmax[i] >= 0;
    const int cnt = 2 * row_ok + 2 * col_ok;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int off = total + incl - cnt;
    for (int k = 0; k < WARPS; ++k) {
      off += k < warp ? wsum[k] : 0;
      total += wsum[k];
    }
    __syncthreads();  // wsum is read before the next chunk writes it
    const float fi = (float)i;
    if (row_ok) {  // (i, minc - 0.5), (i, maxc + 0.5): 2r + 1 = 2i + 1
      cand[off++] = {fi, rmin[i] - 0.5f, key_of(2 * i + 1, 2 * rmin[i]), 0};
      cand[off++] = {fi, rmax[i] + 0.5f, key_of(2 * i + 1, 2 * rmax[i] + 2), 0};
    }
    if (col_ok) {  // (minr - 0.5, i), (maxr + 0.5, i): 2c + 1 = 2i + 1
      cand[off++] = {cmin[i] - 0.5f, fi, key_of(2 * cmin[i], 2 * i + 1), 0};
      cand[off++] = {cmax[i] + 0.5f, fi, key_of(2 * cmax[i] + 2, 2 * i + 1), 0};
    }
  }
  const int d_lo = blockIdx.y * dchunk, d_hi = min(d, d_lo + dchunk);
  if (blockIdx.y == 0 && t == 0) any[n] = total > 0;
  float2* dst = reinterpret_cast<float2*>(out) + (size_t)n * d;
  if (total == 0) {  // an empty mask: every point its centroid, (0, 0)
    for (int k = d_lo + t; k < d_hi; k += THREADS) dst[k] = make_float2(0.f, 0.f);
    return;
  }
  __syncthreads();

  // the selection: a thread a direction over every candidate (the warp's
  // lanes read the same one: a broadcast), in two chains for the latency
  for (int k = d_lo + t; k < d_hi; k += THREADS) {
    const float dx = dirs[2 * k], dy = dirs[2 * k + 1];
    float bs0 = -INFINITY, bs1 = -INFINITY;
    int bk0 = -1, bk1 = -1;
    int i = 0;
    for (; i + 1 < total; i += 2) {
      const Cand p = cand[i], q = cand[i + 1];
      const float sp = __fadd_rn(__fmul_rn(p.r, dx), __fmul_rn(p.c, dy));
      const float sq = __fadd_rn(__fmul_rn(q.r, dx), __fmul_rn(q.c, dy));
      const bool bp = beats(sp, p.key, bs0, bk0), bq = beats(sq, q.key, bs1, bk1);
      bs0 = bp ? sp : bs0;
      bk0 = bp ? p.key : bk0;
      bs1 = bq ? sq : bs1;
      bk1 = bq ? q.key : bk1;
    }
    if (i < total) {
      const Cand p = cand[i];
      const float sp = __fadd_rn(__fmul_rn(p.r, dx), __fmul_rn(p.c, dy));
      const bool bp = beats(sp, p.key, bs0, bk0);
      bs0 = bp ? sp : bs0;
      bk0 = bp ? p.key : bk0;
    }
    if (beats(bs1, bk1, bs0, bk0)) bk0 = bk1;
    // r = ((key >> KEY_SHIFT) - 1) / 2, c = ((key & (2^KEY_SHIFT - 1)) - 1) / 2
    dst[k] = make_float2(0.5f * (float)((bk0 >> KEY_SHIFT) - 1),
                         0.5f * (float)((bk0 & ((1 << KEY_SHIFT) - 1)) - 1));
  }
}

size_t smem_bytes(int h, int w) {
  const int th = min(h, TILE), tw = min(w, TILE);
  return (size_t)(2 * (h + w)) * sizeof(Cand) + ((th * tw + 15) & ~15) +
         (size_t)(2 * (h + w) + WARPS) * sizeof(int);
}

}  // namespace

// Called once, when the library is loaded: the SM count and the shared
// memory of the largest mask, MAX_SIDE x MAX_SIDE (224 KB).
extern "C" int ysi_hull_support_init(void) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hull_support_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_SIDE, MAX_SIDE));
  return (int)err;
}

extern "C" int ysi_hull_support(const void* masks, const void* dirs, void* out, void* any, int n,
                                int h, int w, int d, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h > MAX_SIDE || w > MAX_SIDE || d <= 0)
    return (int)cudaErrorInvalidValue;
  // directions a block: all of them, or a share (whole warps of them)
  // where there are fewer than two cells an SM
  const int warps = (d + 31) / 32;
  const int split = max(1, min(warps, (2 * num_sms + n - 1) / n));
  const int dchunk = (warps + split - 1) / split * 32;
  const dim3 grid(n, (d + dchunk - 1) / dchunk);
  hull_support_kernel<<<grid, THREADS, smem_bytes(h, w), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const float*>(dirs),
      static_cast<float*>(out), static_cast<uint8_t*>(any), h, w, d, dchunk);
  return (int)cudaGetLastError();
}
