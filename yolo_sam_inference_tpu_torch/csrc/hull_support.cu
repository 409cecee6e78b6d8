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
// masks (N, h, w) bool, any sides; dirs (D, 2) fp32 unit directions; out
// (N, D, 2) fp32; any (N,) bool. The score is two products and a sum, each
// rounded to fp32 (no fused multiply-add), which is what the plain PyTorch
// version computes, so the two pick the same candidate on every tie.
//
// Replaces yolo_sam_inference_tpu/ops/hull_support.py:55
// (support_vertices_tpu) together with the candidates' front end of
// yolo_sam_inference_tpu/ops/metrics.py:148 (_hull_candidate_scores). The
// TPU kernel takes the candidates made by XLA and forms the (P, D) score
// tile with a matmul in VMEM; the first CUDA design took them from some 25
// plain launches over fp32 copies of the masks (about 33 MB each at config
// 1) and walked them with a thread per direction.
//
// Crops (both sides up to TILE: config 1's and the classical path's 128 x
// 128 cells), hull_support_kernel, one launch: a block takes a cell's mask,
// staged in shared memory with 16-byte loads (one 16 KB tile for a 128 x
// 128 crop), and finds each row's and column's extremes in one pass over
// it, a warp a row and a lane a 32-bit word of it (four columns). It writes
// the candidates of the rows and columns that have a pixel (compacted by a
// block scan; about 190 of the 512 slots at config 1) into shared memory,
// and a thread then takes a direction over all of them, the warp's lanes
// reading the same candidate. The key (2r + 1) * 2^13 + (2c + 1) breaks a
// score tie by r then c in one compare.
//
// Whole frames (a side above TILE: the single-cell API on 2048^2 and larger
// frames, any metric_crop above 256), three launches after a memset of the
// scratch: hull_support_extremes_kernel, a block a TILE x TILE tile of a
// mask, the same pass, merging its rows' and columns' extremes into the
// scratch in device memory by atomic maxima ((w - minc, maxc + 1) a row,
// (h - minr, maxr + 1) a column; 0 where there is no pixel);
// hull_support_select_kernel, a block a (mask, 32 directions, slice of the
// rows and columns): the slice's candidates compacted into shared memory
// THREADS rows and columns at a time, each warp scoring every eighth of
// them for the 32 directions (a lane each) with its best carried in
// registers across the chunks, the warps' bests merged into one partial a
// slice; hull_support_merge_kernel, a thread a direction over the slices'
// partials. Keys are 64 bits, (2r + 1) * 2^32 + (2c + 1), for any side.
// Slices (a few when there are few masks: the plan is the wrapper's,
// ops/hull_support.py::frame_plan) keep the card busy on a single frame.
//
// The plain version also holds, for each empty row or column, the mask's
// centroid, and that is never the maximum of a non-empty mask: along a unit
// direction the best candidate scores at least half the larger component
// (>= 0.35) above the best pixel centre, the centroid at most at it, and the
// fp32 roundings (1.5 ulp of a score) stay below 0.2 at coordinates below
// 2^20. So the kernels
// leave the centroid out and give an empty mask's points as the plain
// version does, all (0, 0) (its centroid, 0 / max(area, 1)).
// What bounds it on the H100: its bytes, the masks (8 MB at config 1, 64 MB
// for an 8192^2 frame) and the points (1 MB at config 1); its flops, a score
// (2 mul, 1 add) for each live candidate and direction (about 0.075 GFLOP at
// config 1: 512 cells x ~192 x 256), take less than half as long at the fp32
// peak. The crops' time goes to issue (about 10 instructions a candidate and
// direction, the compares and selects included) and to a block's phases in
// series. A crop's block takes a share of the directions when there are few
// cells (grid y), so the classical batch's 95 cells still spread over the
// card. A frame's extremes pass reads each byte once over many blocks.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 256;      // masks with both sides up to TILE take the crops' kernel
constexpr int KEY_SHIFT = 13;  // the crops' keys: 2r + 1 and 2c + 1 are below 2^13
constexpr int GROUP = 32;      // directions a block of the frames' selection: a lane each
int num_sms = 0;

struct __align__(16) Cand {  // a crop's candidate: its coordinates and its tie-break key
  float r, c;
  int key, pad;
};

struct __align__(16) WideCand {  // a frame's candidate: the key for any side
  float r, c;
  unsigned long long key;
};

__device__ __forceinline__ bool beats(float s, int k, float bs, int bk) {
  return s > bs || (s == bs && k > bk);
}

__device__ __forceinline__ bool beats(float s, unsigned long long k, float bs,
                                      unsigned long long bk) {
  return s > bs || (s == bs && k > bk);
}

__device__ __forceinline__ int key_of(int r2, int c2) {  // r2 = 2r + 1, c2 = 2c + 1
  return (r2 << KEY_SHIFT) | c2;
}

__device__ __forceinline__ unsigned long long wide_key(unsigned r2, unsigned c2) {
  return (unsigned long long)r2 << 32 | c2;  // r2 = 2r + 1, c2 = 2c + 1, below 2^32
}

__device__ __forceinline__ float score(float r, float c, float dx, float dy) {
  return __fadd_rn(__fmul_rn(r, dx), __fmul_rn(c, dy));
}

// This thread's offset in an exclusive scan of `cnt` over the block's
// threads in order; `sum` gets the block's total. Two barriers.
__device__ __forceinline__ int block_scan(int cnt, int* wsum, int& sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int off = incl - cnt;
  sum = 0;
  for (int k = 0; k < WARPS; ++k) {
    off += k < warp ? wsum[k] : 0;
    sum += wsum[k];
  }
  __syncthreads();  // wsum is read before the next scan writes it
  return off;
}

// Stages the th x tw tile at src (rows `stride` bytes apart) in `tile` and
// finds the extremes of its rows and columns, in tile coordinates: row(r,
// lo, hi) is called once for each row with a pixel, by one lane of the warp
// that owns it; each column's first and last row are merged into cmin[c] /
// cmax[c] (shared memory, set to INT_MAX / -1 before the call) by atomics.
// One barrier, between the loads and the pass.
template <class RowFn>
__device__ __forceinline__ void tile_extremes(const uint8_t* src, size_t stride, int th, int tw,
                                              uint8_t* tile, int* cmin, int* cmax, RowFn row) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if ((tw & 15) == 0 && (stride & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_row = tw >> 4;  // 16 bytes a load
    for (int i = t; i < th * per_row; i += THREADS) {
      const int r = i / per_row, v = i - r * per_row;
      reinterpret_cast<uint4*>(tile)[i] = reinterpret_cast<const uint4*>(src + (size_t)r * stride)[v];
    }
  } else {
    for (int i = t; i < th * tw; i += THREADS) tile[i] = src[(size_t)(i / tw) * stride + i % tw];
  }
  __syncthreads();
  if ((tw & 3) == 0) {
    // a warp a row, a lane a 32-bit word (4 columns) of it at a time: the
    // row's extremes by warp reductions; each lane keeps its columns' first
    // and last row over its warp's rows, merged across the warps by atomics
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
      if (lane == 0 && hi >= 0) row(r, lo, hi);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (cmx[jj][b] >= 0) {
          atomicMin(&cmin[4 * (lane + 32 * jj) + b], cmn[jj][b]);
          atomicMax(&cmax[4 * (lane + 32 * jj) + b], cmx[jj][b]);
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
      if (lane == 0 && hi >= 0) row(r, lo, hi);
    }
    if (t < tw) {
      int lo = INT_MAX, hi = -1;
      for (int r = 0; r < th; ++r)
        if (tile[r * tw + t]) {
          lo = min(lo, r);
          hi = r;
        }
      if (hi >= 0) {  // this thread owns column t
        cmin[t] = lo;
        cmax[t] = hi;
      }
    }
  }
}

// ---------------------------------------------------------------- crops

__global__ void __launch_bounds__(THREADS)
    hull_support_kernel(const uint8_t* masks, const float* dirs, float* out, uint8_t* any, int h,
                        int w, int d, int dchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  Cand* cand = reinterpret_cast<Cand*>(smem);                         // (2h + 2w,)
  uint8_t* tile = reinterpret_cast<uint8_t*>(cand + 2 * (h + w));     // (h, w)
  int* rmin = reinterpret_cast<int*>(tile + ((h * w + 15) & ~15));  // (h,) each
  int* rmax = rmin + h;
  int* cmin = rmax + h;  // (w,) each
  int* cmax = cmin + w;
  int* wsum = cmax + w;  // (WARPS,)
  const int t = threadIdx.x;
  const int n = blockIdx.x;

  for (int i = t; i < h; i += THREADS) {
    rmin[i] = INT_MAX;
    rmax[i] = -1;
  }
  for (int i = t; i < w; i += THREADS) {
    cmin[i] = INT_MAX;
    cmax[i] = -1;
  }
  // each row's extreme columns and each column's extreme rows (the arrays
  // are set before the pass: its barrier orders them)
  tile_extremes(masks + (size_t)n * h * w, w, h, w, tile, cmin, cmax, [&](int r, int lo, int hi) {
    rmin[r] = lo;
    rmax[r] = hi;
  });
  __syncthreads();

  // the candidates of the rows and columns with a pixel, compacted: thread t
  // writes row i0 + t's two and column i0 + t's two at its offset of a block
  // scan, for i0 = 0, THREADS, ...
  int total = 0;
  for (int i0 = 0; i0 < max(h, w); i0 += THREADS) {
    const int i = i0 + t;
    const bool row_ok = i < h && rmax[i] >= 0, col_ok = i < w && cmax[i] >= 0;
    const int cnt = 2 * row_ok + 2 * col_ok;
    int sum;
    int off = total + block_scan(cnt, wsum, sum);
    total += sum;
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
      const float sp = score(p.r, p.c, dx, dy), sq = score(q.r, q.c, dx, dy);
      const bool bp = beats(sp, p.key, bs0, bk0), bq = beats(sq, q.key, bs1, bk1);
      bs0 = bp ? sp : bs0;
      bk0 = bp ? p.key : bk0;
      bs1 = bq ? sq : bs1;
      bk1 = bq ? q.key : bk1;
    }
    if (i < total) {
      const Cand p = cand[i];
      const float sp = score(p.r, p.c, dx, dy);
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
  return (size_t)(2 * (h + w)) * sizeof(Cand) + ((h * w + 15) & ~15) +
         (size_t)(2 * (h + w) + WARPS) * sizeof(int);
}

// ---------------------------------------------------------------- frames
// The scratch of mask n, ext + n * 2 (h + w) ints, zeroed before the first
// kernel: rows' (w - minc) (h,), rows' (maxc + 1) (h,), columns' (h - minr)
// (w,), columns' (maxr + 1) (w,); 0 for a row or column with no pixel.

__global__ void __launch_bounds__(THREADS)
    hull_support_extremes_kernel(const uint8_t* masks, int* ext, int h, int w, int tiles_r,
                                 int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem[];  // (TILE, TILE) bytes
  __shared__ int cmin[TILE], cmax[TILE];
  const int t = threadIdx.x;
  const int tiles = tiles_r * tiles_c;
  const int n = blockIdx.x / tiles, tt = blockIdx.x - n * tiles;
  const int r0 = tt / tiles_c * TILE, c0 = tt % tiles_c * TILE;
  const int th = min(TILE, h - r0), tw = min(TILE, w - c0);
  int* row_lo = ext + (size_t)n * 2 * (h + w) + r0;
  int* row_hi = row_lo + h;
  int* col_lo = row_lo - r0 + 2 * h + c0;
  int* col_hi = col_lo + w;
  for (int i = t; i < TILE; i += THREADS) {
    cmin[i] = INT_MAX;
    cmax[i] = -1;
  }
  tile_extremes(masks + (size_t)n * h * w + (size_t)r0 * w + c0, w, th, tw, smem, cmin, cmax,
                [&](int r, int lo, int hi) {
                  atomicMax(&row_lo[r], w - (c0 + lo));
                  atomicMax(&row_hi[r], c0 + hi + 1);
                });
  __syncthreads();
  if (t < tw && cmax[t] >= 0) {  // one merge a column a tile
    atomicMax(&col_lo[t], h - (r0 + cmin[t]));
    atomicMax(&col_hi[t], r0 + cmax[t] + 1);
  }
}

__global__ void __launch_bounds__(THREADS)
    hull_support_select_kernel(const int* ext, const float* dirs, float* part_s,
                               unsigned long long* part_k, int h, int w, int d, int per_slice) {
  __shared__ WideCand cand[4 * THREADS];  // a chunk's candidates
  __shared__ float red_s[WARPS][GROUP];
  __shared__ unsigned long long red_k[WARPS][GROUP];
  __shared__ int wsum[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = blockIdx.x, s = blockIdx.z;
  const int k = blockIdx.y * GROUP + lane;  // this lane's direction
  const int* row_lo = ext + (size_t)n * 2 * (h + w);
  const int* row_hi = row_lo + h;
  const int* col_lo = row_hi + h;
  const int* col_hi = col_lo + w;
  const float dx = k < d ? dirs[2 * k] : 0.f, dy = k < d ? dirs[2 * k + 1] : 0.f;
  float bs0 = -INFINITY, bs1 = -INFINITY;
  unsigned long long bk0 = 0, bk1 = 0;  // 0: no candidate (every key is above 2^32)
  const long long m = max(h, w);
  const long long i_lo = (long long)s * per_slice * THREADS;
  const int i_hi = (int)min(m, i_lo + (long long)per_slice * THREADS);
  for (int i0 = (int)i_lo; i0 < i_hi; i0 += THREADS) {
    const int i = i0 + t;
    const bool row_ok = i < h && row_hi[i] > 0, col_ok = i < w && col_hi[i] > 0;
    int total;
    int off = block_scan(2 * row_ok + 2 * col_ok, wsum, total);
    const float fi = (float)i;
    if (row_ok) {
      const int minc = w - row_lo[i], maxc = row_hi[i] - 1;
      cand[off++] = {fi, minc - 0.5f, wide_key(2u * i + 1u, 2u * minc)};
      cand[off++] = {fi, maxc + 0.5f, wide_key(2u * i + 1u, 2u * maxc + 2u)};
    }
    if (col_ok) {
      const int minr = h - col_lo[i], maxr = col_hi[i] - 1;
      cand[off++] = {minr - 0.5f, fi, wide_key(2u * minr, 2u * i + 1u)};
      cand[off++] = {maxr + 0.5f, fi, wide_key(2u * maxr + 2u, 2u * i + 1u)};
    }
    __syncthreads();
    // warp v scores candidates v, v + WARPS, ... (its lanes read the same
    // one: a broadcast), in two chains for the latency
    int j = warp;
    for (; j + WARPS < total; j += 2 * WARPS) {
      const WideCand p = cand[j], q = cand[j + WARPS];
      const float sp = score(p.r, p.c, dx, dy), sq = score(q.r, q.c, dx, dy);
      const bool bp = beats(sp, p.key, bs0, bk0), bq = beats(sq, q.key, bs1, bk1);
      bs0 = bp ? sp : bs0;
      bk0 = bp ? p.key : bk0;
      bs1 = bq ? sq : bs1;
      bk1 = bq ? q.key : bk1;
    }
    if (j < total) {
      const WideCand p = cand[j];
      const float sp = score(p.r, p.c, dx, dy);
      const bool bp = beats(sp, p.key, bs0, bk0);
      bs0 = bp ? sp : bs0;
      bk0 = bp ? p.key : bk0;
    }
    __syncthreads();  // the chunk is read before the next one is written
  }
  if (beats(bs1, bk1, bs0, bk0)) {
    bs0 = bs1;
    bk0 = bk1;
  }
  red_s[warp][lane] = bs0;
  red_k[warp][lane] = bk0;
  __syncthreads();
  if (warp == 0 && k < d) {
    for (int v = 1; v < WARPS; ++v)
      if (beats(red_s[v][lane], red_k[v][lane], bs0, bk0)) {
        bs0 = red_s[v][lane];
        bk0 = red_k[v][lane];
      }
    const size_t o = ((size_t)n * gridDim.z + s) * d + k;
    part_s[o] = bs0;
    part_k[o] = bk0;
  }
}

__global__ void __launch_bounds__(THREADS)
    hull_support_merge_kernel(const float* part_s, const unsigned long long* part_k, float* out,
                              uint8_t* any, int d, int slices) {
  const int n = blockIdx.x, k = blockIdx.y * THREADS + threadIdx.x;
  if (k >= d) return;
  const size_t base = (size_t)n * slices * d + k;
  float bs = part_s[base];
  unsigned long long bk = part_k[base];
  for (int s = 1; s < slices; ++s) {
    const float v = part_s[base + (size_t)s * d];
    const unsigned long long key = part_k[base + (size_t)s * d];
    if (beats(v, key, bs, bk)) {
      bs = v;
      bk = key;
    }
  }
  // r = ((key >> 32) - 1) / 2, c = ((key & (2^32 - 1)) - 1) / 2; an empty
  // mask (no key) at (0, 0)
  reinterpret_cast<float2*>(out)[(size_t)n * d + k] =
      bk ? make_float2(0.5f * (float)((long long)(bk >> 32) - 1),
                       0.5f * (float)((long long)(bk & 0xffffffffull) - 1))
         : make_float2(0.f, 0.f);
  if (k == 0) any[n] = bk != 0;
}

}  // namespace

// Called once, when the library is loaded: the SM count and the dynamic
// shared memory of the crops' largest tile (TILE x TILE, 86 KB) and of the
// frames' tiles (64 KB).
extern "C" int ysi_hull_support_init(void) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hull_support_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(TILE, TILE));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hull_support_extremes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TILE * TILE);
  return (int)err;
}

// ext (N, 2 (h + w)) int32, part_s (N, S, D) fp32 and part_k (N, S, D)
// int64, S = ceil(ceil(max(h, w) / THREADS) / per_slice): the frames'
// scratch, unused (may be null) when both sides are up to TILE.
extern "C" int ysi_hull_support(const void* masks, const void* dirs, void* out, void* any,
                                void* ext, void* part_s, void* part_k, int n, int h, int w, int d,
                                int per_slice, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h <= TILE && w <= TILE) {
    // directions a block: all of them, or a share (whole warps of them)
    // where there are fewer than two cells an SM
    const int warps = (d + 31) / 32;
    const int split = max(1, min(warps, (2 * num_sms + n - 1) / n));
    const int dchunk = (warps + split - 1) / split * 32;
    const dim3 grid(n, (d + dchunk - 1) / dchunk);
    hull_support_kernel<<<grid, THREADS, smem_bytes(h, w), st>>>(
        static_cast<const uint8_t*>(masks), static_cast<const float*>(dirs),
        static_cast<float*>(out), static_cast<uint8_t*>(any), h, w, d, dchunk);
    return (int)cudaGetLastError();
  }
  const int tiles_r = (h + TILE - 1) / TILE, tiles_c = (w + TILE - 1) / TILE;
  const int chunks = (max(h, w) + THREADS - 1) / THREADS;
  const int groups = (d + GROUP - 1) / GROUP;
  if (!ext || !part_s || !part_k || per_slice <= 0 || groups > 65535 ||
      (long long)n * tiles_r * tiles_c > INT_MAX || (chunks + per_slice - 1) / per_slice > 65535)
    return (int)cudaErrorInvalidValue;
  const int slices = (chunks + per_slice - 1) / per_slice;
  cudaError_t err = cudaMemsetAsync(ext, 0, (size_t)n * 2 * (h + w) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  hull_support_extremes_kernel<<<n * tiles_r * tiles_c, THREADS, TILE * TILE, st>>>(
      static_cast<const uint8_t*>(masks), static_cast<int*>(ext), h, w, tiles_r, tiles_c);
  hull_support_select_kernel<<<dim3(n, groups, slices), THREADS, 0, st>>>(
      static_cast<const int*>(ext), static_cast<const float*>(dirs), static_cast<float*>(part_s),
      static_cast<unsigned long long*>(part_k), h, w, d, per_slice);
  hull_support_merge_kernel<<<dim3(n, (d + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const unsigned long long*>(part_k),
      static_cast<float*>(out), static_cast<uint8_t*>(any), d, slices);
  return (int)cudaGetLastError();
}
