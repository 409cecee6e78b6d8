// The frames' resample onto a stage's canvas (Hopper, sm_90a): the
// antialiased linear resize of jax.image.resize (half-pixel centres, a
// triangle kernel widened by the downsampling factor, rows normalised),
// written at an offset into a canvas with the stage's epilogue and pad.
//
//   x   (B, H, W, C) uint8 or fp32, any element strides (a gray frame's
//       stride-0 channel view is read as one channel);
//   out (B, OH, OW, C) fp32 contiguous:
//       out[b, oy + i, ox + j, c] = (r[b, i, j, c] - sub[c]) / div[c]
//       for i < nh, j < nw, and `pad` everywhere else, where
//       r[b, i, j, c] = sum_t wx[j, t] * sum_s wy[i, s] * x[b, ys[i] + s, xs[j] + t, c]
//   ys / wy (nh,) int32 starts and (nh, ky) fp32 weights, xs / wx the same
//   for the columns: each output row's or column's band, cut from the dense
//   resampling matrix the plain version multiplies by, so the weights are
//   the same fp32 numbers (ops/preprocess.py::_band_table).
//
// Replaces no TPU kernel: the JAX package leaves this resize to XLA
// (jax.image.resize in yolo_sam_inference_tpu/ops/preprocess.py). Added
// because the plain version, two dense fp32 einsums against the (out, in)
// matrices, ran as a CUDA-core fp32 GEMM (cutlass simt sgemm) of 478 GFLOP
// a batch of eight 2048^2 frames (the letterbox's 640 and SAM's 1024
// canvas), about 9.6 ms a batch, on a gray frame expanded to three fp32
// channels (a 403 MB copy a call): 99.7-99.8% of its multiplies were by
// zero, since a row of the matrix has at most 4 nonzero taps at 2x and 7 at
// 3.2x.
//
// What bounds it on the H100 is bytes: the uint8 frame read once (33.5 MB
// for 8 gray 2048^2 frames) and the fp32 canvas written once (100.7 MB at
// 1024^2 x 3, 39.3 MB at 640^2 x 3), 40 and 22 us at 3.35 TB/s. The
// arithmetic (ky + kx fma a computed pixel and channel) is far below that.
//
// Design: a block owns a TY x TX tile of one image's canvas. Where the tile
// meets the resized area it stages, in one round of loads, the input window
// the tile's bands reach (for a gray uint8 frame whose rows are 16-byte
// aligned: whole 16-byte chunks from the boundary below the window, else
// element by element) and the tile's bands, into shared memory. The
// vertical pass then takes 4 neighbouring window columns a thread (one
// 32-bit shared load a tap: 4 bytes, turned into fp32 by a byte permute
// and a subtraction, exact, instead of the quarter-rate integer convert)
// into an fp32 tile; the horizontal pass sums each output pixel's band from
// it and writes the epilogue's values, channels interleaved as the canvas
// holds them (a gray frame's one computed channel written C times, each
// with its own offset and divisor, IEEE division), into an output tile
// that the pad fills first where the tile leaves the resized area. Each
// warp then copies whole canvas rows of the tile out as 16-byte vectors. A
// tile wholly in the pad only stores. The band width follows the scale (a
// loop over the taps), so downsampling by any factor and upsampling (2
// taps) go through the same code; the host picks TY and TX so the shared
// tiles fit (ops/preprocess.py::_tile_plan, which mirrors `layout`).
// On an H100 with the L2 flushed before each call this form takes 0.077 ms
// (letterbox) and 0.139 ms (SAM's canvas) at 8 gray 2048^2 frames, 3.5x
// the bound (PERF.md); a first form whose vertical pass read the frame
// from device memory a byte at a time took 0.158 and 0.227 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_C = 4;
// the dynamic shared memory a block may ask for (227 KB less the static epilogue constants)
constexpr int MAX_SMEM = 226 * 1024;

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Byte offsets of a block's shared tiles: the input window IN (cin x rh
// rows of sw elements), the vertical pass V (cin x ty rows of sw fp32), the
// output tile O (ty rows of tx pixels x c fp32), the tile's row bands WY
// (ty x ky) and starts YS, its column bands WX (kx x tx, tap-major) and
// starts XS. sw leaves room for the 16-byte chunks' offset (0-15).
struct Layout {
  int sw;
  size_t in, v, o, wy, ys, wx, xs, total;
};

__host__ __device__ inline Layout layout(int cin, int c, int ty, int tx, int vw, int rh, int ky,
                                         int kx, int elem) {
  Layout l;
  l.sw = (int)round16((size_t)vw + 15);
  l.in = 0;
  l.v = l.in + round16((size_t)cin * rh * l.sw * elem);
  l.o = l.v + round16((size_t)cin * ty * l.sw * 4);
  l.wy = l.o + round16((size_t)ty * tx * c * 4);
  l.ys = l.wy + round16((size_t)ty * ky * 4);
  l.wx = l.ys + round16((size_t)ty * 4);
  l.xs = l.wx + round16((size_t)tx * kx * 4);
  l.total = l.xs + round16((size_t)tx * 4);
  return l;
}

// 4 neighbouring window values as fp32: a byte b becomes 2^23 + b by a
// permute into the exponent pattern of 2^23, then exactly b.
__device__ __forceinline__ void load4(const uint8_t* p, float (&f)[4]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float((int)__byte_perm(u, 0x4B000000u, 0x7540u + i)) - 8388608.f;
}

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    resample_kernel(const T* __restrict__ x, long long sb, long long sh, long long sw,
                    long long sc, int vec, int c, int cin, const int* __restrict__ ys,
                    const float* __restrict__ wy, int ky, const int* __restrict__ xs,
                    const float* __restrict__ wx, int kx, int nh, int nw, int oy, int ox,
                    float* __restrict__ out, int oh, int ow, const float* __restrict__ sub,
                    const float* __restrict__ dv, float pad, int ty, int tx, int vw, int rh) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_sub[MAX_C], s_div[MAX_C];
  const Layout l = layout(cin, c, ty, tx, vw, rh, ky, kx, (int)sizeof(T));
  T* IN = reinterpret_cast<T*>(smem + l.in);
  float* V = reinterpret_cast<float*>(smem + l.v);
  float* O = reinterpret_cast<float*>(smem + l.o);
  float* WY = reinterpret_cast<float*>(smem + l.wy);
  int* YS = reinterpret_cast<int*>(smem + l.ys);
  float* WX = reinterpret_cast<float*>(smem + l.wx);
  int* XS = reinterpret_cast<int*>(smem + l.xs);
  const int b = blockIdx.z, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cy0 = blockIdx.y * ty, cx0 = blockIdx.x * tx;
  const int rows = min(ty, oh - cy0), cols = min(tx, ow - cx0), orow = tx * c;
  // the tile's share of the resized area, in resized rows and columns
  const int r0 = max(cy0, oy) - oy, r1 = min(cy0 + rows, oy + nh) - oy;
  const int q0 = max(cx0, ox) - ox, q1 = min(cx0 + cols, ox + nw) - ox;
  const bool any = r0 < r1 && q0 < q1;
  const int nr = any ? r1 - r0 : 0, nq = any ? q1 - q0 : 0;
  const int y0 = any ? ys[r0] : 0, x0 = any ? xs[q0] : 0;
  const int xw = any ? xs[q1 - 1] + kx - x0 : 0;  // the window's columns, at most vw
  int off = 0;  // where the window's first column sits in a staged row
  if (tid < c) {
    s_sub[tid] = sub[tid];
    s_div[tid] = dv[tid];
  }
  if (any) {
    const int nin = ys[r1 - 1] + ky - y0;  // the window's rows, at most rh
    const T* xb = x + (long long)b * sb + (long long)y0 * sh + (long long)x0 * sw;
    for (int i = tid; i < nr * ky; i += THREADS) WY[i] = wy[(long long)r0 * ky + i];
    for (int i = tid; i < nr; i += THREADS) YS[i] = ys[r0 + i] - y0;
    for (int i = tid; i < nq * kx; i += THREADS) {
      const int p = i / kx, k = i - p * kx;
      WX[k * tx + p] = wx[(long long)q0 * kx + i];
    }
    for (int i = tid; i < nq; i += THREADS) XS[i] = xs[q0 + i] - x0;
    if (vec) {  // uint8, one channel of unit stride, rows and images 16-byte aligned
      off = (int)(reinterpret_cast<uintptr_t>(xb) & 15);
      const uint4* a = reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(xb) - off);
      const int chunks = (off + xw + 15) >> 4;
      for (int i = tid; i < nin * chunks; i += THREADS) {
        const int rr = i / chunks, k = i - rr * chunks;
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(IN) + (size_t)rr * l.sw + 16 * k) =
            __ldg(a + rr * (sh >> 4) + k);
      }
    } else {
      for (int i = tid; i < cin * nin * xw; i += THREADS) {
        const int j = i % xw, t = i / xw, rr = t % nin, ch = t / nin;
        IN[(size_t)(ch * rh + rr) * l.sw + j] = xb[rr * sh + j * sw + ch * sc];
      }
    }
    if (nr < rows || nq < cols)  // the tile leaves the resized area: pad first
      for (int i = tid; i < rows * orow; i += THREADS) O[i] = pad;
  }
  __syncthreads();
  if (any) {  // vertical: a warp a window row, 4 columns a lane
    const int groups = (off + xw + 3) >> 2;
    for (int rc = warp; rc < cin * nr; rc += WARPS) {
      const int r = rc % nr, ch = rc / nr;
      const T* in = IN + (size_t)(ch * rh + YS[r]) * l.sw;
      const float* w = WY + r * ky;
      float* vr = V + (size_t)(ch * ty + r) * l.sw;
      for (int g = lane; g < groups; g += 32) {
        float a[4] = {0.f, 0.f, 0.f, 0.f}, f[4];
        for (int k = 0; k < ky; ++k) {
          load4(in + (size_t)k * l.sw + 4 * g, f);
          const float wk = w[k];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = fmaf(wk, f[i], a[i]);
        }
        *reinterpret_cast<float4*>(vr + 4 * g) = make_float4(a[0], a[1], a[2], a[3]);
      }
    }
  }
  __syncthreads();
  if (any) {  // horizontal and the epilogue: a warp an output row, a pixel a lane
    const int rt = r0 + oy - cy0, qt = q0 + ox - cx0;  // the share's origin in the tile
    for (int r = warp; r < nr; r += WARPS) {
      float* orow_p = O + (rt + r) * orow;
      for (int p = lane; p < nq; p += 32) {
        const int base = XS[p] + off;
        float acc[MAX_C];
#pragma unroll
        for (int ch = 0; ch < MAX_C; ++ch) {
          float s = 0.f;
          if (ch < cin) {
            const float* v = V + (size_t)(ch * ty + r) * l.sw + base;
            for (int k = 0; k < kx; ++k) s = fmaf(WX[k * tx + p], v[k], s);
          }
          acc[ch] = s;
        }
        float* o = orow_p + (qt + p) * c;
#pragma unroll
        for (int oc = 0; oc < MAX_C; ++oc)
          if (oc < c) o[oc] = (acc[cin == 1 ? 0 : oc] - s_sub[oc]) / s_div[oc];
      }
    }
  }
  __syncthreads();
  // each warp stores whole rows of the tile: cols * c contiguous floats
  for (int r = warp; r < rows; r += WARPS) {
    float* dst = out + (((long long)b * oh + cy0 + r) * ow + cx0) * c;
    const float* src = O + r * orow;
    const int n = cols * c;
    const int head = min((int)((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3), n);
    for (int e = lane; e < head; e += 32) dst[e] = any ? src[e] : pad;
    const int nv = (n - head) >> 2;
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    for (int v = lane; v < nv; v += 32) {
      const float* q = src + head + 4 * v;
      d4[v] = any ? make_float4(q[0], q[1], q[2], q[3]) : make_float4(pad, pad, pad, pad);
    }
    for (int e = head + 4 * nv + lane; e < n; e += 32) dst[e] = any ? src[e] : pad;
  }
}

}  // namespace

extern "C" int ysi_resample_init(void) {
  cudaError_t err = cudaFuncSetAttribute(resample_kernel<uint8_t>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(resample_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  return (int)err;
}

// fp32: 0 for uint8 input, 1 for fp32; strides in elements; vec: stage the
// window in 16-byte chunks (uint8, one channel of unit stride, rows and
// images 16-byte aligned); ty x tx the tile, vw and rh the widest input
// column window of tx consecutive output columns and the tallest row window
// of ty consecutive output rows.
extern "C" int ysi_resample(const void* x, int fp32, long long sb, long long sh, long long sw,
                            long long sc, int vec, int b, int c, int cin, const void* ys,
                            const void* wy, int ky, const void* xs, const void* wx, int kx,
                            int nh, int nw, int oy, int ox, void* out, int oh, int ow,
                            const void* sub, const void* dv, float pad, int ty, int tx, int vw,
                            int rh, void* stream) {
  const Layout l = layout(cin, c, ty, tx, vw, rh, ky, kx, fp32 ? 4 : 1);
  if (b <= 0 || c <= 0 || c > MAX_C || (cin != 1 && cin != c) || ky <= 0 || kx <= 0 ||
      nh <= 0 || nw <= 0 || oy < 0 || ox < 0 || oy + nh > oh || ox + nw > ow || ty <= 0 ||
      tx <= 0 || vw < kx || rh < ky || l.total > (size_t)MAX_SMEM ||
      (vec && (fp32 || cin != 1 || sw != 1 || sh % 16 || sb % 16 ||
               reinterpret_cast<uintptr_t>(x) % 16)) ||
      (long long)(oh + ty - 1) / ty > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ow + tx - 1) / tx, (oh + ty - 1) / ty, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ysp = static_cast<const int*>(ys);
  const int* xsp = static_cast<const int*>(xs);
  const float* wyp = static_cast<const float*>(wy);
  const float* wxp = static_cast<const float*>(wx);
  float* o = static_cast<float*>(out);
  const float* subp = static_cast<const float*>(sub);
  const float* dvp = static_cast<const float*>(dv);
  if (fp32)
    resample_kernel<float><<<grid, THREADS, l.total, st>>>(
        static_cast<const float*>(x), sb, sh, sw, sc, vec, c, cin, ysp, wyp, ky, xsp, wxp, kx,
        nh, nw, oy, ox, o, oh, ow, subp, dvp, pad, ty, tx, vw, rh);
  else
    resample_kernel<uint8_t><<<grid, THREADS, l.total, st>>>(
        static_cast<const uint8_t*>(x), sb, sh, sw, sc, vec, c, cin, ysp, wyp, ky, xsp, wxp, kx,
        nh, nw, oy, ox, o, oh, ow, subp, dvp, pad, ty, tx, vw, rh);
  return (int)cudaGetLastError();
}
