// Per-prompt window crop of the decoder's token grid, for Hopper (sm_90a).
//
//   out[n, i, j, :] = grid[n, r0[n] + i, c0[n] + j, :]   for i, j < wg
//
// grid (N, gs, gs, C) bf16, r0/c0 (N,) int64 starts read in place with any
// element stride (the engine passes the two columns of its (N, 2) starts),
// clamped to [0, gs - wg] here, as the engine clamps them; out (N, wg, wg, C).
//
// Replaces yolo_sam_inference_tpu/ops/window_crop.py:46 (window_crop). The
// TPU kernel stages each prompt's whole (gs, gs, C) plane through VMEM and
// crops it there with a roll, because Mosaic takes no unaligned dynamic
// column start. Here nothing needs staging: one window row is wg * C
// contiguous values of one grid row, so a block per (prompt, window row)
// copies it with 16-byte loads and stores, neighbouring threads on
// neighbouring addresses. What bounds it on the H100 is memory bandwidth:
// at config 1 it moves 2 x 512 x 11 x 11 x 256 x 2 bytes (about 63 MB) and
// reads only the windows, not the 268 MB grid. On the device this body
// takes about that bound with the windows cold (0.019 ms at config 1, the
// L2 flushed by a read before each call) and 1.2x it on back-to-back calls,
// so its redesign only moved the starts: read where the engine keeps them,
// they cost no cast launches before the copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(128)
    window_crop_kernel(const __nv_bfloat16* grid, const long long* r0, const long long* c0, int rs,
                       int cs, __nv_bfloat16* out, int gs, int c, int wg) {
  const int n = blockIdx.x, i = blockIdx.y;
  const long long hi = gs - wg;
  const int r = (int)min(max(r0[(long long)n * rs], 0LL), hi);
  const int col = (int)min(max(c0[(long long)n * cs], 0LL), hi);
  const uint4* src =
      reinterpret_cast<const uint4*>(grid + (((long)n * gs + r + i) * gs + col) * c);
  uint4* dst = reinterpret_cast<uint4*>(out + (((long)n * wg + i) * wg) * c);
  const int chunks = wg * c / 8;
  for (int v = threadIdx.x; v < chunks; v += blockDim.x) dst[v] = src[v];
}

}  // namespace

// r0 / c0: int64, element strides rs / cs.
extern "C" int ysi_window_crop(const void* grid, const void* r0, const void* c0, int rs, int cs,
                               void* out, int n, int gs, int c, int wg, void* stream) {
  if (n <= 0 || gs <= 0 || wg <= 0 || wg > gs || c <= 0 || c % 8) return (int)cudaErrorInvalidValue;
  window_crop_kernel<<<dim3(n, wg), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(grid), static_cast<const long long*>(r0),
      static_cast<const long long*>(c0), rs, cs,
      static_cast<__nv_bfloat16*>(out), gs, c, wg);
  return (int)cudaGetLastError();
}
