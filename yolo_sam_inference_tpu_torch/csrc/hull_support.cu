// Convex-hull support points of cell masks, for Hopper (sm_90a).
//
//   s[n, i, d] = r[n, i] * dir[d, 0] + c[n, i] * dir[d, 1]
//   out[n, d]  = the candidate (r, c) with the largest s, ties broken by the
//                largest r, then the largest c
//
// pts (N, P, 2) fp32 boundary candidates (r, c); dirs (D, 2) fp32 unit
// directions; out (N, D, 2) fp32. The score is two products and a sum, each
// rounded to fp32 (no fused multiply-add), which is what the plain PyTorch
// version computes, so the two pick the same candidate on every tie.
//
// Replaces yolo_sam_inference_tpu/ops/hull_support.py:55
// (support_vertices_tpu). The TPU kernel forms the (P, D) score tile with a
// matmul in VMEM and reduces it with masked maxima (three selects for the
// tie-break); here one thread per direction walks the P candidates of one
// cell in shared memory and keeps a running lexicographic maximum, so the
// (N, P, D) scores never exist anywhere. What bounds it on the H100: FP32
// issue, P * D * 5 operations per cell (about 0.7 MFLOP per cell at
// config 1, 512 x 512 candidates x directions); the input is 4 KB per cell.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void __launch_bounds__(256)
    hull_support_kernel(const float* pts, const float* dirs, float* out, int p, int d) {
  extern __shared__ float ps[];  // (p, 2)
  const int n = blockIdx.x;
  const float* src = pts + (long)n * p * 2;
  for (int v = threadIdx.x; v < 2 * p; v += blockDim.x) ps[v] = src[v];
  __syncthreads();
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    const float dx = dirs[2 * k], dy = dirs[2 * k + 1];
    float best = -INFINITY, br = -1e9f, bc = -1e9f;
    for (int i = 0; i < p; ++i) {
      const float r = ps[2 * i], c = ps[2 * i + 1];
      const float s = __fadd_rn(__fmul_rn(r, dx), __fmul_rn(c, dy));
      if (s > best || (s == best && (r > br || (r == br && c > bc)))) {
        best = s;
        br = r;
        bc = c;
      }
    }
    out[((long)n * d + k) * 2] = br;
    out[((long)n * d + k) * 2 + 1] = bc;
  }
}

}  // namespace

extern "C" int ysi_hull_support(const void* pts, const void* dirs, void* out, int n, int p, int d,
                                void* stream) {
  if (n <= 0 || p <= 0 || d <= 0 || p > 4096) return (int)cudaErrorInvalidValue;
  hull_support_kernel<<<n, 256, sizeof(float) * 2 * p, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(dirs), static_cast<float*>(out), p,
      d);
  return (int)cudaGetLastError();
}
