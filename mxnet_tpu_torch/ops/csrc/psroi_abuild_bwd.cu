// Backward of the PS-ROI accumulation-matrix build (psroi_abuild.cu): given
// the cotangent g (N, H, W) of A[n] = sum_s yv[n, s, :] (x) xv[n, s, :],
//   dyv[n, s, h] = sum_w g[n, h, w] xv[n, s, w]    (w ascending)
//   dxv[n, s, w] = sum_h yv[n, s, h] g[n, h, w]    (h ascending)
// each accumulated in fp32 with fused multiply-adds in that fixed order.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py _abuild_bwd /
// _abuild_bwd_kernel_factory (the custom VJP of psroi_abuild_pallas), which
// runs the two small dots xv g^T and yv g per roi on the MXU at HIGHEST
// precision.  The contractions are 64 and 38 deep at the R-FCN shapes: far
// too small a product for the tensor cores to matter.
//
// Bound on the card: bytes.  On the train path at batch 1 one pooling call
// has N = 49 bins x 128 rois = 6,272 matrices of 38 x 64 with S = 16: it
// reads g (61 MB) and yv, xv (41 MB) and writes dyv, dxv (41 MB), 143 MB,
// about 43 us at 3.35 TB/s, against 0.98 GFLOP (15 us at 67 TFLOP/s).
// Design: one block per n stages g[n], yv[n] and xv[n] in shared memory
// (16 KB at those shapes), so each input byte is read from device memory
// once, then writes dyv[n] and dxv[n] with the fastest index on neighbouring
// threads, so the stores coalesce.  g and xv are staged with a row stride of
// W + 1 floats: the dyv loop walks g down a column (h fastest), and the odd
// stride puts neighbouring rows in neighbouring shared-memory banks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void psroi_abuild_bwd_kernel(const float* __restrict__ yv,
                                        const float* __restrict__ xv,
                                        const float* __restrict__ g, int s,
                                        int h, int w, float* __restrict__ dyv,
                                        float* __restrict__ dxv) {
  extern __shared__ float smem[];
  const int ws = w + 1;  // padded row stride of gs and xs
  float* gs = smem;              // h x ws
  float* xs = gs + h * ws;       // s x ws
  float* ys = xs + s * ws;       // s x h
  const long long r = blockIdx.x;
  const float* gr = g + r * h * w;
  const float* xr = xv + r * s * w;
  const float* yr = yv + r * s * h;
  for (int t = threadIdx.x; t < h * w; t += blockDim.x) {
    const int hh = t / w;
    gs[hh * ws + (t - hh * w)] = gr[t];
  }
  for (int t = threadIdx.x; t < s * w; t += blockDim.x) {
    const int ss = t / w;
    xs[ss * ws + (t - ss * w)] = xr[t];
  }
  for (int t = threadIdx.x; t < s * h; t += blockDim.x) ys[t] = yr[t];
  __syncthreads();
  float* dy = dyv + r * s * h;
  for (int t = threadIdx.x; t < s * h; t += blockDim.x) {
    const int ss = t / h;
    const int hh = t - ss * h;
    const float* grow = gs + hh * ws;
    const float* xrow = xs + ss * ws;
    float acc = 0.f;
    for (int k = 0; k < w; ++k) acc = fmaf(grow[k], xrow[k], acc);
    dy[t] = acc;
  }
  float* dx = dxv + r * s * w;
  for (int t = threadIdx.x; t < s * w; t += blockDim.x) {
    const int ss = t / w;
    const int ww = t - ss * w;
    const float* yrow = ys + ss * h;
    float acc = 0.f;
    for (int k = 0; k < h; ++k) acc = fmaf(yrow[k], gs[k * ws + ww], acc);
    dx[t] = acc;
  }
}

}  // namespace

// yv (N, S, H), xv (N, S, W), g (N, H, W) f32 -> dyv (N, S, H), dxv (N, S, W).
extern "C" int mx_psroi_abuild_bwd(const void* yv, const void* xv,
                                   const void* g, void* dyv, void* dxv, int n,
                                   int s, int h, int w, void* stream) {
  const size_t smem = ((size_t)(h + s) * (w + 1) + (size_t)s * h) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        psroi_abuild_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  psroi_abuild_bwd_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yv), static_cast<const float*>(xv),
      static_cast<const float*>(g), s, h, w, static_cast<float*>(dyv),
      static_cast<float*>(dxv));
  return static_cast<int>(cudaGetLastError());
}
