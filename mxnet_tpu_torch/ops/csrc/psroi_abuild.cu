// Deformable PS-ROI pooling accumulation-matrix build:
//   A[n, h, w] = sum_s yv[n, s, h] xv[n, s, w], accumulated in fp32 with
//   fused multiply-adds from 0, s ascending.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py _abuild_impl /
// _abuild_fwd_kernel_factory (entry psroi_abuild_pallas, forward), which runs
// one small (H, S) x (S, W) MXU dot per roi at HIGHEST precision.  yv and xv
// hold arbitrary fp32 bilinear weights, so TF32 tensor-core products would
// not keep the fp32 sum, and with S = 16 the 2 S flops per 4-byte output are
// a quarter of the bytes bound anyway: the work belongs on the CUDA cores.
//
// Bound on the card: bytes.  One pooling call of the R-FCN head at batch 1
// builds N = 49 bins x 300 rois = 14,700 matrices of 38 x 64 from S = 16:
// 143 MB of A written and 96 MB of yv / xv read, 71 us at 3.35 TB/s.
//
// The first design (one block per n, yv[n] and xv[n] in shared memory, one
// output per thread) missed that bound 3x: every output read 2 S = 32 floats
// from shared memory for 16 FMAs, about one shared-memory wavefront per
// output, 35.75 M of them per call, ~0.14 ms of the load pipe alone.
//
// Design (S = 16, W % 4 == 0, 16-byte aligned xv and A):
// - one warp per roi, persistent over rois (warp i takes rois i, i + total
//   warps, ...), with two shared-memory stages per warp: while the warp
//   computes roi r, cp.async brings roi r + total warps' yv and xv into the
//   other stage, so a warp always has its next roi's bytes in flight;
// - yv[n] is staged transposed, to (H, S): lane l copies s = l % 16 of row
//   2 i + l / 16, so the 4-byte copies land in distinct banks;
// - register tiling: a lane owns a 1 x 4 tile of outputs, A[n, h, w..w+3],
//   holds xv[n, :, w..w+3] in 64 registers for every row it walks, and reads
//   a row's 16 yv coefficients as 4 broadcast 16-byte loads: each
//   shared-memory load feeds 16 FMAs (the first design: half of one);
// - each tile goes out as one 16-byte streaming store (st.global.cs: A is
//   three times the L2), 32 lanes covering two whole 256-byte rows;
// - no integer division in the output loop.
// Every other shape takes psroi_abuild_kernel, the first design (one block
// per roi), with the same sum in the same order: both paths give A bit for
// bit.
//
// The bf16 instance (mx_psroi_abuild_bf16) stores A in bf16, as the TPU
// kernel does for a bf16 out_dtype (_abuild_fwd_kernel_factory): yv and xv
// stay fp32, the sum over s is the same fp32 sum, and only the store rounds
// (to nearest even), 8 bytes a lane in place of 16.  A is the larger part
// of the bytes, so its bound at the R-FCN call is 72 MB of A and 96 MB of
// yv / xv: 167 MB, 50 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "pipeline.cuh"

namespace {

constexpr int kS = 16;          // the tiled path's S (spp^2 of the R-FCN head)
constexpr int kMaxWarps = 4;    // rois (warps) per block on the tiled path
constexpr int kThreads = 256;   // generic path

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                     fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
psroi_abuild_kernel_tiled(const float* __restrict__ yv,
                          const float* __restrict__ xv, int n, int h, int w,
                          T* __restrict__ a) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int stage = kS * (h + w);  // floats: yv^T (h x S), then xv (S x w)
  float* buf = reinterpret_cast<float*>(smem4) + warp * 2 * stage;
  // output tiling: lpr lanes per row, each a 4-column group c, rows r0,
  // r0 + rstep, ...; lanes past rstep * lpr idle in the output loop
  const int cg = w >> 2;
  const int lpr = cg < 32 ? cg : 32;
  const int rstep = 32 / lpr;
  const int c0 = lane % lpr;
  const int r0 = lane / lpr;
  const int s_l = lane & (kS - 1);

  auto load = [&](int r, float* dst) {
    const float* yr = yv + (long long)r * kS * h;
    for (int hh = lane >> 4; hh < h; hh += 2)
      mx::cp_async4(dst + hh * kS + s_l, yr + s_l * h + hh);
    const float* xr = xv + (long long)r * kS * w;
    float* xs = dst + kS * h;
    for (int t = lane * 4; t < kS * w; t += 128) mx::cp_async16(xs + t, xr + t);
  };

  const int step = gridDim.x * wpb;
  int r = blockIdx.x * wpb + warp;
  if (r < n) load(r, buf);
  mx::cp_async_commit();
  for (int b = 0; r < n; r += step, b ^= 1) {
    if (r + step < n) load(r + step, buf + (b ^ 1) * stage);
    mx::cp_async_commit();
    mx::cp_async_wait<1>();  // this roi's stage has landed
    __syncwarp();
    const float* cur = buf + b * stage;
    const float4* ys4 = reinterpret_cast<const float4*>(cur);
    const float4* xs4 = reinterpret_cast<const float4*>(cur + kS * h);
    T* out = a + (long long)r * h * w;
    if (r0 < rstep) {
      for (int c = c0; c < cg; c += lpr) {
        float4 x[kS];
#pragma unroll
        for (int s = 0; s < kS; ++s) x[s] = xs4[s * cg + c];
#pragma unroll 2
        for (int hh = r0; hh < h; hh += rstep) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int q = 0; q < kS / 4; ++q) {
            const float4 y = ys4[hh * (kS / 4) + q];
            acc = fma4(y.x, x[4 * q], acc);
            acc = fma4(y.y, x[4 * q + 1], acc);
            acc = fma4(y.z, x[4 * q + 2], acc);
            acc = fma4(y.w, x[4 * q + 3], acc);
          }
          mx::stcs4(out + 4 * (hh * cg + c), acc);
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
}

// Any S and W: one block per roi stages yv[n] (S x H) and xv[n] (S x W) in
// shared memory; each thread writes outputs (h, w) with w fastest.
template <typename T>
__global__ void psroi_abuild_kernel(const float* __restrict__ yv,
                                    const float* __restrict__ xv, int s, int h,
                                    int w, T* __restrict__ a) {
  extern __shared__ float smem[];
  float* ys = smem;
  float* xs = smem + s * h;
  const long long r = blockIdx.x;
  const float* yr = yv + r * s * h;
  const float* xr = xv + r * s * w;
  for (int t = threadIdx.x; t < s * h; t += blockDim.x) ys[t] = yr[t];
  for (int t = threadIdx.x; t < s * w; t += blockDim.x) xs[t] = xr[t];
  __syncthreads();
  T* out = a + r * h * w;
  for (int hh = threadIdx.x >> 5; hh < h; hh += kThreads / 32) {
    for (int ww = threadIdx.x & 31; ww < w; ww += 32) {
      float acc = 0.f;
      for (int k = 0; k < s; ++k) acc = fmaf(ys[k * h + hh], xs[k * w + ww], acc);
      mx::store(out + hh * w + ww, acc);
    }
  }
}

template <typename T>
int psroi_abuild(const void* yv, const void* xv, void* a, int n, int s, int h, int w,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(xv) | reinterpret_cast<uintptr_t>(a)) & 15) == 0;
  const size_t per_warp = 2 * sizeof(float) * kS * (size_t)(h + w);
  if (s == kS && w % 4 == 0 && aligned && per_warp <= mx::kSmemMax) {
    const int wpb = static_cast<int>(std::min<size_t>(kMaxWarps, mx::kSmemMax / per_warp));
    int blocks = 0;
    const cudaError_t err = mx::persistent_grid(psroi_abuild_kernel_tiled<T>, wpb * 32,
                                                wpb * per_warp, (n + wpb - 1) / wpb, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    psroi_abuild_kernel_tiled<T><<<blocks, wpb * 32, wpb * per_warp, st>>>(
        static_cast<const float*>(yv), static_cast<const float*>(xv), n, h, w,
        static_cast<T*>(a));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = (size_t)s * (h + w) * sizeof(float);
  cudaError_t err = mx::allow_smem(psroi_abuild_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  psroi_abuild_kernel<T><<<n, kThreads, smem, st>>>(
      static_cast<const float*>(yv), static_cast<const float*>(xv), s, h, w,
      static_cast<T*>(a));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// yv (N, S, H) f32, xv (N, S, W) f32 -> a (N, H, W) f32.
extern "C" int mx_psroi_abuild(const void* yv, const void* xv, void* a, int n,
                               int s, int h, int w, void* stream) {
  return psroi_abuild<float>(yv, xv, a, n, s, h, w, stream);
}

// The same with a (N, H, W) bf16.
extern "C" int mx_psroi_abuild_bf16(const void* yv, const void* xv, void* a, int n,
                                    int s, int h, int w, void* stream) {
  return psroi_abuild<mx::bf16>(yv, xv, a, n, s, h, w, stream);
}
