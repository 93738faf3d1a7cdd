// Backward of the PS-ROI accumulation-matrix build (psroi_abuild.cu): given
// the cotangent g (N, H, W) of A[n] = sum_s yv[n, s, :] (x) xv[n, s, :],
//   dyv[n, s, h] = sum_w g[n, h, w] xv[n, s, w]
//   dxv[n, s, w] = sum_h yv[n, s, h] g[n, h, w]
// each accumulated in fp32 in a fixed order (no atomics), so two launches on
// the same input give the same bits.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py _abuild_bwd /
// _abuild_bwd_kernel_factory (the custom VJP of psroi_abuild_pallas), which
// runs the two small dots xv g^T and yv g per roi on the MXU at HIGHEST
// precision.  The contractions are 64 and 38 deep at the R-FCN shapes, and
// the weights arbitrary fp32: CUDA-core FMAs, not TF32 tensor cores.
//
// Bound on the card: bytes.  On the train path at batch 1 one pooling call
// has N = 49 bins x 128 rois = 6,272 matrices of 38 x 64 with S = 16: it
// reads g (61 MB) and yv, xv (41 MB) and writes dyv, dxv (41 MB), 143 MB,
// 43 us at 3.35 TB/s, against 0.98 GFLOP (15 us at 67 TFLOP/s).
//
// The first design (one block per n, g, yv and xv staged in shared memory
// with 4-byte loads and a division per element, one output per thread) fed
// every FMA from two shared-memory loads: 4,864 wavefronts per roi, ~0.12 ms
// of the load pipe per call, 4x the bound.
//
// Design (S = 16, W % 4 == 0, every pointer 16-byte aligned): one block of
// 4 warps per roi, persistent over rois.
// - Two shared-memory stages of yv[n] (staged transposed, to (H, S)), xv[n]
//   and g[n], 16 KB each at the path's shapes: cp.async brings the next
//   roi's while the block computes this one, so every byte of the call is
//   read once, in 16-byte copies, one roi ahead.  (One warp per roi with g
//   streamed into registers 4 or 8 rows ahead waited on g; one warp per roi
//   with g staged too fitted only 6 warps on an SM: both were slower.)
// - Warp k takes rows h = k, k + 4, ...; lane l owns the 4 columns
//   w = 4 (l % 16 + 16 j) .. + 3 and the half s in [8 (l / 16), + 8).  Per
//   row it reads g[n, h, w..w+3] once (one 16-byte load) and its 8 yv
//   coefficients as two broadcast 16-byte loads.
// - dxv: the lane's 8 x 4 sums over its rows stay in registers (fmaf, rows
//   ascending); at the end the 4 warps' partials meet in shared memory and
//   are added in warp order, then leave as 16-byte streaming stores.
// - dyv: the lane forms 8 partial sums over its 4 columns (xv[n, s,
//   w..w+3] in registers), and a transpose-reduce over the 16 lanes of its
//   half (xor 8, 4, 2 halving the values each lane keeps, then xor 1)
//   leaves each lane pair with the full sum of one s in 8 shuffles and no
//   selects: a lane holds its partials in the order s0 + (i ^ m), m its
//   lane bits.  The (S, H) sums collect in shared memory and are stored
//   contiguously.
// Every other shape takes psroi_abuild_bwd_kernel, the first design.
//
// The bf16 instance (mx_psroi_abuild_bwd_bf16) takes the cotangent of a
// bf16 A: g is upcast to fp32 as it is read, and dyv and dxv are the same
// fp32 sums, written fp32 (_abuild_bwd_kernel_factory upcasts g the same
// way).  Both designs, templated on g's type: the tiled one stages g in
// bf16 (16-byte copies of 8 values; H W a multiple of 8) and reads four
// values a lane in 8 bytes.  At the train call g is 31 MB in place of 61:
// 112.5 MB, 34 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "pipeline.cuh"

namespace {

constexpr int kS = 16;          // the tiled path's S (spp^2 of the R-FCN head)
constexpr int kWarps = 4;       // warps of a tiled block, sharing one roi's rows
constexpr int kThreads = 256;   // generic path
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                     fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

__device__ __forceinline__ float dot4(float4 g, float4 x) {
  return fmaf(g.w, x.w, fmaf(g.z, x.z, fmaf(g.y, x.y, g.x * x.x)));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Shared memory of a tiled block, in floats: two stages of yv^T (h x S),
// xv (S x w) and g (h x w, in g's type G); the dyv sums (S x h); the dxv
// partials of the kWarps warps (kWarps x S x 16 float4).
template <typename G>
__host__ __device__ constexpr size_t tiled_stage(int h, int w) {
  return (size_t)kS * (h + w) + (size_t)h * w * sizeof(G) / sizeof(float);
}
template <typename G>
__host__ __device__ constexpr size_t tiled_floats(int h, int w) {
  return 2 * tiled_stage<G>(h, w) + (size_t)kS * h + (size_t)kWarps * kS * 16 * 4;
}

template <typename G>
__global__ void __launch_bounds__(kWarps * 32, 4)
psroi_abuild_bwd_kernel_tiled(const float* __restrict__ yv,
                              const float* __restrict__ xv,
                              const G* __restrict__ g, int n, int h, int w,
                              float* __restrict__ dyv, float* __restrict__ dxv) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int stage = static_cast<int>(tiled_stage<G>(h, w));
  float* buf = reinterpret_cast<float*>(smem4);
  float* dy = buf + 2 * stage;
  float4* fold = reinterpret_cast<float4*>(dy + kS * h);
  const int cg = w >> 2;
  const int c_l = lane & 15;
  const int s0 = 8 * (lane >> 4);  // this half's s range [s0, s0 + 8)
  // the lane keeps its dyv partials in the order s0 + (i ^ m): then every
  // step of the transpose-reduce keeps the first half of its values and
  // sends the second, and the lane pair ends with s_out = s0 + m
  const int m = (lane >> 1) & 7;
  const int s_out = s0 + m;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  auto copy16 = [&](float* dst, const float* src, int count) {
    for (int t = tid * 4; t < count; t += kWarps * 128) mx::cp_async16(dst + t, src + t);
  };
  auto load = [&](int r, float* dst) {
    const float* yr = yv + (long long)r * kS * h;
    const int s_t = tid & (kS - 1);
    for (int hh = tid >> 4; hh < h; hh += kWarps * 2)
      mx::cp_async4(dst + hh * kS + s_t, yr + s_t * h + hh);
    copy16(dst + kS * h, xv + (long long)r * kS * w, kS * w);
    copy16(dst + kS * (h + w), reinterpret_cast<const float*>(g + (long long)r * h * w),
           static_cast<int>((size_t)h * w * sizeof(G) / sizeof(float)));
  };

  int r = blockIdx.x;
  if (r < n) load(r, buf);
  mx::cp_async_commit();
  for (int b = 0; r < n; r += gridDim.x, b ^= 1) {
    if (r + gridDim.x < n) load(r + gridDim.x, buf + (b ^ 1) * stage);
    mx::cp_async_commit();
    mx::cp_async_wait<1>();  // this roi's stage has landed
    __syncthreads();
    const float* cur = buf + b * stage;
    const float4* ys4 = reinterpret_cast<const float4*>(cur);
    const float4* xs4 = reinterpret_cast<const float4*>(cur + kS * h);
    const G* gs = reinterpret_cast<const G*>(cur + kS * (h + w));
    float4* dx4 = reinterpret_cast<float4*>(dxv) + (long long)r * kS * cg;
    // column chunks of 16 groups; lanes past cg add zeros to the reductions
    for (int c0 = 0; c0 < cg; c0 += 16) {
      const int c = c0 + c_l;
      const bool live = c < cg;
      float4 x[8], ax[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = live ? xs4[(s0 + (i ^ m)) * cg + c] : zero;
        ax[i] = zero;
      }
#pragma unroll 2
      for (int hh = warp; hh < h; hh += kWarps) {
        const float4 gv = live ? mx::lds4(gs + 4 * (hh * cg + c)) : zero;
        const float4 ylo = ys4[hh * (kS / 4) + s0 / 4];
        const float4 yhi = ys4[hh * (kS / 4) + s0 / 4 + 1];
        ax[0] = fma4(ylo.x, gv, ax[0]);
        ax[1] = fma4(ylo.y, gv, ax[1]);
        ax[2] = fma4(ylo.z, gv, ax[2]);
        ax[3] = fma4(ylo.w, gv, ax[3]);
        ax[4] = fma4(yhi.x, gv, ax[4]);
        ax[5] = fma4(yhi.y, gv, ax[5]);
        ax[6] = fma4(yhi.z, gv, ax[6]);
        ax[7] = fma4(yhi.w, gv, ax[7]);
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = dot4(gv, x[i]);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] += __shfl_xor_sync(kAll, p[i + 4], 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) p[i] += __shfl_xor_sync(kAll, p[i + 2], 4);
        float v = p[0] + __shfl_xor_sync(kAll, p[1], 2);
        v += __shfl_xor_sync(kAll, v, 1);
        if (!(lane & 1)) {
          float* d = dy + s_out * h + hh;
          *d = c0 == 0 ? v : *d + v;
        }
      }
      // dxv of this chunk: the warps' partial sums over their rows, added
      // in warp order
#pragma unroll
      for (int i = 0; i < 8; ++i) fold[(warp * kS + s0 + i) * 16 + c_l] = ax[i];
      __syncthreads();
      for (int e = tid; e < kS * 16; e += kWarps * 32) {
        const int col = c0 + (e & 15);
        if (col >= cg) continue;
        float4 acc = fold[e];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) acc = add4(acc, fold[k * kS * 16 + e]);
        __stcs(dx4 + (e >> 4) * cg + col, acc);
      }
      __syncthreads();  // fold is free, dy complete
    }
    float4* dyg = reinterpret_cast<float4*>(dyv) + (long long)r * 4 * h;
    const float4* dys = reinterpret_cast<const float4*>(dy);
    for (int t = tid; t < 4 * h; t += kWarps * 32) __stcs(dyg + t, dys[t]);
    __syncthreads();  // this stage and dy are free
  }
}

// Any S and W: one block per n stages g[n], yv[n] and xv[n] in shared
// memory, g and xv with a row stride of W + 1 floats (the dyv loop walks g
// down a column, and the odd stride puts neighbouring rows in neighbouring
// banks); sums over w and over h ascending.
template <typename G>
__global__ void psroi_abuild_bwd_kernel(const float* __restrict__ yv,
                                        const float* __restrict__ xv,
                                        const G* __restrict__ g, int s,
                                        int h, int w, float* __restrict__ dyv,
                                        float* __restrict__ dxv) {
  extern __shared__ float smem[];
  const int ws = w + 1;  // padded row stride of gs and xs
  float* gs = smem;              // h x ws
  float* xs = gs + h * ws;       // s x ws
  float* ys = xs + s * ws;       // s x h
  const long long r = blockIdx.x;
  const G* gr = g + r * h * w;
  const float* xr = xv + r * s * w;
  const float* yr = yv + r * s * h;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  constexpr int kRowStep = kThreads / 32;
  for (int hh = ty; hh < h; hh += kRowStep)
    for (int ww = tx; ww < w; ww += 32) gs[hh * ws + ww] = mx::to_float(gr[hh * w + ww]);
  for (int ss = ty; ss < s; ss += kRowStep)
    for (int ww = tx; ww < w; ww += 32) xs[ss * ws + ww] = xr[ss * w + ww];
  for (int t = threadIdx.x; t < s * h; t += blockDim.x) ys[t] = yr[t];
  __syncthreads();
  float* dy = dyv + r * s * h;
  for (int ss = ty; ss < s; ss += kRowStep) {
    const float* xrow = xs + ss * ws;
    for (int hh = tx; hh < h; hh += 32) {
      const float* grow = gs + hh * ws;
      float acc = 0.f;
      for (int k = 0; k < w; ++k) acc = fmaf(grow[k], xrow[k], acc);
      dy[ss * h + hh] = acc;
    }
  }
  float* dx = dxv + r * s * w;
  for (int ss = ty; ss < s; ss += kRowStep) {
    const float* yrow = ys + ss * h;
    for (int ww = tx; ww < w; ww += 32) {
      float acc = 0.f;
      for (int k = 0; k < h; ++k) acc = fmaf(yrow[k], gs[k * ws + ww], acc);
      dx[ss * w + ww] = acc;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename G>
int psroi_abuild_bwd(const void* yv, const void* xv, const void* g, void* dyv, void* dxv,
                     int n, int s, int h, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(yv) && aligned16(xv) && aligned16(g) &&
                       aligned16(dyv) && aligned16(dxv);
  const size_t tiled_smem = sizeof(float) * tiled_floats<G>(h, w);
  // each roi's g, and each stage, a whole number of 16-byte copies
  const bool whole = ((size_t)h * w * sizeof(G)) % 16 == 0;
  if (s == kS && w > 0 && w % 4 == 0 && whole && aligned && tiled_smem <= mx::kSmemMax) {
    int blocks = 0;
    const cudaError_t err = mx::persistent_grid(
        psroi_abuild_bwd_kernel_tiled<G>, kWarps * 32, tiled_smem, n, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    psroi_abuild_bwd_kernel_tiled<G><<<blocks, kWarps * 32, tiled_smem, st>>>(
        static_cast<const float*>(yv), static_cast<const float*>(xv),
        static_cast<const G*>(g), n, h, w, static_cast<float*>(dyv),
        static_cast<float*>(dxv));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = ((size_t)(h + s) * (w + 1) + (size_t)s * h) * sizeof(float);
  cudaError_t err = mx::allow_smem(psroi_abuild_bwd_kernel<G>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  psroi_abuild_bwd_kernel<G><<<n, kThreads, smem, st>>>(
      static_cast<const float*>(yv), static_cast<const float*>(xv),
      static_cast<const G*>(g), s, h, w, static_cast<float*>(dyv),
      static_cast<float*>(dxv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// yv (N, S, H), xv (N, S, W), g (N, H, W) f32 -> dyv (N, S, H), dxv (N, S, W).
extern "C" int mx_psroi_abuild_bwd(const void* yv, const void* xv,
                                   const void* g, void* dyv, void* dxv, int n,
                                   int s, int h, int w, void* stream) {
  return psroi_abuild_bwd<float>(yv, xv, g, dyv, dxv, n, s, h, w, stream);
}

// The same with g (N, H, W) bf16; dyv and dxv f32.
extern "C" int mx_psroi_abuild_bwd_bf16(const void* yv, const void* xv,
                                        const void* g, void* dyv, void* dxv, int n,
                                        int s, int h, int w, void* stream) {
  return psroi_abuild_bwd<mx::bf16>(yv, xv, g, dyv, dxv, n, s, h, w, stream);
}
