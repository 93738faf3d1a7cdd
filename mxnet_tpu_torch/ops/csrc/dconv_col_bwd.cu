// Backward of the deformable-convolution sampling (dconv_col.cu): given the
// cotangent g (BG, N, C) of col, the gradients of the lerp factors and of ft
//   d_ly = lf sum_c g [(1-lx)(f10-f00) + lx(f11-f01)]
//   d_lx = lf sum_c g [(1-ly)(f01-f00) + ly(f11-f10)]
//   d_lf =    sum_c g bilinear(f)
//   d_ft[corner] += w_corner lf g          (four corners per row)
// where fij = ft[bg, yi W + xj, c] and w00 = (1-ly)(1-lx), w01 = (1-ly) lx,
// w10 = ly (1-lx), w11 = ly lx.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py _dconv_bwd /
// _dconv_bwd_kernel_factory (the custom VJP of dconv_col_pallas), which
// builds each block of dA = g ft^T in VMEM, reduces it against the one-hot
// masks and accumulates A^T g across the row-block grid.  A row of A has at
// most four non-zeros, so here dA is never formed: each row reads its four
// corner rows of ft, as the forward does, and the row sums above are the
// masked reductions of dA written out.  A clamped corner (y1 == y0 or
// x1 == x0) reads one address twice, so f10 - f00 (or f01 - f00) is exactly
// 0 and so is d_ly (d_lx), as the one-hot difference (e1y - e0y) makes it.
//
// Bound on the card: bytes.  At the R-FCN res5 shapes (batch 1: BG = 4,
// N = 21,888, C = 128, H W = 2,432) the launch reads g once (44.8 MB), the
// factors (2.5 MB) and ft (5 MB, L2 resident), and writes d_ft (5 MB) and
// the three row outputs: about 58 MB, 17 us at 3.35 TB/s.  Design: one warp
// per row, lanes striding over the channels (coalesced g and corner loads),
// the three row sums reduced by warp shuffles, d_ft accumulated with
// atomicAdd into a buffer the entry zeroes first on the same stream.  A
// corner whose weight is 0 (or a dead row, lf = 0) adds nothing and is
// skipped.  The atomics sum in an order that changes from run to run, so
// d_ft agrees with a fixed-order sum to rounding, not bitwise.  No fast-math:
// fp32 throughout, as the TPU kernel pins HIGHEST precision for fp32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void dconv_col_bwd_kernel(
    const int* __restrict__ y0, const int* __restrict__ y1,
    const int* __restrict__ x0, const int* __restrict__ x1,
    const float* __restrict__ ly, const float* __restrict__ lx,
    const float* __restrict__ lf, const float* __restrict__ ft,
    const float* __restrict__ g, long long rows, int n, int w, int hw, int c,
    float* __restrict__ dly, float* __restrict__ dlx, float* __restrict__ dlf,
    float* __restrict__ dft) {
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps leave together: rows split by warp
  const long long bg = r / n;
  const float fy = ly[r];
  const float fx = lx[r];
  const float live = lf[r];
  const float w00 = (1.f - fy) * (1.f - fx);
  const float w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx);
  const float w11 = fy * fx;
  const long long base = bg * hw * (long long)c;
  const long long o00 = base + (long long)(y0[r] * w + x0[r]) * c;
  const long long o01 = base + (long long)(y0[r] * w + x1[r]) * c;
  const long long o10 = base + (long long)(y1[r] * w + x0[r]) * c;
  const long long o11 = base + (long long)(y1[r] * w + x1[r]) * c;
  // scatter weights w_ij lf; a zero weight adds nothing and is skipped
  const float s00 = w00 * live, s01 = w01 * live, s10 = w10 * live, s11 = w11 * live;
  const float* gr = g + r * c;
  float acc_y = 0.f, acc_x = 0.f, acc_f = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float gk = gr[k];
    const float f00 = ft[o00 + k];
    const float f01 = ft[o01 + k];
    const float f10 = ft[o10 + k];
    const float f11 = ft[o11 + k];
    acc_y += gk * ((1.f - fx) * (f10 - f00) + fx * (f11 - f01));
    acc_x += gk * ((1.f - fy) * (f01 - f00) + fy * (f11 - f10));
    acc_f += gk * (w00 * f00 + w01 * f01 + w10 * f10 + w11 * f11);
    if (s00 != 0.f) atomicAdd(dft + o00 + k, s00 * gk);
    if (s01 != 0.f) atomicAdd(dft + o01 + k, s01 * gk);
    if (s10 != 0.f) atomicAdd(dft + o10 + k, s10 * gk);
    if (s11 != 0.f) atomicAdd(dft + o11 + k, s11 * gk);
  }
  acc_y = warp_sum(acc_y);
  acc_x = warp_sum(acc_x);
  acc_f = warp_sum(acc_f);
  if (lane == 0) {
    dly[r] = live * acc_y;
    dlx[r] = live * acc_x;
    dlf[r] = acc_f;
  }
}

}  // namespace

// y0..x1 (BG, N) i32; ly, lx, lf (BG, N) f32; ft (BG, H W, C) f32;
// g (BG, N, C) f32 -> dly, dlx, dlf (BG, N) f32 and dft (BG, H W, C) f32.
extern "C" int mx_dconv_col_bwd(const void* y0, const void* y1, const void* x0,
                                const void* x1, const void* ly, const void* lx,
                                const void* lf, const void* ft, const void* g,
                                void* dly, void* dlx, void* dlf, void* dft,
                                int bg, int n, int h, int w, int c,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)bg * n;
  cudaError_t err = cudaMemsetAsync(dft, 0, (size_t)bg * h * w * c * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dconv_col_bwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int*>(y0), static_cast<const int*>(y1),
      static_cast<const int*>(x0), static_cast<const int*>(x1),
      static_cast<const float*>(ly), static_cast<const float*>(lx),
      static_cast<const float*>(lf), static_cast<const float*>(ft),
      static_cast<const float*>(g), rows, n, w, h * w, c,
      static_cast<float*>(dly), static_cast<float*>(dlx),
      static_cast<float*>(dlf), static_cast<float*>(dft));
  return static_cast<int>(cudaGetLastError());
}
