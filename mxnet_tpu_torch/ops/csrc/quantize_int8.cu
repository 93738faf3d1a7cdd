// Symmetric int8 quantize and dequantize of a float32 tensor of any size:
//   quantize:   s = 127 / range;  q = int8(sign(x) * min(|x| * s + 0.5, 127))
//   dequantize: x = float(q) * (range / 127)
// with `range` a float32 scalar on the device (the max-abs of the tensor's
// min / max range).  The cast truncates toward zero, so adding 0.5 before it
// rounds half away from zero.
//
// Replaces the TPU kernels mxnet_tpu/ops/pallas_kernels.py
// quantize_int8_pallas / dequantize_int8_pallas (_q_kernel, _dq_kernel over
// _tiled_elementwise), which flatten the tensor to (rows, 128) tiles and keep
// the scale in SMEM.  Here each thread reads `range` through a pointer (so the
// caller never copies it to the host) and forms the scale itself with the same
// float32 division as the JAX op, 127.0f / range; Hopper has no tile-alignment
// rule, so any element count is taken.
//
// Bound on the card: bytes, 5 per element either way (4 read and 1 written, or
// 1 read and 4 written), against ~4 flops per element.  Design: a grid-stride
// loop over groups of four elements, 16-byte float4 loads or stores against
// 4-byte char4 ones, and a scalar tail for the last n % 4 elements (or for all
// of them when the wrapper finds a pointer that is not aligned for vectors).
//
// Bit-exactness with the plain PyTorch version: the multiply and the add are
// written with _rn intrinsics, so that nvcc's default -fmad=true cannot
// contract |x| * s + 0.5 into one FMA, and the divisions with __fdiv_rn.  The
// edge cases follow the JAX formula: a NaN anywhere in |x| * s + 0.5 (x NaN,
// or x = 0 with a zero range) gives 0, as sign() * NaN cast to int8 does there;
// +-0 gives 0; fminf would drop a NaN, so it is tested first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ signed char quantize_one(float x, float s) {
  const float m = __fadd_rn(__fmul_rn(fabsf(x), s), 0.5f);
  if (m != m) return 0;  // NaN
  const int q = static_cast<int>(fminf(m, 127.0f));  // truncates toward zero
  return static_cast<signed char>(x > 0.0f ? q : (x < 0.0f ? -q : 0));
}

__global__ void quantize_int8_kernel(const float* __restrict__ x,
                                     const float* __restrict__ range,
                                     signed char* __restrict__ q, long long n,
                                     long long n4) {
  const float s = __fdiv_rn(127.0f, *range);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  char4* q4 = reinterpret_cast<char4*>(q);
  for (long long i = first; i < n4; i += stride) {
    const float4 v = x4[i];
    q4[i] = make_char4(quantize_one(v.x, s), quantize_one(v.y, s),
                       quantize_one(v.z, s), quantize_one(v.w, s));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) q[i] = quantize_one(x[i], s);
}

__global__ void dequantize_int8_kernel(const signed char* __restrict__ q,
                                       const float* __restrict__ range,
                                       float* __restrict__ x, long long n,
                                       long long n4) {
  const float s = __fdiv_rn(*range, 127.0f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const char4* q4 = reinterpret_cast<const char4*>(q);
  float4* x4 = reinterpret_cast<float4*>(x);
  for (long long i = first; i < n4; i += stride) {
    const char4 v = q4[i];
    x4[i] = make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                        __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) x[i] = __fmul_rn((float)q[i], s);
}

// Enough blocks to cover the vector groups once, at most 16 per SM of an
// H100 (132 SMs); the grid-stride loop takes the rest.
unsigned grid_for(long long n) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// x (n,) f32, range () f32 on the device -> q (n,) int8.  vec != 0 when x is
// 16-byte and q 4-byte aligned.
extern "C" int mx_quantize_int8(const void* x, const void* range, void* q,
                                long long n, int vec, void* stream) {
  quantize_int8_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(range),
      static_cast<signed char*>(q), n, vec ? n / 4 : 0);
  return static_cast<int>(cudaGetLastError());
}

// q (n,) int8, range () f32 on the device -> x (n,) f32.  vec != 0 when q is
// 4-byte and x 16-byte aligned.
extern "C" int mx_dequantize_int8(const void* q, const void* range, void* x,
                                  long long n, int vec, void* stream) {
  dequantize_int8_kernel<<<grid_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(range),
      static_cast<float*>(x), n, vec ? n / 4 : 0);
  return static_cast<int>(cudaGetLastError());
}
