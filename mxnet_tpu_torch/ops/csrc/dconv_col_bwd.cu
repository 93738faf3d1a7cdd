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
// most four non-zeros, so here only dA's four corner values per row are
// formed, from the row's four corner values of ft, and the row sums above
// are their masked reductions.  A clamped corner (y1 == y0 or x1 == x0)
// reads one value twice, so f10 - f00 (or f01 - f00) is exactly 0 and so is
// d_ly (d_lx), as the one-hot difference (e1y - e0y) makes it.
//
// g comes in one of two layouts, and the entry takes its row and channel
// strides: contiguous (C, 1), or channel-major (1, N), which is how the
// autograd hands it from deformable_convolution (ops/detection.py), with
// the rows laid out (tap, ho, wo).  Two designs, chosen by shape and layout
// in the entry:
//   - dconv_col_bwd_tiled_kernel (below), for channel-major g whose rows'
//     layout the caller passes: a block sums the corner terms of a tile of
//     output positions, all taps, in shared memory;
//   - dconv_col_bwd_kernel, for any other call: one warp per row, lanes
//     striding over the channels (coalesced corner loads), the three row
//     sums reduced by warp shuffles, d_ft accumulated with global atomics.
//     In the channel-major layout a lane's load of g is not coalesced with
//     its neighbours', but the eight warps of a block take eight
//     consecutive rows, whose values of one channel lie in 32 consecutive
//     bytes.
//
// Bound on the card: bytes.  At the R-FCN res5 shapes (batch 1: BG = 4,
// N = 21,888, C = 128, H W = 2,432) the launch reads g once (44.8 MB), the
// factors (2.5 MB) and ft (5 MB, L2 resident), and writes d_ft (5 MB) and
// the three row outputs: about 58 MB, 17 us at 3.35 TB/s.  d_ft starts from
// a buffer the entry zeroes on the same stream.  A corner whose weight is 0
// (or a dead row, lf = 0) adds nothing and is skipped.  The atomics sum in
// an order that changes from run to run, so d_ft agrees with a fixed-order
// sum to rounding, not bitwise.  No fast-math: fp32 throughout, as the TPU
// kernel pins HIGHEST precision for fp32.
//
// The bf16 instance (mx_dconv_col_bwd_bf16: bf16 ft, g and d_ft) follows
// the TPU kernel's bf16 contract (_dconv_bwd_kernel_factory, _dconv_bwd):
// dA and the three row sums in fp32 from the bf16 values and the fp32
// factors, written fp32; d_ft = bf16(A)^T g, where each corner's scatter
// weight is the forward's one-hot weight rounded to bf16 (a clamped
// corner's two weights merged), accumulated in fp32 over every row, in an
// fp32 buffer that the caller passes, and rounded once to bf16 at the end
// by a second kernel.  Both designs, templated on the element type: the
// tiled one stages its ft window in bf16 (8-byte cp.async copies, half the
// window's room) and converts four channels as it reads them, and takes
// the merged bf16 weights as its corners' scatter weights, so a clamped
// corner's second weight is 0 and adds nothing.
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "pipeline.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A row's four scatter weights, for d_ft: fp32 w_ij lf; bf16 the forward's
// one-hot weights, a clamped corner's merged on its first corner, rounded
// to bf16
template <typename T>
__device__ __forceinline__ float4 scatter_weights(float fy, float fx, float live, bool,
                                                  bool) {
  return make_float4((1.f - fy) * (1.f - fx) * live, (1.f - fy) * fx * live,
                     fy * (1.f - fx) * live, fy * fx * live);
}

template <>
__device__ __forceinline__ float4 scatter_weights<mx::bf16>(float fy, float fx, float live,
                                                            bool ysame, bool xsame) {
  const float wy0 = ysame ? (1.f - fy) + fy : 1.f - fy, wy1 = ysame ? 0.f : fy;
  const float wx0 = xsame ? (1.f - fx) + fx : 1.f - fx, wx1 = xsame ? 0.f : fx;
  return make_float4(mx::round_bf16(wy0 * wx0 * live), mx::round_bf16(wy0 * wx1 * live),
                     mx::round_bf16(wy1 * wx0 * live), mx::round_bf16(wy1 * wx1 * live));
}

// Row r (of the BG N), by one warp: lanes over the channels, the three row
// sums reduced by warp shuffles.  T is the element type of ft and g; d_ft
// is summed in fp32 (for bf16 the caller's buffer).
template <typename T>
__device__ __forceinline__ void bwd_row(
    long long r, int lane, const int* __restrict__ y0, const int* __restrict__ y1,
    const int* __restrict__ x0, const int* __restrict__ x1,
    const float* __restrict__ ly, const float* __restrict__ lx,
    const float* __restrict__ lf, const T* __restrict__ ft,
    const T* __restrict__ g, int n, int w, int hw, int c, long long g_row,
    long long g_chan, float* __restrict__ dly, float* __restrict__ dlx,
    float* __restrict__ dlf, float* __restrict__ dft) {
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
  // scatter weights; a zero weight adds nothing and is skipped
  const float4 sw = scatter_weights<T>(fy, fx, live, y0[r] == y1[r], x0[r] == x1[r]);
  const float s00 = sw.x, s01 = sw.y, s10 = sw.z, s11 = sw.w;
  const T* gr = g + bg * (long long)n * c + (r - bg * n) * g_row;
  float acc_y = 0.f, acc_x = 0.f, acc_f = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float gk = mx::to_float(gr[k * g_chan]);
    const float f00 = mx::to_float(ft[o00 + k]);
    const float f01 = mx::to_float(ft[o01 + k]);
    const float f10 = mx::to_float(ft[o10 + k]);
    const float f11 = mx::to_float(ft[o11 + k]);
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

template <typename T>
__global__ void dconv_col_bwd_kernel(
    const int* __restrict__ y0, const int* __restrict__ y1,
    const int* __restrict__ x0, const int* __restrict__ x1,
    const float* __restrict__ ly, const float* __restrict__ lx,
    const float* __restrict__ lf, const T* __restrict__ ft,
    const T* __restrict__ g, long long rows, int n, int w, int hw, int c,
    long long g_row, long long g_chan, float* __restrict__ dly,
    float* __restrict__ dlx, float* __restrict__ dlf, float* __restrict__ dft) {
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together: rows split by warp
  bwd_row<T>(r, threadIdx.x & 31, y0, y1, x0, x1, ly, lx, lf, ft, g, n, w, hw, c, g_row,
             g_chan, dly, dlx, dlf, dft);
}

// The bf16 instance's last step: d_ft rounded once from its fp32 sums.
__global__ void round_to_bf16_kernel(const float* __restrict__ acc, long long total,
                                     mx::bf16* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride)
    out[e] = __float2bfloat16_rn(acc[e]);
}

// 16-byte atomic add (sm_90): one request where four scalar ones would go.
__device__ __forceinline__ void red_add4(float* dst, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The tiled design, for rows laid out (tap, ho, wo) (K2 <= kMaxTaps taps over
// an Ho x Wo output), channel-major g, and C a multiple of 4.  Block = one
// tile of kTileH x kTileW output positions of one bg, across all K2 taps;
// lane l of every warp takes position l of the tile, so for one tap and one
// channel a warp's 32 loads of g are four 32-byte runs of consecutive rows.
// The block's window is the box its rows' corners reach (block-wide min /
// max of y0, y1, x0, x1: it adapts to the offsets).  Where it fits in
// kMaxWindow pixels, the block walks the channels kChunk at a time, with
// the ft window in shared memory as [pixel][channel] (16-byte cp.async;
// the next chunk's copy is in flight while the last one is flushed) and a
// d_ft window beside it.  Warp w takes channels 4w .. 4w + 3 of a chunk
// (16-byte shared loads and stores): for each tap its lanes read their four
// corners from the ft window, sum dA's four corner values over the four
// channels into their rows' three sums, and add their four corner terms
// into the d_ft window.  A warp owns its channels, so only its own lanes
// can meet on a pixel, at one corner of one tap when two rows' offsets
// cross a pixel edge.  The block finds those meetings once
// (__match_any_sync): where lanes meet at most in pairs, the lower lane
// adds its partner's terms to its own (a warp shuffle); where more meet,
// they add in turns by rank.  __syncwarp orders each corner's adds after
// the last's.  The flush adds the chunk's d_ft window to d_ft with one
// 16-byte global atomic per four channels not all zero (neighbouring
// tiles' windows overlap) and leaves it zero.  The row sums of the warps
// are added in warp order at the end.  A tile whose window is too large
// for shared memory (offsets of many pixels) takes its rows one warp each,
// as dconv_col_bwd_kernel does.
//
// Timed on an H100 at the res5 train call and slower (PERF.md): shared
// float atomics for the d_ft window (compare-and-swap loops on this card),
// turns for every meeting, a [channel][pixel] window read a channel at a
// time, and fewer warps with more channels each.
constexpr int kTileH = 4, kTileW = 8;  // kTileH kTileW == 32: a lane a position
constexpr int kTiledWarps = 8;
constexpr int kChunk = 4 * kTiledWarps;  // channels of the windows at a time
constexpr int kPitch = kChunk + 4;  // floats of a window pixel: 16-byte rows, and
                                    // eight lanes on consecutive pixels hit
                                    // distinct banks
constexpr int kMaxTaps = 9;      // K2 of a 3 x 3 kernel
constexpr int kMaxWindow = 224;  // pixels of a window

// dynamic shared memory, floats: the ft and d_ft windows [kMaxWindow][kPitch]
// (their room holds the warps' row sums at the end), then the lanes' rows
// [kTapWords][kMaxTaps][32]
constexpr int kWindowFloats = 2 * kMaxWindow * kPitch;
constexpr int kTapWords = 5;  // fy, fx, live, rank (and base), turns
constexpr size_t kTiledSmem = sizeof(float) * (kWindowFloats + kTapWords * kMaxTaps * 32);
static_assert(kWindowFloats >= kTiledWarps * kMaxTaps * 3 * 32, "room for the row sums");

// grid (ceil(Wo / kTileW), ceil(Ho / kTileH), BG), kTiledWarps * 32
// threads, kTiledSmem bytes of dynamic shared memory; three blocks an SM.
// T is the element type of ft and g: a bf16 ft window is staged in bf16
// and converted as it is read, and d_ft (for bf16 the caller's fp32
// buffer) is summed in fp32.
template <typename T>
__global__ void __launch_bounds__(kTiledWarps * 32, 3)
dconv_col_bwd_tiled_kernel(
    const int* __restrict__ y0, const int* __restrict__ y1,
    const int* __restrict__ x0, const int* __restrict__ x1,
    const float* __restrict__ ly, const float* __restrict__ lx,
    const float* __restrict__ lf, const T* __restrict__ ft,
    const T* __restrict__ g, int n, int w, int hw, int c, int k2, int ho,
    int wo, float* __restrict__ dly, float* __restrict__ dlx,
    float* __restrict__ dlf, float* __restrict__ dft) {
  extern __shared__ __align__(16) float sm[];
  float* tap_fy = sm + kWindowFloats;  // [t][lane], and so on
  float* tap_fx = tap_fy + kMaxTaps * 32;
  float* tap_live = tap_fx + kMaxTaps * 32;
  int* tap_rank = reinterpret_cast<int*>(tap_live + kMaxTaps * 32);
  int* tap_turns = tap_rank + kMaxTaps * 32;
  __shared__ int win[4];  // min y0, min x0, max y1, max x1 over the block
  const int bg = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int oy = blockIdx.y * kTileH + lane / kTileW;
  const int ox = blockIdx.x * kTileW + lane % kTileW;
  const bool pos = oy < ho && ox < wo;
  const int hwo = ho * wo;
  const int row0 = oy * wo + ox;  // row of tap 0; tap t adds t Ho Wo
  const long long fb = (long long)bg * n;
  const T* ftb = ft + (long long)bg * hw * c;
  float* dftb = dft + (long long)bg * hw * c;
  const T* gb = g + (long long)bg * c * n;

  // warp w reads the rows of taps w and w + kTiledWarps
  if (tid == 0) win[0] = win[1] = INT_MAX, win[2] = win[3] = INT_MIN;
  __syncthreads();
  constexpr int kMine = (kMaxTaps + kTiledWarps - 1) / kTiledWarps;
  int cy[kMine], cx[kMine], dx[kMine], dy[kMine];
  {
    int ymin = INT_MAX, xmin = INT_MAX, ymax = INT_MIN, xmax = INT_MIN;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int t = warp + i * kTiledWarps;
      const bool in = pos && t < k2;
      const long long r = fb + (in ? (long long)t * hwo + row0 : 0);
      cy[i] = in ? y0[r] : 0;
      cx[i] = in ? x0[r] : 0;
      dy[i] = in ? y1[r] - cy[i] : 0;  // 0 or 1
      dx[i] = in ? x1[r] - cx[i] : 0;
      if (t < kMaxTaps) {
        // a lane past the map adds nothing and its sums are not written
        tap_fy[t * 32 + lane] = in ? ly[r] : 0.f;
        tap_fx[t * 32 + lane] = in ? lx[r] : 0.f;
        tap_live[t * 32 + lane] = in ? lf[r] : 0.f;
      }
      if (in) {
        ymin = min(ymin, cy[i]);
        xmin = min(xmin, cx[i]);
        ymax = max(ymax, cy[i] + dy[i]);
        xmax = max(xmax, cx[i] + dx[i]);
      }
    }
    ymin = __reduce_min_sync(0xffffffffu, ymin);
    xmin = __reduce_min_sync(0xffffffffu, xmin);
    ymax = __reduce_max_sync(0xffffffffu, ymax);
    xmax = __reduce_max_sync(0xffffffffu, xmax);
    if (lane == 0) {
      atomicMin(win + 0, ymin);
      atomicMin(win + 1, xmin);
      atomicMax(win + 2, ymax);
      atomicMax(win + 3, xmax);
    }
  }
  __syncthreads();
  const int ymin = win[0], xmin = win[1];
  const int wh = win[2] - ymin + 1, ww = win[3] - xmin + 1, px = wh * ww;
  if (px > kMaxWindow) {  // the whole block leaves together
    for (int i = warp; i < k2 * 32; i += kTiledWarps) {
      const int t = i / 32, l = i % 32;
      const int py = blockIdx.y * kTileH + l / kTileW, pxx = blockIdx.x * kTileW + l % kTileW;
      if (py < ho && pxx < wo)
        bwd_row<T>(fb + (long long)t * hwo + py * wo + pxx, lane, y0, y1, x0, x1, ly, lx,
                   lf, ft, g, n, w, hw, c, 1, n, dly, dlx, dlf, dft);
    }
    return;
  }

  // each lane's corners: base pixel (y0, x0) in the window; turns: bits
  // 5q..5q+4 the turns of corner q less one, bit 20 + q whether the lane
  // adds at corner q, bits 24 and 25 x1 - x0 and y1 - y0; rank: bits
  // 5q..5q+4 the lane's turn at corner q, or where lanes meet at most in
  // pairs (one turn), the lane whose terms this lane adds beside its own;
  // bits 20.. of rank: the base pixel
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int t = warp + i * kTiledWarps;
    if (t >= k2) break;  // uniform
    const int base = pos ? (cy[i] - ymin) * ww + (cx[i] - xmin) : 0;
    const int pc[4] = {base, base + dx[i], base + dy[i] * ww, base + dy[i] * ww + dx[i]};
    const float fy = tap_fy[t * 32 + lane], fx = tap_fx[t * 32 + lane];
    const float live = tap_live[t * 32 + lane];
    const float4 s4 = scatter_weights<T>(fy, fx, live, dy[i] == 0, dx[i] == 0);
    const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
    int rank = 0, turns = dx[i] << 24 | dy[i] << 25;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool adds = pos && sc[q] != 0.f;
      const unsigned m = __match_any_sync(0xffffffffu, adds ? pc[q] : -1 - lane);
      const int group = __reduce_max_sync(0xffffffffu, adds ? (unsigned)__popc(m) : 1u);
      const int lead = __ffs(m) - 1;
      if (group == 2) {  // pairs at most: the lower lane adds both terms
        const int other = __popc(m) == 2 ? __ffs(m & ~(1u << lead)) - 1 : lane;
        rank |= (lane == lead ? other : lane) << (5 * q);
        turns |= (adds && lane == lead ? 1 : 0) << (20 + q);
      } else {
        rank |= __popc(m & ((1u << lane) - 1u)) << (5 * q);
        turns |= (adds ? 1 : 0) << (20 + q);
      }
      turns |= (group - 1) << (5 * q);
    }
    tap_rank[t * 32 + lane] = rank | base << 20;
    tap_turns[t * 32 + lane] = turns;
  }

  float acc[kMaxTaps][3];  // this warp's part of the lanes' row sums
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) acc[t][0] = acc[t][1] = acc[t][2] = 0.f;
  T* fw = reinterpret_cast<T*>(sm);        // [kMaxWindow][kPitch], in ft's type
  float* dw = sm + kMaxWindow * kPitch;    // [kMaxWindow][kPitch]
  const int k4 = 4 * warp;  // this warp's four channels of a chunk
  // chunk c0 of ft over the window into fw (channels past C: zeros, never
  // NaN from a stale stage)
  auto stage = [&](int c0) {
    const int cn = min(kChunk, c - c0);
    for (int i = tid; i < px * (kChunk / 4); i += kTiledWarps * 32) {
      const int p = i / (kChunk / 4), q4 = 4 * (i % (kChunk / 4));
      const int py = p / ww, pxx = p - py * ww;
      T* dst = fw + p * kPitch + q4;
      const T* src = ftb + (long long)((ymin + py) * w + xmin + pxx) * c + c0 + q4;
      if constexpr (sizeof(T) == sizeof(float)) {
        if (q4 < cn)
          mx::cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src));
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {  // bf16: four channels in 8 bytes, converted as they are read
        if (q4 < cn)
          mx::cp_async8(dst, src);
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      }
    }
    mx::cp_async_commit();
  };
  __syncthreads();  // the lanes' corners are out
  stage(0);
  for (int i = tid; i < px * (kChunk / 4); i += kTiledWarps * 32) {
    const int p = i / (kChunk / 4), q4 = 4 * (i % (kChunk / 4));
    *reinterpret_cast<float4*>(dw + p * kPitch + q4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int cn = min(kChunk, c - c0);  // a multiple of 4
    mx::cp_async_wait<0>();
    __syncthreads();  // the chunk's ft is in, its d_ft window zero
    const bool mine4 = k4 < cn;  // warp-uniform
    float gv[4], gn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      gv[j] = pos && mine4 ? mx::to_float(gb[(long long)(c0 + k4 + j) * n + row0]) : 0.f;
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      if (t >= k2 || !mine4) break;  // uniform
#pragma unroll
      for (int j = 0; j < 4; ++j)  // the next tap's g, in flight
        gn[j] = pos && t + 1 < k2
                    ? mx::to_float(gb[(long long)(c0 + k4 + j) * n +
                                      (long long)(t + 1) * hwo + row0])
                    : 0.f;
      const float y = tap_fy[t * 32 + lane], x = tap_fx[t * 32 + lane];
      const float live = tap_live[t * 32 + lane];
      const int rank = tap_rank[t * 32 + lane], base = rank >> 20;
      const int turns = tap_turns[t * 32 + lane];
      const int ddx = (turns >> 24) & 1, ddy = ((turns >> 25) & 1) * ww;
      const int pc[4] = {base, base + ddx, base + ddy, base + ddy + ddx};
      const float w00 = (1.f - y) * (1.f - x);
      const float w01 = (1.f - y) * x;
      const float w10 = y * (1.f - x);
      const float w11 = y * x;
      const float4 a = mx::lds4(fw + pc[0] * kPitch + k4);
      const float4 b = mx::lds4(fw + pc[1] * kPitch + k4);
      const float4 e = mx::lds4(fw + pc[2] * kPitch + k4);
      const float4 f = mx::lds4(fw + pc[3] * kPitch + k4);
      const float f00[4] = {a.x, a.y, a.z, a.w}, f01[4] = {b.x, b.y, b.z, b.w};
      const float f10[4] = {e.x, e.y, e.z, e.w}, f11[4] = {f.x, f.y, f.z, f.w};
      // dA at the four corners over this warp's channels (the rows of
      // dA = g ft^T that the TPU kernel reduces), then their masked sums
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s00 += gv[j] * f00[j];
        s01 += gv[j] * f01[j];
        s10 += gv[j] * f10[j];
        s11 += gv[j] * f11[j];
      }
      // a clamped corner reads one value twice: s10 - s00 (s01 - s00) is 0
      acc[t][0] += (1.f - x) * (s10 - s00) + x * (s11 - s01);
      acc[t][1] += (1.f - y) * (s01 - s00) + y * (s11 - s10);
      acc[t][2] += w00 * s00 + w01 * s01 + w10 * s10 + w11 * s11;
      const float4 g4 = make_float4(gv[0], gv[1], gv[2], gv[3]);  // 0 past the map
      const float4 s4 = scatter_weights<T>(y, x, live, ddy == 0, ddx == 0);
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool adds = (turns >> (20 + q)) & 1;
        const int mine = (rank >> (5 * q)) & 31, last = (turns >> (5 * q)) & 31;
        float4* dst = reinterpret_cast<float4*>(dw + pc[q] * kPitch + k4);
        float4 v = make_float4(sc[q] * g4.x, sc[q] * g4.y, sc[q] * g4.z, sc[q] * g4.w);
        if (last == 1) {  // uniform: lanes meet in pairs, the lower adds both
          const float4 o = make_float4(
              __shfl_sync(0xffffffffu, v.x, mine), __shfl_sync(0xffffffffu, v.y, mine),
              __shfl_sync(0xffffffffu, v.z, mine), __shfl_sync(0xffffffffu, v.w, mine));
          if (mine != lane) v = make_float4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
        }
        if (last <= 1) {  // uniform: one turn
          if (adds) {
            const float4 d = *dst;
            *dst = make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w);
          }
          __syncwarp();
        } else {
          for (int r = 0; r <= last; ++r) {  // uniform
            if (adds && r == mine) {
              const float4 d = *dst;
              *dst = make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w);
            }
            __syncwarp();
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = gn[j];
    }
    __syncthreads();  // every warp is done with the chunk
    if (c0 + kChunk < c) stage(c0 + kChunk);  // in flight during the flush
    // the flush leaves the d_ft window zero for the next chunk
    for (int i = tid; i < px * (kChunk / 4); i += kTiledWarps * 32) {
      const int p = i / (kChunk / 4), q4 = 4 * (i % (kChunk / 4));
      const int py = p / ww, pxx = p - py * ww;
      float4* src = reinterpret_cast<float4*>(dw + p * kPitch + q4);
      const float4 v = *src;
      *src = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q4 < cn && (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f))
        red_add4(dftb + (long long)((ymin + py) * w + xmin + pxx) * c + c0 + q4, v);
    }
  }

  // the row sums: warp w's parts in shared memory, added in warp order
  __syncthreads();
  float* part = sm;  // [warp][tap][3][lane]
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t)
    if (t < k2)
#pragma unroll
      for (int j = 0; j < 3; ++j) part[((warp * kMaxTaps + t) * 3 + j) * 32 + lane] = acc[t][j];
  __syncthreads();
  for (int i = tid; i < k2 * 32; i += kTiledWarps * 32) {
    const int t = i / 32, l = i % 32;
    const int py = blockIdx.y * kTileH + l / kTileW, pxx = blockIdx.x * kTileW + l % kTileW;
    if (py >= ho || pxx >= wo) continue;
    float s[3] = {0.f, 0.f, 0.f};
    for (int v = 0; v < kTiledWarps; ++v)
      for (int j = 0; j < 3; ++j) s[j] += part[((v * kMaxTaps + t) * 3 + j) * 32 + l];
    const long long r = fb + (long long)t * hwo + py * wo + pxx;
    const float lv = tap_live[t * 32 + l];
    dly[r] = lv * s[0];
    dlx[r] = lv * s[1];
    dlf[r] = s[2];
  }
}

}  // namespace

// y0..x1 (BG, N) i32; ly, lx, lf (BG, N) f32; ft (BG, H W, C) f32; g (BG, N, C)
// f32 with row stride g_row and channel stride g_chan (C and 1, or 1 and N)
// -> dly, dlx, dlf (BG, N) f32 and dft (BG, H W, C) f32.  k2, ho, wo: the
// rows' layout (tap, ho, wo), N = k2 ho wo, or 0 where the rows have none.
// Channel-major g with a layout of at most kMaxTaps taps, C a multiple of 4
// and ft and d_ft 16-byte aligned takes the tiled design; every other call
// the row kernel.
extern "C" int mx_dconv_col_bwd(const void* y0, const void* y1, const void* x0,
                                const void* x1, const void* ly, const void* lx,
                                const void* lf, const void* ft, const void* g,
                                void* dly, void* dlx, void* dlf, void* dft,
                                int bg, int n, int h, int w, int c, int g_row,
                                int g_chan, int k2, int ho, int wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)bg * n;
  cudaError_t err = cudaMemsetAsync(dft, 0, (size_t)bg * h * w * c * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* iy0 = static_cast<const int*>(y0);
  const auto* iy1 = static_cast<const int*>(y1);
  const auto* ix0 = static_cast<const int*>(x0);
  const auto* ix1 = static_cast<const int*>(x1);
  const auto* fly = static_cast<const float*>(ly);
  const auto* flx = static_cast<const float*>(lx);
  const auto* flf = static_cast<const float*>(lf);
  const auto* fft = static_cast<const float*>(ft);
  const auto* fg = static_cast<const float*>(g);
  auto* oy = static_cast<float*>(dly);
  auto* ox = static_cast<float*>(dlx);
  auto* of = static_cast<float*>(dlf);
  auto* oft = static_cast<float*>(dft);
  // 16-byte windows and atomics: C a multiple of 4, ft and d_ft 16-byte aligned
  const bool vec4 = c % 4 == 0 && (reinterpret_cast<uintptr_t>(ft) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(dft) & 15) == 0;
  if (k2 > 0 && k2 <= kMaxTaps && g_row == 1 && (long long)k2 * ho * wo == n && vec4) {
    err = mx::allow_smem(dconv_col_bwd_tiled_kernel<float>, kTiledSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((wo + kTileW - 1) / kTileW, (ho + kTileH - 1) / kTileH, bg);
    dconv_col_bwd_tiled_kernel<float><<<grid, kTiledWarps * 32, kTiledSmem, s>>>(
        iy0, iy1, ix0, ix1, fly, flx, flf, fft, fg, n, w, h * w, c, k2, ho, wo, oy, ox,
        of, oft);
  } else {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dconv_col_bwd_kernel<float><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
        iy0, iy1, ix0, ix1, fly, flx, flf, fft, fg, rows, n, w, h * w, c, g_row, g_chan,
        oy, ox, of, oft);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same with ft, g and dft bf16, and acc (BG, H W, C) f32, the buffer
// d_ft is summed in (zeroed here, on the stream); the designs are chosen as
// for fp32 (ft 8-byte aligned for the tiled one's 4-channel loads), then
// d_ft is rounded once from acc.
extern "C" int mx_dconv_col_bwd_bf16(const void* y0, const void* y1, const void* x0,
                                     const void* x1, const void* ly, const void* lx,
                                     const void* lf, const void* ft, const void* g,
                                     void* dly, void* dlx, void* dlf, void* dft, void* acc,
                                     int bg, int n, int h, int w, int c, int g_row,
                                     int g_chan, int k2, int ho, int wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)bg * n;
  const long long total = (long long)bg * h * w * c;
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)total * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* iy0 = static_cast<const int*>(y0);
  const auto* iy1 = static_cast<const int*>(y1);
  const auto* ix0 = static_cast<const int*>(x0);
  const auto* ix1 = static_cast<const int*>(x1);
  const auto* fly = static_cast<const float*>(ly);
  const auto* flx = static_cast<const float*>(lx);
  const auto* flf = static_cast<const float*>(lf);
  const auto* fft = static_cast<const mx::bf16*>(ft);
  const auto* fg = static_cast<const mx::bf16*>(g);
  auto* oy = static_cast<float*>(dly);
  auto* ox = static_cast<float*>(dlx);
  auto* of = static_cast<float*>(dlf);
  auto* oacc = static_cast<float*>(acc);
  const bool vec4 = c % 4 == 0 && (reinterpret_cast<uintptr_t>(ft) & 7) == 0 &&
                    (reinterpret_cast<uintptr_t>(acc) & 15) == 0;
  if (k2 > 0 && k2 <= kMaxTaps && g_row == 1 && (long long)k2 * ho * wo == n && vec4) {
    err = mx::allow_smem(dconv_col_bwd_tiled_kernel<mx::bf16>, kTiledSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((wo + kTileW - 1) / kTileW, (ho + kTileH - 1) / kTileH, bg);
    dconv_col_bwd_tiled_kernel<mx::bf16><<<grid, kTiledWarps * 32, kTiledSmem, s>>>(
        iy0, iy1, ix0, ix1, fly, flx, flf, fft, fg, n, w, h * w, c, k2, ho, wo, oy, ox, of,
        oacc);
  } else {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dconv_col_bwd_kernel<mx::bf16><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
        iy0, iy1, ix0, ix1, fly, flx, flf, fft, fg, rows, n, w, h * w, c, g_row, g_chan, oy,
        ox, of, oacc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  const long long rblocks = std::min<long long>((total + kThreads - 1) / kThreads, 1 << 16);
  round_to_bf16_kernel<<<(unsigned)rblocks, kThreads, 0, s>>>(
      static_cast<const float*>(acc), total, static_cast<mx::bf16*>(dft));
  return static_cast<int>(cudaGetLastError());
}
