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
// factors, written fp32; d_ft = bf16(A)^T g, where each corner's weight is
// the forward's one-hot weight rounded to bf16 (a clamped corner's two
// weights merged on its first corner, the second 0), summed in fp32 over
// every row and rounded once to bf16.  The TPU kernel forms that d_ft as a
// product on its matrix unit (A^T @ g, bf16 in, fp32 sums), and so does this
// one, on the tensor cores: the products of two bf16 values are exact and
// the sums fp32, which is the contract.  Its design (dconv_col_bwd_bf16_
// tiled_kernel below) is its own:
//   - one cooperative launch a call, a persistent grid sized by the
//     occupancy query (one 16-warp block an SM): it zeroes the fp32 buffer
//     d_ft is summed in (passed by the caller), walks its tiles by a
//     stride, grid-syncs and rounds d_ft to bf16.  The grid's sync after
//     the zeroing sits before a block's first atomic, so the zeroing
//     overlaps the first tile's taps.  No memset and no second kernel;
//   - the tiles of the fp32 design (kTileH x kTileW positions, all taps),
//     all 128 channels of the R-FCN calls in one pass: the ft window staged
//     in bf16, and g channel-major into a ring of three taps' slots, one
//     16-byte cp.async a thread, two taps ahead (a channel's values of one
//     tile row are 8 consecutive rows);
//   - per tap, one block barrier: 128 threads write tap t + 1's 32 rows of
//     A (their merged bf16 weights, one entry a thread) into a zeroed
//     [window pixel][row] tile and 128 reset tap t - 1's (a ring of three
//     tiles), while every warp runs mma.sync m16n8k16 (bf16 in, fp32 sums)
//     on its part of d_window (pixels x channels) += A_t^T g_t, skipping
//     the 16-pixel m-tiles the tap's rows do not reach; the sums stay in
//     registers over the taps and are added to the fp32 buffer once a tile
//     (16-byte red.global.add where not all zero);
//   - the three row sums stay on the CUDA cores as in the fp32 design, from
//     the staged g and the bf16 ft window, eight channels a warp, the
//     warps' parts added a tap later by a fixed tree (the same bits every
//     call): at most 4 C multiply-adds a row, where the tensor cores would
//     form all of dA;
//   - a tile whose window overflows kMaxWindow takes its rows one warp each
//     (fp32 atomics into the buffer), and every other call (contiguous g,
//     no layout, more than kMaxTaps taps) the row design, each inside the
//     same single cooperative launch (dconv_col_bwd_bf16_rows_kernel).
// Bound on the card: bytes.  At the res5 call (batch 1) it reads g (22.4 MB
// of bf16), the factors (2.5 MB) and ft (2.5 MB) and writes d_ft (2.5 MB)
// and the row sums (1 MB): about 31 MB, 9.2 us at 3.35 TB/s.  The fp32
// buffer (5 MB, written, added to and read once) stays in the 50 MB L2.
// What stops it (timing splits on an H100, PERF.md): the tap steps' chains
// of dependent work between block barriers (ldmatrix -> mma; loads ->
// multiply-adds), with one block an SM to hide them; the products of the
// mostly-zero A tiles (~4 of ~150 window pixels a row) and the ~4,800
// 16-byte atomics a tile (windows overlap ~5x); and 320 tiles on 132 SMs.
#include <cooperative_groups.h>
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

__global__ void dconv_col_bwd_kernel(
    const int* __restrict__ y0, const int* __restrict__ y1,
    const int* __restrict__ x0, const int* __restrict__ x1,
    const float* __restrict__ ly, const float* __restrict__ lx,
    const float* __restrict__ lf, const float* __restrict__ ft,
    const float* __restrict__ g, long long rows, int n, int w, int hw, int c,
    long long g_row, long long g_chan, float* __restrict__ dly,
    float* __restrict__ dlx, float* __restrict__ dlf, float* __restrict__ dft) {
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together: rows split by warp
  bwd_row<float>(r, threadIdx.x & 31, y0, y1, x0, x1, ly, lx, lf, ft, g, n, w, hw, c, g_row,
                 g_chan, dly, dlx, dlf, dft);
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
__global__ void __launch_bounds__(kTiledWarps * 32, 3)
dconv_col_bwd_tiled_kernel(
    const int* __restrict__ y0, const int* __restrict__ y1,
    const int* __restrict__ x0, const int* __restrict__ x1,
    const float* __restrict__ ly, const float* __restrict__ lx,
    const float* __restrict__ lf, const float* __restrict__ ft,
    const float* __restrict__ g, int n, int w, int hw, int c, int k2, int ho,
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
  const float* ftb = ft + (long long)bg * hw * c;
  float* dftb = dft + (long long)bg * hw * c;
  const float* gb = g + (long long)bg * c * n;

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
        bwd_row<float>(fb + (long long)t * hwo + py * wo + pxx, lane, y0, y1, x0, x1, ly,
                       lx, lf, ft, g, n, w, hw, c, 1, n, dly, dlx, dlf, dft);
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
    const float4 s4 = scatter_weights<float>(fy, fx, live, dy[i] == 0, dx[i] == 0);
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
  float* fw = sm;                          // [kMaxWindow][kPitch]
  float* dw = sm + kMaxWindow * kPitch;    // [kMaxWindow][kPitch]
  const int k4 = 4 * warp;  // this warp's four channels of a chunk
  // chunk c0 of ft over the window into fw (channels past C: zeros, never
  // NaN from a stale stage)
  auto stage = [&](int c0) {
    const int cn = min(kChunk, c - c0);
    for (int i = tid; i < px * (kChunk / 4); i += kTiledWarps * 32) {
      const int p = i / (kChunk / 4), q4 = 4 * (i % (kChunk / 4));
      const int py = p / ww, pxx = p - py * ww;
      float* dst = fw + p * kPitch + q4;
      const float* src = ftb + (long long)((ymin + py) * w + xmin + pxx) * c + c0 + q4;
      if (q4 < cn)
        mx::cp_async16(dst, src);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
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
      gv[j] = pos && mine4 ? gb[(long long)(c0 + k4 + j) * n + row0] : 0.f;
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      if (t >= k2 || !mine4) break;  // uniform
#pragma unroll
      for (int j = 0; j < 4; ++j)  // the next tap's g, in flight
        gn[j] = pos && t + 1 < k2
                    ? gb[(long long)(c0 + k4 + j) * n + (long long)(t + 1) * hwo + row0]
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
      const float4 s4 = scatter_weights<float>(y, x, live, ddy == 0, ddx == 0);
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


// ---------------------------------------------------------------------------
// The bf16 instance (see the note at the top): one cooperative launch a call
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kBfWarps = 16;              // warps of a block, one block an SM
constexpr int kBfThreads = kBfWarps * 32;
constexpr int kBfChunk = 128;             // channels of a pass: sixteen 8-wide n-tiles
constexpr int kBfRows = kMaxTaps * 32;    // rows of a tile, (tap, lane)
constexpr int kGPitch = 32 + 8;           // bf16 a channel of one tap's g slot
constexpr int kAPitch = 32 + 8;           // bf16 a pixel of a tap's A tile
constexpr int kFPitch = kBfChunk + 8;     // bf16 a pixel of the ft window
constexpr int kWarpMTiles = kMaxWindow / 32;  // a warp's 16-pixel m-tiles
static_assert(kMaxWindow % 32 == 0, "two warps share an n-tile pair's m-tiles");
static_assert(kBfWarps == 16 && kBfChunk == 128,
              "warp w: n-tiles 2 (w % 8) and 2 (w % 8) + 1, m-tiles w / 8 + 2 j, "
              "row-sum channels 8 w .. 8 w + 7");
static_assert(kBfChunk * kTileH == kBfThreads, "a thread a run of a tap's g slot");
// The pitches (80 and 272 bytes) keep every ldmatrix row and 16-byte access
// aligned, the eight rows of one 8 x 8 matrix on distinct banks, and eight
// consecutive window pixels' 16-byte reads on distinct banks.
// dynamic shared memory: three taps' g slots [kRing][kBfChunk][kGPitch], the
// ft window [kMaxWindow][kFPitch], three A tiles [kRing][kMaxWindow][kAPitch],
// all bf16;
// then, fp32, the warps' row-sum parts of two taps [2][kBfWarps][3][32], the
// row sums [kMaxTaps][3][32], and the rows' words [kBfWords][kBfRows]
constexpr int kBfWords = 6;  // fy, fx, live, pixel (base | dx << 16 | dy << 17), w01, w23
constexpr int kRing = 3;     // taps of g and of A in shared memory at once
constexpr size_t kBfSmem =
    sizeof(mx::bf16) *
        (kRing * kBfChunk * kGPitch + kMaxWindow * kFPitch + kRing * kMaxWindow * kAPitch) +
    sizeof(float) * (2 * kBfWarps * 3 * 32 + kMaxTaps * 3 * 32 + kBfWords * kBfRows);
static_assert(kBfSmem <= mx::kSmemMax, "one block's shared memory");

// a lane's row of one tap of a tile: its corners and factors
struct BfRow {
  int cy, cx, dy, dx;
  float fy, fx, live;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The grid's first and last steps: zero the fp32 buffer, and round it to
// d_ft (16-byte and 8-byte pieces where the pointers allow, then the rest)
__device__ __forceinline__ void zero_buffer(float* acc, long long total, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? total / 4 : 0;
  for (long long i = i0; i < n4; i += stride)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = 4 * n4 + i0; i < total; i += stride) acc[i] = 0.f;
}

__device__ __forceinline__ void round_buffer(const float* acc, long long total, bool vec,
                                             mx::bf16* dft) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? total / 4 : 0;
  for (long long i = i0; i < n4; i += stride)
    reinterpret_cast<uint2*>(dft)[i] =
        mx::float4_to_bf16x4(reinterpret_cast<const float4*>(acc)[i]);
  for (long long i = 4 * n4 + i0; i < total; i += stride)
    dft[i] = __float2bfloat16_rn(acc[i]);
}

// The tiled design in bf16 (channel-major g, rows laid out (tap, ho, wo) with
// K2 <= kMaxTaps, C a multiple of 4): a persistent cooperative grid of
// kBfThreads-thread blocks with kBfSmem bytes of dynamic shared memory, one
// block an SM.  A tile takes its channels kBfChunk at a time (one pass at the
// R-FCN calls), and in a pass its taps one after another, one block barrier
// a tap: while every warp adds tap t's products into its part of d_window,
// in registers, and its eight channels of tap t's row sums, 128 threads
// reset tap t - 1's entries of A and 128 write tap t + 1's (three buffers),
// the first 96 threads add tap t - 1's row-sum parts by a fixed tree, and
// tap t + 2's g is in flight (one 16-byte cp.async a thread, three slots).
// The block's first atomic waits for the grid to have zeroed the buffer (the
// grid's sync sits there, so the zeroing overlaps the first tile's taps), and
// the next tile's factors are loaded during the flush.  vec: acc 16-byte and
// dft 8-byte aligned.
__global__ void __launch_bounds__(kBfThreads, 1)
dconv_col_bwd_bf16_tiled_kernel(
    const int* __restrict__ y0, const int* __restrict__ y1,
    const int* __restrict__ x0, const int* __restrict__ x1,
    const float* __restrict__ ly, const float* __restrict__ lx,
    const float* __restrict__ lf, const mx::bf16* __restrict__ ft,
    const mx::bf16* __restrict__ g, int n, int w, int hw, int c, int k2, int ho, int wo,
    int bgs, long long total, int vec, float* __restrict__ dly, float* __restrict__ dlx,
    float* __restrict__ dlf, float* __restrict__ acc, mx::bf16* __restrict__ dft) {
  extern __shared__ __align__(16) unsigned char smem[];
  mx::bf16* gs = reinterpret_cast<mx::bf16*>(smem);  // [slot][channel][row of the tap]
  mx::bf16* fw = gs + kRing * kBfChunk * kGPitch;     // [pixel][channel]
  mx::bf16* as = fw + kMaxWindow * kFPitch;           // [slot][pixel][row of the tap]
  float* part = reinterpret_cast<float*>(as + kRing * kMaxWindow * kAPitch);  // [2][warp][3][lane]
  float* rs = part + 2 * kBfWarps * 3 * 32;           // [tap][3][lane]
  float* tap_fy = rs + kMaxTaps * 3 * 32;             // [tap][lane], and so on
  float* tap_fx = tap_fy + kBfRows;
  float* tap_live = tap_fx + kBfRows;
  int* tap_pix = reinterpret_cast<int*>(tap_live + kBfRows);
  unsigned* tap_w01 = reinterpret_cast<unsigned*>(tap_pix + kBfRows);
  unsigned* tap_w23 = tap_w01 + kBfRows;
  __shared__ int win[4];  // min y0, min x0, max y1, max x1 over the tile
  __shared__ int tap_lo[kMaxTaps], tap_hi[kMaxTaps];  // window pixels a tap's rows reach
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cg::grid_group grid = cg::this_grid();

  for (int i = tid; i < kRing * kMaxWindow * kAPitch / 8; i += kBfThreads)
    reinterpret_cast<uint4*>(as)[i] = make_uint4(0u, 0u, 0u, 0u);  // A tiles start zero
  zero_buffer(acc, total, vec);
  bool zeroed = false;  // whether this block has passed the grid's sync after the zeroing
  auto await_zeroed = [&]() {  // block-uniform
    if (!zeroed) grid.sync();
    zeroed = true;
  };

  const int tiles_x = (wo + kTileW - 1) / kTileW, tiles_y = (ho + kTileH - 1) / kTileH;
  const int tiles = tiles_x * tiles_y * bgs;
  const int hwo = ho * wo;
  const int nt = 2 * (warp & 7), mh = warp >> 3;  // this warp's n-tiles and m-tile parity
  const int k8 = 8 * warp;  // this warp's eight channels of a pass, for the row sums
  // the ft window in 16-byte pieces of eight channels where C and ft allow
  const bool vec8 = c % 8 == 0 && (reinterpret_cast<uintptr_t>(ft) & 15) == 0;
  // warp t's lanes read tap t's rows of tile `tl`
  auto load_rows = [&](int tl) {
    BfRow q = {0, 0, 0, 0, 0.f, 0.f, 0.f};
    const int qx = tl % tiles_x, qy = tl / tiles_x % tiles_y, qb = tl / (tiles_x * tiles_y);
    const int oy = qy * kTileH + lane / kTileW, ox = qx * kTileW + lane % kTileW;
    if (tl < tiles && warp < k2 && oy < ho && ox < wo) {
      const long long r = (long long)qb * n + (long long)warp * hwo + oy * wo + ox;
      q.cy = y0[r];
      q.cx = x0[r];
      q.dy = y1[r] - q.cy;  // 0 or 1
      q.dx = x1[r] - q.cx;
      q.fy = ly[r];
      q.fx = lx[r];
      q.live = lf[r];
    }
    return q;
  };
  BfRow next = load_rows(blockIdx.x);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bx = tile % tiles_x, by = tile / tiles_x % tiles_y, bg = tile / (tiles_x * tiles_y);
    const int oy = by * kTileH + lane / kTileW, ox = bx * kTileW + lane % kTileW;
    const bool pos = oy < ho && ox < wo;
    const long long fb = (long long)bg * n;
    const mx::bf16* ftb = ft + (long long)bg * hw * c;
    float* accb = acc + (long long)bg * hw * c;
    const mx::bf16* gb = g + (long long)bg * c * n;
    const BfRow rw = next;
    const bool in = pos && warp < k2;

    __syncthreads();  // the last tile is done with the shared words
    if (tid == 0) win[0] = win[1] = INT_MAX, win[2] = win[3] = INT_MIN;
    for (int i = tid; i < kMaxTaps * 3 * 32; i += kBfThreads) rs[i] = 0.f;
    __syncthreads();
    if (warp < kMaxTaps) {
      // a lane past the map adds nothing and its sums are not written
      tap_fy[warp * 32 + lane] = rw.fy;
      tap_fx[warp * 32 + lane] = rw.fx;
      tap_live[warp * 32 + lane] = rw.live;
    }
    {
      const int ymin = __reduce_min_sync(0xffffffffu, in ? rw.cy : INT_MAX);
      const int xmin = __reduce_min_sync(0xffffffffu, in ? rw.cx : INT_MAX);
      const int ymax = __reduce_max_sync(0xffffffffu, in ? rw.cy + rw.dy : INT_MIN);
      const int xmax = __reduce_max_sync(0xffffffffu, in ? rw.cx + rw.dx : INT_MIN);
      if (lane == 0 && warp < k2) {
        atomicMin(win + 0, ymin);
        atomicMin(win + 1, xmin);
        atomicMax(win + 2, ymax);
        atomicMax(win + 3, xmax);
      }
    }
    __syncthreads();
    const int ymin = win[0], xmin = win[1];
    const int ww = win[3] - xmin + 1, px = (win[2] - ymin + 1) * ww;
    if (px > kMaxWindow) {  // the whole block takes the tile's rows one warp each
      next = load_rows(tile + gridDim.x);
      await_zeroed();
      for (int i = warp; i < k2 * 32; i += kBfWarps) {
        const int t = i / 32, l = i % 32;
        const int py = by * kTileH + l / kTileW, pxx = bx * kTileW + l % kTileW;
        if (py < ho && pxx < wo)
          bwd_row<mx::bf16>(fb + (long long)t * hwo + py * wo + pxx, lane, y0, y1, x0, x1, ly,
                            lx, lf, ft, g, n, w, hw, c, 1, n, dly, dlx, dlf, acc);
      }
      continue;  // block-uniform
    }

    // each row's base pixel in the window and its four merged bf16 weights
    // (a lane past the map: 0), and each tap's reach
    if (warp < k2) {  // warp-uniform
      const int base = pos ? (rw.cy - ymin) * ww + (rw.cx - xmin) : 0;
      const float4 s4 =
          scatter_weights<mx::bf16>(rw.fy, rw.fx, rw.live, rw.dy == 0, rw.dx == 0);
      tap_pix[warp * 32 + lane] = base | rw.dx << 16 | rw.dy << 17;
      tap_w01[warp * 32 + lane] = pos ? pack_bf16x2(s4.x, s4.y) : 0u;  // exact: rounded already
      tap_w23[warp * 32 + lane] = pos ? pack_bf16x2(s4.z, s4.w) : 0u;
      const int lo = __reduce_min_sync(0xffffffffu, pos ? base : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, pos ? base + rw.dy * ww + rw.dx : INT_MIN);
      if (lane == 0) tap_lo[warp] = lo, tap_hi[warp] = hi;
    }

    // pass c0's channels of the ft window into shared memory (channels past
    // C: zeros)
    auto stage_window = [&](int c0) {
      const int cn = min(kBfChunk, c - c0);
      const int q = vec8 ? 8 : 4;  // channels a piece
      const int pieces = kBfChunk / q;
      for (int i = tid; i < px * pieces; i += kBfThreads) {
        const int p = i / pieces, qc = q * (i - p * pieces);
        const int py = p / ww, pxx = p - py * ww;
        mx::bf16* dst = fw + p * kFPitch + qc;
        const mx::bf16* src = ftb + (long long)((ymin + py) * w + xmin + pxx) * c + c0 + qc;
        if (vec8) {
          if (qc < cn)
            mx::cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src));
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        } else {
          if (qc < cn)
            mx::cp_async8(dst, src);
          else
            *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
        }
      }
    };
    // pass c0's channels of tap t's g (the tile's rows, channel-major) into
    // slot t % kRing: thread (j, r) copies channel j's run of kTileW rows of
    // tile row r; channels past C and positions past the map: zeros
    auto stage_g = [&](int c0, int t) {
      const int j = tid / kTileH, r = tid % kTileH;
      mx::bf16* dst = gs + ((t % kRing) * kBfChunk + j) * kGPitch + r * kTileW;
      const int gy = by * kTileH + r, gx = bx * kTileW;
      const bool live = c0 + j < c && gy < ho;
      const mx::bf16* src = gb + (long long)(c0 + j) * n + (long long)t * hwo + gy * wo + gx;
      if (live && gx + kTileW <= wo && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        mx::cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src));
      } else {
#pragma unroll
        for (int e = 0; e < kTileW; ++e)
          dst[e] = live && gx + e < wo ? src[e] : __float2bfloat16_rn(0.f);
      }
    };
    // the entry of tap t's row l at corner q in its A tile (slot t % kRing),
    // by thread q * 32 + l of a group of 128: its merged weight, or a reset
    // to 0.  A clamped corner's second weight is 0 and not written (its
    // pixel keeps the first's), so no two writes of a tap meet.
    auto put = [&](int t, int i, bool reset) {
      const int l = i & 31, q = i >> 5;
      const int pix = tap_pix[t * 32 + l];
      const int base = pix & 0xffff, ddx = (pix >> 16) & 1, ddy = ((pix >> 17) & 1) * ww;
      const int pc = base + (q & 1) * ddx + (q >> 1) * ddy;
      const unsigned wpair = q < 2 ? tap_w01[t * 32 + l] : tap_w23[t * 32 + l];
      const unsigned short wq = (unsigned short)(q & 1 ? wpair >> 16 : wpair & 0xffffu);
      unsigned short* e =
          reinterpret_cast<unsigned short*>(as + (t % kRing) * kMaxWindow * kAPitch) +
          pc * kAPitch + l;
      if (reset)
        *e = 0;
      else if (wq != 0)
        *e = wq;
    };
    // tap t's row sums: the warps' parts (buffer t & 1) added by a fixed
    // tree (pairs of warps, then pairs of pairs)
    auto add_parts = [&](int t) {
      if (tid < 3 * 32) {
        const float* src = part + (t & 1) * kBfWarps * 3 * 32 + tid;
        float v[kBfWarps];
#pragma unroll
        for (int i = 0; i < kBfWarps; ++i) v[i] = src[i * 3 * 32];
#pragma unroll
        for (int h = 1; h < kBfWarps; h *= 2)
#pragma unroll
          for (int i = 0; i < kBfWarps; i += 2 * h) v[i] += v[i + h];
        rs[t * 3 * 32 + tid] += v[0];
      }
    };

    float d[kWarpMTiles][2][4];  // d_window: this warp's m-tiles of its two n-tiles
#pragma unroll
    for (int j = 0; j < kWarpMTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) d[j][h][0] = d[j][h][1] = d[j][h][2] = d[j][h][3] = 0.f;
    __syncthreads();  // the rows' words and reaches are out
    for (int c0 = 0; c0 < c; c0 += kBfChunk) {
      const int cn = min(kBfChunk, c - c0);  // a multiple of 4
      if (c0 > 0) __syncthreads();  // the last pass is done with A, g, ft and the parts
      stage_window(c0);
      stage_g(c0, 0);
      mx::cp_async_commit();  // group: the window and tap 0's g
      if (k2 > 1) stage_g(c0, 1);
      mx::cp_async_commit();  // group: tap 1's g (empty where K2 == 1)
      if (tid < 128) put(0, tid, false);
#pragma unroll 1
      for (int t = 0; t < k2; ++t) {
        mx::cp_async_wait<1>();  // all but the last group: tap t's g is in
        __syncthreads();  // tap t's g and A are in for all; tap t - 1 is done
        if (t + 2 < k2) stage_g(c0, t + 2);  // in flight during taps t and t + 1
        mx::cp_async_commit();  // (an empty group past the last tap)
        if (t >= 1 && tid < 128) put(t - 1, tid, true);  // back to zero: slot (t + 2) % kRing
        if (t + 1 < k2 && tid >= 128 && tid < 256) put(t + 1, tid - 128, false);
        if (t >= 1) add_parts(t - 1);
        const mx::bf16* gt = gs + (t % kRing) * kBfChunk * kGPitch;
        const int lo = tap_lo[t], hi = tap_hi[t];
        if (nt * 8 < cn) {  // warp-uniform
          unsigned b0[4], b1[4];  // g_tap's channels of n-tiles nt, nt + 1 x 32 rows
          ldmatrix_x4(b0, gt + (nt * 8 + (lane & 7)) * kGPitch + (lane >> 3) * 8);
          ldmatrix_x4(b1, gt + (nt * 8 + 8 + (lane & 7)) * kGPitch + (lane >> 3) * 8);
          const mx::bf16* at =
              as + (t % kRing) * kMaxWindow * kAPitch + (lane & 15) * kAPitch + (lane >> 4) * 8;
#pragma unroll
          for (int j = 0; j < kWarpMTiles; ++j) {
            const int m0 = (mh + 2 * j) * 16;
            if (m0 > hi || m0 + 15 < lo) continue;  // uniform: no row of the tap reaches it
            unsigned a0[4], a1[4];  // k-steps 0 and 1: rows 0-15 and 16-31 of the tap
            ldmatrix_x4(a0, at + m0 * kAPitch);
            ldmatrix_x4(a1, at + m0 * kAPitch + 16);
            mma_bf16(d[j][0], a0, b0[0], b0[1]);
            mma_bf16(d[j][1], a0, b1[0], b1[1]);
            mma_bf16(d[j][0], a1, b0[2], b0[3]);
            mma_bf16(d[j][1], a1, b1[2], b1[3]);
          }
        }
        {  // the row sums over this warp's eight channels, as in the fp32 design
          float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
          const float y = tap_fy[t * 32 + lane], x = tap_fx[t * 32 + lane];
          if (k8 < cn) {  // warp-uniform
            const int pix = tap_pix[t * 32 + lane];
            const int base = pix & 0xffff, ddx = (pix >> 16) & 1, ddy = ((pix >> 17) & 1) * ww;
            const int pc[4] = {base, base + ddx, base + ddy, base + ddy + ddx};
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // four channels at a time
              float gv[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                gv[j] = __bfloat162float(gt[(k8 + 4 * h + j) * kGPitch + lane]);
              const float4 fa = mx::lds4(fw + pc[0] * kFPitch + k8 + 4 * h);
              const float4 fb4 = mx::lds4(fw + pc[1] * kFPitch + k8 + 4 * h);
              const float4 fe = mx::lds4(fw + pc[2] * kFPitch + k8 + 4 * h);
              const float4 ff = mx::lds4(fw + pc[3] * kFPitch + k8 + 4 * h);
              const float f00[4] = {fa.x, fa.y, fa.z, fa.w}, f01[4] = {fb4.x, fb4.y, fb4.z, fb4.w};
              const float f10[4] = {fe.x, fe.y, fe.z, fe.w}, f11[4] = {ff.x, ff.y, ff.z, ff.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                s00 += gv[j] * f00[j];
                s01 += gv[j] * f01[j];
                s10 += gv[j] * f10[j];
                s11 += gv[j] * f11[j];
              }
            }
          }
          const float w00 = (1.f - y) * (1.f - x);
          const float w01 = (1.f - y) * x;
          const float w10 = y * (1.f - x);
          const float w11 = y * x;
          // a clamped corner reads one value twice: s10 - s00 (s01 - s00) is 0
          float* dst = part + ((t & 1) * kBfWarps + warp) * 3 * 32 + lane;
          dst[0] = (1.f - x) * (s10 - s00) + x * (s11 - s01);
          dst[32] = (1.f - y) * (s01 - s00) + y * (s11 - s10);
          dst[64] = w00 * s00 + w01 * s01 + w10 * s10 + w11 * s11;
        }
      }
      mx::cp_async_wait<0>();  // (only empty groups are left)
      __syncthreads();  // every warp is done with the pass's last tap
      add_parts(k2 - 1);
      // the A tiles back to zero for the next pass or tile (the loop reset
      // every tap before the last)
      if (tid < 128) put(k2 - 1, tid, true);
      if (c0 + kBfChunk >= c) next = load_rows(tile + gridDim.x);  // in flight during the flush
      await_zeroed();
      // the flush: lanes 2i and 2i + 1 swap halves, so that each holds four
      // consecutive channels of one pixel, and add them with one 16-byte
      // atomic where not all zero (neighbouring tiles' windows overlap)
      if (nt * 8 < cn) {  // warp-uniform
        const bool odd = lane & 1;
#pragma unroll
        for (int j = 0; j < kWarpMTiles; ++j) {
          const int m0 = (mh + 2 * j) * 16;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* e = d[j][h];
            if (m0 < px) {  // uniform
              const float v0 = __shfl_xor_sync(0xffffffffu, odd ? e[0] : e[2], 1);
              const float v1 = __shfl_xor_sync(0xffffffffu, odd ? e[1] : e[3], 1);
              const float4 v = odd ? make_float4(v0, v1, e[2], e[3]) : make_float4(e[0], e[1], v0, v1);
              const int p = m0 + (lane >> 2) + (odd ? 8 : 0);
              const int ch = (nt + h) * 8 + 2 * (lane & 2);
              if (p < px && ch < cn && (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)) {
                const int py = p / ww, pxx = p - py * ww;
                red_add4(accb + (long long)((ymin + py) * w + xmin + pxx) * c + c0 + ch, v);
              }
            }
            e[0] = e[1] = e[2] = e[3] = 0.f;
          }
        }
      }
    }

    // the row sums, from the taps' sums in shared memory
    __syncthreads();
    for (int i = tid; i < k2 * 32; i += kBfThreads) {
      const int t = i / 32, l = i % 32;
      const int py = by * kTileH + l / kTileW, pxx = bx * kTileW + l % kTileW;
      if (py >= ho || pxx >= wo) continue;
      const long long r = fb + (long long)t * hwo + py * wo + pxx;
      const float lv = tap_live[t * 32 + l];
      dly[r] = lv * rs[(t * 3 + 0) * 32 + l];
      dlx[r] = lv * rs[(t * 3 + 1) * 32 + l];
      dlf[r] = rs[(t * 3 + 2) * 32 + l];
    }
  }
  await_zeroed();  // a block without tiles
  grid.sync();
  round_buffer(acc, total, vec, dft);
}

// Every other bf16 call: the row design (one warp a row, fp32 atomics into
// the buffer) between the same zeroing and rounding, in one cooperative
// launch of a persistent grid of kWarpsPerBlock * 32-thread blocks.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dconv_col_bwd_bf16_rows_kernel(
    const int* __restrict__ y0, const int* __restrict__ y1,
    const int* __restrict__ x0, const int* __restrict__ x1,
    const float* __restrict__ ly, const float* __restrict__ lx,
    const float* __restrict__ lf, const mx::bf16* __restrict__ ft,
    const mx::bf16* __restrict__ g, long long rows, int n, int w, int hw, int c,
    long long g_row, long long g_chan, long long total, int vec, float* __restrict__ dly,
    float* __restrict__ dlx, float* __restrict__ dlf, float* __restrict__ acc,
    mx::bf16* __restrict__ dft) {
  cg::grid_group grid = cg::this_grid();
  zero_buffer(acc, total, vec);
  grid.sync();
  // a block's warps take consecutive rows, as dconv_col_bwd_kernel's do
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); r < rows;
       r += stride)  // whole warps
    bwd_row<mx::bf16>(r, threadIdx.x & 31, y0, y1, x0, x1, ly, lx, lf, ft, g, n, w, hw, c,
                      g_row, g_chan, dly, dlx, dlf, acc);
  grid.sync();
  round_buffer(acc, total, vec, dft);
}

// A cooperative launch of `kernel` on a persistent grid: as many blocks as
// can be resident at once (the occupancy query, never a constant), fewer
// where the `items` need fewer.  Returns the launch's error: a grid the
// card cannot hold at once is refused, never run.
template <typename K>
cudaError_t launch_cooperative(K kernel, int threads, size_t smem, long long items,
                               void** params, cudaStream_t s) {
  cudaError_t err = mx::allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long blocks = std::max(1LL, std::min(items, (long long)sms * per_sm));
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3((unsigned)blocks), dim3(threads), params, smem, s);
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
    err = mx::allow_smem(dconv_col_bwd_tiled_kernel, kTiledSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((wo + kTileW - 1) / kTileW, (ho + kTileH - 1) / kTileH, bg);
    dconv_col_bwd_tiled_kernel<<<grid, kTiledWarps * 32, kTiledSmem, s>>>(
        iy0, iy1, ix0, ix1, fly, flx, flf, fft, fg, n, w, h * w, c, k2, ho, wo, oy, ox,
        of, oft);
  } else {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dconv_col_bwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
        iy0, iy1, ix0, ix1, fly, flx, flf, fft, fg, rows, n, w, h * w, c, g_row, g_chan,
        oy, ox, of, oft);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same with ft, g and dft bf16, and acc (BG, H W, C) f32, the buffer
// d_ft is summed in before it is rounded to dft: one cooperative launch
// (see the note at the top), whose error this returns.  Channel-major g
// with a layout of at most kMaxTaps taps, C a multiple of 4, ft 8-byte and
// acc 16-byte aligned takes the tiled design; every other call the row
// design.
extern "C" int mx_dconv_col_bwd_bf16(const void* y0, const void* y1, const void* x0,
                                     const void* x1, const void* ly, const void* lx,
                                     const void* lf, const void* ft, const void* g,
                                     void* dly, void* dlx, void* dlf, void* dft, void* acc,
                                     int bg, int n, int h, int w, int c, int g_row,
                                     int g_chan, int k2, int ho, int wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* iy0 = static_cast<const int*>(y0);
  const int* iy1 = static_cast<const int*>(y1);
  const int* ix0 = static_cast<const int*>(x0);
  const int* ix1 = static_cast<const int*>(x1);
  const float* fly = static_cast<const float*>(ly);
  const float* flx = static_cast<const float*>(lx);
  const float* flf = static_cast<const float*>(lf);
  const mx::bf16* fft = static_cast<const mx::bf16*>(ft);
  const mx::bf16* fg = static_cast<const mx::bf16*>(g);
  float* oy = static_cast<float*>(dly);
  float* ox = static_cast<float*>(dlx);
  float* of = static_cast<float*>(dlf);
  float* oacc = static_cast<float*>(acc);
  mx::bf16* oft = static_cast<mx::bf16*>(dft);
  int hw = h * w;
  long long rows = (long long)bg * n, total = (long long)hw * bg * c;
  // 16-byte pieces of the buffer and 8-byte ones of d_ft
  int vec = (reinterpret_cast<uintptr_t>(acc) & 15) == 0 &&
            (reinterpret_cast<uintptr_t>(dft) & 7) == 0;
  const bool tiled = k2 > 0 && k2 <= kMaxTaps && g_row == 1 && (long long)k2 * ho * wo == n &&
                     c % 4 == 0 && (reinterpret_cast<uintptr_t>(ft) & 7) == 0 &&
                     (reinterpret_cast<uintptr_t>(acc) & 15) == 0;
  cudaError_t err;
  if (tiled) {
    void* params[] = {&iy0, &iy1, &ix0, &ix1, &fly, &flx, &flf, &fft, &fg, &n, &w, &hw, &c,
                      &k2, &ho, &wo, &bg, &total, &vec, &oy, &ox, &of, &oacc, &oft};
    const long long tiles =
        (long long)((wo + kTileW - 1) / kTileW) * ((ho + kTileH - 1) / kTileH) * bg;
    err = launch_cooperative(dconv_col_bwd_bf16_tiled_kernel, kBfThreads, kBfSmem, tiles, params,
                             s);
  } else {
    long long row_stride = g_row, chan_stride = g_chan;
    void* params[] = {&iy0, &iy1, &ix0, &ix1, &fly, &flx, &flf, &fft, &fg, &rows, &n, &w, &hw,
                      &c, &row_stride, &chan_stride, &total, &vec, &oy, &ox, &of, &oacc, &oft};
    err = launch_cooperative(dconv_col_bwd_bf16_rows_kernel, kWarpsPerBlock * 32, 0,
                             (rows + kWarpsPerBlock - 1) / kWarpsPerBlock, params, s);
  }
  return static_cast<int>(err);
}
