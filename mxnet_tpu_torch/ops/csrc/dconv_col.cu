// Deformable-convolution sampling: col[bg, n, c] = sum_p A[bg, n, p] ft[bg, p, c]
// with A = [(1-ly)(h==y0) + ly(h==y1)] [(1-lx)(w==x0) + lx(w==x1)] lf, p = h W + w.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py _dconv_impl /
// _dconv_fwd_kernel_factory (entry dconv_col_pallas, forward).  The TPU
// kernel builds each block of the one-hot matrix A in VMEM and multiplies it
// on the MXU, because gathers were slow there.  A row of A has at most four
// non-zeros, so here the kernel is the direct four-corner weighted gather:
//   col = lf ((1-ly)(1-lx) ft[y0 W + x0] + (1-ly) lx ft[y0 W + x1]
//             + ly (1-lx) ft[y1 W + x0] + ly lx ft[y1 W + x1])
// in that order of operations, in fp32.  A clamped corner (y1 == y0 or
// x1 == x0 at the last row or column) puts both weights on one address, as
// the one-hot compare does.
//
// Output layout: channel-major, col[bg] stored as (C, N), i.e. strides
// (C N, 1, N) of the (BG, N, C) tensor.  That is the layout the weight
// product of ops/detection.py deformable_convolution reads, so its
// reshape / permute / reshape of the column are views and no transposing
// copy of the 44.8 MB column follows the kernel.
//
// Bound on the card: bytes.  At the R-FCN res5 call (BG 4, N 21,888,
// H W 2,432, C 128) the launch writes 44.8 MB of col and reads 5 MB of ft
// and 2.5 MB of factors: 52.3 MB, about 16 us at 3.35 TB/s.  The four corner
// rows of ft are read from L2 (ft[bg] is 1.2 MB).
//
// Design (C % 4 == 0, N % 4 == 0, 16-byte aligned pointers): a transpose
// through shared memory.  A persistent block walks over tiles of kTileN
// consecutive rows n of one bg; the next tile's seven factor vectors are
// copied into a second shared stage by cp.async while the current tile is
// computed and stored.  Lanes run along the channels: each loads a float4 of
// each of the four corner rows, a warp one 512-byte corner row per access,
// and a warp gathers kGroup rows at once (16 16-byte loads in flight a lane).
// The combined 4 x 4 block of a lane (4 channels x 4 rows) goes to the
// shared tile [channel][row] as four 16-byte stores along the rows, whose
// 16-byte chunk index is XOR-swizzled by the channel so that neither these
// stores nor the row reads after the barrier conflict on banks.  Then the
// block writes whole channel rows of col, lanes along n, 16 bytes a lane,
// as streaming stores (st.global.cs): measured at the R-FCN call, the kernel
// is faster with them and the weight product that reads col next no slower.
// Other shapes take a simple kernel that writes the same layout: one thread
// per output element, threads along n.
//
// The bf16 instance (mx_dconv_col_bf16: bf16 ft and col, the factors as
// for fp32) follows the contract of the TPU kernel's bf16 instance
// (_dconv_fwd_kernel_factory with dot_dtype bf16): per corner the one-hot
// weight A = yfac xfac lf in fp32 (the two weights of a clamped corner
// merged into one, as the one-hot compare merges them), rounded to bf16;
// its products with ft, exact in fp32, summed in fp32 in corner order and
// rounded once to the bf16 column.  Its bound at the res5 call is half the
// fp32 one: 22.4 MB of col, 2.5 MB of ft and 2.5 MB of factors, about 8 us
// at 3.35 TB/s.  Its gathers are not: four corner rows per output row, 89.6
// MB from L2 at the res5 call, whose pace is set by the bytes a lane keeps
// in flight.  So where C % 8 == 0 and N % 8 == 0 (the R-FCN calls) it has a
// design of its own, dconv_col_tiled_bf16x8_kernel: the fp32 design's tiles
// and factor stages, with 16-byte loads of eight bf16 channels, sixteen
// lanes over a 128-channel corner row, so that a warp gathers two rows per
// load and a lane keeps 16 loads of 16 bytes in flight as an fp32 lane does
// (4 rows x 4 corners); its 8 x 4 (channel x row) register block goes to the
// shared tile as eight 8-byte stores of four rows, whose 8-byte chunk is
// XOR-swizzled by the channel, and whole 128-byte channel rows of col (64
// bf16 rows) leave as 16-byte streaming stores.  Other bf16 shapes take the
// fp32 designs, templated on the element type (8-byte loads of four
// channels and stores of four rows; one thread per output).
//
// Contract: y0, y1 in [0, H), x0, x1 in [0, W).  The port's only caller
// (ops/detection.py deformable_convolution) builds them clamped to the map.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "pipeline.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 64;                    // rows n of one tile
constexpr int kChunks = kTileN / 4;           // 16-byte chunks of a tile row
constexpr int kChunkC = 128;                  // channels of one pass: 32 lanes x 4
constexpr int kGroup = 4;                     // rows a warp gathers at once
constexpr int kGroups = kTileN / (kWarps * kGroup);
static_assert(kTileN % (kWarps * kGroup) == 0, "a warp owns whole groups");
static_assert(kChunks >= 8, "the swizzle spans 8 chunks");

// One row's combination of its four corner values f00, f01, f10, f11 (the
// corners' flags: y1 == y0, x1 == x0).
template <typename T>
struct Mix;

// fp32: lf ((1-ly)(1-lx) f00 + (1-ly) lx f01 + ly (1-lx) f10 + ly lx f11)
template <>
struct Mix<float> {
  float live, w00, w01, w10, w11;
  __device__ __forceinline__ Mix(float fy, float fx, float lv, bool, bool)
      : live(lv), w00((1.f - fy) * (1.f - fx)), w01((1.f - fy) * fx),
        w10(fy * (1.f - fx)), w11(fy * fx) {}
  __device__ __forceinline__ float operator()(float a, float b, float c, float d) const {
    return live * (w00 * a + w01 * b + w10 * c + w11 * d);
  }
};

// bf16: the one-hot weights A = yfac xfac lf rounded to bf16, a clamped
// corner's weight on its first corner and 0 on the second; the products are
// exact in fp32
template <>
struct Mix<mx::bf16> {
  float a00, a01, a10, a11;
  __device__ __forceinline__ Mix(float fy, float fx, float lv, bool ysame, bool xsame) {
    const float wy0 = ysame ? (1.f - fy) + fy : 1.f - fy, wy1 = ysame ? 0.f : fy;
    const float wx0 = xsame ? (1.f - fx) + fx : 1.f - fx, wx1 = xsame ? 0.f : fx;
    a00 = mx::round_bf16(wy0 * wx0 * lv);
    a01 = mx::round_bf16(wy0 * wx1 * lv);
    a10 = mx::round_bf16(wy1 * wx0 * lv);
    a11 = mx::round_bf16(wy1 * wx1 * lv);
  }
  __device__ __forceinline__ float operator()(float a, float b, float c, float d) const {
    return a00 * a + a01 * b + a10 * c + a11 * d;
  }
};

// the shared tile's chunk for channel `ch`, chunk `q` of its row
__device__ __forceinline__ int swizzle(int ch, int q) { return q ^ ((ch >> 2) & 7); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dconv_col_tiled_kernel(const int* __restrict__ y0, const int* __restrict__ y1,
                       const int* __restrict__ x0, const int* __restrict__ x1,
                       const float* __restrict__ ly, const float* __restrict__ lx,
                       const float* __restrict__ lf, const T* __restrict__ ft,
                       long long tiles, int n, int w, int hw, int c,
                       T* __restrict__ col) {
  __shared__ float4 tile[kChunkC][kChunks];
  __shared__ __align__(16) int corner[2][4][kTileN];   // y0, y1, x0, x1
  __shared__ __align__(16) float lerp[2][3][kTileN];   // ly, lx, lf
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_per_bg = (n + kTileN - 1) / kTileN;

  // cp.async of tile t's factors into stage s: 7 vectors x kChunks 16-byte
  // pieces, one a thread; rows past n are not copied (and not read)
  auto stage = [&](long long t, int s) {
    if (tid < 7 * kChunks) {
      const int v = tid / kChunks, k = tid % kChunks;
      const int row = (int)(t % tiles_per_bg) * kTileN + 4 * k;
      if (row < n) {
        const long long off = (t / tiles_per_bg) * n + row;
        if (v < 4) {
          const int* src = (v == 0 ? y0 : v == 1 ? y1 : v == 2 ? x0 : x1) + off;
          mx::cp_async16(reinterpret_cast<float*>(&corner[s][v][4 * k]),
                         reinterpret_cast<const float*>(src));
        } else {
          const float* src = (v == 4 ? ly : v == 5 ? lx : lf) + off;
          mx::cp_async16(&lerp[s][v - 4][4 * k], src);
        }
      }
    }
    mx::cp_async_commit();
  };

  int s = 0;
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, s ^= 1) {
    // the other stage was last read before the previous tile's first barrier
    if (t + gridDim.x < tiles) {
      stage(t + gridDim.x, s ^ 1);
      mx::cp_async_wait<1>();
    } else {
      mx::cp_async_wait<0>();
    }
    __syncthreads();
    const long long bg = t / tiles_per_bg;
    const int n0 = (int)(t % tiles_per_bg) * kTileN;
    const int rows = min(kTileN, n - n0);  // a multiple of 4
    const T* f = ft + bg * hw * (long long)c;
    T* out = col + bg * (long long)c * n + n0;
    for (int c0 = 0; c0 < c; c0 += kChunkC) {
      const int cw = min(kChunkC, c - c0);  // a multiple of 4
      const int ch = 4 * lane;              // this lane's first channel of the pass
      if (ch < cw) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int r0 = (warp * kGroups + g) * kGroup;
          if (r0 >= rows) break;
          float4 p[kGroup][4];
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            const int r = r0 + i;
            const int a0 = corner[s][0][r] * w, a1 = corner[s][1][r] * w;
            const int b0 = corner[s][2][r], b1 = corner[s][3][r];
            const T* q = f + c0 + ch;
            p[i][0] = mx::ldg4(q + (long long)(a0 + b0) * c);
            p[i][1] = mx::ldg4(q + (long long)(a0 + b1) * c);
            p[i][2] = mx::ldg4(q + (long long)(a1 + b0) * c);
            p[i][3] = mx::ldg4(q + (long long)(a1 + b1) * c);
          }
          float o[4][kGroup];  // [channel][row]
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            const int r = r0 + i;
            const Mix<T> m(lerp[s][0][r], lerp[s][1][r], lerp[s][2][r],
                           corner[s][0][r] == corner[s][1][r],
                           corner[s][2][r] == corner[s][3][r]);
            o[0][i] = m(p[i][0].x, p[i][1].x, p[i][2].x, p[i][3].x);
            o[1][i] = m(p[i][0].y, p[i][1].y, p[i][2].y, p[i][3].y);
            o[2][i] = m(p[i][0].z, p[i][1].z, p[i][2].z, p[i][3].z);
            o[3][i] = m(p[i][0].w, p[i][1].w, p[i][2].w, p[i][3].w);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tile[ch + j][swizzle(ch + j, r0 / 4)] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
          }
        }
      }
      __syncthreads();
      // whole channel rows of col: kChunks 16-byte pieces a channel
      for (int e = tid; e < cw * kChunks; e += kThreads) {
        const int cc = e / kChunks, q = e % kChunks;
        if (4 * q < rows) mx::stcs4(out + (long long)(c0 + cc) * n + 4 * q, tile[cc][swizzle(cc, q)]);
      }
      __syncthreads();
    }
  }
}

// The bf16 design for C % 8 == 0 and N % 8 == 0 (see the note at the top):
// half-warp h of warp v gathers rows 8 v + 4 h .. + 3 of a tile, lane l % 16
// channels 8 (l % 16) .. + 7 of a 128-channel pass.
constexpr int kGroup8 = 4;  // rows a half-warp gathers at once
static_assert(kTileN == kWarps * 2 * kGroup8, "one group of eight rows a warp");

// the shared tile's 8-byte chunk (four rows) for channel `ch`, chunk `q` of its row
__device__ __forceinline__ int swizzle8(int ch, int q) { return q ^ ((ch >> 3) & 15); }

// eight bf16 as floats
__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const unsigned v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
dconv_col_tiled_bf16x8_kernel(const int* __restrict__ y0, const int* __restrict__ y1,
                              const int* __restrict__ x0, const int* __restrict__ x1,
                              const float* __restrict__ ly, const float* __restrict__ lx,
                              const float* __restrict__ lf, const mx::bf16* __restrict__ ft,
                              long long tiles, int n, int w, int hw, int c,
                              mx::bf16* __restrict__ col) {
  __shared__ __align__(16) uint2 tile[kChunkC][kTileN / 4];  // [channel][four rows], swizzled
  __shared__ __align__(16) int corner[2][4][kTileN];   // y0, y1, x0, x1
  __shared__ __align__(16) float lerp[2][3][kTileN];   // ly, lx, lf
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_per_bg = (n + kTileN - 1) / kTileN;

  // as dconv_col_tiled_kernel's
  auto stage = [&](long long t, int s) {
    if (tid < 7 * kChunks) {
      const int v = tid / kChunks, k = tid % kChunks;
      const int row = (int)(t % tiles_per_bg) * kTileN + 4 * k;
      if (row < n) {
        const long long off = (t / tiles_per_bg) * n + row;
        if (v < 4) {
          const int* src = (v == 0 ? y0 : v == 1 ? y1 : v == 2 ? x0 : x1) + off;
          mx::cp_async16(reinterpret_cast<float*>(&corner[s][v][4 * k]),
                         reinterpret_cast<const float*>(src));
        } else {
          const float* src = (v == 4 ? ly : v == 5 ? lx : lf) + off;
          mx::cp_async16(&lerp[s][v - 4][4 * k], src);
        }
      }
    }
    mx::cp_async_commit();
  };

  const int ch = 8 * (lane & 15);                        // this lane's first channel of a pass
  const int r0 = warp * 2 * kGroup8 + (lane >> 4) * kGroup8;  // this half-warp's first row
  int s = 0;
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, s ^= 1) {
    if (t + gridDim.x < tiles) {
      stage(t + gridDim.x, s ^ 1);
      mx::cp_async_wait<1>();
    } else {
      mx::cp_async_wait<0>();
    }
    __syncthreads();
    const long long bg = t / tiles_per_bg;
    const int n0 = (int)(t % tiles_per_bg) * kTileN;
    const int rows = min(kTileN, n - n0);  // a multiple of 8
    const mx::bf16* f = ft + bg * hw * (long long)c;
    mx::bf16* out = col + bg * (long long)c * n + n0;
    for (int c0 = 0; c0 < c; c0 += kChunkC) {
      const int cw = min(kChunkC, c - c0);  // a multiple of 8
      if (ch < cw && r0 < rows) {
        uint4 p[kGroup8][4];
#pragma unroll
        for (int i = 0; i < kGroup8; ++i) {
          const int r = r0 + i;
          const int a0 = corner[s][0][r] * w, a1 = corner[s][1][r] * w;
          const int b0 = corner[s][2][r], b1 = corner[s][3][r];
          const mx::bf16* q = f + c0 + ch;
          p[i][0] = __ldg(reinterpret_cast<const uint4*>(q + (long long)(a0 + b0) * c));
          p[i][1] = __ldg(reinterpret_cast<const uint4*>(q + (long long)(a0 + b1) * c));
          p[i][2] = __ldg(reinterpret_cast<const uint4*>(q + (long long)(a1 + b0) * c));
          p[i][3] = __ldg(reinterpret_cast<const uint4*>(q + (long long)(a1 + b1) * c));
        }
        float o[8][kGroup8];  // [channel][row]
#pragma unroll
        for (int i = 0; i < kGroup8; ++i) {
          const int r = r0 + i;
          const Mix<mx::bf16> m(lerp[s][0][r], lerp[s][1][r], lerp[s][2][r],
                                corner[s][0][r] == corner[s][1][r],
                                corner[s][2][r] == corner[s][3][r]);
          float f00[8], f01[8], f10[8], f11[8];
          unpack8(p[i][0], f00);
          unpack8(p[i][1], f01);
          unpack8(p[i][2], f10);
          unpack8(p[i][3], f11);
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j][i] = m(f00[j], f01[j], f10[j], f11[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tile[ch + j][swizzle8(ch + j, r0 / 4)] =
              mx::float4_to_bf16x4(make_float4(o[j][0], o[j][1], o[j][2], o[j][3]));
      }
      __syncthreads();
      // whole channel rows of col: eight 16-byte pieces (eight rows) a
      // channel, each two swizzled chunks of one aligned pair, swapped where
      // the swizzle's low bit is set
      for (int e = tid; e < cw * (kTileN / 8); e += kThreads) {
        const int cc = e / (kTileN / 8), k = e % (kTileN / 8);
        const int sw = (cc >> 3) & 15;
        uint4 v = *reinterpret_cast<const uint4*>(&tile[cc][(2 * k) ^ (sw & 14)]);
        if (sw & 1) v = make_uint4(v.z, v.w, v.x, v.y);
        if (8 * k < rows)
          __stcs(reinterpret_cast<uint4*>(out + (long long)(c0 + cc) * n + 8 * k), v);
      }
      __syncthreads();
    }
  }
}

// any C, N and alignment: one thread per output element, in col's
// channel-major order (threads along n)
template <typename T>
__global__ void dconv_col_kernel(const int* __restrict__ y0,
                                 const int* __restrict__ y1,
                                 const int* __restrict__ x0,
                                 const int* __restrict__ x1,
                                 const float* __restrict__ ly,
                                 const float* __restrict__ lx,
                                 const float* __restrict__ lf,
                                 const T* __restrict__ ft, long long total,
                                 int n, int w, int hw, int c,
                                 T* __restrict__ col) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long bgc = e / n;
    const long long r = (bgc / c) * n + e % n;  // the factors' row
    const int k = (int)(bgc % c);
    const Mix<T> m(ly[r], lx[r], lf[r], y0[r] == y1[r], x0[r] == x1[r]);
    const T* f = ft + (bgc / c) * hw * (long long)c + k;
    const long long a0 = (long long)y0[r] * w, a1 = (long long)y1[r] * w;
    mx::store(col + e, m(mx::to_float(f[(a0 + x0[r]) * c]), mx::to_float(f[(a0 + x1[r]) * c]),
                         mx::to_float(f[(a1 + x0[r]) * c]), mx::to_float(f[(a1 + x1[r]) * c])));
  }
}

template <typename T>
int dconv_col(const void* y0, const void* y1, const void* x0, const void* x1,
              const void* ly, const void* lx, const void* lf, const void* ft, void* col,
              int bg, int n, int h, int w, int c, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* iy0 = static_cast<const int*>(y0);
  const auto* iy1 = static_cast<const int*>(y1);
  const auto* ix0 = static_cast<const int*>(x0);
  const auto* ix1 = static_cast<const int*>(x1);
  const auto* fly = static_cast<const float*>(ly);
  const auto* flx = static_cast<const float*>(lx);
  const auto* flf = static_cast<const float*>(lf);
  const auto* fft = static_cast<const T*>(ft);
  T* out = static_cast<T*>(col);
  if (vec) {
    const long long tiles = (long long)bg * ((n + kTileN - 1) / kTileN);
    int blocks = 0;
    cudaError_t err =
        mx::persistent_grid(dconv_col_tiled_kernel<T>, kThreads, 0, tiles, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    dconv_col_tiled_kernel<T><<<blocks, kThreads, 0, st>>>(
        iy0, iy1, ix0, ix1, fly, flx, flf, fft, tiles, n, w, h * w, c, out);
  } else {
    const long long total = (long long)bg * n * c;
    const long long blocks = std::min<long long>((total + kThreads - 1) / kThreads, 1 << 20);
    dconv_col_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        iy0, iy1, ix0, ix1, fly, flx, flf, fft, total, n, w, h * w, c, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y0..x1 (BG, N) i32; ly, lx, lf (BG, N) f32; ft (BG, H W, C) f32;
// col (BG, N, C) f32 out, channel-major (strides (C N, 1, N)).  `vec` says
// C % 4 == 0, N % 4 == 0 and every pointer 16-byte aligned: the tiled kernel.
extern "C" int mx_dconv_col(const void* y0, const void* y1, const void* x0,
                            const void* x1, const void* ly, const void* lx,
                            const void* lf, const void* ft, void* col, int bg,
                            int n, int h, int w, int c, int vec, void* stream) {
  return dconv_col<float>(y0, y1, x0, x1, ly, lx, lf, ft, col, bg, n, h, w, c, vec, stream);
}

// The same with ft and col bf16 (the bf16 contract above); with `vec`, C % 8
// == 0 and N % 8 == 0 the bf16 design, else the fp32 ones in bf16.
extern "C" int mx_dconv_col_bf16(const void* y0, const void* y1, const void* x0,
                                 const void* x1, const void* ly, const void* lx,
                                 const void* lf, const void* ft, void* col, int bg,
                                 int n, int h, int w, int c, int vec, void* stream) {
  if (!(vec && c % 8 == 0 && n % 8 == 0))
    return dconv_col<mx::bf16>(y0, y1, x0, x1, ly, lx, lf, ft, col, bg, n, h, w, c, vec,
                               stream);
  const long long tiles = (long long)bg * ((n + kTileN - 1) / kTileN);
  int blocks = 0;
  cudaError_t err =
      mx::persistent_grid(dconv_col_tiled_bf16x8_kernel, kThreads, 0, tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  dconv_col_tiled_bf16x8_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(y0), static_cast<const int*>(y1), static_cast<const int*>(x0),
      static_cast<const int*>(x1), static_cast<const float*>(ly), static_cast<const float*>(lx),
      static_cast<const float*>(lf), static_cast<const mx::bf16*>(ft), tiles, n, w, h * w, c,
      static_cast<mx::bf16*>(col));
  return static_cast<int>(cudaGetLastError());
}
