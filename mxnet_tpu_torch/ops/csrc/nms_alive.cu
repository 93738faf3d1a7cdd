// Greedy-NMS survivor mask over score-ordered boxes, batched over images.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py
// _nms_pallas_batched / _nms_kernel_factory (entry nms_alive_pallas).  Same
// greedy semantics as multi_proposal.cc:221-273: box i survives iff valid[i]
// and no surviving j < i has IoU(j, i) > thresh (with ids, only equal-id
// pairs suppress).
//
// The TPU kernel settles one tile at a time by fixed-point iteration, because
// its grid runs in order on one core.  Here the two-phase GPU greedy is used:
//   1. nms_mask_kernel, one block per (row word, column word >= it, image):
//      mask[b, i, j / 64] bit (j % 64) is set iff j > i and IoU(i, j) > thresh.
//      All N^2 / 2 IoUs run in parallel; this is the only arithmetic.
//   2. a scan, one block per image, that walks the boxes 64 at a time (one
//      "word"): the word's survivors are the live boxes that no earlier
//      survivor removed and no earlier survivor of the same word overlaps;
//      their mask rows are then ORed into the removed bits of later words.
//
// Bound on the card: not arithmetic and not bytes.  At N = 6000 phase 1 does
// ~12 flops for each of 18 M pairs and writes 2.3 MB of mask; phase 2 is a
// chain of N / 64 = 94 dependent steps per image, and its time is that
// chain's latency.  nms_scan_kernel (two_stage) keeps global memory off the
// chain:
//   - the removed bits live in registers: thread t owns later word t and
//     ORs the word's kept rows into it, their indices listed by its warp
//     (a popcount compaction), four independent loads in flight: no atomics
//     and no division;
//   - while a word resolves, cp.async brings the next word's mask rows
//     (only the columns from that word on, and only the rows of boxes not
//     yet removed: no other row can be kept, so no other is read) into the
//     second of two shared-memory stages: 64 x words x 8 bytes each, 48 KB
//     at N = 6000;
//   - every warp resolves the word by itself from the 64 diagonal rows in
//     registers (two per lane), by the TPU kernel's fixed-point iteration
//     with warp OR-reductions, so that no warp waits for another's answer:
//     one barrier per word (walking the candidates, one step per survivor,
//     took 1.5x the fixed point's time on an H100 at N = 6000);
//   - a word's survivors are kept as one 64-bit word in shared memory and
//     expanded to the bool output at the end.
// A size whose two stages do not fit in shared memory (N above ~14,000)
// takes the first scan (nms_scan_kernel_global), chosen by shape in the
// C entry: thread 0 settles each word from shared memory, the block ORs the
// kept rows' later words from global memory with shared atomics.
//
// The IoU is written in the reference formula's own operation order
// (pallas_kernels.py iou2d and detection.py _iou_mat), with the _rn
// intrinsics so that nvcc cannot contract ai + aj - w * h into an FMA: the
// survivor masks are bit-identical to the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;
constexpr int kScanThreads = 256;  // two-stage scan: one owner per later word

// IoU of box a with box b, areas aa and ba.  Two boxes that do not overlap
// (inter == 0) have IoU exactly 0 by the formula too (0 / u is +0 for u > 0,
// and u <= 0 gives 0): the division is skipped for them, the bits stay.
__device__ __forceinline__ float iou(float ax1, float ay1, float ax2, float ay2,
                                     float aa, float4 b, float ba, float plus_one) {
  const float w = fmaxf(
      __fadd_rn(__fsub_rn(fminf(ax2, b.z), fmaxf(ax1, b.x)), plus_one), 0.f);
  const float h = fmaxf(
      __fadd_rn(__fsub_rn(fminf(ay2, b.w), fmaxf(ay1, b.y)), plus_one), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f) return 0.f;
  const float uni = __fsub_rn(__fadd_rn(aa, ba), inter);
  return uni <= 0.f ? 0.f : __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

// grid (words (words + 1) / 2, B), block kWord threads: block x is the pair
// (rb, cb >= rb) of the upper triangle, counted row by row from the last row
// word up; thread t compares row box rb * 64 + t with the 64 column boxes of
// word cb.  Only later boxes are suppressed and the scans read only words
// cb >= rb: the scratch below the diagonal is never written.
__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const float* __restrict__ area,
                                const float* __restrict__ ids, int n,
                                int words, float thresh, float plus_one,
                                u64* __restrict__ mask) {
  const int b = blockIdx.y;
  // t counts from the bottom row word: row word words-1-r holds r + 1 blocks
  const long long t = blockIdx.x;
  int r = static_cast<int>((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((long long)(r + 1) * (r + 2) / 2 <= t) ++r;
  while ((long long)r * (r + 1) / 2 > t) --r;
  const int rb = words - 1 - r;
  const int cb = rb + static_cast<int>(t - (long long)r * (r + 1) / 2);
  const int i = rb * kWord + threadIdx.x;
  u64* row = mask + ((size_t)b * n + i) * words;
  __shared__ float4 cbox[kWord];  // one 16-byte broadcast load per column box
  __shared__ float carea[kWord];
  __shared__ float cid[kWord];
  const float* bx = boxes + (size_t)b * n * 4;
  const float* ar = area + (size_t)b * n;
  const int j0 = cb * kWord;
  const int cols = min(kWord, n - j0);
  if (threadIdx.x < cols) {
    const int j = j0 + threadIdx.x;
    cbox[threadIdx.x] = make_float4(bx[j * 4 + 0], bx[j * 4 + 1], bx[j * 4 + 2],
                                    bx[j * 4 + 3]);
    carea[threadIdx.x] = ar[j];
    cid[threadIdx.x] = ids ? ids[(size_t)b * n + j] : 0.f;
  }
  __syncthreads();
  if (i >= n) return;
  const float x1 = bx[i * 4 + 0], y1 = bx[i * 4 + 1];
  const float x2 = bx[i * 4 + 2], y2 = bx[i * 4 + 3];
  const float ai = ar[i];
  const float id = ids ? ids[(size_t)b * n + i] : 0.f;
  u64 bits = 0ULL;
  const int start = cb == rb ? threadIdx.x + 1 : 0;
  for (int k = start; k < cols; ++k) {
    if (ids && cid[k] != id) continue;
    if (iou(x1, y1, x2, y2, ai, cbox[k], carea[k], plus_one) > thresh) {
      bits |= 1ULL << k;
    }
  }
  row[cb] = bits;
}

// The survivors of one word, in one warp: `cand` holds the word's boxes that
// are live and not removed by an earlier word (the same in every lane);
// lane l holds the word's diagonal mask rows l (d_lo) and l + 32 (d_hi).
// Iterates the TPU kernel's fixed point (pallas_kernels.py:441-457): the
// kept boxes are the candidates that no kept box of the word removes,
// starting from all candidates; each round ORs the kept rows over the warp
// (two warp reductions).  It ends when a round changes nothing, which the
// greedy order reaches within the length of the word's longest chain.
__device__ __forceinline__ u64 resolve_word(u64 cand, u64 d_lo, u64 d_hi) {
  const int lane = threadIdx.x & 31;
  u64 kept = cand;
  // a strictly upper-triangular word settles within 64 rounds; the bound
  // only keeps a corrupted mask from looping forever
  for (int round = 0; round <= kWord; ++round) {
    const u64 mine = (((kept >> lane) & 1ULL) ? d_lo : 0ULL) |
                     (((kept >> (lane + 32)) & 1ULL) ? d_hi : 0ULL);
    const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(mine));
    const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(mine >> 32));
    const u64 next = cand & ~((static_cast<u64>(hi) << 32) | lo);
    if (next == kept) break;
    kept = next;
  }
  return kept;
}

// Issues cp.async copies of mask rows [wb * 64, wb * 64 + cnt), columns
// [wb, words), into dst (row k at dst + k * words): warps over rows, lanes
// over columns.  A row whose bit is set in `skip` (a box already removed: it
// cannot be kept, so its row is never read) is not copied.
__device__ __forceinline__ void stage_rows(u64* dst, const u64* m, int wb, int cnt,
                                           int words, u64 skip) {
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < cnt; k += kScanThreads / 32) {
    if ((skip >> k) & 1ULL) continue;
    const u64* src = m + (size_t)(wb * kWord + k) * words;
    for (int c = wb + lane; c < words; c += 32) mx::cp_async8(dst + k * words + c, src + c);
  }
}

// grid (B), kScanThreads threads, dynamic shared memory (2 * 64 + 2) * words
// u64: the two stages, the kept words and the live words.  words <= kScanThreads.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask, const unsigned char* __restrict__ valid,
                int n, int words, unsigned char* __restrict__ alive) {
  extern __shared__ u64 smem[];
  const int stage = kWord * words;  // stage s at smem + s * stage
  u64* kept_words = smem + 2 * kWord * words;
  u64* live_words = kept_words + words;
  __shared__ u64 handoff[2];  // removed bits of the next word, from its owner
  __shared__ u64 ahead[2];    // and of the word after it, for the staging
  __shared__ int kept_list[kScanThreads / 32][kWord];  // each warp's kept rows
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const u64* m = mask + (size_t)b * n * words;
  const unsigned char* v = valid + (size_t)b * n;
  unsigned char* out = alive + (size_t)b * n;

  stage_rows(smem, m, 0, min(kWord, n), words, 0ULL);
  mx::cp_async_commit();
  for (int w = tid >> 5; w < words; w += kScanThreads / 32) {
    const int i = w * kWord + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, i < n && v[i]);
    const unsigned hi = __ballot_sync(0xffffffffu, i + 32 < n && v[i + 32]);
    if (lane == 0) live_words[w] = (static_cast<u64>(hi) << 32) | lo;
  }
  __syncthreads();
  // a dead box, and a bit past n, counts as removed from the start
  u64 removed = tid < words ? ~live_words[tid] : ~0ULL;
  if (tid == 0) handoff[0] = removed;
  if (tid == 1) ahead[1] = removed;

  for (int wb = 0; wb < words; ++wb) {
    const u64* cur = smem + (wb & 1) * stage;
    mx::cp_async_wait<0>();
    // the one barrier of the word: its rows and its removed bits are visible,
    // and every thread is done with the other stage and handoff slot
    __syncthreads();
    if (wb + 1 < words)
      stage_rows(smem + ((wb + 1) & 1) * stage, m, wb + 1, min(kWord, n - (wb + 1) * kWord),
                 words, ahead[(wb + 1) & 1]);
    mx::cp_async_commit();
    // rows past n were not staged: their bits are never candidates or kept
    const u64 kept = resolve_word(~handoff[wb & 1], cur[lane * words + wb],
                                  cur[(lane + 32) * words + wb]);
    if (tid == 0) kept_words[wb] = kept;
    // the kept rows' indices, listed by this warp for its own lanes
    int* list = kept_list[tid >> 5];
    const unsigned below = (1u << lane) - 1u;
    const unsigned klo = static_cast<unsigned>(kept), khi = static_cast<unsigned>(kept >> 32);
    if ((klo >> lane) & 1u) list[__popc(klo & below)] = lane;
    if ((khi >> lane) & 1u) list[__popc(klo) + __popc(khi & below)] = lane + 32;
    __syncwarp();
    if (tid > wb && tid < words) {
      const int cnt = __popcll(kept);
      u64 r = removed;
      for (int i = 0; i < cnt; i += 4) {  // four independent loads in flight
        const int a0 = list[i];
        const int a1 = list[min(i + 1, cnt - 1)];
        const int a2 = list[min(i + 2, cnt - 1)];
        const int a3 = list[min(i + 3, cnt - 1)];
        r |= cur[a0 * words + tid] | cur[a1 * words + tid] | cur[a2 * words + tid] |
             cur[a3 * words + tid];
      }
      removed = r;
      if (tid == wb + 1) handoff[(wb + 1) & 1] = r;
      if (tid == wb + 2) ahead[(wb + 2) & 1] = r;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kScanThreads)
    out[i] = static_cast<unsigned char>((kept_words[i >> 6] >> (i & 63)) & 1ULL);
}

// The first scan, for sizes whose two stages do not fit: grid (B), dynamic
// shared memory words * 8 bytes for the removed bits.  Thread 0 settles each
// word from shared memory (the word's own mask bits staged there first);
// then the block ORs the kept rows' later words into the removed bits with
// shared-memory atomics.  Two barriers per 64 boxes.
__global__ void nms_scan_kernel_global(const u64* __restrict__ mask,
                                       const unsigned char* __restrict__ valid, int n,
                                       int words, unsigned char* __restrict__ alive) {
  extern __shared__ u64 removed[];
  __shared__ u64 diag[kWord];
  __shared__ unsigned char live[kWord];
  __shared__ u64 kept_word;
  const int b = blockIdx.x;
  const u64* m = mask + (size_t)b * n * words;
  const unsigned char* v = valid + (size_t)b * n;
  unsigned char* out = alive + (size_t)b * n;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ULL;
  for (int wb = 0; wb < words; ++wb) {
    const int base = wb * kWord;
    const int cnt = min(kWord, n - base);
    if (threadIdx.x < cnt) {
      diag[threadIdx.x] = m[(size_t)(base + threadIdx.x) * words + wb];
      live[threadIdx.x] = v[base + threadIdx.x];
    }
    __syncthreads();  // also orders the previous word's atomics before this read
    if (threadIdx.x == 0) {
      u64 rem = removed[wb];
      u64 kept = 0ULL;
      for (int k = 0; k < cnt; ++k) {
        if (!live[k] || ((rem >> k) & 1ULL)) continue;
        kept |= 1ULL << k;
        rem |= diag[k];
      }
      kept_word = kept;
    }
    __syncthreads();
    const u64 kept = kept_word;
    if (threadIdx.x < cnt) out[base + threadIdx.x] = (kept >> threadIdx.x) & 1ULL;
    const int later = words - wb - 1;
    if (kept != 0ULL && later > 0) {
      // consecutive threads read consecutive words of one kept row
      for (int t = threadIdx.x; t < kWord * later; t += blockDim.x) {
        const int k = t / later;
        if ((kept >> k) & 1ULL) {
          const int w = wb + 1 + (t - k * later);
          atomicOr(&removed[w], m[(size_t)(base + k) * words + w]);
        }
      }
    }
    __syncthreads();  // diag / live / kept_word are rewritten next step
  }
}

// the two mask-row stages of the two-stage scan, in bytes
size_t two_stage_smem(int words) { return (size_t)(2 * kWord + 2) * words * sizeof(u64); }

// 4 KB: the scan's static shared memory (kept lists, handoffs) beside it
bool two_stage_fits(int words) {
  return words <= kScanThreads && two_stage_smem(words) + 4096 <= mx::kSmemMax;
}

}  // namespace

// 1 when a call over n boxes takes nms_scan_kernel_global, 0 when it takes
// the two-stage nms_scan_kernel: the rule mx_nms_alive launches by.
extern "C" int mx_nms_scan_global(int n) {
  return two_stage_fits((n + kWord - 1) / kWord) ? 0 : 1;
}

// boxes (B, N, 4) f32, area (B, N) f32, valid (B, N) u8, ids (B, N) f32 or
// null, mask scratch (B, N, ceil(N / 64)) u64, alive (B, N) u8 out.
extern "C" int mx_nms_alive(const void* boxes, const void* area,
                            const void* valid, const void* ids, void* mask,
                            void* alive, int batch, int n, float thresh,
                            float plus_one, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + kWord - 1) / kWord;
  const unsigned pairs = static_cast<unsigned>((long long)words * (words + 1) / 2);
  nms_mask_kernel<<<dim3(pairs, batch), kWord, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(area),
      static_cast<const float*>(ids), n, words, thresh, plus_one,
      static_cast<u64*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const u64* m = static_cast<const u64*>(mask);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  unsigned char* out = static_cast<unsigned char*>(alive);
  if (two_stage_fits(words)) {
    err = mx::allow_smem(nms_scan_kernel, two_stage_smem(words));
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_scan_kernel<<<batch, kScanThreads, two_stage_smem(words), s>>>(m, v, n, words, out);
  } else {
    nms_scan_kernel_global<<<batch, 256, words * sizeof(u64), s>>>(m, v, n, words, out);
  }
  return static_cast<int>(cudaGetLastError());
}
