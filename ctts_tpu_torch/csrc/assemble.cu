// Sentence assembly: the overlap-add of region rows at their cumsum
// offsets (ctts.c:2951-3012, appending into the sentence buffer).
//
// Replaces: ctts_tpu/ops/pallas/assemble.py:72 assemble_regions (body
// _make_kernel :40). Output position p starts at 0.0f and adds, in
// ascending r, bufs[r][p - offsets[r]] wherever
// 0 <= p - offsets[r] < min(live_len[r], WREG) (live_len = MARGIN +
// compacted length, 0 for an inactive region). These are the same f32
// adds in the same order as the JAX region loop
// (ctts_tpu/synth/device.py:1621-1633), so the sums are bit-equal.
//
// Bound on this card: bytes. Each output is written once and each live
// region sample read once (~0.75 MB a sentence at the serving bucket,
// over 3.35 TB/s). A thread per output sample that scanned all R region
// tables in device memory was instruction-bound instead: 2R dependent
// loads and ~100 instructions for at most 2 loads and 1 store.
//
// Design: the grid is (1024-position tile, sentence). A block stages its
// sentence's region tables in shared memory (kThreads regions at a time,
// so any R). Each warp holds 128 consecutive positions, 4 a lane, lists
// the regions whose live span meets them with a ballot (ascending r) and
// walks only that list, so any overlap depth gives the same adds in the
// same order. Every sample is read once and every output written once,
// so loads and stores are streaming (evict-first); a lane's 4 outputs
// leave as one float4. Positions that no region covers are written 0.0f
// with no read. Shapes that are not 16-byte aligned take scalar stores.
// Tiles of 2048 or 4096 positions, float4 loads (aligned, shifted in
// registers) and plain (cached) accesses were each slower on the H100.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 4;  // positions a block writes
constexpr unsigned kFull = 0xffffffffu;

// Adds region row (live span [off, off + n)) to the lane's positions
// p0 .. p0 + 3.
__device__ __forceinline__ void add_region(const float* __restrict__ row,
                                           int off, int n, int p0, float* v) {
  const int j = p0 - off;
  if (j >= 0 && j + 4 <= n) {
    float x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = __ldcs(row + j + t);
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = __fadd_rn(v[t], x[t]);
  } else if (j < n && j + 4 > 0) {  // the region's first or last samples
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (j + t >= 0 && j + t < n) v[t] = __fadd_rn(v[t], __ldcs(row + j + t));
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(const float* __restrict__ bufs,
                const int* __restrict__ offsets,
                const int* __restrict__ live_len, float* __restrict__ out,
                int R, int WREG, int OUTW) {
  __shared__ int s_off[kThreads];
  __shared__ int s_len[kThreads];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * kTile + warp * 128;  // the warp's span
  const int hi = min(lo + 128, OUTW);
  const int p0 = lo + 4 * lane;
  const size_t row0 = static_cast<size_t>(b) * R;

  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r0 = 0; r0 < R; r0 += kThreads) {
    const int nr = min(kThreads, R - r0);
    if (r0 > 0) __syncthreads();  // every warp has walked the last chunk
    if (static_cast<int>(threadIdx.x) < nr) {
      const size_t r = row0 + r0 + threadIdx.x;
      s_off[threadIdx.x] = offsets[r];
      s_len[threadIdx.x] = max(0, min(live_len[r], WREG));
    }
    __syncthreads();
    for (int c = 0; c < nr; c += 32) {
      const int k = c + lane;
      const bool meets = k < nr && lo < hi && s_len[k] > 0 && s_off[k] < hi &&
                         s_off[k] + s_len[k] > lo;
      unsigned hits = __ballot_sync(kFull, meets);
      while (hits) {
        const int r = c + __ffs(hits) - 1;
        hits &= hits - 1;
        add_region(bufs + (row0 + r0 + r) * static_cast<size_t>(WREG),
                   s_off[r], s_len[r], p0, v);
      }
    }
  }

  float* o = out + static_cast<size_t>(b) * OUTW;
  if (kVec) {
    if (p0 < OUTW) {  // OUTW % 4 == 0
      __stcs(reinterpret_cast<float4*>(o + p0),
             make_float4(v[0], v[1], v[2], v[3]));
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (p0 + t < OUTW) __stcs(o + p0 + t, v[t]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// bufs [B, R*WREG] f32; offsets, live_len [B, R] i32 -> out [B, OUTW].
extern "C" int ctts_assemble(const float* bufs, const int* offsets,
                             const int* live_len, float* out, int B, int R,
                             int WREG, int OUTW, cudaStream_t stream) {
  if (B > 0 && OUTW > 0) {
    const dim3 grid((OUTW + kTile - 1) / kTile, B);
    if (OUTW % 4 == 0 && aligned16(out)) {
      assemble_kernel<true><<<grid, kThreads, 0, stream>>>(
          bufs, offsets, live_len, out, R, WREG, OUTW);
    } else {
      assemble_kernel<false><<<grid, kThreads, 0, stream>>>(
          bufs, offsets, live_len, out, R, WREG, OUTW);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
