// Silence-removal compaction: the memmove loop of
// remove_silence_regions (ctts.c:1634-1690).
//
// Replaces: ctts_tpu/ops/pallas/compact.py:89 compact_units (body
// _make_kernel :44). For every region r and kept segment s < NBLK with
// seg_len > 0, samples starts[s] .. + seg_len move to dst[s] inside the
// region's row of [R*WREG]; every other position keeps its content.
//
// Why out of place is exact: destinations ascend and never reach the
// next source (dst[s] + len[s] <= starts[s + 1], compact.py:10-18), so
// copying every segment from the untouched input gives the bits of the
// in-place sequence, and all positions can be written at once. (An
// in-place parallel move would race: a segment's source can overlap
// another's destination.)
//
// Bound on this card: bytes. Every output position is written once and
// reads one input sample: 2 x the buffer (~0.54 GB at the serving
// bucket, 0.16 ms at 3.35 TB/s) plus the tables, whatever NBLK is.
//
// Design: the grid is (region row, row tile of kSpan positions), so it
// does not grow with NBLK. A block compacts its row's table into shared
// memory: the segments with seg_len > 0, in slot order (a block scan
// ranks them), as destination start, destination end and source shift.
// A thread owns 4 consecutive positions at a time (a float4 store where
// the row is 16-byte aligned); it finds the last segment whose
// destination starts at or before its first position by a binary
// search from the segment it found last (positions only grow), then
// walks forward across its 4 positions. A position inside a segment
// reads its sample at the shift, any other its own sample: one float4
// load where the 4 share a shift and the source is aligned, else 4
// scalar loads. A row without moved segments is copied as it is.
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using ctts::block_excl_sum;

constexpr int kThreads = ctts::kScanThreads;
constexpr int kSpan = 8192;  // positions a block writes

// The last segment in [lo, nseg) whose destination starts at or before
// p, or lo when none past lo does (lo = -1: before the first segment).
__device__ __forceinline__ int locate(const int* s_d, int nseg, int lo,
                                      int p) {
  if (lo + 1 >= nseg || s_d[lo + 1] > p) return lo;
  int a = lo + 1, z = nseg - 1;  // s_d[a] <= p
  while (a < z) {
    const int mid = (a + z + 1) >> 1;
    if (s_d[mid] <= p) a = mid; else z = mid - 1;
  }
  return a;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const float* __restrict__ in, float* __restrict__ out,
               const int* __restrict__ starts, const int* __restrict__ dst,
               const int* __restrict__ seg_len, int WREG, int NBLK) {
  extern __shared__ int s_seg[];  // dst start, dst end, shift [NBLK] each
  int* s_d = s_seg;
  int* s_e = s_seg + NBLK;
  int* s_sh = s_seg + 2 * NBLK;
  __shared__ int s_scan[ctts::kScanWarps];

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const size_t tab = static_cast<size_t>(row) * NBLK;
  const int per = (NBLK + kThreads - 1) / kThreads;
  const int k0 = min(t * per, NBLK);
  const int k1 = min(k0 + per, NBLK);
  int cnt = 0;
  for (int k = k0; k < k1; ++k) cnt += seg_len[tab + k] > 0;
  int nseg;
  int at = block_excl_sum(cnt, s_scan, &nseg);
  for (int k = k0; k < k1; ++k) {
    const int ln = seg_len[tab + k];
    if (ln > 0) {
      const int d = dst[tab + k];
      s_d[at] = d;
      s_e[at] = d + ln;
      s_sh[at] = starts[tab + k] - d;
      ++at;
    }
  }
  __syncthreads();

  const float* src = in + static_cast<size_t>(row) * WREG;
  float* o = out + static_cast<size_t>(row) * WREG;
  const int lo_p = blockIdx.y * kSpan;
  const int hi_p = min(lo_p + kSpan, WREG);
  int seg = -1;
  if (kVec) {
    for (int p = lo_p + 4 * t; p < hi_p; p += 4 * kThreads) {
      float4 v;
      if (nseg == 0) {
        v = __ldcs(reinterpret_cast<const float4*>(src + p));
      } else {
        seg = locate(s_d, nseg, seg, p);
        int sh[4];
        int s = seg;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          while (s + 1 < nseg && s_d[s + 1] <= p + e) ++s;
          sh[e] = s >= 0 && p + e < s_e[s] ? s_sh[s] : 0;
        }
        if (sh[0] == sh[1] && sh[0] == sh[2] && sh[0] == sh[3] &&
            ((p + sh[0]) & 3) == 0) {
          v = __ldcs(reinterpret_cast<const float4*>(src + p + sh[0]));
        } else {
          v.x = src[p + sh[0]];
          v.y = src[p + 1 + sh[1]];
          v.z = src[p + 2 + sh[2]];
          v.w = src[p + 3 + sh[3]];
        }
      }
      __stcs(reinterpret_cast<float4*>(o + p), v);
    }
  } else {
    for (int p = lo_p + t; p < hi_p; p += kThreads) {
      seg = locate(s_d, nseg, seg, p);
      const int sh = seg >= 0 && p < s_e[seg] ? s_sh[seg] : 0;
      o[p] = src[p + sh];
    }
  }
}

template <bool kVec>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float* in, float* out, const int* starts,
                   const int* dst, const int* seg_len, int WREG, int NBLK) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        compact_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  compact_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      in, out, starts, dst, seg_len, WREG, NBLK);
  return cudaGetLastError();
}

}  // namespace

// in, out [B, R*WREG] f32; starts, dst, seg_len [B, R, NBLK] i32
// (region-local, MARGIN included). The segments with seg_len > 0 must
// have ascending, disjoint destinations (as silence removal makes them).
extern "C" int ctts_compact(const float* in, float* out, const int* starts,
                            const int* dst, const int* seg_len, int B, int R,
                            int WREG, int NBLK, cudaStream_t stream) {
  if (B <= 0 || R <= 0 || WREG <= 0) return 0;
  const size_t smem = 3 * sizeof(int) * static_cast<size_t>(NBLK);
  const bool vec = WREG % 4 == 0 &&
                   (reinterpret_cast<size_t>(in) & 15) == 0 &&
                   (reinterpret_cast<size_t>(out) & 15) == 0;
  const dim3 grid(B * R, (WREG + kSpan - 1) / kSpan);
  return static_cast<int>(
      vec ? launch<true>(grid, smem, stream, in, out, starts, dst, seg_len,
                         WREG, NBLK)
          : launch<false>(grid, smem, stream, in, out, starts, dst, seg_len,
                          WREG, NBLK));
}
