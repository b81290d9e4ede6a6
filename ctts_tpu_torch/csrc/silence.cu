// Silence-removal tables: the kept segments of every region row, as
// remove_silence_regions finds them (ctts.c:1634-1690).
//
// Replaces: no pallas_call. On the TPU the tables were XLA ops: the
// seg_table pass of ctts_tpu/synth/device.py:1276 around
// dops.silence_segments (ctts_tpu/ops/device_ops.py:491), cumsum
// windows, shifted masks and a flag extraction over [B*R, CONTW]. This
// kernel computes the same tables (SynthesisCore._seg_tables, the plain
// version silence_tables_plain in ops/hopper/silence.py) from runs:
//   silent = i < n && |x| <= trunc(max_amp * thr), max_amp over the n
//   live samples; a maximal silent run [a, b] of L >= min_run =
//   max(M, keep_n + 1) samples drops [a + keep_n, b]; the kept segments
//   are [0, n) minus those gaps (plan_arrays.kept_segments_bound proves
//   the masks equal to this). Slot k holds the k-th segment; past nblk
//   segments the last slot runs to the region's length (the catch-all).
//   A region that is all zero, empty, or not removed keeps everything.
// Outputs per region: starts (+ MARGIN), dst = MARGIN + the exclusive
// sum of seg_len, seg_len [nblk] i32; new_len i64; and per sentence
// the count of removed regions with more than nblk segments.
//
// Bound on this card: bytes. Each live sample is read once for the max
// and once for the runs (the second read mostly from L2), the tables
// written once: ~0.26 GB at the serving bucket, ~0.08 ms at 3.35 TB/s.
//
// Design: one block per region row, the row streamed in tiles of 8192
// samples, so any CONTW works (nothing of the row is kept in shared
// memory). A tile's samples are read coalesced, and a ballot per 32
// samples packs their silent flags into 256 words; thread t then owns
// word t. The last loud position before each word comes from a block
// max-scan (plus the tiles before), so a silent run that crosses words
// or tiles is measured exactly. A gap ends where a loud sample follows
// a silent run of >= min_run (at most 3 a word, as min_run >= 11); a
// block sum-scan ranks the gaps, and gap j writes slot j's end and slot
// j + 1's start into shared memory (2 * nblk ints). The run that ends
// the row is the last gap or the last segment's end. A final pass
// writes the tables with a block scan of the lengths for dst. All
// integer but the one f32 multiply max_amp * thr and the |x| compares.
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using ctts::block_excl_max;
using ctts::block_excl_sum;
using ctts::kFullMask;

constexpr int kThreads = ctts::kScanThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32 * kThreads;  // samples a tile: one word a thread
constexpr int kMaxGapsPerWord = 3;    // gaps end >= min_run + 1 >= 12 apart

__global__ void __launch_bounds__(kThreads)
silence_tables_kernel(const float* __restrict__ bufs,
                      const int* __restrict__ region_len,
                      const unsigned char* __restrict__ remove,
                      const float* __restrict__ threshold,
                      int* __restrict__ starts, int* __restrict__ dst,
                      int* __restrict__ seg_len,
                      long long* __restrict__ new_len,
                      int* __restrict__ ovf_count, int R, int WREG,
                      int MARGIN, int CONTW, int keep_n, int min_run,
                      int nblk) {
  extern __shared__ int s_tab[];  // s_start [nblk], s_end [nblk]
  int* s_start = s_tab;
  int* s_end = s_tab + nblk;
  __shared__ unsigned s_bits[kThreads];
  __shared__ int s_scan[kWarps];
  __shared__ float s_max[kWarps];

  const int row = blockIdx.x;  // b * R + r
  const int b = row / R;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int length = region_len[row];
  const int n = min(max(length, 0), CONTW);
  const bool rm = remove[row] != 0;
  const float* x = bufs + static_cast<size_t>(row) * WREG + MARGIN;

  // The largest |x| of the live samples (only where silence is removed).
  float m = 0.0f;
  if (rm) {
#pragma unroll 8
    for (int i = t; i < n; i += kThreads) m = fmaxf(m, fabsf(x[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));
  if (lane == 0) s_max[t >> 5] = m;
  __syncthreads();
  float max_amp = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) max_amp = fmaxf(max_amp, s_max[w]);

  const bool changed = rm && max_amp != 0.0f && length != 0;
  int n_segs = 0;
  if (changed) {
    const float thr = truncf(__fmul_rn(max_amp, threshold[b]));
    if (t == 0) s_start[0] = 0;
    int carry_p = -1;  // the last loud position before the tile
    int carry_g = 0;   // the gaps before the tile
    for (int base = 0; base < n; base += kTile) {
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = base + j * kThreads + t;
        v[j] = i < n ? x[i] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = base + j * kThreads + t;
        const unsigned w = __ballot_sync(kFullMask, i < n && fabsf(v[j]) <= thr);
        if (lane == 0) s_bits[j * kWarps + (t >> 5)] = w;
      }
      __syncthreads();

      // Thread t: samples p0 .. p0 + 31 of word t.
      const int p0 = base + 32 * t;
      const int live = min(max(n - p0, 0), 32);
      const unsigned valid = live == 32 ? kFullMask : (1u << live) - 1u;
      const unsigned loud = ~s_bits[t] & valid;
      const int last = loud ? p0 + 31 - __clz(loud) : -1;
      int tile_last;
      const int p_in = max(block_excl_max(last, s_scan, &tile_last), carry_p);
      // Loud samples right after a silent one: the ends of silent runs.
      const unsigned after = p_in == p0 - 1 ? 1u : 0u;
      unsigned ends = loud & ~((loud << 1) | after);
      int cnt = 0;
      int ga[kMaxGapsPerWord], gb[kMaxGapsPerWord];
      while (ends) {
        const int k = __ffs(ends) - 1;
        ends &= ends - 1;
        const unsigned below = loud & ((1u << k) - 1u);
        const int p = below ? p0 + 31 - __clz(below) : p_in;
        if (p0 + k - 1 - p >= min_run) {  // the run [p + 1, p0 + k - 1]
          ga[cnt] = p + 1;
          gb[cnt] = p0 + k - 1;
          ++cnt;
        }
      }
      int tile_gaps;
      const int rank = carry_g + block_excl_sum(cnt, s_scan, &tile_gaps);
      for (int e = 0; e < cnt; ++e) {
        const int j = rank + e;
        if (j < nblk) s_end[j] = ga[e] + keep_n - 1;
        if (j + 1 < nblk) s_start[j + 1] = gb[e] + 1;
      }
      carry_p = max(carry_p, tile_last);
      carry_g += tile_gaps;
      __syncthreads();  // s_bits is written again by the next tile
    }
    // The run that ends the row: a last gap, or the last segment's end.
    if (t == 0 && carry_g < nblk) {
      s_end[carry_g] = n - 1 - carry_p >= min_run ? carry_p + keep_n : n - 1;
    }
    n_segs = carry_g + 1;
    __syncthreads();
  }

  // The tables: thread t owns slots [k0, k1).
  const bool over = changed && n_segs > nblk;
  const int per = (nblk + kThreads - 1) / kThreads;
  const int k0 = min(t * per, nblk);
  const int k1 = min(k0 + per, nblk);
  int sum = 0;
  for (int k = k0; k < k1; ++k) {
    if (changed && k < n_segs) {
      sum += over && k == nblk - 1 ? max(length - s_start[k], 0)
                                   : s_end[k] - s_start[k] + 1;
    }
  }
  int total;
  int off = block_excl_sum(sum, s_scan, &total);
  const size_t o = static_cast<size_t>(row) * nblk;
  for (int k = k0; k < k1; ++k) {
    int st = 0, ln = 0;
    if (changed) {
      if (k < n_segs) {
        st = s_start[k];
        ln = over && k == nblk - 1 ? max(length - st, 0)
                                   : s_end[k] - st + 1;
      } else {
        st = CONTW;
      }
    }
    starts[o + k] = st + MARGIN;
    dst[o + k] = MARGIN + off;
    seg_len[o + k] = ln;
    off += ln;
  }
  if (t == 0) {
    new_len[row] = changed ? static_cast<long long>(total) : length;
    if (over) atomicAdd(ovf_count + b, 1);
  }
}

}  // namespace

// bufs [B, R*WREG] f32 (content at [MARGIN, MARGIN + CONTW) of each
// region row); region_len [B, R] i32; remove [B, R] bool (one byte);
// threshold [B] f32 -> starts, dst, seg_len [B, R, nblk] i32, new_len
// [B, R] i64, ovf_count [B] i32 (zeroed here). keep_n and min_run as
// silence_segments derives them from min_silence.
extern "C" int ctts_silence_tables(const float* bufs, const int* region_len,
                                   const unsigned char* remove,
                                   const float* threshold, int* starts,
                                   int* dst, int* seg_len, long long* new_len,
                                   int* ovf_count, int B, int R, int WREG,
                                   int MARGIN, int CONTW, int keep_n,
                                   int min_run, int nblk,
                                   cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(ovf_count, 0, sizeof(int) * B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || R <= 0) return 0;
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(nblk);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(silence_tables_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  silence_tables_kernel<<<B * R, kThreads, smem, stream>>>(
      bufs, region_len, remove, threshold, starts, dst, seg_len, new_len,
      ovf_count, R, WREG, MARGIN, CONTW, keep_n, min_run, nblk);
  return static_cast<int>(cudaGetLastError());
}
