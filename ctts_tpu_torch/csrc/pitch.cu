// Pitch-search correlations for estimate_pitch (ctts.c:1899-1943).
//
// Replaces: ctts_tpu/ops/pallas/pitch.py:88 pitch_corr_components (body
// _pitch_kernel :46), which splits every int16 into bf16-exact hi/lo
// halves and returns six component sums that combine_exact joins.
// Here the same exact integers are computed directly:
//   corr[lag] = sum_{i < L} s[i] * s[i + lag]
//   e2[lag]   = sum_{i < L} s[i + lag]^2        lag = 0..275, L <= 220
// (s = the int16-valued segment, L = the row's analysis length; the
// masked base is s[i] for i < L). A product fits int32 (|s| <= 32768);
// a sum reaches 220 * 2^30 and is kept in int64, then rounded to f32
// once (__ll2float_rn), which is what combine_exact returns.
//
// Bound on this card: arithmetic-light and latency-bound. One block per
// row stages the 495 samples in shared memory (2 KB) and gives each lag
// a thread; ~220 int multiply-adds per thread, 2 x 276 f32 stores per
// row. Simple for now: no tiling across rows, no tensor cores (the int8
// path cannot take 16-bit samples exactly without a split).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 495;   // PITCH_MAX_LAG + PITCH_ANALYSIS
constexpr int kAna = 220;    // PITCH_ANALYSIS
constexpr int kLags = 276;   // lags 0..PITCH_MAX_LAG
constexpr int kThreads = 288;

__global__ void pitch_corr_kernel(const float* __restrict__ seg,
                                  const int* __restrict__ ana_len,
                                  float* __restrict__ corr,
                                  float* __restrict__ e2) {
  __shared__ int s[kSpan];
  const int row = blockIdx.x;
  const float* src = seg + static_cast<size_t>(row) * kSpan;
  for (int i = threadIdx.x; i < kSpan; i += blockDim.x) {
    s[i] = static_cast<int>(src[i]);  // int16-valued: exact
  }
  __syncthreads();
  int n = ana_len[row];
  n = n < 0 ? 0 : (n > kAna ? kAna : n);
  const int lag = threadIdx.x;
  if (lag >= kLags) return;
  long long c = 0;
  long long e = 0;
  for (int i = 0; i < n; ++i) {
    const int v = s[i + lag];
    c += static_cast<long long>(s[i] * v);
    e += static_cast<long long>(v * v);
  }
  const size_t o = static_cast<size_t>(row) * kLags + lag;
  corr[o] = __ll2float_rn(c);
  e2[o] = __ll2float_rn(e);
}

}  // namespace

// seg [n, 495] f32, ana_len [n] i32 -> corr, e2 [n, 276] f32.
extern "C" int ctts_pitch_corr(const float* seg, const int* ana_len,
                               float* corr, float* e2, int n,
                               cudaStream_t stream) {
  if (n > 0) {
    pitch_corr_kernel<<<n, kThreads, 0, stream>>>(seg, ana_len, corr, e2);
  }
  return static_cast<int>(cudaGetLastError());
}
