// Pitch-search correlations for estimate_pitch (ctts.c:1899-1943).
//
// Replaces: ctts_tpu/ops/pallas/pitch.py:88 pitch_corr_components (body
// _pitch_kernel :46), which splits every int16 into bf16-exact hi/lo
// halves and returns six component sums that combine_exact joins.
// Here the same exact integers are computed directly:
//   corr[lag] = sum_{i < L} s[i] * s[i + lag]
//   e2[lag]   = sum_{i < L} s[i + lag]^2        lag = 0..275, L <= 220
// (s = the int16-valued segment, L = the row's analysis length; the
// masked base is s[i] for i < L), each rounded once to f32, which is
// what combine_exact returns.
//
// Bound on this card: the bytes (2 KB in, 2.2 KB out a row) take less
// time than a launch; the work is ~276 L multiply-adds a row, so the
// instruction rate bounds it. A thread per lag with int64 sums spent
// ~7 instructions and 2 shared-memory loads on each multiply-add and
// summed e2 term by term.
//
// Design: one warp per row, 4 rows a block, no block barrier.
// - A row with L = 0 is all zeros: written with no read.
// - e2 from a prefix sum of squares P[k] = sum_{i<k} s[i]^2, exact in f64
//   (< 2^39): e2[lag] = P[lag + L] - P[lag], the same integer.
// - corr on dp4a: byte planes s = 256 hi + lo (hi signed, lo unsigned),
//   packed 4 samples a word at every offset; 4 dp4a give 4 samples of the
//   4 plane products, kept in 3 int32 sums a lag (each below 2^24 for 220
//   terms) and joined in int64 once. A multiply-add costs one dp4a.
// - Lags tiled in registers: a lane holds lags 8 lane .. 8 lane + 7 on a
//   window of 2 aligned uint4 blocks a plane (one new block a step), and
//   lanes below 20 one more lag, 256 + lane (a word a step): 36 dp4a a
//   step cover the row's 276 lags on all 32 lanes. The base word pair
//   arrives as a shared-memory broadcast.
// - Shared memory is laid out so that no access conflicts on a bank more
//   than 2-way, and corr/e2 leave through a shared-memory stage as
//   coalesced stores.
// On the H100 the loop runs at the dp4a pipe's rate (half the int32
// rate); f64 fused multiply-adds (9 lags a lane) and 12 lags a lane on
// 23 lanes were each slower.
#include <cuda_runtime.h>

namespace {

constexpr int kSpan = 495;   // PITCH_MAX_LAG + PITCH_ANALYSIS
constexpr int kAna = 220;    // PITCH_ANALYSIS
constexpr int kLags = 276;   // lags 0..PITCH_MAX_LAG
constexpr int kRows = 4;     // rows (warps) a block
constexpr int kPadded = 512; // the segment, zero past kSpan
constexpr int kChunks = kPadded / 128;  // of 4 samples a lane
constexpr int kG = 8;                   // lags a lane: lags 0..255
constexpr int kExtra = kLags - 32 * kG;  // lags 256..275, one a lane
constexpr unsigned kFull = 0xffffffffu;

// Samples k = 128 m + 4 lane + t (t < 4) of a row, 0 past kSpan.
__device__ __forceinline__ void load4(const float* __restrict__ src, int m,
                                      int lane, int* v) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int k = 128 * m + 4 * lane + t;
    v[t] = k < kSpan ? static_cast<int>(src[k]) : 0;  // int16-valued: exact
  }
}

// P[k] lives at pidx(k): one pad slot every 16, so that lanes writing 4
// consecutive entries, or reading 8 lags apart, hit distinct banks.
__device__ __forceinline__ int pidx(int k) { return k + (k >> 4); }
constexpr int kPSize = kPadded + (kPadded >> 4) + 1;

// P[k + 1] for the 4 samples of load4(m): the running sum of squares,
// scanned across the warp; `carry` is P[128 m] on entry, P[128 (m + 1)]
// on return. Every value is an integer below 2^39: exact in f64.
__device__ __forceinline__ void prefix4(const int* v, int m, int lane,
                                        double* P, double& carry) {
  double sq[4];
  double own = 0.0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    sq[t] = static_cast<double>(v[t]) * static_cast<double>(v[t]);
    own += sq[t];
  }
  double incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  double run = carry + (incl - own);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    run += sq[t];
    P[pidx(128 * m + 4 * lane + t + 1)] = run;
  }
  carry += __shfl_sync(kFull, incl, 31);
}

// Four-byte dot products, signed (s) or unsigned (u) per operand.
__device__ __forceinline__ int dp4a_ss(unsigned a, unsigned b, int c) {
  return __dp4a(static_cast<int>(a), static_cast<int>(b), c);
}
__device__ __forceinline__ int dp4a_su(unsigned a, unsigned b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ int dp4a_us(unsigned a, unsigned b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ int dp4a_uu(unsigned a, unsigned b, int c) {
  return static_cast<int>(__dp4a(a, b, static_cast<unsigned>(c)));
}

// The 4 byte-plane products of base word pair a (hi, lo) and window
// words (h, l): 4 samples of s[i] * s[i + lag] as 65536 hh + 256 hx + ll.
__device__ __forceinline__ void mac4(uint2 a, unsigned h, unsigned l, int& hh,
                                     int& hx, int& ll) {
  hh = dp4a_ss(a.x, h, hh);
  hx = dp4a_su(a.x, l, hx);
  hx = dp4a_us(a.y, h, hx);
  ll = dp4a_uu(a.y, l, ll);
}

__device__ __forceinline__ unsigned word_of(const uint4& q, int i) {
  return i == 0 ? q.x : (i == 1 ? q.y : (i == 2 ? q.z : q.w));
}

// The 4 words at offsets 4q .. 4q + 3 of a byte plane, from its aligned
// words w = bytes 4q .. 4q + 3 and nx = bytes 4q + 4 .. 4q + 7.
__device__ __forceinline__ uint4 shifted_words(unsigned w, unsigned nx) {
  return make_uint4(w, __byte_perm(w, nx, 0x4321), __byte_perm(w, nx, 0x5432),
                    __byte_perm(w, nx, 0x6543));
}

struct RowSmem {
  double P[kPSize];
  uint4 wh[kPadded / 4];  // wh[q].{x,y,z,w}: hi bytes of s[k .. k+3], k = 4q..4q+3
  uint4 wl[kPadded / 4];
  uint2 base[64];         // (hi, lo) words of the masked base, 0 past L
};

// The row in shared memory: P, the byte-plane words at every offset, and
// the masked base.
__device__ __forceinline__ void setup_row(RowSmem& sm,
                                          const float* __restrict__ src,
                                          int L, int lane) {
  // Byte planes, 4 samples a word: word q = 32 m + lane holds samples
  // 4q .. 4q + 3.
  unsigned hw[kChunks], lw[kChunks];
  double carry = 0.0;
  if (lane == 0) sm.P[0] = 0.0;
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    int v[4];
    load4(src, m, lane, v);
    prefix4(v, m, lane, sm.P, carry);
    hw[m] = lw[m] = 0u;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      hw[m] |= static_cast<unsigned>((v[t] >> 8) & 0xff) << (8 * t);
      lw[m] |= static_cast<unsigned>(v[t] & 0xff) << (8 * t);
    }
  }
  // Words at every offset, from each word and the next one (the next
  // lane's, or the next chunk's first; 0 past the end).
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const bool last = m + 1 == kChunks;
    const unsigned h0 = __shfl_sync(kFull, last ? 0u : hw[(m + 1) % kChunks], 0);
    const unsigned l0 = __shfl_sync(kFull, last ? 0u : lw[(m + 1) % kChunks], 0);
    unsigned nh = __shfl_down_sync(kFull, hw[m], 1);
    unsigned nl = __shfl_down_sync(kFull, lw[m], 1);
    if (lane == 31) {
      nh = h0;
      nl = l0;
    }
    sm.wh[32 * m + lane] = shifted_words(hw[m], nh);
    sm.wl[32 * m + lane] = shifted_words(lw[m], nl);
  }
  // The masked base: groups g < ceil(L / 4), the last one cut at L.
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int g = 32 * m + lane;
    const int keep = min(max(L - 4 * g, 0), 4);  // samples of group g
    const unsigned mask = keep == 4 ? kFull : (1u << (8 * keep)) - 1u;
    sm.base[g] = make_uint2(hw[m] & mask, lw[m] & mask);
  }
  __syncwarp();
}

// One step g of the loop: the window is blocks J, J+1 (mod 2) of the
// ring; block J+1 (block q0 + g + 1) is loaded first. The extra lag reads
// its words at xl + 4g.
template <int J>
__device__ __forceinline__ void step(const RowSmem& sm, int q0, int xl, int g,
                                     uint4 (&bh)[2], uint4 (&bl)[2],
                                     int (&hh)[kG + 1], int (&hx)[kG + 1],
                                     int (&ll)[kG + 1]) {
  constexpr int kNew = (J + 1) % 2;
  bh[kNew] = sm.wh[q0 + g + 1];
  bl[kNew] = sm.wl[q0 + g + 1];
  const unsigned xh = reinterpret_cast<const unsigned*>(sm.wh)[xl + 4 * g];
  const unsigned xw = reinterpret_cast<const unsigned*>(sm.wl)[xl + 4 * g];
  const uint2 a = sm.base[g];
#pragma unroll
  for (int d = 0; d < kG; ++d) {
    mac4(a, word_of(bh[(J + d / 4) % 2], d % 4),
         word_of(bl[(J + d / 4) % 2], d % 4), hh[d], hx[d], ll[d]);
  }
  mac4(a, xh, xw, hh[kG], hx[kG], ll[kG]);
}

__global__ void __launch_bounds__(32 * kRows)
pitch_corr_kernel(const float* __restrict__ seg,
                  const int* __restrict__ ana_len, float* __restrict__ corr,
                  float* __restrict__ e2, int n) {
  __shared__ RowSmem smem[kRows];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + warp;
  if (row >= n) return;
  const size_t o = static_cast<size_t>(row) * kLags;
  const int L = min(max(ana_len[row], 0), kAna);
  if (L == 0) {
    for (int k = lane; k < kLags; k += 32) {
      corr[o + k] = 0.0f;
      e2[o + k] = 0.0f;
    }
    return;
  }
  RowSmem& sm = smem[warp];
  setup_row(sm, seg + static_cast<size_t>(row) * kSpan, L, lane);

  // Lags 8 lane .. 8 lane + 7 and, on lanes below kExtra, 256 + lane (the
  // other lanes' extra lag is computed and dropped).
  const int lag0 = kG * lane;
  const int q0 = 2 * lane;  // lag0 / 4
  const int xl = 32 * kG + lane;
  uint4 bh[2], bl[2];
  bh[0] = sm.wh[q0];
  bl[0] = sm.wl[q0];
  int hh[kG + 1], hx[kG + 1], ll[kG + 1];
#pragma unroll
  for (int d = 0; d <= kG; ++d) hh[d] = hx[d] = ll[d] = 0;
  const int ng = (L + 3) / 4;
  for (int g = 0; g < ng; g += 2) {  // base groups past ng are 0
    step<0>(sm, q0, xl, g, bh, bl, hh, hx, ll);
    step<1>(sm, q0, xl, g + 1, bh, bl, hh, hx, ll);
  }
  float c[kG + 1], e[kG + 1];
#pragma unroll
  for (int d = 0; d <= kG; ++d) {
    const int lag = d < kG ? lag0 + d : min(xl, kLags - 1);
    c[d] = __ll2float_rn(static_cast<long long>(hh[d]) * 65536 +
                         static_cast<long long>(hx[d]) * 256 + ll[d]);
    e[d] = __double2float_rn(sm.P[pidx(lag + L)] - sm.P[pidx(lag)]);
  }
  // The planes are read no more: they stage the row's corr and e2, which
  // leave as coalesced stores.
  float* c_out = reinterpret_cast<float*>(sm.wh);
  float* e_out = reinterpret_cast<float*>(sm.wl);
  __syncwarp();
#pragma unroll
  for (int d = 0; d < kG; d += 4) {
    *reinterpret_cast<float4*>(c_out + lag0 + d) =
        make_float4(c[d], c[d + 1], c[d + 2], c[d + 3]);
    *reinterpret_cast<float4*>(e_out + lag0 + d) =
        make_float4(e[d], e[d + 1], e[d + 2], e[d + 3]);
  }
  if (lane < kExtra) {
    c_out[xl] = c[kG];
    e_out[xl] = e[kG];
  }
  __syncwarp();
  for (int k = lane; k < kLags; k += 32) {
    corr[o + k] = c_out[k];
    e2[o + k] = e_out[k];
  }
}

}  // namespace

// seg [n, 495] f32, ana_len [n] i32 -> corr, e2 [n, 276] f32.
extern "C" int ctts_pitch_corr(const float* seg, const int* ana_len,
                               float* corr, float* e2, int n,
                               cudaStream_t stream) {
  if (n > 0) {
    pitch_corr_kernel<<<(n + kRows - 1) / kRows, 32 * kRows, 0, stream>>>(
        seg, ana_len, corr, e2, n);
  }
  return static_cast<int>(cudaGetLastError());
}
