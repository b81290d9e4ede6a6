// The serving core's unit stage: the bank pick with its crossfade curves
// (unit_base_kernel, once a batch) and the per-unit contributions that
// the compose kernel places (unit_contrib_kernel, once a refine trip and
// once in the epilogue).
//
// Replaces: no pallas_call. On the TPU prepare_base and the set-up of
// make_contrib_fn (ctts_tpu/synth/device.py:761, :841-886) and its
// contrib_fn (:887-918) were XLA ops. The port's plain versions
// (unit_base_plain and unit_contrib_plain in ops/hopper/units.py) gather
// base = q16(bank[uid] * gain[uid]) [B, U, UBUF], pick the curves from
// tables of the batch's distinct lengths, and make the contributions in
// ~10 masked passes over [B, U, UBUF].
//
// Per unit (uid = max(unit_id, 0), n = unit_id >= 0 ? lengths[uid] : 0,
// base[c] = q16(bank[uid][c] * gains[uid]), 0 past the bank's width):
//   unit_base: heads = base[:CFMAX], hcols = base[:HW]; fo, fi[i] =
//     fade_out, fade_in(i * (1 / max(cf_in, 1))), the LUT lerp of
//     ops/luts.py; tail_total = the int sum of base over [CFMAX, n)
//     (0 without remove_dc);
//   unit_contrib, for c < n of an active unit (0 elsewhere): x = heads[c]
//     (c < CFMAX) or base[c]; with remove_dc x = clamp(x - dc) (dc =
//     sign(T) * (|T| / max(n, 1)), T the int sum of heads[:min(n,
//     CFMAX)] and tail_total); with fade_in, on c < min(n,
//     fade_in_samples): x = trunc(x * sine_fade(c * (1 / max(fade,
//     1)))); without it, on head columns c < cf_in: x = x * fi[c].
//   Every multiply and add is its own rounding (--fmad=false and the _rn
//   intrinsics), the divisions correctly rounded, in the plain
//   versions' order. Evaluating a curve per unit gives the bits of the
//   plain versions' table of distinct lengths: t = i * (1 / max(len, 1))
//   is the same f32 product.
//
// Bound on this card: bytes. unit_base writes heads, hcols, fo and fi
// and reads each unit's bank row (the bank, ~24 MB, stays in L2);
// unit_contrib writes contrib [B, U, W] and reads heads, fi where a
// unit mixes, and the bank rows.
//
// Design: one block per unit slot, 4 columns a thread and float4 loads
// and stores where the widths are multiples of 4 and the rows 16-byte
// aligned (V = 4), else one. base is never materialised past its head
// columns: the contributions recompute its body from the bank, so no
// [B, U, UBUF] buffer lives from the prologue to the epilogue, and the
// contributions' pass only writes at full width. A unit's columns past
// n are written as zeros without a read.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = ctts::kScanThreads;
constexpr int kLut = 1024;  // FADE_LUT_SIZE

__device__ __forceinline__ float q16(float x) {
  if (isnan(x)) return x;
  return truncf(fminf(fmaxf(x, -32768.0f), 32767.0f));
}

__device__ __forceinline__ float clamp16(float x) {
  return fminf(fmaxf(x, -32768.0f), 32767.0f);
}

// fast_fade_* lookup with linear interpolation (ops/luts.py).
__device__ __forceinline__ float lut_lookup(const float* __restrict__ lut,
                                            float t) {
  const float idx_f = __fmul_rn(t, static_cast<float>(kLut - 1));
  const int idx = static_cast<int>(idx_f);
  if (idx < 0) return __ldg(lut);
  if (idx >= kLut - 1) return __ldg(lut + kLut - 1);
  const float frac = __fsub_rn(idx_f, static_cast<float>(idx));
  return __fadd_rn(__fmul_rn(__ldg(lut + idx), __fsub_rn(1.0f, frac)),
                   __fmul_rn(__ldg(lut + idx + 1), frac));
}

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = x[j];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
unit_base_kernel(const float* __restrict__ bank,
                 const float* __restrict__ gains,
                 const int* __restrict__ lengths,
                 const int* __restrict__ unit_id,
                 const int* __restrict__ cf_in,
                 const float* __restrict__ lut_out,
                 const float* __restrict__ lut_in,
                 float* __restrict__ heads, float* __restrict__ hcols,
                 int* __restrict__ tail_total, float* __restrict__ fo,
                 float* __restrict__ fi, int UBUF, int CFMAX, int HW,
                 int remove_dc) {
  __shared__ int s_scan[ctts::kScanWarps];
  const int unit = blockIdx.x;
  const int id = unit_id[unit];
  const int uid = max(id, 0);
  const int n = id >= 0 ? min(lengths[uid], UBUF) : 0;
  const float g = gains[uid];
  const float* row = bank + static_cast<size_t>(uid) * UBUF;
  const float inv =
      __fdiv_rn(1.0f, static_cast<float>(max(cf_in[unit], 1)));
  const size_t hrow = static_cast<size_t>(unit) * CFMAX;
  for (int c = V * threadIdx.x; c < HW; c += V * kThreads) {
    float x[V];
    if (c < UBUF) {
      load_v<V>(row + c, x);
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = q16(__fmul_rn(x[j], g));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = 0.0f;
    }
    store_v<V>(hcols + static_cast<size_t>(unit) * HW + c, x);
    if (c < CFMAX) {
      store_v<V>(heads + hrow + c, x);
      float a[V], b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = __fmul_rn(static_cast<float>(c + j), inv);
        a[j] = lut_lookup(lut_out, t);
        b[j] = lut_lookup(lut_in, t);
      }
      store_v<V>(fo + hrow + c, a);
      store_v<V>(fi + hrow + c, b);
    }
  }
  int s = 0;
  if (remove_dc)
    for (int c = CFMAX + threadIdx.x; c < n; c += kThreads)
      s += static_cast<int>(q16(__fmul_rn(row[c], g)));
  int total;
  ctts::block_excl_sum(s, s_scan, &total);
  if (threadIdx.x == 0) tail_total[unit] = total;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
unit_contrib_kernel(const float* __restrict__ heads,
                    const float* __restrict__ bank,
                    const float* __restrict__ gains,
                    const int* __restrict__ lengths,
                    const int* __restrict__ unit_id,
                    const int* __restrict__ cf_in,
                    const unsigned char* __restrict__ fade_in,
                    const int* __restrict__ tail_total,
                    const float* __restrict__ fi,
                    const float* __restrict__ lut_sine,
                    float* __restrict__ contrib, int UBUF, int CFMAX, int W,
                    int fade_in_samples, int remove_dc) {
  __shared__ int s_scan[ctts::kScanWarps];
  const int unit = blockIdx.x;
  const int id = unit_id[unit];
  const int uid = max(id, 0);
  const int n = id >= 0 ? min(lengths[uid], UBUF) : 0;
  const float g = gains[uid];
  const float* row = bank + static_cast<size_t>(uid) * UBUF;
  const float* h = heads + static_cast<size_t>(unit) * CFMAX;
  const float* f = fi + static_cast<size_t>(unit) * CFMAX;
  float dcf = 0.0f;
  if (remove_dc) {
    int s = 0;
    for (int c = threadIdx.x; c < min(n, CFMAX); c += kThreads)
      s += static_cast<int>(h[c]);
    int head_total;
    ctts::block_excl_sum(s, s_scan, &head_total);
    const long long t = static_cast<long long>(head_total) + tail_total[unit];
    const long long q = (t < 0 ? -t : t) / max(n, 1);
    dcf = static_cast<float>(t > 0 ? q : -q);
  }
  const int fade = min(n, fade_in_samples);
  const bool fin = fade_in[unit] != 0;
  const float inv = __fdiv_rn(1.0f, static_cast<float>(max(fade, 1)));
  const int cf = cf_in[unit];
  float* o = contrib + static_cast<size_t>(unit) * W;
  for (int c = V * threadIdx.x; c < W; c += V * kThreads) {
    const bool head = c < CFMAX;
    float src[V], mix[V], out[V];
    if (c < n) load_v<V>(head ? h + c : row + c, src);
    const bool mixes = head && !fin && c < cf && c < n;
    if (mixes) load_v<V>(f + c, mix);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int cj = c + j;
      float x = 0.0f;
      if (cj < n) {
        x = head ? src[j] : q16(__fmul_rn(src[j], g));
        if (remove_dc) x = clamp16(__fsub_rn(x, dcf));
        if (fin && cj < fade)
          x = truncf(__fmul_rn(
              x, lut_lookup(lut_sine,
                            __fmul_rn(static_cast<float>(cj), inv))));
        if (mixes && cj < cf) x = __fmul_rn(x, mix[j]);
      }
      out[j] = x;
    }
    store_v<V>(o + c, out);
  }
}

// Whether every pointer allows float4 loads and stores.
bool aligned16(std::initializer_list<const float*> ptrs) {
  for (const float* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace

// bank [N, UBUF] f32, gains [N] f32, lengths [N] i32; unit_id, cf_in
// [units] i32 (units = B*U); lut_out, lut_in [1024] f32 (the fade-out
// and fade-in tables) -> heads, fo, fi [units, CFMAX] f32, hcols [units,
// HW] f32 (CFMAX <= HW <= max(UBUF, CFMAX)), tail_total [units] i32.
extern "C" int ctts_unit_base(const float* bank, const float* gains,
                              const int* lengths, const int* unit_id,
                              const int* cf_in, const float* lut_out,
                              const float* lut_in, float* heads,
                              float* hcols, int* tail_total, float* fo,
                              float* fi, int units, int UBUF, int CFMAX,
                              int HW, int remove_dc, cudaStream_t stream) {
  if (units <= 0) return 0;
  if (UBUF % 4 == 0 && CFMAX % 4 == 0 && HW % 4 == 0 &&
      aligned16({bank, heads, hcols, fo, fi}))
    unit_base_kernel<4><<<units, kThreads, 0, stream>>>(
        bank, gains, lengths, unit_id, cf_in, lut_out, lut_in, heads, hcols,
        tail_total, fo, fi, UBUF, CFMAX, HW, remove_dc);
  else
    unit_base_kernel<1><<<units, kThreads, 0, stream>>>(
        bank, gains, lengths, unit_id, cf_in, lut_out, lut_in, heads, hcols,
        tail_total, fo, fi, UBUF, CFMAX, HW, remove_dc);
  return static_cast<int>(cudaGetLastError());
}

// heads, fi [units, CFMAX] f32; bank, gains, lengths, unit_id, cf_in as
// above; fade_in [units] bool (one byte); tail_total [units] i32;
// lut_sine [1024] f32 -> contrib [units, W] f32, W = max(UBUF, CFMAX).
extern "C" int ctts_unit_contrib(const float* heads, const float* bank,
                                 const float* gains, const int* lengths,
                                 const int* unit_id, const int* cf_in,
                                 const unsigned char* fade_in,
                                 const int* tail_total, const float* fi,
                                 const float* lut_sine, float* contrib,
                                 int units, int UBUF, int CFMAX,
                                 int fade_in_samples, int remove_dc,
                                 cudaStream_t stream) {
  if (units <= 0) return 0;
  const int W = max(UBUF, CFMAX);
  if (UBUF % 4 == 0 && CFMAX % 4 == 0 &&
      aligned16({heads, bank, fi, contrib}))
    unit_contrib_kernel<4><<<units, kThreads, 0, stream>>>(
        heads, bank, gains, lengths, unit_id, cf_in, fade_in, tail_total, fi,
        lut_sine, contrib, UBUF, CFMAX, W, fade_in_samples, remove_dc);
  else
    unit_contrib_kernel<1><<<units, kThreads, 0, stream>>>(
        heads, bank, gains, lengths, unit_id, cf_in, fade_in, tail_total, fi,
        lut_sine, contrib, UBUF, CFMAX, W, fade_in_samples, remove_dc);
  return static_cast<int>(cudaGetLastError());
}
