// region_post on every region row, in place: the energy ramp of
// apply_phrase_intonation (ctts.c:2841-2865), then the region's tail
// fade (apply_fade_out, ctts.c:3028-3039), on the content after the
// contour.
//
// Replaces: no pallas_call. On the TPU the stage was XLA ops: the
// vmapped region_post of ctts_tpu/synth/device.py:1567-1593, which ramps
// and masks all B*R*CONTW content samples and rewrites every row. The
// port's plain version (region_post_plain in ops/hopper/region_post.py,
// SynthesisCore._region_post's body around dops.tail_fade_window) does
// the same. This kernel computes, per row of cnt samples:
//   ramp, on j < cnt where do_dsp && energy && cnt >= 100:
//     x = q16(x * (es + (ee - es) * (j / max(cnt - 1, 1))));
//   fade, fade = min(fade_after, before + cnt) (before: the samples of
//     the sentence ahead of the row), on the positions p of [cnt - fade,
//     cnt) inside the W2-wide window that ends at cnt (or starts at 0):
//     x = trunc(x * sine_fade(((fade - (p - (cnt - fade))) * (1/fade)))),
//     the LUT lerp of ops/luts.py with its table from the host.
// Every multiply and add is its own rounding (--fmad=false and the _rn
// intrinsics), the division and reciprocal correctly rounded, in the
// plain version's order.
//
// Bound on this card: bytes. The least work reads and writes each
// sample that is ramped or faded once (8 bytes) and reads the row's
// flags; the serving batch's words are short.
//
// Design: one block per region row, one pass: each position is ramped,
// then faded on the ramped value, then stored once. A row with neither
// a ramp nor a fade exits after reading its flags and writes nothing
// (the XLA form read and rewrote every row).
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLut = 1024;  // FADE_LUT_SIZE
constexpr int kUnroll = 4;

__device__ __forceinline__ float q16(float x) {
  if (isnan(x)) return x;
  return truncf(fminf(fmaxf(x, -32768.0f), 32767.0f));
}

// fast_fade_* lookup with linear interpolation (ops/luts.py).
__device__ __forceinline__ float lut_lookup(const float* lut, float t) {
  const float idx_f = __fmul_rn(t, static_cast<float>(kLut - 1));
  const int idx = static_cast<int>(idx_f);
  if (idx < 0) return lut[0];
  if (idx >= kLut - 1) return lut[kLut - 1];
  const float frac = __fsub_rn(idx_f, static_cast<float>(idx));
  return __fadd_rn(__fmul_rn(lut[idx], __fsub_rn(1.0f, frac)),
                   __fmul_rn(lut[idx + 1], frac));
}

__global__ void __launch_bounds__(kThreads)
region_post_kernel(float* __restrict__ bufs,
                   const long long* __restrict__ comp_lens,
                   const long long* __restrict__ before,
                   const float* __restrict__ contour,
                   const unsigned char* __restrict__ do_dsp,
                   const unsigned char* __restrict__ energy,
                   const int* __restrict__ fade_after,
                   const float* __restrict__ lut, int WREG, int MARGIN,
                   int CONTW, int W2) {
  __shared__ float s_lut[kLut];
  const int row = blockIdx.x;
  const long long cnt = comp_lens[row];
  const bool ramp = do_dsp[row] != 0 && energy[row] != 0 && cnt >= 100;
  const long long ramp_end = ramp ? min(cnt, static_cast<long long>(CONTW))
                                  : 0;
  // The fade: [lo, cnt) of the window [max(cnt - W2, 0), ... + W2).
  const long long fade =
      min(static_cast<long long>(fade_after[row]), cnt + before[row]);
  const long long start = cnt - fade;
  const long long lo = max(start, max(cnt - W2, 0LL));
  const long long fade_end =
      fade > 0 ? min(cnt, static_cast<long long>(CONTW)) : 0;
  const long long fade_lo = fade > 0 ? lo : fade_end;
  if (ramp_end <= 0 && fade_lo >= fade_end) return;

  for (int j = threadIdx.x; j < kLut; j += kThreads) s_lut[j] = lut[j];
  __syncthreads();
  float* x = bufs + static_cast<size_t>(row) * WREG + MARGIN;
  const float* c = contour + 5 * static_cast<size_t>(row);
  const float es = c[3], ee = c[4];
  const float de = __fsub_rn(ee, es);
  const float span = static_cast<float>(max(cnt - 1, 1LL));
  const float ffade = static_cast<float>(fade);
  const float inv = __frcp_rn(static_cast<float>(max(fade, 1LL)));
  // Positions [from, to) of the row (at most CONTW), kUnroll loads in
  // flight a thread.
  const int from = static_cast<int>(ramp_end > 0 ? 0 : fade_lo);
  const int to = static_cast<int>(max(ramp_end, fade_end));
  for (int base = from + threadIdx.x; base < to;
       base += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kThreads;
      v[u] = p < to ? x[p] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kThreads;
      const bool in_ramp = p < ramp_end;
      const bool in_fade = p >= fade_lo && p < fade_end;
      if (!in_ramp && !in_fade) continue;
      if (in_ramp) {
        const float te = __fdiv_rn(static_cast<float>(p), span);
        v[u] = q16(__fmul_rn(v[u], __fadd_rn(es, __fmul_rn(de, te))));
      }
      if (in_fade) {
        const float rel = static_cast<float>(p - start);
        const float t = __fmul_rn(__fsub_rn(ffade, rel), inv);
        v[u] = truncf(__fmul_rn(v[u], lut_lookup(s_lut, t)));
      }
      x[p] = v[u];
    }
  }
}

}  // namespace

// bufs [B*R, WREG] f32, updated in place (region content at MARGIN,
// CONTW wide); comp_lens, before [B*R] i64; contour [B*R, 5] f32 (es,
// ee at 3, 4); do_dsp, energy [B*R] bool (one byte); fade_after [B*R]
// i32; lut [1024] f32, the sine-fade table; W2 the tail-fade window.
extern "C" int ctts_region_post(float* bufs, const long long* comp_lens,
                                const long long* before,
                                const float* contour,
                                const unsigned char* do_dsp,
                                const unsigned char* energy,
                                const int* fade_after, const float* lut,
                                int rows, int WREG, int MARGIN, int CONTW,
                                int W2, cudaStream_t stream) {
  if (rows <= 0) return 0;
  region_post_kernel<<<rows, kThreads, 0, stream>>>(
      bufs, comp_lens, before, contour, do_dsp, energy, fade_after, lut,
      WREG, MARGIN, CONTW, W2);
  return static_cast<int>(cudaGetLastError());
}
