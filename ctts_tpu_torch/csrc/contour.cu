// Phrase-intonation pitch contour and the interrogative fall on every
// region row, in place: apply_smooth_pitch_contour (ctts.c:2206-2273;
// the port's oracle synth/dsp_np.py apply_smooth_pitch_contour) on the
// row's rise segment and on its question-final fall segment.
//
// Replaces: no pallas_call. On the TPU the stage was XLA ops: the
// compact frame workspace and the question-final while_loop of
// ctts_tpu/synth/device.py:1324-1565. The port's plain version
// (contour_plain in ops/hopper/contour.py, SynthesisCore._contour's
// body around dops.contour_zones) builds [B, K, 256] frame tensors,
// K = zone_slots(SMAX, 2R). This kernel computes what they compute, not
// the workspace:
//   per row: rise = trunc(cnt * 0.6f), split = rise > 100 && cnt - rise
//   > 100; segment 0 = [0, n0), n0 = do_dsp ? (qfinal && split ? rise :
//   cnt) : 0, factors c0 -> (qfinal && split ? c2 : c1); segment 1 =
//   [rise, cnt) when qfinal && do_dsp && active && split, factors c2 ->
//   c1. A segment of n samples with factors fs -> fe is active when
//   n >= 100 and |fs - fe| >= 0.01; frame m (pos = 128 m) runs when
//   pos + 256 <= n, with pf = fs + (fe - fs) * smoothstep(pos * inv),
//   inv = 1 / (n - 256) (inf at n == 256, so frame 0 is NaN there, as in
//   the C). Sample j of a frame is trunc(lerp * hann[j]), the lerp at
//   src = j * pf reading a = x[pos + idx] (0 at or past n) and, when
//   idx + 1 < 256, b = x[pos + idx + 1]. Position p of the segment is
//   the int16-wrapped sum of frame p/128 at p % 128 and frame p/128 - 1
//   at p % 128 + 128, divided by the sum of their Hann weights, q16'd,
//   and written where that sum exceeds 0.01.
// Every multiply and add is its own rounding (--fmad=false, and the
// _rn intrinsics spell it out), in the plain version's order; the Hann
// table comes from the host (ops/luts.py hann). Pitch factors must lie
// in [0, 1000] (the plan's are 1 +- max_pitch_change): a frame then
// reads only its own segment's samples at or after its start. A segment
// must lie inside its row (cnt <= WREG - MARGIN; the lowering keeps cnt
// <= CONTW); one that does not is left as it is.
//
// Bound on this card: bytes. The least work reads and writes each
// sample of an active segment once: ~8 bytes a sample (the serving
// batch's words are short; a full bucket of 144 x 114688 samples would
// be 0.13 GB, ~0.04 ms at 3.35 TB/s). The arithmetic, ~30 f32 ops a
// sample, is far below the CUDA cores' rate.
//
// Design: one block per region row; a row with no segment that runs a
// frame exits after reading its flags. A segment is swept left to
// right in chunks of kChunk output positions. A chunk's frames read
// from 128 samples before the chunk on (frame p/128 - 1 starts there),
// so the block stages that window of the original samples in shared
// memory, computes the chunk into registers, stages the next chunk's
// window (which overlaps this chunk's last 128 positions) and only
// then writes the chunk back: every read sees the input as it was,
// without an OLA buffer or a copy of the row. A read past the window
// (pitch factors above ~2.5) goes to device memory, where the sweep
// has not written yet. The rise writes only [0, rise) and the fall
// reads only [rise, cnt), so the two segments run one after the other.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrame = 256;
constexpr int kHop = 128;
constexpr int kChunk = 2048;                  // output positions a chunk
constexpr int kPer = kChunk / kThreads;       // positions a thread
constexpr int kReach = 512;                   // window past the chunk
constexpr int kWin = kHop + kChunk + kReach;  // samples a window
constexpr int kChunkFrames = kChunk / kHop + 1;

struct Segment {
  long long off;  // row-content offset of the segment
  long long n;    // its samples
  float fs, fe;
};

__device__ __forceinline__ bool runs(const Segment& s) {
  // Active (n >= 100, |fs - fe| >= 0.01) with at least one frame.
  return s.n >= kFrame && fabsf(__fsub_rn(s.fs, s.fe)) >= 0.01f;
}

// torch.clamp(x, -32768, 32767) then trunc; NaN stays NaN.
__device__ __forceinline__ float q16(float x) {
  if (isnan(x)) return x;
  return truncf(fminf(fmaxf(x, -32768.0f), 32767.0f));
}

// torch.remainder(x + 32768, 65536) - 32768: fmod, then the divisor's
// sign. On an integer-valued y below 2^31 fmod is C's integer %, the
// path every OLA sum takes (a sum of two truncated products).
__device__ __forceinline__ float wrap16(float x) {
  const float y = __fadd_rn(x, 32768.0f);
  float r;
  if (fabsf(y) < 2147483648.0f && truncf(y) == y) {
    r = static_cast<float>(static_cast<int>(y) % 65536);
  } else {
    r = fmodf(y, 65536.0f);
  }
  if (r != 0.0f && r < 0.0f) r = __fadd_rn(r, 65536.0f);
  return __fsub_rn(r, 32768.0f);
}

// Sweep one segment of the row (seg points at its first sample).
__device__ void contour_segment(float* __restrict__ seg, const Segment& s,
                                const float* s_hann, float* s_win,
                                float* s_pf) {
  const int t = threadIdx.x;
  const int n = static_cast<int>(s.n);  // it lies inside the row
  const float denom = static_cast<float>(n - kFrame);
  const float inv = denom != 0.0f ? __fdiv_rn(1.0f, denom) : INFINITY;
  const int frames = (n - kFrame) / kHop + 1;  // frames that run
  // Past frame `frames` no frame covers a position: norm is 0 there.
  const int qend = min(n, kHop * (frames + 1));

  // Stage chunk q0's window [q0 - 128, q0 - 128 + kWin) of the segment
  // and the pitch factors of frames q0/128 - 1 .. q0/128 + kChunk/128 - 1.
  auto stage = [&](int q0) {
    const int w0 = q0 - kHop;
    for (int w = t; w < kWin; w += kThreads) {
      const int p = w0 + w;
      s_win[w] = p >= 0 && p < n ? seg[p] : 0.0f;
    }
    if (t < kChunkFrames) {
      const int m = q0 / kHop - 1 + t;
      const float tt = __fmul_rn(static_cast<float>(kHop * m), inv);
      const float sm = __fmul_rn(__fmul_rn(tt, tt),
                                 __fsub_rn(3.0f, __fmul_rn(2.0f, tt)));
      s_pf[t] = __fadd_rn(s.fs, __fmul_rn(__fsub_rn(s.fe, s.fs), sm));
    }
  };

  // Frame m's sample j (a frame that runs), for chunk q0's window.
  auto contrib = [&](int q0, int m, int j) -> float {
    const float pf = s_pf[m - (q0 / kHop - 1)];
    const float src = __fmul_rn(static_cast<float>(j), pf);
    const int idx = static_cast<int>(src);
    const float frac = __fsub_rn(src, static_cast<float>(idx));
    const int pos = kHop * m;
    const int w0 = q0 - kHop;
    auto at = [&](int p) -> float {
      const int w = max(p - w0, 0);
      if (w < kWin) return s_win[w];
      return p < n ? seg[p] : 0.0f;  // not yet written by the sweep
    };
    // a reads 0 at or past n (pos + idx >= n, kept from overflowing).
    const float a = idx < n - pos ? at(pos + idx) : 0.0f;
    float sample = a;
    if (idx < kFrame - 1) {  // idx + 1 < 256: then pos + idx + 1 < n
      const float b = at(pos + idx + 1);
      sample = __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, frac)),
                         __fmul_rn(b, frac));
    }
    return truncf(__fmul_rn(sample, s_hann[j]));
  };

  stage(0);
  __syncthreads();
  for (int q0 = 0; q0 < qend; q0 += kChunk) {
    float val[kPer];
    bool put[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = q0 + k * kThreads + t;
      put[k] = false;
      val[k] = 0.0f;
      if (q >= qend) continue;
      const int m = q / kHop;
      const int i = q - m * kHop;
      float c1 = 0.0f, h1 = 0.0f, c2 = 0.0f, h2 = 0.0f;
      if (m < frames) {
        c1 = contrib(q0, m, i);
        h1 = s_hann[i];
      }
      if (m >= 1) {  // frame m - 1 runs: m - 1 < qend / 128 <= frames
        c2 = contrib(q0, m - 1, i + kHop);
        h2 = s_hann[i + kHop];
      }
      const float norm = __fadd_rn(h1, h2);
      if (norm > 0.01f) {
        val[k] = q16(__fdiv_rn(wrap16(__fadd_rn(c1, c2)), norm));
        put[k] = true;
      }
    }
    __syncthreads();  // every read of this window is done
    if (q0 + kChunk < qend) stage(q0 + kChunk);
    __syncthreads();  // the next window holds the samples as they were
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (put[k]) seg[q0 + k * kThreads + t] = val[k];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
contour_zones_kernel(float* __restrict__ bufs,
                     const long long* __restrict__ comp_lens,
                     const float* __restrict__ contour,
                     const unsigned char* __restrict__ qfinal,
                     const unsigned char* __restrict__ do_dsp,
                     const unsigned char* __restrict__ active,
                     const float* __restrict__ hann, int WREG, int MARGIN) {
  __shared__ float s_win[kWin];
  __shared__ float s_pf[kChunkFrames];
  __shared__ float s_hann[kFrame];

  const int row = blockIdx.x;
  const long long cnt = comp_lens[row];
  const float* c = contour + 5 * static_cast<size_t>(row);
  const long long rise =
      static_cast<long long>(__fmul_rn(static_cast<float>(cnt), 0.6f));
  const bool split = rise > 100 && cnt - rise > 100;
  const bool q = qfinal[row] != 0;
  const bool dsp = do_dsp[row] != 0;
  const bool split1 = q && split;
  Segment s0{0, dsp ? (split1 ? rise : cnt) : 0, c[0], split1 ? c[2] : c[1]};
  Segment s1{rise, q && dsp && active[row] != 0 && split ? cnt - rise : 0,
             c[2], c[1]};
  const bool run0 = runs(s0), run1 = runs(s1);
  if (!run0 && !run1) return;

  for (int j = threadIdx.x; j < kFrame; j += kThreads) s_hann[j] = hann[j];
  float* content = bufs + static_cast<size_t>(row) * WREG + MARGIN;
  const int width = WREG - MARGIN;  // what the row holds
  // A segment must lie in the row (the lowering keeps cnt <= CONTW).
  if (run0 && s0.n <= width) {
    contour_segment(content, s0, s_hann, s_win, s_pf);
  }
  if (run1 && s1.off + s1.n <= width) {
    contour_segment(content + s1.off, s1, s_hann, s_win, s_pf);
  }
}

}  // namespace

// bufs [B*R, WREG] f32, updated in place (region content at MARGIN);
// comp_lens [B*R] i64; contour [B*R, 5] f32 (ws, we, peak, es, ee);
// qfinal, do_dsp, active [B*R] bool (one byte); hann [256] f32.
extern "C" int ctts_contour_zones(float* bufs, const long long* comp_lens,
                                  const float* contour,
                                  const unsigned char* qfinal,
                                  const unsigned char* do_dsp,
                                  const unsigned char* active,
                                  const float* hann, int rows, int WREG,
                                  int MARGIN, cudaStream_t stream) {
  if (rows <= 0) return 0;
  contour_zones_kernel<<<rows, kThreads, 0, stream>>>(
      bufs, comp_lens, contour, qfinal, do_dsp, active, hann, WREG, MARGIN);
  return static_cast<int>(cudaGetLastError());
}
