// Unit placement (compose) for the refine loop (ctts.c:3279-3358
// crossfade overlap placement).
//
// Replaces: ctts_tpu/ops/pallas/compose.py:145 compose_units (body
// _make_kernel :81). The reference places units k = 0..U-1 of each
// sentence in order into its flat [R*WREG] buffer at base_off[k]: for
// i < n_eff[k], buf[off + i] = contrib[k][i], except the crossfade
// prefix i < cf, which becomes
//   trunc(clip(trunc(buf[off+i] * fo[k][i] + contrib[k][i])))
// (multiply and add rounded apart: __fmul_rn, __fadd_rn, --fmad=false).
// With export, unit k first copies the pre-merge windows
//   seg[k]  = buf[off + cf - ana, +512)   (pitch analysis segment)
//   tail[k] = buf[off + cf - CFMAX, off + cf)   (energy tail).
// Inactive slots (n_eff == 0) change nothing and export zeros.
//
// Here placement is a function of position: the value at p starts from
// 0.0f and applies, in ascending k, every active unit with
// off_k <= p < off_k + n_eff[k] -- the same f32 operations in the same
// order as the sequential walk, so the bits are equal for any overlap.
// An export of unit k is the same walk over the units before k.
//
// Bound on this card: bytes. Every position of the 2 MB-a-sentence
// buffer is written once (0.0f where no unit covers it; no zero fill),
// and each unit's contribution and fade are read where they land. The
// grid is (position chunk or export, sentence). A warp holds 512
// positions (16 a lane), lists the units that reach them with a ballot
// and walks that list once, its 16 loads of a unit in flight together.
// Nothing waits on another warp: no barrier, no shared memory. It
// writes the buffer at about two thirds of the rate of a plain zero
// fill of it (chip_smoke.py phase 4).
#include <cuda_runtime.h>

namespace {

constexpr int kSegW = 512;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                    // positions a lane holds
constexpr int kWarpSpan = 32 * kPer;        // positions a warp holds
constexpr int kChunk = kWarps * kWarpSpan;  // buffer positions a block writes
constexpr unsigned kFull = 0xffffffffu;

// Logical index q of a block's positions -> flat position: a buffer
// chunk from lo, or an export (seg then tail).
struct Span {
  int lo, s0, t0, seg_w;
  __device__ int pos(int q) const {
    return seg_w == 0 ? lo + q : (q < seg_w ? s0 + q : t0 + q - seg_w);
  }
};

// One warp: the values at span positions q0 + lane + 32e (e < kPer,
// q < nq) after the active units before ku. The warp lists the units
// that reach its positions by a ballot over 32 slots at a time and
// walks them in order; for each unit a lane's kPer loads have no
// branch between them, so they are all in flight at once.
__device__ __forceinline__ void warp_walk(
    const Span& sp, int q0, int nq, int ku, const int* base_off,
    const int* cf_in, const int* n_eff, const float* contrib,
    const float* fo, size_t slot0, int UBUF, int CFMAX, int lane,
    float* v) {
  int p[kPer];
  int pmin = 0x7fffffff, pmax = -0x7fffffff;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    p[e] = sp.pos(q0 + lane + 32 * e);
    v[e] = 0.0f;
    if (q0 + lane + 32 * e < nq) {
      pmin = min(pmin, p[e]);
      pmax = max(pmax, p[e]);
    }
  }
  pmin = __reduce_min_sync(kFull, pmin);
  pmax = __reduce_max_sync(kFull, pmax);
  for (int k0 = 0; k0 < ku; k0 += 32) {
    const int k = k0 + lane;
    int off = 0, n = 0, cf = 0;
    if (k < ku) {
      off = base_off[slot0 + k];
      n = min(n_eff[slot0 + k], UBUF);
      cf = min(cf_in[slot0 + k], min(n, CFMAX));
    }
    unsigned hits = __ballot_sync(kFull, n > 0 && off <= pmax &&
                                             off + n > pmin);
    while (hits) {
      const int src = __ffs(hits) - 1;
      hits &= hits - 1;
      const int uoff = __shfl_sync(kFull, off, src);
      const int un = __shfl_sync(kFull, n, src);
      const int ucf = __shfl_sync(kFull, cf, src);
      const size_t slot = slot0 + k0 + src;
      const float* x = contrib + slot * UBUF;
      const float* f = fo + slot * CFMAX;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = p[e] - uoff;
        const bool in = i >= 0 && i < un && q0 + lane + 32 * e < nq;
        const bool mix = in && i < ucf;
        const float xv = x[min(max(i, 0), un - 1)];
        const float fv = mix ? f[i] : 0.0f;
        const float m = truncf(__fadd_rn(__fmul_rn(v[e], fv), xv));
        const float mixed = truncf(fminf(fmaxf(m, -32768.0f), 32767.0f));
        v[e] = mix ? mixed : (in ? xv : v[e]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
compose_kernel(const float* __restrict__ contrib,
               const float* __restrict__ fo,
               const int* __restrict__ base_off,
               const int* __restrict__ cf_in,
               const int* __restrict__ n_eff, const int* __restrict__ ana,
               float* __restrict__ buf, float* __restrict__ seg,
               float* __restrict__ tail, int U, int UBUF, int CFMAX,
               int TOT, int nchunks) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const size_t slot0 = static_cast<size_t>(b) * U;
  float v[kPer];
  if (static_cast<int>(blockIdx.x) < nchunks) {  // a buffer chunk
    const int lo = blockIdx.x * kChunk;
    const int q0 = warp * kWarpSpan;
    const int nq = min(kChunk, TOT - lo);
    if (q0 >= nq) return;
    warp_walk(Span{lo, 0, 0, 0}, q0, nq, U, base_off, cf_in, n_eff, contrib,
              fo, slot0, UBUF, CFMAX, lane, v);
    float* out = buf + static_cast<size_t>(b) * TOT + lo;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int q = q0 + lane + 32 * e;
      if (q < nq) out[q] = v[e];
    }
    return;
  }
  // Unit ku's exports: the walk over the units before it at its two
  // pre-merge windows (zeros for an inactive slot).
  const int ku = blockIdx.x - nchunks;
  const size_t slot = slot0 + ku;
  const int cf = cf_in[slot];
  const Span sp{0, base_off[slot] + cf - ana[slot],
                base_off[slot] + cf - CFMAX, kSegW};
  const int units = n_eff[slot] > 0 ? ku : 0;
  const int nq = kSegW + CFMAX;
  for (int q0 = warp * kWarpSpan; q0 < nq; q0 += kChunk) {
    warp_walk(sp, q0, nq, units, base_off, cf_in, n_eff, contrib, fo, slot0,
              UBUF, CFMAX, lane, v);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int q = q0 + lane + 32 * e;
      if (q >= nq) break;
      if (q < kSegW) {
        seg[slot * kSegW + q] = v[e];
      } else {
        tail[slot * CFMAX + q - kSegW] = v[e];
      }
    }
  }
}

}  // namespace

// contrib [B,U,UBUF], fo [B,U,CFMAX] f32; base_off, cf_in, n_eff, ana
// [B,U] i32 -> buf [B,TOT], and with do_export seg [B,U,512] and tail
// [B,U,CFMAX] f32; every element of each is written.
extern "C" int ctts_compose(const float* contrib, const float* fo,
                            const int* base_off, const int* cf_in,
                            const int* n_eff, const int* ana, float* buf,
                            float* seg, float* tail, int B, int U, int UBUF,
                            int CFMAX, int TOT, int do_export,
                            cudaStream_t stream) {
  if (B > 0) {
    const int nchunks = (TOT + kChunk - 1) / kChunk;
    const dim3 grid(nchunks + (do_export ? U : 0), B);
    compose_kernel<<<grid, kThreads, 0, stream>>>(
        contrib, fo, base_off, cf_in, n_eff, ana, buf, seg, tail, U, UBUF,
        CFMAX, TOT, nchunks);
  }
  return static_cast<int>(cudaGetLastError());
}
