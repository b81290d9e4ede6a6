// Sequential unit placement (compose) for the refine loop
// (ctts.c:3279-3358 crossfade overlap placement).
//
// Replaces: ctts_tpu/ops/pallas/compose.py:145 compose_units (body
// _make_kernel :81). For each sentence, units k = 0..U-1 are placed in
// order into the flat [R*WREG] region buffer at base_off[k]:
//   - with export, first copy the pre-merge windows
//       seg[k]  = buf[off + cf - ana, +512)   (pitch analysis segment)
//       tail[k] = buf[off + cf - CFMAX, off + cf)   (energy tail)
//   - then for i < n_eff[k]: buf[off + i] = contrib[k][i], except the
//     crossfade prefix i < cf, which becomes
//       trunc(clip(trunc(buf[off+i] * fo[k][i] + contrib[k][i])))
//     with the multiply and the add rounded separately (__fmul_rn,
//     __fadd_rn; the build also passes --fmad=false).
// Inactive slots (n_eff == 0) are skipped; their exports stay as the
// wrapper's zero fill.
//
// Bound on this card: unit k + 1's windows can read unit k's write, so
// units run in series inside one block per sentence, separated by
// __syncthreads(); each unit's window is spread over the block's
// threads. The buffer (2 MB a sentence at the serving bucket) lives in
// global memory, far beyond 227 KB of shared memory, and the work is a
// few MB of coalesced traffic per sentence: latency-bound, with B
// blocks on 132 SMs. Simple for now: no staging in shared memory, no
// overlap of one unit's loads with the previous unit's stores.
#include <cuda_runtime.h>

namespace {

constexpr int kSegW = 512;
constexpr int kThreads = 1024;

__global__ void compose_kernel(const float* __restrict__ contrib,
                               const float* __restrict__ fo,
                               const int* __restrict__ base_off,
                               const int* __restrict__ cf_in,
                               const int* __restrict__ n_eff,
                               const int* __restrict__ ana,
                               float* buf, float* __restrict__ seg,
                               float* __restrict__ tail, int U, int UBUF,
                               int CFMAX, int TOT, int do_export) {
  const int b = blockIdx.x;
  float* flat = buf + static_cast<size_t>(b) * TOT;
  for (int k = 0; k < U; ++k) {
    const size_t slot = static_cast<size_t>(b) * U + k;
    const int n = n_eff[slot];
    if (n <= 0) continue;  // the same for every thread of the block
    const int off = base_off[slot];
    const int cf = cf_in[slot];
    if (do_export) {
      const float* sp = flat + off + cf - ana[slot];
      float* so = seg + slot * kSegW;
      for (int i = threadIdx.x; i < kSegW; i += blockDim.x) so[i] = sp[i];
      const float* tp = flat + off + cf - CFMAX;
      float* to = tail + slot * CFMAX;
      for (int i = threadIdx.x; i < CFMAX; i += blockDim.x) to[i] = tp[i];
      __syncthreads();  // exports read the buffer before the merge
    }
    const float* x = contrib + slot * UBUF;
    const float* f = fo + slot * CFMAX;
    float* w = flat + off;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float v = x[i];
      if (i < cf) {
        float m = truncf(__fadd_rn(__fmul_rn(w[i], f[i]), v));
        v = truncf(fminf(fmaxf(m, -32768.0f), 32767.0f));
      }
      w[i] = v;
    }
    __syncthreads();  // the next unit reads this unit's writes
  }
}

}  // namespace

// contrib [B,U,UBUF], fo [B,U,CFMAX] f32; base_off, cf_in, n_eff, ana
// [B,U] i32; buf [B,TOT] (zero-filled by the caller), seg [B,U,512],
// tail [B,U,CFMAX] f32.
extern "C" int ctts_compose(const float* contrib, const float* fo,
                            const int* base_off, const int* cf_in,
                            const int* n_eff, const int* ana, float* buf,
                            float* seg, float* tail, int B, int U, int UBUF,
                            int CFMAX, int TOT, int do_export,
                            cudaStream_t stream) {
  if (B > 0) {
    compose_kernel<<<B, kThreads, 0, stream>>>(
        contrib, fo, base_off, cf_in, n_eff, ana, buf, seg, tail, U, UBUF,
        CFMAX, TOT, do_export);
  }
  return static_cast<int>(cudaGetLastError());
}
