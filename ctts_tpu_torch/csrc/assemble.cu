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
// Bound on this card: one pass over the rows and one over the output
// (~2.5 MB a sentence at the serving bucket): HBM bandwidth. Simple
// for now: one thread per output sample scanning all R offsets from
// global memory (cached), no shared-memory staging of the tables.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void assemble_kernel(const float* __restrict__ bufs,
                                const int* __restrict__ offsets,
                                const int* __restrict__ live_len,
                                float* __restrict__ out, int R, int WREG,
                                int OUTW) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= OUTW) return;
  const int* off = offsets + static_cast<size_t>(b) * R;
  const int* live = live_len + static_cast<size_t>(b) * R;
  float acc = 0.0f;
  for (int r = 0; r < R; ++r) {
    const int j = p - off[r];
    if (j >= 0 && j < live[r] && j < WREG) {
      acc = __fadd_rn(acc, bufs[(static_cast<size_t>(b) * R + r) * WREG + j]);
    }
  }
  out[static_cast<size_t>(b) * OUTW + p] = acc;
}

}  // namespace

// bufs [B, R*WREG] f32; offsets, live_len [B, R] i32 -> out [B, OUTW].
extern "C" int ctts_assemble(const float* bufs, const int* offsets,
                             const int* live_len, float* out, int B, int R,
                             int WREG, int OUTW, cudaStream_t stream) {
  if (B > 0 && OUTW > 0) {
    const dim3 grid((OUTW + kThreads - 1) / kThreads, B);
    assemble_kernel<<<grid, kThreads, 0, stream>>>(bufs, offsets, live_len,
                                                   out, R, WREG, OUTW);
  }
  return static_cast<int>(cudaGetLastError());
}
