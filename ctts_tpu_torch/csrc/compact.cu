// Silence-removal compaction: the memmove loop of
// remove_silence_regions (ctts.c:1634-1690).
//
// Replaces: ctts_tpu/ops/pallas/compact.py:89 compact_units (body
// _make_kernel :44). For every region r and kept segment s < NBLK with
// seg_len > 0 and starts != dst, copy seg_len samples from
// starts[s] to dst[s] inside the region's row of [R*WREG]; every other
// position keeps its content.
//
// Why out of place is exact: destinations ascend and never reach the
// next source (dst[s] + len[s] <= starts[s + 1], compact.py:10-18), so
// copying every segment from the untouched input gives the bits of the
// in-place sequence, and all moves can run at once.
//
// Bound on this card: pure data movement, one copy of the buffer plus
// the moved samples (~2 x 2 MB a sentence at the serving bucket), so
// HBM bandwidth. Simple for now: a device-to-device copy of the whole
// buffer, then one block per (region, segment) copying with coalesced
// 4-byte accesses; no vector loads, and segments whose length is far
// below the block size leave threads idle.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void compact_kernel(const float* __restrict__ in,
                               float* __restrict__ out,
                               const int* __restrict__ starts,
                               const int* __restrict__ dst,
                               const int* __restrict__ seg_len, int R,
                               int WREG, int NBLK) {
  const int b = blockIdx.y;
  const int t = blockIdx.x;  // r * NBLK + s
  const int r = t / NBLK;
  const size_t e = static_cast<size_t>(b) * R * NBLK + t;
  const int len = seg_len[e];
  const int s0 = starts[e];
  const int d0 = dst[e];
  if (len <= 0 || s0 == d0) return;
  const size_t row = (static_cast<size_t>(b) * R + r) * WREG;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    out[row + d0 + i] = in[row + s0 + i];
  }
}

}  // namespace

// in, out [B, R*WREG] f32; starts, dst, seg_len [B, R, NBLK] i32
// (region-local, MARGIN included).
extern "C" int ctts_compact(const float* in, float* out, const int* starts,
                            const int* dst, const int* seg_len, int B, int R,
                            int WREG, int NBLK, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(B) * R * WREG * sizeof(float);
  cudaError_t err =
      cudaMemcpyAsync(out, in, bytes, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && R * NBLK > 0) {
    compact_kernel<<<dim3(R * NBLK, B), kThreads, 0, stream>>>(
        in, out, starts, dst, seg_len, R, WREG, NBLK);
  }
  return static_cast<int>(cudaGetLastError());
}
