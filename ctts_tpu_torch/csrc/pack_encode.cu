// The serving core's packed output: the valid prefixes of the rows of
// out [B, OM] int16 back to back and, with the wire codec, their
// encoding (ops/wire.py), in one pass that reads each valid sample once.
//
// Replaces: no pallas_call. On the TPU the packed tail of the compiled
// batch core (ctts_tpu/parallel/batch.py:75-100: a scan of B
// dynamic_update_slices into a zeroed B*OM buffer, the pad to whole
// blocks) and the wire encode (encode_device, ctts_tpu/ops/wire.py:48)
// were XLA ops. The port's plain version (pack_encode_plain in
// ops/hopper/pack_encode.py: pack_rows, the pad, wire.encode) makes
// ~10 int32 passes over all B*OM samples. This kernel computes, for the
// packed stream x (x[p] the p-th valid sample, 0 past the total and
// before position 0):
//   wire off: packed[p] = x[p] for p < total;
//   wire on, per block k of 512 positions: r[p] = x[p] - 2 x[p-1] +
//     x[p-2] (int32), z = (r << 1) ^ (r >> 31), class = 1 + (max z >
//     0xF) + (> 0xFF) + (> 0xFFF) + (> 0xFFFF); plane q < class of the
//     block is 64 words, word w holding nibble q of samples 8w..8w+7
//     (sample 8w+i at bits 4i), at word 64 * (the classes of the blocks
//     before k + q).
//
// Bound on this card: bytes (the valid samples read once, the words or
// packed samples and the classes written once).
//
// Design: one launch, a block of 8 warps per 4096 positions, a warp per
// wire block and 16 samples a lane (runs 8l..8l+7 and 256+8l..256+8l+7,
// the samples of words l and 32+l of each plane). Each block scans the
// row lengths into shared offsets; a lane finds the row of its run's
// first position by binary search and walks from there, so rows of
// length 0 or 1 and residuals that reach into earlier rows need no
// special case. With the codec the rank of each block's planes comes
// from a chained scan with decoupled look-back over the blocks, in the
// order they start (a counter hands out their indices): status words
// (flag, classes) a block, zeroed by the launcher. Blocks whose
// positions start 2 or more past the total hold zeros (residual 0,
// class 1): they write their classes and return without a look-back,
// and no earlier block waits on them.
#include <cuda_runtime.h>

#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kBlock = 512;      // WIRE_BLOCK
constexpr int kChunkW = 64;      // WIRE_CHUNK_W: words a plane of a block
constexpr int kWarps = ctts::kScanWarps;
constexpr int kThreads = ctts::kScanThreads;
constexpr int kSpan = kWarps * kBlock;   // positions a thread block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

// The row of packed position p < total: the first r with off[r + 1] >
// p (rows of length 0 are stepped over).
__device__ __forceinline__ int find_row(const int* off, int B, int p) {
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (off[mid + 1] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// x[q - 2 .. q + 7] of the packed stream.
__device__ __forceinline__ void load_run(const int16_t* __restrict__ out,
                                         const int* off, int B, int OM,
                                         int total, int q, int v[10]) {
  const int p0 = q - 2;
  int r = find_row(off, B, max(min(p0, total - 1), 0));
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int p = p0 + i;
    int x = 0;
    if (p >= 0 && p < total) {
      while (off[r + 1] <= p) ++r;
      x = out[static_cast<size_t>(r) * OM + (p - off[r])];
    }
    v[i] = x;
  }
}

__device__ __forceinline__ unsigned plane_word(const unsigned z[8], int q) {
  unsigned w = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) w |= ((z[i] >> (4 * q)) & 0xFu) << (4 * i);
  return w;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The classes of the blocks before `block` (warp 0 of the block; its
// own classes sum to `agg`), by decoupled look-back over `status`.
__device__ int look_back(unsigned long long* status, int block, int agg) {
  const int lane = threadIdx.x & 31;
  if (block == 0) {
    if (lane == 0)
      atomicExch(status, kInclusive | static_cast<unsigned>(agg));
    return 0;
  }
  if (lane == 0)
    atomicExch(status + block, kAggregate | static_cast<unsigned>(agg));
  int before = 0;
  int top = block - 1;
  while (true) {
    const int idx = top - lane;
    const unsigned long long s =
        idx >= 0 ? load_status(status + idx) : kInclusive;
    const unsigned flag = static_cast<unsigned>(s >> 32);
    const unsigned inclusive = __ballot_sync(kFull, flag == 2);
    const unsigned empty = __ballot_sync(kFull, flag == 0);
    const int first = inclusive ? __ffs(inclusive) - 1 : 31;
    const unsigned upto = first == 31 ? kFull : (2u << first) - 1u;
    if (empty & upto) continue;                // a predecessor not ready
    int v = (upto >> lane) & 1u ? static_cast<int>(s & 0xffffffffu) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    before += v;
    if (inclusive) break;
    top -= 32;
  }
  if (lane == 0)
    atomicExch(status + block,
               kInclusive | static_cast<unsigned>(before + agg));
  return before;
}

__global__ void __launch_bounds__(kThreads)
pack_encode_kernel(const int16_t* __restrict__ out,
                   const int* __restrict__ lens, int B, int OM, int nblk,
                   int wire, int16_t* __restrict__ packed,
                   unsigned* __restrict__ words, int* __restrict__ classes,
                   unsigned long long* __restrict__ status) {
  extern __shared__ int s_off[];             // [B + 1]
  __shared__ int s_scan[kWarps];
  __shared__ int s_cls[kWarps];
  __shared__ int s_block;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    s_block = wire ? static_cast<int>(atomicAdd(status, 1ull)) : blockIdx.x;
  // Exclusive offsets of the row lengths (clamped to [0, OM]).
  int carry = 0;
  for (int i0 = 0; i0 < B; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const int len = i < B ? min(max(lens[i], 0), OM) : 0;
    int tot;
    const int excl = ctts::block_excl_sum(len, s_scan, &tot);
    if (i < B) s_off[i] = carry + excl;
    carry += tot;
  }
  if (threadIdx.x == 0) s_off[B] = carry;
  __syncthreads();
  const int total = s_off[B];
  const int block = s_block;
  const int k = block * kWarps + warp;       // this warp's wire block
  const long long first = static_cast<long long>(block) * kSpan;

  if (!wire) {
    if (first >= total) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = k * kBlock + h * (kBlock / 2) + 8 * lane;
      if (q >= total) continue;
      int v[10];
      load_run(out, s_off, B, OM, total, q, v);
      if (q + 8 <= total) {
        int4 pk;
        pk.x = (v[2] & 0xffff) | (v[3] << 16);
        pk.y = (v[4] & 0xffff) | (v[5] << 16);
        pk.z = (v[6] & 0xffff) | (v[7] << 16);
        pk.w = (v[8] & 0xffff) | (v[9] << 16);
        *reinterpret_cast<int4*>(packed + q) = pk;
      } else {
        for (int i = 0; i < 8 && q + i < total; ++i)
          packed[q + i] = static_cast<int16_t>(v[i + 2]);
      }
    }
    return;
  }

  // Positions past total + 1 hold residual 0: class 1, nothing to rank.
  if (first >= static_cast<long long>(total) + 2) {
    if (lane == 0 && k < nblk) classes[k] = 1;
    return;
  }
  unsigned z[2][8];
  unsigned mx = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int v[10];
    load_run(out, s_off, B, OM, total,
             k * kBlock + h * (kBlock / 2) + 8 * lane, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = v[i + 2] - 2 * v[i + 1] + v[i];
      z[h][i] = static_cast<unsigned>((r << 1) ^ (r >> 31));
      mx = max(mx, z[h][i]);
    }
  }
  mx = __reduce_max_sync(kFull, mx);
  const int cls = k < nblk ? 1 + (mx > 0xFu) + (mx > 0xFFu) +
                                 (mx > 0xFFFu) + (mx > 0xFFFFu)
                           : 0;
  if (lane == 0) s_cls[warp] = cls;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < kWarps ? s_cls[lane] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int agg = __shfl_sync(kFull, incl, 31);
    const int before = look_back(status + 1, block, agg);
    if (lane < kWarps) s_cls[lane] = before + incl - c;
  }
  __syncthreads();
  if (k >= nblk) return;
  if (lane == 0) classes[k] = cls;
  unsigned* dst = words + static_cast<size_t>(s_cls[warp]) * kChunkW;
  for (int q = 0; q < cls; ++q) {
    dst[q * kChunkW + lane] = plane_word(z[0], q);
    dst[q * kChunkW + 32 + lane] = plane_word(z[1], q);
  }
}

}  // namespace

// out [B, OM] int16; lens [B] i32 (clamped to [0, OM]); nblk =
// ceil(B*OM / 512). Wire off: packed [B*OM] int16 gets the valid prefix
// (the rest is not written); words, classes and status are unused. Wire
// on: classes [nblk] i32 on every block, words [5 * 64 * nblk] i32 over
// the valid prefix (64 * sum(classes[:ceil(total / 512)]) words),
// status [ceil(nblk / 8) + 1] u64 scratch (zeroed here).
extern "C" int ctts_pack_encode(const int16_t* out, const int* lens,
                                int16_t* packed, unsigned* words,
                                int* classes, unsigned long long* status,
                                int B, int OM, int wire,
                                cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * OM;
  if (B <= 0 || OM <= 0) return 0;
  const int nblk = static_cast<int>((n + kBlock - 1) / kBlock);
  const int grid = (nblk + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int) * (B + 1);
  if (wire) {
    const cudaError_t err = cudaMemsetAsync(
        status, 0, sizeof(unsigned long long) * (grid + 1), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pack_encode_kernel<<<grid, kThreads, smem, stream>>>(
      out, lens, B, OM, nblk, wire, packed, words, classes, status);
  return static_cast<int>(cudaGetLastError());
}
