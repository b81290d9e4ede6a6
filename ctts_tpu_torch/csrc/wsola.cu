// WSOLA frame chain for speed != 1.0 (ctts.c:3436-3488 search,
// 3506-3566 frame loop).
//
// Replaces: ctts_tpu/ops/pallas/wsola.py:515 wsola_frames_batch (body
// _make_batch_kernel :404) and :573 wsola_frames (body _make_kernel
// :360). The TPU kernels get exact correlations out of bf16 MXU passes
// (hi/lo splits, stride-4 circulants, TwoSum) and run S sentences in
// lockstep to hide latency; here one block runs one sentence's chain to
// its own run count, for k < nrun in frame order:
//   1. tail = the 384 samples at the previous chosen position + AHOP;
//   2. coarse search over offsets -128..128 step 4: num = the exact
//      integer sum of tail * candidate (int32 products, int64 sums,
//      rounded once with __ll2float_rn), sq1/sq2 from the exact energy
//      table, corr = denom < 1 ? 0 : num / denom with denom =
//      sqrt(sq1 * sq2) -- a separate f32 multiply, then __fsqrt_rn and
//      __fdiv_rn, correctly rounded like XLA:CPU and the NumPy oracle.
//      Invalid candidates are -inf (and skipped); earliest max wins;
//      none valid -> offset 0, best -2;
//   3. fine search +-1..3 around it, taken only on a strict '>';
//   4. offset 0 at k = 0; clamp the frame into [0, input_count - 512];
//   5. trunc(frame * hann) added to acc and hann to norm at k * hop.
// The OLA adds of frame k finish before frame k+1 starts
// (__syncthreads), so every output position sums its frames in
// ascending k from 0.0f -- the Pallas kernel's order. acc holds exact
// integers (< 2^19); the caller wraps them to int16 once.
//
// Bound on this card: a chain of up to ~894 dependent frames per
// sentence (max_steps at SMAX 114688), ~71 x 384 multiply-adds and 512
// output updates each: latency, not bytes or operations. One block per
// sentence (B = 128 is one wave on 132 SMs); the 768-sample window of a
// step sits in shared memory as int32; one warp per candidate (16
// warps: the 65 coarse candidates in 5 rounds, the 6 fine ones in one).
// Simple for now: no prefetch of the next step's window or energies,
// acc/norm read-modify-written in global memory (L2), no TMA.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kFrame = 512;
constexpr int kAhop = 128;
constexpr int kOverlap = kFrame - kAhop;            // 384
constexpr int kMaxShift = 128;
constexpr int kWin = kFrame + 2 * kMaxShift;        // 768
constexpr int kNCoarse = 65;                        // -128..128 step 4
constexpr int kNFine = 6;                           // -3..3 without 0
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Normalized correlation of win[j, j + 384) with the tail; one warp,
// every lane returns the result.
__device__ __forceinline__ float corr_at(const int* win, const int* tail,
                                         int j, float sq1, float sq2,
                                         int lane) {
  long long s = 0;
  for (int i = lane; i < kOverlap; i += 32) {
    s += static_cast<long long>(win[j + i] * tail[i]);  // |.| <= 2^30
  }
  s = warp_sum(s);
  const float num = __ll2float_rn(s);
  const float denom = __fsqrt_rn(__fmul_rn(sq1, sq2));
  return denom < 1.0f ? 0.0f : __fdiv_rn(num, denom);
}

// Candidate at window index j (offset j - 128) is valid when its frame
// lies inside [0, ic).
__device__ __forceinline__ bool valid_at(int nominal, int j, int ic) {
  const int pos = nominal + j - kMaxShift;
  return pos >= 0 && pos + kFrame <= ic;
}

__global__ void __launch_bounds__(kThreads)
wsola_frames_kernel(const float* __restrict__ inp,
                    const float* __restrict__ sq,
                    const int* __restrict__ input_count,
                    const int* __restrict__ nrun,
                    const float* __restrict__ window,
                    float* __restrict__ acc, float* __restrict__ norm,
                    int S, int hop, int out_size) {
  __shared__ int win[kWin];
  __shared__ float hann[kFrame];
  __shared__ float corr_c[kNCoarse];
  __shared__ float corr_f[kNFine];
  __shared__ int s_best_off;
  __shared__ float s_best;
  __shared__ int s_qo;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x;
  const float* x = inp + static_cast<size_t>(b) * S;
  const float* sqb = sq + static_cast<size_t>(b) * S;
  float* ab = acc + static_cast<size_t>(b) * out_size;
  float* nb = norm + static_cast<size_t>(b) * out_size;
  const int ic = min(input_count[b], S);
  const int nr = nrun[b];

  for (int p = tid; p < out_size; p += kThreads) {
    ab[p] = 0.0f;
    nb[p] = 0.0f;
  }
  for (int i = tid; i < kFrame; i += kThreads) hann[i] = window[i];
  __syncthreads();

  int qo_prev = 0;  // window index of the previous frame's tail
  for (int k = 0; k < nr; ++k) {
    const int nominal = k * kAhop;
    for (int j = tid; j < kWin; j += kThreads) {
      const int p = nominal - kMaxShift + j;
      win[j] = (p >= 0 && p < S) ? static_cast<int>(x[p]) : 0;
    }
    __syncthreads();

    if (k > 0) {
      const int* tail = win + qo_prev;
      const int tpos = nominal - kMaxShift + qo_prev;
      const float sq2 = (tpos >= 0 && tpos < S) ? sqb[tpos] : 0.0f;
      for (int c = warp; c < kNCoarse; c += kWarps) {
        const int j = 4 * c;
        float v = -CUDART_INF_F;
        if (valid_at(nominal, j, ic)) {
          v = corr_at(win, tail, j, sqb[nominal - kMaxShift + j], sq2, lane);
        }
        if (lane == 0) corr_c[c] = v;
      }
      __syncthreads();

      if (warp == 0) {  // earliest coarse max
        float bv = -CUDART_INF_F;
        int bi = kNCoarse;
        for (int c = lane; c < kNCoarse; c += 32) {
          const float v = corr_c[c];
          if (v > bv || (v == bv && c < bi)) {
            bv = v;
            bi = c;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          const bool none = bv == -CUDART_INF_F;
          s_best_off = none ? 0 : 4 * bi - kMaxShift;
          s_best = none ? -2.0f : bv;
        }
      }
      __syncthreads();

      const int best_off = s_best_off;
      if (warp < kNFine) {
        const int rel = warp < 3 ? warp - 3 : warp - 2;
        const int j = best_off + kMaxShift + rel;
        float v = -CUDART_INF_F;
        if (j >= 0 && j <= 2 * kMaxShift && valid_at(nominal, j, ic)) {
          v = corr_at(win, tail, j, sqb[nominal - kMaxShift + j], sq2, lane);
        }
        if (lane == 0) corr_f[warp] = v;
      }
      __syncthreads();
    }

    if (tid == 0) {
      int off = 0;
      if (k > 0) {
        float bv = corr_f[0];
        int bw = 0;
        for (int w = 1; w < kNFine; ++w) {
          if (corr_f[w] > bv) {
            bv = corr_f[w];
            bw = w;
          }
        }
        off = s_best_off;
        if (bv > s_best) off += bw < 3 ? bw - 3 : bw - 2;
      }
      int actual = nominal + off;
      if (actual + kFrame > ic) actual = ic - kFrame;
      actual = max(actual, 0);
      s_qo = min(max(actual - nominal + kMaxShift, 0), 2 * kMaxShift);
    }
    __syncthreads();

    const int qo = s_qo;
    const int base = k * hop;
    for (int i = tid; i < kFrame; i += kThreads) {
      const int p = base + i;
      if (p < out_size) {
        const float c = truncf(__fmul_rn(static_cast<float>(win[qo + i]),
                                         hann[i]));
        ab[p] = __fadd_rn(ab[p], c);
        nb[p] = __fadd_rn(nb[p], hann[i]);
      }
    }
    qo_prev = qo;
    __syncthreads();
  }
}

// Latency floor of the frame chain (a microbenchmark; not on the
// serving path). Per frame it keeps only the steps that wait on the
// previous frame's choice: every warp scores one candidate against the
// tail at the chosen index (12 int32 products a lane from shared
// memory, an int64 warp sum, __fsqrt_rn and __fdiv_rn), warp 0 takes
// the earliest max, six warps score the fine candidates, one thread
// decides -- four block barriers. The kernel's frame adds four more
// coarse rounds a warp, the window load and the OLA; with_load puts the
// window load from global memory back. Block b runs nrun[b] frames and
// writes its last tail index to out[b].
__global__ void __launch_bounds__(kThreads)
wsola_chain_floor_kernel(const float* __restrict__ inp,
                         const int* __restrict__ nrun,
                         int* __restrict__ out, int S, int with_load) {
  __shared__ int win[kWin];
  __shared__ float score[kWarps];
  __shared__ int s_j;
  __shared__ int s_qo;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* x = inp + static_cast<size_t>(blockIdx.x) * S;
  const int nr = nrun[blockIdx.x];
  const float sq = S > 0 ? 1.0f + fabsf(x[0]) : 1.0f;

  int qo = kMaxShift;
  for (int k = 0; k < nr; ++k) {
    if (k == 0 || with_load) {
      const int nominal = with_load ? k * kAhop : 0;
      for (int j = tid; j < kWin; j += kThreads) {
        const int p = nominal - kMaxShift + j;
        win[j] = (p >= 0 && p < S) ? static_cast<int>(x[p]) : 0;
      }
      __syncthreads();
    }
    const int* tail = win + qo;
    const float v = corr_at(win, tail, 4 * warp, sq, sq, lane);
    if (lane == 0) score[warp] = v;
    __syncthreads();

    if (warp == 0) {
      float bv = lane < kWarps ? score[lane] : -CUDART_INF_F;
      int bi = lane;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) s_j = 4 * bi;
    }
    __syncthreads();

    if (warp < kNFine) {
      const float f = corr_at(win, tail, s_j + warp, sq, sq, lane);
      if (lane == 0) score[warp] = f;
    }
    __syncthreads();

    if (tid == 0) {
      int bw = 0;
      for (int w = 1; w < kNFine; ++w) {
        if (score[w] > score[bw]) bw = w;
      }
      s_qo = s_j + bw;
    }
    __syncthreads();
    qo = s_qo;
  }
  if (tid == 0) out[blockIdx.x] = qo;
}

}  // namespace

// inp, sq [B, S] f32; input_count, nrun [B] i32; window [512] f32
// -> acc, norm [B, out_size] f32.
extern "C" int ctts_wsola_frames(const float* inp, const float* sq,
                                 const int* input_count, const int* nrun,
                                 const float* window, float* acc,
                                 float* norm, int B, int S, int hop,
                                 int out_size, cudaStream_t stream) {
  if (B > 0) {
    wsola_frames_kernel<<<B, kThreads, 0, stream>>>(
        inp, sq, input_count, nrun, window, acc, norm, S, hop, out_size);
  }
  return static_cast<int>(cudaGetLastError());
}

// inp [B, S] f32, nrun [B] i32 -> out [B] i32 (the chain floor above).
extern "C" int ctts_wsola_chain_floor(const float* inp, const int* nrun,
                                      int* out, int B, int S, int with_load,
                                      cudaStream_t stream) {
  if (B > 0) {
    wsola_chain_floor_kernel<<<B, kThreads, 0, stream>>>(inp, nrun, out, S,
                                                         with_load);
  }
  return static_cast<int>(cudaGetLastError());
}
