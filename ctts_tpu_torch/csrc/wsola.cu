// WSOLA frame chain for speed != 1.0 (ctts.c:3436-3488 search,
// 3506-3566 frame loop).
//
// Replaces: ctts_tpu/ops/pallas/wsola.py:515 wsola_frames_batch (body
// _make_batch_kernel :404) and :573 wsola_frames (body _make_kernel
// :360). The TPU kernels get exact correlations out of bf16 MXU passes
// (hi/lo splits, stride-4 circulants, TwoSum) and run S sentences in
// lockstep to hide latency. Here the work is split in two launches:
//
// decide: one block per sentence runs its chain of frames k < nrun and
//   writes only each frame's chosen input position to pos [B, max_steps]
//   (-1 past nrun). Frame k's tail is the 384 samples at the previous
//   chosen position + AHOP; the coarse search takes the earliest max of
//   the normalized correlation over offsets -128..128 step 4 (invalid
//   candidates skipped; none valid -> offset 0, best -2); the fine
//   search tries +-1..3 around it and moves only on a strict '>'; k = 0
//   takes offset 0; the frame is clamped into [0, input_count - 512].
//   num is the exact integer sum of tail * candidate, rounded once with
//   __ll2float_rn; denom = sqrt(sq1 * sq2) is a separate f32 multiply,
//   then __fsqrt_rn and __fdiv_rn (correctly rounded, like XLA:CPU and
//   the NumPy oracle); corr = denom < 1 ? 0 : num / denom.
// emit: one thread per output sample adds its <= ceil(512 / hop) frames
//   in ascending k from 0.0f -- trunc(x * hann) to acc and hann to
//   norm, each multiply and add rounded apart (--fmad=false) -- and
//   writes both once. That is the add sequence of the Pallas kernel and
//   of the plain version, so the bits are the same. acc holds exact
//   integers (< 2^19); the caller wraps them to int16 once.
//
// Bound on this card: a chain of up to ~894 dependent frames per
// sentence (max_steps at SMAX 114688), 71 x 384 multiply-adds each:
// latency, not bytes or operations. What the decide block (13 warps)
// does about it:
//   - nothing in the chain waits on device memory. The sentence streams
//     through a 2048-sample ring in shared memory (int32 samples, f32
//     energies, and byte planes of each 4-sample group): every 4 frames
//     the warps past the fine search issue cp.async for the 512 samples
//     and energies needed 4 frames later, and land them during the 4th;
//   - the 65 coarse candidates are scored in one round: warp w takes 5
//     neighbouring candidates and each lane a run of 12 tail samples, so
//     a lane's 7 window groups serve all 5. The products come from dp4a
//     on byte planes, w * t = 256 (256 hi*hi + hi*lo + lo*hi) + lo*lo
//     (hi signed, lo unsigned), both sums exact in int32 over all 384
//     samples and added across the warp by redux.sync;
//   - six warps score the fine candidates (int32 products, int64 sums);
//   - two block barriers a frame: each warp posts its best candidate as
//     one 64-bit key (order-preserving value bits, then the negated
//     index, so a max is the earliest max), and after each barrier every
//     warp reads the keys (a lane each, two redux.sync max) and takes the
//     decision itself;
//   - the OLA is off the chain (emit);
//   - the chains of different buckets are independent: the table launch
//     (ctts_wsola_decide_table) runs the rows of every stretch bucket of
//     a serving batch side by side, so a batch pays the chain's latency
//     once, not once a bucket. It runs the same per-row body
//     (decide_row) as the launch of one bucket (ctts_wsola_frames,
//     ctts_wsola_decide), so each row's positions are the same; the
//     emit then runs alone per bucket (ctts_wsola_emit).
// Measured against this design on the card (PERF.md, PR 3): int64 or
// f64 multiply-adds in place of dp4a, 3 or 17 candidates a warp (22 or
// 4 warps; with 4, every warp ran the fine search itself and a frame
// had one barrier). All were slower.
#include <cuda_runtime.h>

namespace {

constexpr int kFrame = 512;
constexpr int kAhop = 128;
constexpr int kMaxShift = 128;
constexpr int kNCoarse = 65;                        // -128..128 step 4
constexpr int kNFine = 6;                           // -3..3 without 0
constexpr int kSpan = 12;                           // 384 tail samples / 32 lanes
constexpr int kRing = 2048;
constexpr int kMask = kRing - 1;
constexpr int kChunk = 512;                         // samples per prefetch
constexpr int kChunkFrames = kChunk / kAhop;        // 4
// Frame k issues the chunk [k*AHOP + kLead, + kChunk) when k % 4 == 0;
// frames k..k+3 read [k*AHOP - 128, k*AHOP + 1024), which the ring held
// already, and the ring's 2048 slots cover both.
constexpr int kLead = 1024;
constexpr int kGroups = kRing / 4;                  // byte-plane slots
constexpr int kGMask = kGroups - 1;
constexpr int kPerWarp = 5;                         // coarse candidates a warp
constexpr int kDecideWarps = (kNCoarse + kPerWarp - 1) / kPerWarp;  // 13
constexpr int kDecideThreads = 32 * kDecideWarps;
constexpr int kEmitThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mac(long long& s, int w, int t) {
  s += static_cast<long long>(w) * t;  // |w * t| <= 2^30
}

// Four samples at ring index a, a multiple of 4 (one aligned run that
// never wraps).
__device__ __forceinline__ void load4(const int* ring, int a, int* v) {
  const int4 q = *reinterpret_cast<const int4*>(ring + (a & kMask));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
template <int kShift>
__device__ __forceinline__ void take_span(const int* v, int* t) {
#pragma unroll
  for (int q = 0; q < kSpan; ++q) t[q] = v[q + kShift];
}

// The kSpan samples at ring index a (any alignment; a & 3 is the same in
// every lane of the warp): four aligned loads and a shift.
__device__ __forceinline__ void load_span(const int* ring, int a, int* t) {
  const int s = a & 3;
  int v[kSpan + 4];
#pragma unroll
  for (int q = 0; q < kSpan + 4; q += 4) load4(ring, a - s + q, v + q);
  switch (s) {
    case 0: take_span<0>(v, t); break;
    case 1: take_span<1>(v, t); break;
    case 2: take_span<2>(v, t); break;
    default: take_span<3>(v, t); break;
  }
}

// Exact sum over the warp of lane values below 2^35 in magnitude: the
// low 16 bits and the rest are each added by one redux.sync (sums below
// 2^21 and 2^24), then joined.
__device__ __forceinline__ long long warp_sum(long long s) {
  const int lo = static_cast<int>(s & 0xffff);
  const int hi = static_cast<int>(s >> 16);
  return static_cast<long long>(__reduce_add_sync(kFull, hi)) * 65536 +
         __reduce_add_sync(kFull, lo);
}

// corr = denom < 1 ? 0 : num / denom, denom = sqrt(sq1 * sq2); the
// denominator does not wait on the sums, so it is taken first.
__device__ __forceinline__ float denom_of(float sq1, float sq2) {
  return __fsqrt_rn(__fmul_rn(sq1, sq2));
}
__device__ __forceinline__ float corr(long long num, float denom) {
  return denom < 1.0f ? 0.0f : __fdiv_rn(__ll2float_rn(num), denom);
}

// Order-preserving key of a finite float (never 0; -0 counts as +0).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float order_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// 64-bit key of candidate `index` with 32-bit value key v (0: none):
// the max over keys is the largest value at the earliest index.
__device__ __forceinline__ unsigned long long cand_key(unsigned v,
                                                       unsigned index) {
  return v ? (static_cast<unsigned long long>(v) << 32) | (kFull - index)
           : 0ull;
}

// Max of keys[0..n) (n <= 32), read by every lane of the warp: one load
// a lane, then the high and the low words each by one redux.sync.
__device__ __forceinline__ unsigned long long max_key(
    const unsigned long long* keys, int n, int lane) {
  const unsigned long long mine = lane < n ? keys[lane] : 0ull;
  const unsigned hi = static_cast<unsigned>(mine >> 32);
  const unsigned top = __reduce_max_sync(kFull, hi);
  const unsigned lo =
      __reduce_max_sync(kFull, hi == top ? static_cast<unsigned>(mine) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

// Candidate at window index j (offset j - 128) is valid when its frame
// lies inside [0, ic); `base` is the input position of window index 0.
__device__ __forceinline__ bool valid_at(int base, int j, int ic) {
  const int pos = base + j;
  return pos >= 0 && pos + kFrame <= ic;
}

__device__ __forceinline__ void cp_async4(void* smem, const float* gmem,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Byte planes of 4 int16 samples: the low bytes (unsigned) and the high
// bytes (signed), v = 256 * hi + lo.
__device__ __forceinline__ unsigned plane_lo(int v0, int v1, int v2, int v3) {
  return __byte_perm(__byte_perm(v0, v1, 0x0040), __byte_perm(v2, v3, 0x0040),
                     0x5410);
}
__device__ __forceinline__ unsigned plane_hi(int v0, int v1, int v2, int v3) {
  return __byte_perm(__byte_perm(v0, v1, 0x0051), __byte_perm(v2, v3, 0x0051),
                     0x5410);
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

// The decide's shared memory: the ring of the row's samples, their
// energies and byte planes, the prefetch's landing area and the two
// rounds of candidate keys.
struct DecideSmem {
  int ring[kRing];  // first: 16-byte aligned with the struct
  float ering[kRing];
  unsigned plane_h[kGroups];
  unsigned plane_l[kGroups];
  float stage[kChunk];
  unsigned long long coarse_key[kDecideWarps];
  unsigned long long fine_key[kNFine];
};

// One block's chain: frames k < nr of the row x (energies e, S samples,
// ic of them input), each frame's chosen input position to out, -1 past
// nr up to max_steps. Both launches of the decide run it, so a row's
// decisions are the same whichever launch runs it.
// kPrefetch = false is the chain's latency floor (a microbenchmark, not
// on the serving path): the ring is filled once, nothing is fetched
// during the chain, and every frame searches whatever the ring holds at
// its indices -- the dependent steps alone.
template <bool kPrefetch>
__device__ __forceinline__ void decide_row(const float* __restrict__ x,
                                           const float* __restrict__ e,
                                           int* __restrict__ out, int ic,
                                           int nr, int S, int max_steps,
                                           DecideSmem& sm) {
  constexpr int kWinGroups = kSpan / 4 + kPerWarp - 1;  // a lane's window
  constexpr int kFetch0 = 32 * kNFine;  // the first prefetching thread
  int* ring = sm.ring;
  float* ering = sm.ering;
  unsigned* plane_h = sm.plane_h;
  unsigned* plane_l = sm.plane_l;
  float* stage = sm.stage;
  unsigned long long* coarse_key = sm.coarse_key;
  unsigned long long* fine_key = sm.fine_key;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // The 4 samples of input positions p0 .. p0 + 3 (p0 a multiple of 4)
  // into the ring and its byte planes.
  auto put4 = [&](int p0, const int* v) {
#pragma unroll
    for (int r = 0; r < 4; ++r) ring[(p0 + r) & kMask] = v[r];
    plane_l[(p0 >> 2) & kGMask] = plane_lo(v[0], v[1], v[2], v[3]);
    plane_h[(p0 >> 2) & kGMask] = plane_hi(v[0], v[1], v[2], v[3]);
  };

  for (int k = nr + tid; k < max_steps; k += kDecideThreads) out[k] = -1;
  const int fill = kPrefetch ? kLead + kMaxShift : kRing;
  for (int g = tid; g < fill / 4; g += kDecideThreads) {  // 4-sample groups
    const int p0 = 4 * g - kMaxShift;
    int v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + r;
      const bool in = p >= 0 && p < S;
      v[r] = in ? static_cast<int>(x[p]) : 0;
      ering[p & kMask] = in ? e[p] : 0.0f;
    }
    put4(p0, v);
  }
  __syncthreads();

  int qo = kMaxShift;  // window index of the previous frame's tail
  for (int k = 0; k < nr; ++k) {
    const int nominal = k * kAhop;
    const int base = nominal - kMaxShift;
    if (kPrefetch && k % kChunkFrames == 0) {
      // The prefetch runs on the threads from kFetch0 on: past the fine
      // search's warps, which it would delay.
      const int p0 = nominal + kLead;
      for (int g = tid - kFetch0; g >= 0 && g < kChunk / 4;
           g += kDecideThreads - kFetch0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = p0 + 4 * g + r;
          const bool in = p < S;
          cp_async4(&stage[4 * g + r], x + (in ? p : 0), in ? 4 : 0);
          cp_async4(&ering[p & kMask], e + (in ? p : 0), in ? 4 : 0);
        }
      }
    }

    int off = 0;
    if (k > 0) {
      const int tpos = base + qo;
      const float sq2 = ering[tpos & kMask];
      int t[kSpan];  // the tail: a run of kSpan samples a lane
      load_span(ring, tpos + kSpan * lane, t);
      int tf[kSpan];  // the tail, lane-interleaved (fine search)
      if (warp < kNFine) {
#pragma unroll
        for (int m = 0; m < kSpan; ++m) {
          tf[m] = ring[(tpos + lane + 32 * m) & kMask];
        }
      }

      {  // coarse: candidates c0 .. c0 + 4 of this warp, one round
        const int c0 = warp * kPerWarp;
        const int c = c0 + lane;  // lane d < kPerWarp scores c0 + d
        const float den = denom_of(ering[(base + 4 * c) & kMask], sq2);
        constexpr int kG = kSpan / 4;  // tail groups a lane
        unsigned th[kG], tl[kG], wh[kWinGroups], wl[kWinGroups];
#pragma unroll
        for (int u = 0; u < kG; ++u) {
          th[u] = plane_hi(t[4 * u], t[4 * u + 1], t[4 * u + 2], t[4 * u + 3]);
          tl[u] = plane_lo(t[4 * u], t[4 * u + 1], t[4 * u + 2], t[4 * u + 3]);
        }
        const int g0 = (base >> 2) + c0 + kG * lane;
#pragma unroll
        for (int u = 0; u < kWinGroups; ++u) {
          wh[u] = plane_h[(g0 + u) & kGMask];
          wl[u] = plane_l[(g0 + u) & kGMask];
        }
        long long num = 0;
#pragma unroll
        for (int d = 0; d < kPerWarp; ++d) {
          int hh = 0, hl = 0, ll = 0;
#pragma unroll
          for (int u = 0; u < kG; ++u) {
            hh = dp4a_ss(wh[d + u], th[u], hh);
            hl = dp4a_su(wh[d + u], tl[u], hl);
            hl = dp4a_us(wl[d + u], th[u], hl);
            ll = dp4a_uu(wl[d + u], tl[u], ll);
          }
          // 256 hh + hl: |lane| <= 12 (2^14 * 256 + 2 * 128 * 255) and
          // 32 lanes of it stay below 1.64e9 < 2^31.
          const long long tot =
              static_cast<long long>(__reduce_add_sync(kFull, hh * 256 + hl)) *
                  256 +
              __reduce_add_sync(kFull, ll);
          if (lane == d) num = tot;
        }
        unsigned key = 0;
        if (lane < kPerWarp && c < kNCoarse && valid_at(base, 4 * c, ic)) {
          key = order_key(corr(num, den));
        }
        const unsigned top = __reduce_max_sync(kFull, key);
        const int first = __ffs(__ballot_sync(kFull, key == top)) - 1;
        if (lane == 0) coarse_key[warp] = cand_key(top, c0 + first);
      }
      __syncthreads();

      const unsigned long long best = max_key(coarse_key, kDecideWarps, lane);
      const int best_off =
          best ? 4 * static_cast<int>(kFull - static_cast<unsigned>(best)) -
                     kMaxShift
               : 0;
      const float best_v =
          best ? order_value(static_cast<unsigned>(best >> 32)) : -2.0f;
      off = best_off;

      if (warp < kNFine) {  // fine: candidate rel(warp) at window index j
        const int j = best_off + kMaxShift + (warp < 3 ? warp - 3 : warp - 2);
        const float den = denom_of(ering[(base + j) & kMask], sq2);
        unsigned key = 0;
        if (j >= 0 && j <= 2 * kMaxShift && valid_at(base, j, ic)) {
          long long s[2] = {0, 0};  // two chains of adds
#pragma unroll
          for (int m = 0; m < kSpan; ++m) {
            mac(s[m % 2], ring[(base + j + lane + 32 * m) & kMask], tf[m]);
          }
          key = order_key(corr(warp_sum(s[0] + s[1]), den));
        }
        if (lane == 0) fine_key[warp] = cand_key(key, warp);
      }
      if (kPrefetch && k % kChunkFrames == kChunkFrames - 1) {
        // The chunk issued 3 frames ago: each prefetching thread lands
        // the groups it fetched; the barrier below publishes them (and
        // the energies).
        cp_async_wait_all();
        const int p0 = (k - (kChunkFrames - 1)) * kAhop + kLead;
        for (int g = tid - kFetch0; g >= 0 && g < kChunk / 4;
             g += kDecideThreads - kFetch0) {
          int v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            v[r] = static_cast<int>(stage[4 * g + r]);
          }
          put4(p0 + 4 * g, v);
        }
      }
      __syncthreads();

      const unsigned long long fine = max_key(fine_key, kNFine, lane);
      if (fine && order_value(static_cast<unsigned>(fine >> 32)) > best_v) {
        const int f = static_cast<int>(kFull - static_cast<unsigned>(fine));
        off += f < 3 ? f - 3 : f - 2;
      }
    }

    int actual = nominal + off;
    if (actual + kFrame > ic) actual = ic - kFrame;
    actual = max(actual, 0);
    qo = min(max(actual - base, 0), 2 * kMaxShift);
    if (tid == 0) out[k] = actual;
  }
  if (kPrefetch) cp_async_wait_all();
}

struct Row {
  const float* x;
  const float* e;
  int* out;
  int ic;
  int nr;
  int S;
  int max_steps;
};

// The rows of one launch a bucket: block b runs row b of one [B, S]
// batch.
struct Batch {
  const float* inp;
  const float* sq;
  const int* input_count;
  const int* nrun;
  int* pos;
  int S;
  int max_steps;

  __device__ __forceinline__ Row row(int b) const {
    return {inp + static_cast<size_t>(b) * S, sq + static_cast<size_t>(b) * S,
            pos + static_cast<size_t>(b) * max_steps, min(input_count[b], S),
            nrun[b], S, max_steps};
  }
};

}  // namespace

// One bucket's batch in a table launch (the layout of ops/hopper/wsola.py
// _Segment): `rows` rows of S samples, max_steps frame slots each.
struct WsolaSegment {
  const float* inp;
  const float* sq;
  const int* input_count;
  const int* nrun;
  int* pos;
  int rows;
  int S;
  int max_steps;
};

namespace {

constexpr int kMaxSegments = 32;

// The rows of a table launch: every row of up to kMaxSegments segments,
// passed by value in the kernel's parameter space (nothing to upload).
// Block b runs row b - first[i] of the last segment i with first[i] <= b.
// The segment is picked with constant indices only, so every field is
// read from the parameter space as it stands (a dynamic index would copy
// the table to local memory first).
struct Table {
  WsolaSegment seg[kMaxSegments];
  int first[kMaxSegments];  // grid row of each segment's row 0, ascending
  int n;

  __device__ __forceinline__ Row row(int b) const {
    int i = 0;
#pragma unroll
    for (int j = 1; j < kMaxSegments; ++j) i += (j < n && b >= first[j]);
    Batch s{};
    int r = 0;
#pragma unroll
    for (int j = 0; j < kMaxSegments; ++j) {
      if (j == i) {
        s = {seg[j].inp, seg[j].sq, seg[j].input_count, seg[j].nrun,
             seg[j].pos, seg[j].S, seg[j].max_steps};
        r = b - first[j];
      }
    }
    return s.row(r);
  }
};

// One block a row of `rows` (Batch: one bucket; Table: every bucket of a
// batch, each row's chain as in its own bucket's launch).
template <bool kPrefetch, class Rows>
__global__ void __launch_bounds__(kDecideThreads)
wsola_decide_kernel(const Rows rows) {
  __shared__ __align__(16) DecideSmem sm;
  const Row r = rows.row(blockIdx.x);
  decide_row<kPrefetch>(r.x, r.e, r.out, r.ic, r.nr, r.S, r.max_steps, sm);
}

// One thread per output sample p of row b: the frames k < nrun with
// k * hop <= p < k * hop + 512, in ascending k from 0.0f.
__global__ void __launch_bounds__(kEmitThreads)
wsola_emit_kernel(const float* __restrict__ inp, const int* __restrict__ pos,
                  const int* __restrict__ nrun,
                  const float* __restrict__ window, float* __restrict__ acc,
                  float* __restrict__ norm, int S, int hop, int out_size,
                  int max_steps) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kEmitThreads + threadIdx.x;
  if (p >= out_size) return;
  const float* x = inp + static_cast<size_t>(b) * S;
  const int* ps = pos + static_cast<size_t>(b) * max_steps;
  const int last = min(nrun[b] - 1, p / hop);
  float a = 0.0f;
  float n = 0.0f;
  for (int k = p >= kFrame ? (p - kFrame) / hop + 1 : 0; k <= last; ++k) {
    const int i = p - k * hop;
    const float h = window[i];
    a = __fadd_rn(a, truncf(__fmul_rn(truncf(x[ps[k] + i]), h)));
    n = __fadd_rn(n, h);
  }
  const size_t o = static_cast<size_t>(b) * out_size + p;
  acc[o] = a;
  norm[o] = n;
}

int decide(const float* inp, const float* sq, const int* ic, const int* nrun,
           int* pos, int B, int S, int max_steps, int prefetch,
           cudaStream_t stream) {
  if (B <= 0) return 0;
  const Batch rows{inp, sq, ic, nrun, pos, S, max_steps};
  if (prefetch) {
    wsola_decide_kernel<true><<<B, kDecideThreads, 0, stream>>>(rows);
  } else {
    wsola_decide_kernel<false><<<B, kDecideThreads, 0, stream>>>(rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int emit(const float* inp, const int* pos, const int* nrun,
         const float* window, float* acc, float* norm, int B, int S, int hop,
         int out_size, int max_steps, cudaStream_t stream) {
  if (B <= 0) return 0;
  const dim3 grid((out_size + kEmitThreads - 1) / kEmitThreads, B);
  wsola_emit_kernel<<<grid, kEmitThreads, 0, stream>>>(
      inp, pos, nrun, window, acc, norm, S, hop, out_size, max_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// inp, sq [B, S] f32; input_count, nrun [B] i32; window [512] f32;
// pos [B, max_steps] i32 scratch -> acc, norm [B, out_size] f32 (pos
// holds each frame's chosen input position, -1 past nrun).
extern "C" int ctts_wsola_frames(const float* inp, const float* sq,
                                 const int* input_count, const int* nrun,
                                 const float* window, int* pos, float* acc,
                                 float* norm, int B, int S, int hop,
                                 int out_size, int max_steps,
                                 cudaStream_t stream) {
  const int rc =
      decide(inp, sq, input_count, nrun, pos, B, S, max_steps, 1, stream);
  if (rc != 0) return rc;
  return emit(inp, pos, nrun, window, acc, norm, B, S, hop, out_size,
              max_steps, stream);
}

// The decide launch alone -> pos [B, max_steps] i32; prefetch = 0 is the
// chain's latency floor (above).
extern "C" int ctts_wsola_decide(const float* inp, const float* sq,
                                 const int* input_count, const int* nrun,
                                 int* pos, int B, int S, int max_steps,
                                 int prefetch, cudaStream_t stream) {
  return decide(inp, sq, input_count, nrun, pos, B, S, max_steps, prefetch,
                stream);
}

// The decide of n <= kMaxSegments buckets in one launch: a block a row of
// every segment, in segment order; each segment's pos as its own
// ctts_wsola_decide (prefetch on) writes it. The segments are copied into
// the launch's parameters, so `segs` may be freed once this returns.
extern "C" int ctts_wsola_decide_table(const WsolaSegment* segs, int n,
                                       cudaStream_t stream) {
  if (n < 0 || n > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t{};
  int grid = 0;
  for (int i = 0; i < n; ++i) {
    t.seg[i] = segs[i];
    t.first[i] = grid;
    grid += segs[i].rows;
  }
  t.n = n;
  if (grid <= 0) return 0;
  wsola_decide_kernel<true><<<grid, kDecideThreads, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// The overlap-add alone, from the positions a decide launch chose: acc,
// norm [B, out_size] f32 as ctts_wsola_frames writes them.
extern "C" int ctts_wsola_emit(const float* inp, const int* pos,
                               const int* nrun, const float* window,
                               float* acc, float* norm, int B, int S, int hop,
                               int out_size, int max_steps,
                               cudaStream_t stream) {
  return emit(inp, pos, nrun, window, acc, norm, B, S, hop, out_size,
              max_steps, stream);
}
