// Wire decode into rows: the host half of the serving drain
// (parallel/batch.py `_drain`, bound by ops/wire_rows.py).
//
// The format is the wire codec's (ops/wire.py): each 512-sample block
// stores 1-5 nibble planes of the zigzagged order-2 delta residual, 64
// uint32 words a plane (nibble i of a block at bits 4*(i%8) of word
// i/8); the planes of the blocks follow one another, and the residual
// runs over a shard's whole word stream from (0, 0), in uint32
// arithmetic that wraps. One call decodes every wired shard of a batch,
// block by block, straight into the row whose [start, end) range holds
// the block, or into a stage in L1 whose samples are then copied to the
// rows that share the block. No buffer of a whole shard's samples sits
// in between.
//
// Two paths of one algorithm, chosen when the library loads by what
// the CPU offers: AVX2 (a block's nibbles unpacked, the zigzag undone
// and both prefix sums run in registers, sixteen int16 lanes a vector)
// and a scalar path with the loop of the runtime's ctn_wire_decode.
// Both give the same bits. Each is exported by name; ctw_decode_rows
// calls the chosen one.
//
// Without the codec a shard's host buffer holds the rows' int16 samples
// back to back; ctw_copy_rows copies every such shard's rows of a batch
// to their addresses in one call, over the same shard, row-end and
// address tables.

#include <immintrin.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBlock = 512;   // samples a block
constexpr int kChunkW = 64;   // uint32 words a plane of a block

// Error codes (the binding raises ValueError on each).
constexpr int64_t kBadClass = -1;   // a class outside 1..5
constexpr int64_t kFewWords = -2;   // the classes need more words
constexpr int64_t kBadEnds = -3;    // row ends negative or decreasing
constexpr int64_t kNoPath = -4;     // the CPU lacks the path's features
constexpr int64_t kFewSamples = -5; // the row ends pass the samples

// Decodes one block of c planes at w into out[0, 512), carrying the
// running first delta (state[0]) and sample (state[1]) across blocks.
typedef void (*BlockFn)(const uint32_t* w, int c, uint32_t* state,
                        int16_t* out);

void block_scalar(const uint32_t* w, int c, uint32_t* state,
                  int16_t* out) {
  int32_t z[kBlock];
  for (int i = 0; i < kBlock; ++i) z[i] = 0;
  for (int p = 0; p < c; ++p, w += kChunkW) {
    const int shift = 4 * p;
    for (int wi = 0; wi < kChunkW; ++wi) {
      uint32_t v = w[wi];
      int32_t* zp = z + wi * 8;
      for (int k = 0; k < 8; ++k, v >>= 4)
        zp[k] |= static_cast<int32_t>(v & 0xF) << shift;
    }
  }
  uint32_t c1 = state[0], x = state[1];
  for (int i = 0; i < kBlock; ++i) {
    const uint32_t zi = static_cast<uint32_t>(z[i]);
    const uint32_t r = (zi >> 1) ^ (~(zi & 1u) + 1u);  // zigzag undo
    c1 += r;
    x += c1;
    out[i] = static_cast<int16_t>(x & 0xFFFFu);
  }
  state[0] = c1;
  state[1] = x;
}

#define CTW_AVX2 __attribute__((target("avx2")))

// The vector path keeps both running sums modulo 2^16, in int16 lanes:
// an int16 output is the low 16 bits of uint32 sums, and those depend
// only on the low 16 bits of what is summed. Lane j of vector k holds
// sample 32 * j + k of the block, so both prefix sums run down the 32
// vectors, one add a vector, and across the 16 lanes once a block.

// 8 x 8 transpose of 16-bit elements inside each 128-bit half of
// v[0..7]: element c of row r goes to element r of row c.
CTW_AVX2 inline void transpose8(__m256i* v) {
  const __m256i a0 = _mm256_unpacklo_epi16(v[0], v[1]);
  const __m256i a1 = _mm256_unpackhi_epi16(v[0], v[1]);
  const __m256i a2 = _mm256_unpacklo_epi16(v[2], v[3]);
  const __m256i a3 = _mm256_unpackhi_epi16(v[2], v[3]);
  const __m256i a4 = _mm256_unpacklo_epi16(v[4], v[5]);
  const __m256i a5 = _mm256_unpackhi_epi16(v[4], v[5]);
  const __m256i a6 = _mm256_unpacklo_epi16(v[6], v[7]);
  const __m256i a7 = _mm256_unpackhi_epi16(v[6], v[7]);
  const __m256i b0 = _mm256_unpacklo_epi32(a0, a2);
  const __m256i b1 = _mm256_unpackhi_epi32(a0, a2);
  const __m256i b2 = _mm256_unpacklo_epi32(a1, a3);
  const __m256i b3 = _mm256_unpackhi_epi32(a1, a3);
  const __m256i b4 = _mm256_unpacklo_epi32(a4, a6);
  const __m256i b5 = _mm256_unpackhi_epi32(a4, a6);
  const __m256i b6 = _mm256_unpacklo_epi32(a5, a7);
  const __m256i b7 = _mm256_unpackhi_epi32(a5, a7);
  v[0] = _mm256_unpacklo_epi64(b0, b4);
  v[1] = _mm256_unpackhi_epi64(b0, b4);
  v[2] = _mm256_unpacklo_epi64(b1, b5);
  v[3] = _mm256_unpackhi_epi64(b1, b5);
  v[4] = _mm256_unpacklo_epi64(b2, b6);
  v[5] = _mm256_unpackhi_epi64(b2, b6);
  v[6] = _mm256_unpacklo_epi64(b3, b7);
  v[7] = _mm256_unpackhi_epi64(b3, b7);
}

// Swaps the bits of mask m between a >> s and b.
CTW_AVX2 inline void swap_bits(__m256i& a, __m256i& b, int s, __m256i m) {
  const __m256i t = _mm256_and_si256(
      _mm256_xor_si256(_mm256_srli_epi16(a, s), b), m);
  b = _mm256_xor_si256(b, t);
  a = _mm256_xor_si256(a, _mm256_slli_epi16(t, s));
}

// Inclusive prefix sum over the 16 int16 lanes, and its total in every
// lane.
CTW_AVX2 inline __m256i scan16(__m256i v, __m256i* total) {
  const __m256i word7 = _mm256_setr_epi8(
      14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15,
      14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15);
  v = _mm256_add_epi16(v, _mm256_slli_si256(v, 2));
  v = _mm256_add_epi16(v, _mm256_slli_si256(v, 4));
  v = _mm256_add_epi16(v, _mm256_slli_si256(v, 8));
  const __m256i t = _mm256_shuffle_epi8(v, word7);   // each half's sum
  v = _mm256_add_epi16(v, _mm256_permute2x128_si256(t, t, 0x08));
  *total = _mm256_add_epi16(t, _mm256_permute2x128_si256(t, t, 0x01));
  return v;
}

template <int C>
CTW_AVX2 void block_avx2_c(const uint32_t* w, uint32_t* state,
                           int16_t* out) {
  // h[p][i], lane j: 16-bit word 8 * j + i of plane p, the nibbles of
  // samples 32 * j + 4 * i .. + 3.
  __m256i h[C][8];
  for (int p = 0; p < C; ++p) {
    const __m128i* src = reinterpret_cast<const __m128i*>(w + p * kChunkW);
    for (int r = 0; r < 8; ++r)
      h[p][r] = _mm256_inserti128_si256(
          _mm256_castsi128_si256(_mm_loadu_si128(src + r)),
          _mm_loadu_si128(src + r + 8), 1);
    transpose8(h[p]);
  }
  const __m256i zero = _mm256_setzero_si256();
  const __m256i one = _mm256_set1_epi16(1);
  const __m256i n02 = _mm256_set1_epi16(0x0F0F);
  const __m256i b0 = _mm256_set1_epi16(0x00FF);
  const __m256i top = _mm256_set1_epi16(static_cast<short>(0x8000));
  // a[k], lane j: the residuals of samples 32 * j .. 32 * j + k summed.
  __m256i a[32];
  __m256i acc = zero;
  for (int i = 0; i < 8; ++i) {
    // The four planes' nibbles m of the four samples 4 * i + m, gathered
    // into z's bits 0..15 by a 4 x 4 nibble transpose.
    __m256i z[4] = {h[0][i], zero, zero, zero};
    for (int p = 1; p < C && p < 4; ++p) z[p] = h[p][i];
    swap_bits(z[0], z[1], 4, n02);
    swap_bits(z[2], z[3], 4, n02);
    swap_bits(z[0], z[2], 8, b0);
    swap_bits(z[1], z[3], 8, b0);
    for (int m = 0; m < 4; ++m) {
      __m256i hi = _mm256_srli_epi16(z[m], 1);
      if constexpr (C > 4)   // bit 16 of z: bit 0 of plane 4's nibble
        hi = _mm256_or_si256(hi, _mm256_and_si256(
            _mm256_slli_epi16(h[4][i], 15 - 4 * m), top));
      const __m256i r = _mm256_xor_si256(
          hi, _mm256_sub_epi16(zero, _mm256_and_si256(z[m], one)));
      acc = _mm256_add_epi16(acc, r);
      a[4 * i + m] = acc;
    }
  }
  // c1 at sample 32 * j + k: the carried c1, the lanes before j's sums
  // and a[k]; then x likewise from the c1 values.
  __m256i tot;
  const __m256i c1 = _mm256_set1_epi16(static_cast<short>(state[0]));
  const __m256i e1 = _mm256_add_epi16(
      _mm256_sub_epi16(scan16(acc, &tot), acc), c1);
  state[0] = static_cast<uint16_t>(_mm256_extract_epi16(
      _mm256_add_epi16(c1, tot), 0));
  acc = zero;
  for (int k = 0; k < 32; ++k) {
    acc = _mm256_add_epi16(acc, _mm256_add_epi16(a[k], e1));
    a[k] = acc;
  }
  const __m256i x = _mm256_set1_epi16(static_cast<short>(state[1]));
  const __m256i e2 = _mm256_add_epi16(
      _mm256_sub_epi16(scan16(acc, &tot), acc), x);
  state[1] = static_cast<uint16_t>(_mm256_extract_epi16(
      _mm256_add_epi16(x, tot), 0));
  // Back to sample order: each group of 8 vectors transposed, row j of
  // a half to samples 32 * j + 8 * g .. + 7.
  for (int g = 0; g < 4; ++g) {
    __m256i* v = a + 8 * g;
    for (int k = 0; k < 8; ++k) v[k] = _mm256_add_epi16(v[k], e2);
    transpose8(v);
    for (int j = 0; j < 8; ++j) {
      _mm_storeu_si128(reinterpret_cast<__m128i*>(
          out + 32 * j + 8 * g), _mm256_castsi256_si128(v[j]));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(
          out + 32 * (j + 8) + 8 * g), _mm256_extracti128_si256(v[j], 1));
    }
  }
}

CTW_AVX2 void block_avx2(const uint32_t* w, int c, uint32_t* state,
                         int16_t* out) {
  switch (c) {
    case 1: block_avx2_c<1>(w, state, out); break;
    case 2: block_avx2_c<2>(w, state, out); break;
    case 3: block_avx2_c<3>(w, state, out); break;
    case 4: block_avx2_c<4>(w, state, out); break;
    default: block_avx2_c<5>(w, state, out); break;
  }
}

// Every shard: check its row ends, then decode its blocks in order, each
// straight into its row where one row holds all of it, else into the
// stage, copied out to the rows that cover it (a row whose output
// pointer is null is skipped). Returns the samples written, or an error
// code.
int64_t walk(BlockFn block, int64_t nshards, const uint32_t* const* words,
             const int64_t* nwords, const int32_t* const* classes,
             const int64_t* nclasses, const int64_t* row_off,
             const int64_t* ends, int16_t* const* outs) {
  alignas(32) int16_t stage[kBlock];
  int64_t written = 0;
  for (int64_t s = 0; s < nshards; ++s) {
    const int64_t r0 = row_off[s], r1 = row_off[s + 1];
    if (r1 <= r0) continue;
    const int64_t* e = ends + r0;
    int16_t* const* o = outs + r0;
    const int64_t nrows = r1 - r0;
    for (int64_t r = 0; r < nrows; ++r)
      if (e[r] < (r ? e[r - 1] : 0)) return kBadEnds;
    const int64_t total = e[nrows - 1];
    const int64_t nblk = (total + kBlock - 1) / kBlock;
    if (nblk > nclasses[s]) return kFewWords;
    const uint32_t* w = words[s];
    const uint32_t* wend = w + nwords[s];
    uint32_t state[2] = {0, 0};
    int64_t row = 0;
    for (int64_t b = 0; b < nblk; ++b) {
      const int c = classes[s][b];
      if (c < 1 || c > 5) return kBadClass;
      if (wend - w < static_cast<int64_t>(c) * kChunkW) return kFewWords;
      int64_t pos = b * kBlock;
      const int64_t stop = pos + kBlock < total ? pos + kBlock : total;
      while (e[row] <= pos) ++row;   // past ended (and empty) rows
      if (e[row] >= pos + kBlock && o[row] != nullptr) {
        block(w, c, state, o[row] + (pos - (row ? e[row - 1] : 0)));
        written += kBlock;
        w += c * kChunkW;
        continue;
      }
      block(w, c, state, stage);
      w += c * kChunkW;
      while (pos < stop) {
        while (e[row] <= pos) ++row;
        const int64_t start = row ? e[row - 1] : 0;
        const int64_t end = e[row] < stop ? e[row] : stop;
        if (o[row] != nullptr) {
          std::memcpy(o[row] + (pos - start), stage + (pos - b * kBlock),
                      static_cast<size_t>(end - pos) * sizeof(int16_t));
          written += end - pos;
        }
        pos = end;
      }
    }
  }
  return written;
}

bool has_avx2() { return __builtin_cpu_supports("avx2"); }

// The path chosen when the library loads.
const bool kVector = has_avx2();

}  // namespace

extern "C" {

// Shard s: words[s] (nwords[s] uint32), classes[s] (nclasses[s]
// int32), and its rows row_off[s] .. row_off[s + 1] - 1 of ends (each
// row's end in the shard's samples, rows back to back from 0) and outs
// (each row's int16 output, or null to skip it).
int64_t ctw_decode_rows_scalar(int64_t nshards, const uint32_t* const* words,
                               const int64_t* nwords,
                               const int32_t* const* classes,
                               const int64_t* nclasses,
                               const int64_t* row_off, const int64_t* ends,
                               int16_t* const* outs) {
  return walk(block_scalar, nshards, words, nwords, classes, nclasses,
              row_off, ends, outs);
}

int64_t ctw_decode_rows_avx2(int64_t nshards, const uint32_t* const* words,
                             const int64_t* nwords,
                             const int32_t* const* classes,
                             const int64_t* nclasses, const int64_t* row_off,
                             const int64_t* ends, int16_t* const* outs) {
  if (!has_avx2()) return kNoPath;
  return walk(block_avx2, nshards, words, nwords, classes, nclasses,
              row_off, ends, outs);
}

int64_t ctw_decode_rows(int64_t nshards, const uint32_t* const* words,
                        const int64_t* nwords, const int32_t* const* classes,
                        const int64_t* nclasses, const int64_t* row_off,
                        const int64_t* ends, int16_t* const* outs) {
  return walk(kVector ? block_avx2 : block_scalar, nshards, words, nwords,
              classes, nclasses, row_off, ends, outs);
}

// Codec off. Shard s: samples[s] (nsamples[s] int16), and its rows
// row_off[s] .. row_off[s + 1] - 1 of ends and outs, as in
// ctw_decode_rows. Checks each shard's row ends against its samples,
// then copies each row to its output (a null output skips the row).
// Returns the samples written, or an error code.
int64_t ctw_copy_rows(int64_t nshards, const int16_t* const* samples,
                      const int64_t* nsamples, const int64_t* row_off,
                      const int64_t* ends, int16_t* const* outs) {
  int64_t written = 0;
  for (int64_t s = 0; s < nshards; ++s) {
    const int64_t r0 = row_off[s], r1 = row_off[s + 1];
    if (r1 <= r0) continue;
    const int64_t* e = ends + r0;
    int16_t* const* o = outs + r0;
    const int64_t nrows = r1 - r0;
    for (int64_t r = 0; r < nrows; ++r)
      if (e[r] < (r ? e[r - 1] : 0)) return kBadEnds;
    if (e[nrows - 1] > nsamples[s]) return kFewSamples;
    for (int64_t r = 0; r < nrows; ++r) {
      const int64_t start = r ? e[r - 1] : 0;
      if (o[r] == nullptr) continue;
      std::memcpy(o[r], samples[s] + start,
                  static_cast<size_t>(e[r] - start) * sizeof(int16_t));
      written += e[r] - start;
    }
  }
  return written;
}

// The name of the path ctw_decode_rows takes: "avx2" or "scalar".
const char* ctw_path(void) { return kVector ? "avx2" : "scalar"; }

}  // extern "C"
