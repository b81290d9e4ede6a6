// ctts_native: C++ host runtime for the ctts_tpu framework.
//
// Implements the host-side production path: memory-mapped voice-database
// access and a bit-exact, plan-driven waveform executor (the same op
// stream the Python compiler emits for the JAX device path). Used for
// low-latency single-stream synthesis, golden-suite generation, and as a
// fast oracle for the device executor's tests.
//
// Numeric contract: identical to the reference engine's observable
// arithmetic (float32 op order, truncating int16 stores, wrapping OLA
// accumulators; parity sources cited per function as file:line into the
// reference tree). The code itself is an original implementation around
// the SynthesisPlan architecture — see ctts_tpu/plan/compiler.py.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libctts_native.so ctts_native.cpp
// ABI: plain C, consumed via ctypes (ctts_tpu/runtime/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <limits>
#include <vector>
#include <algorithm>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53545443;
constexpr uint32_t kVersion = 1;
constexpr int kSampleRate = 22050;
constexpr int kLutSize = 1024;
constexpr float kPi = 3.14159265358979323846f;

// ---------------------------------------------------------------------------
// Fade lookup tables (parity: ctts.c:52-101)
// ---------------------------------------------------------------------------

struct FadeLuts {
  float out_[kLutSize];
  float in_[kLutSize];
  float sine_[kLutSize];
  FadeLuts() {
    for (int i = 0; i < kLutSize; ++i) {
      float t = static_cast<float>(i) / static_cast<float>(kLutSize - 1);
      out_[i] = 0.5f * (1.0f + std::cos(kPi * t));
      in_[i] = 0.5f * (1.0f - std::cos(kPi * t));
      sine_[i] = std::sin(t * kPi * 0.5f);
    }
  }
};
const FadeLuts& luts() {
  static FadeLuts l;
  return l;
}

inline float lut_lookup(const float* lut, float t) {
  float idx_f = t * (kLutSize - 1);
  int idx = static_cast<int>(idx_f);
  if (idx >= kLutSize - 1) return lut[kLutSize - 1];
  if (idx < 0) return lut[0];
  float frac = idx_f - idx;
  return lut[idx] * (1.0f - frac) + lut[idx + 1] * frac;
}
inline float fade_out_gain(float t) { return lut_lookup(luts().out_, t); }
inline float fade_in_gain(float t) { return lut_lookup(luts().in_, t); }
inline float sine_gain(float t) { return lut_lookup(luts().sine_, t); }

inline int16_t clamp_i16(float v) {
  if (v > 32767.0f) v = 32767.0f;
  if (v < -32768.0f) v = -32768.0f;
  return static_cast<int16_t>(v);  // trunc toward zero
}

// ---------------------------------------------------------------------------
// Voice database (format: ctts.h:84-111)
// ---------------------------------------------------------------------------

#pragma pack(push, 1)
struct DbHeader {
  uint32_t magic, version, unit_count, sample_rate, bits_per_sample;
  uint32_t index_offset, strings_offset, audio_offset, total_samples;
  uint32_t max_unit_chars, hash_table_size, hash_table_offset;
  uint8_t reserved[16];
};
struct DbIndexEntry {
  uint32_t hash, string_offset;
  uint16_t string_len, char_count;
  uint32_t audio_offset, sample_count, flags, next_hash, reserved;
};
#pragma pack(pop)

struct Database {
  int fd = -1;
  size_t size = 0;
  const uint8_t* data = nullptr;
  DbHeader header{};
  const DbIndexEntry* index = nullptr;
  const uint32_t* hash_table = nullptr;
  const char* strings = nullptr;
  const int16_t* audio = nullptr;
};

uint32_t fnv1a(const char* s, size_t len) {
  uint32_t h = 2166136261u;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 16777619u;
  }
  return h;
}

// ---------------------------------------------------------------------------
// DSP primitives (bit-parity with the reference; sources per function)
// ---------------------------------------------------------------------------

// remove_dc_offset (ctts.c:1568-1583)
void remove_dc(int16_t* s, size_t n) {
  if (n == 0) return;
  int64_t sum = 0;
  for (size_t i = 0; i < n; ++i) sum += s[i];
  int16_t dc = static_cast<int16_t>(sum / static_cast<int64_t>(n));
  for (size_t i = 0; i < n; ++i) {
    int32_t v = s[i] - dc;
    if (v > 32767) v = 32767;
    if (v < -32768) v = -32768;
    s[i] = static_cast<int16_t>(v);
  }
}

// apply_fade_in / apply_fade_out (ctts.c:3015-3039)
void fade_in_head(int16_t* s, size_t n, size_t fade) {
  if (fade == 0 || n == 0) return;
  if (fade > n) fade = n;
  float inv = 1.0f / static_cast<float>(fade);
  for (size_t i = 0; i < fade; ++i) {
    float t = static_cast<float>(i) * inv;
    s[i] = static_cast<int16_t>(s[i] * sine_gain(t));
  }
}
void fade_out_tail(int16_t* s, size_t n, size_t fade) {
  if (fade == 0 || n == 0) return;
  if (fade > n) fade = n;
  size_t start = n - fade;
  float inv = 1.0f / static_cast<float>(fade);
  for (size_t i = 0; i < fade; ++i) {
    float t = static_cast<float>(fade - i) * inv;
    s[start + i] = static_cast<int16_t>(s[start + i] * sine_gain(t));
  }
}

// calculate_rms (ctts.c:1697-1706) — double accumulation
float rms_of(const int16_t* s, size_t n) {
  if (n == 0) return 0.0f;
  double acc = 0.0;
  for (size_t i = 0; i < n; ++i) {
    double v = static_cast<double>(s[i]);
    acc += v * v;
  }
  return static_cast<float>(std::sqrt(acc / n));
}

// normalize_rms (ctts.c:1709-1727)
void normalize_rms(int16_t* s, size_t n, float target) {
  if (n == 0 || target <= 0) return;
  float cur = rms_of(s, n);
  if (cur < 1.0f) return;
  float gain = target / cur;
  if (gain > 3.0f) gain = 3.0f;
  if (gain < 0.1f) gain = 0.1f;
  for (size_t i = 0; i < n; ++i) s[i] = clamp_i16(s[i] * gain);
}

// match_boundary_energy (ctts.c:1730-1759)
void match_energy(const int16_t* prev, size_t prev_n, int16_t* next,
                  size_t next_n, size_t boundary) {
  if (boundary == 0 || prev_n == 0 || next_n == 0) return;
  size_t blen = std::min({boundary, prev_n, next_n});
  float prev_rms = rms_of(prev + prev_n - blen, blen);
  float next_rms = rms_of(next, blen);
  if (prev_rms < 1.0f || next_rms < 1.0f) return;
  float ratio = prev_rms / next_rms;
  if (ratio > 2.0f) ratio = 2.0f;
  if (ratio < 0.5f) ratio = 0.5f;
  for (size_t i = 0; i < blen && i < next_n; ++i) {
    float t = static_cast<float>(i) / static_cast<float>(blen);
    float gain = ratio * (1.0f - t) + 1.0f * t;
    next[i] = clamp_i16(next[i] * gain);
  }
}

// estimate_pitch (ctts.c:1899-1943) — sequential f32 accumulation
float estimate_pitch(const int16_t* s, size_t n) {
  if (n < 200) return 0.0f;
  size_t min_lag = kSampleRate / 400;
  size_t max_lag = kSampleRate / 80;
  if (max_lag > n / 2) max_lag = n / 2;
  size_t alen = kSampleRate / 100;
  if (alen > n - max_lag) alen = n - max_lag;
  float best_corr = 0.0f;
  size_t best_lag = 0;
  for (size_t lag = min_lag; lag <= max_lag; ++lag) {
    float corr = 0.0f, e1 = 0.0f, e2 = 0.0f;
    for (size_t i = 0; i < alen; ++i) {
      float a = s[i], b = s[i + lag];
      corr += a * b;
      e1 += a * a;
      e2 += b * b;
    }
    float norm = std::sqrt(e1 * e2);
    if (norm > 0) corr /= norm;
    if (corr > best_corr) {
      best_corr = corr;
      best_lag = lag;
    }
  }
  if (best_corr > 0.3f && best_lag > 0)
    return static_cast<float>(kSampleRate) / best_lag;
  return 0.0f;
}

// apply_pitch_shift (ctts.c:1946-1976)
void pitch_shift(int16_t* s, size_t n, float factor) {
  if (factor < 0.9f || factor > 1.1f || n < 100) return;
  size_t new_n = static_cast<size_t>(n / factor);
  std::vector<int16_t> tmp(new_n, 0);
  for (size_t i = 0; i < new_n; ++i) {
    float pos = i * factor;
    size_t idx = static_cast<size_t>(pos);
    float frac = pos - idx;
    if (idx + 1 < n)
      tmp[i] = static_cast<int16_t>(s[idx] * (1.0f - frac) + s[idx + 1] * frac);
    else if (idx < n)
      tmp[i] = s[idx];
  }
  size_t copy_n = std::min(new_n, n);
  std::memcpy(s, tmp.data(), copy_n * sizeof(int16_t));
  if (copy_n < n) std::memset(s + copy_n, 0, (n - copy_n) * sizeof(int16_t));
}

// smooth_pitch_boundary (ctts.c:1979-2024)
void smooth_boundary(const int16_t* buf, size_t buf_n, int16_t* next,
                     size_t next_n, size_t boundary) {
  if (boundary == 0 || buf_n < 200 || next_n < 200) return;
  size_t region = boundary * 2;
  if (region > buf_n / 2) region = buf_n / 2;
  if (region > next_n / 2) region = next_n / 2;
  float prev_p = estimate_pitch(buf + buf_n - region, region);
  float next_p = estimate_pitch(next, region);
  if (prev_p > 0 && next_p > 0) {
    float ratio = next_p / prev_p;
    if (ratio > 1.15f || ratio < 0.85f) {
      float target = (ratio > 1.0f) ? 1.0f + (ratio - 1.0f) * 0.5f
                                    : 1.0f - (1.0f - ratio) * 0.5f;
      float factor = target / ratio;
      size_t shift = boundary;
      if (shift > next_n / 4) shift = next_n / 4;
      if (shift == 0) return;
      std::vector<int16_t> region_buf(next, next + shift);
      pitch_shift(region_buf.data(), shift, factor);
      for (size_t i = 0; i < shift; ++i) {
        float t = static_cast<float>(i) / shift;
        next[i] = static_cast<int16_t>(region_buf[i] * (1.0f - t) + next[i] * t);
      }
    }
  }
}

// apply_smooth_pitch_contour (ctts.c:2194-2273) — incl. the reference's
// past-frame reads (substituting 0 beyond the buffer, like the oracle).
struct Hann256 {
  float w[256];
  Hann256() {
    for (int i = 0; i < 256; ++i)
      w[i] = 0.5f * (1.0f - std::cos(2.0f * kPi * i / 256.0f));
  }
};
const Hann256& hann256() {
  static Hann256 h;
  return h;
}

void pitch_contour(int16_t* s, size_t n, float f0, float f1) {
  if (n < 100 || std::fabs(f0 - f1) < 0.01f) return;
  const size_t frame = 256, hop = 128;
  std::vector<int16_t> tmp(s, s + n);
  std::vector<float> norm(n, 0.0f);
  std::memset(s, 0, n * sizeof(int16_t));
  float inv = (n != frame) ? 1.0f / static_cast<float>(n - frame)
                           : std::numeric_limits<float>::infinity();
  for (size_t pos = 0; pos + frame <= n; pos += hop) {
    float t = static_cast<float>(pos) * inv;
    float st = t * t * (3.0f - 2.0f * t);
    float pf = f0 + (f1 - f0) * st;
    for (size_t i = 0; i < frame; ++i) {
      float src = i * pf;
      size_t idx = static_cast<size_t>(src);
      float frac = src - idx;
      float sample;
      if (idx + 1 < frame) {
        sample = tmp[pos + idx] * (1.0f - frac) + tmp[pos + idx + 1] * frac;
      } else {
        // Reference reads past the frame (ctts.c:2251); 0 past the buffer.
        sample = (pos + idx < n) ? static_cast<float>(tmp[pos + idx]) : 0.0f;
      }
      s[pos + i] = static_cast<int16_t>(
          static_cast<int16_t>(s[pos + i]) +
          static_cast<int16_t>(sample * hann256().w[i]));
      norm[pos + i] += hann256().w[i];
    }
  }
  for (size_t i = 0; i < n; ++i) {
    if (norm[i] > 0.01f) {
      float v = s[i] / norm[i];
      s[i] = clamp_i16(v);
    } else {
      s[i] = tmp[i];
    }
  }
}

// remove_silence_regions (ctts.c:1634-1690)
size_t remove_silence(int16_t* s, size_t n, float threshold,
                      size_t min_silence) {
  if (n == 0) return 0;
  int16_t max_amp = 0;
  for (size_t i = 0; i < n; ++i) {
    int16_t a = s[i] > 0 ? s[i] : -s[i];
    if (a > max_amp) max_amp = a;
  }
  if (max_amp == 0) return n;
  int16_t thr = static_cast<int16_t>(max_amp * threshold);
  size_t w = 0, r = 0;
  while (r < n) {
    int16_t a = s[r] > 0 ? s[r] : -s[r];
    if (a <= thr) {
      size_t start = r;
      while (r < n) {
        a = s[r] > 0 ? s[r] : -s[r];
        if (a > thr) break;
        ++r;
      }
      size_t run = r - start;
      if (run >= min_silence) {
        size_t keep = min_silence / 4;
        if (keep < 10) keep = 10;
        for (size_t i = 0; i < keep && start + i < n; ++i)
          s[w++] = s[start + i];
      } else {
        for (size_t i = start; i < r; ++i) s[w++] = s[i];
      }
    } else {
      s[w++] = s[r++];
    }
  }
  return w;
}

// WSOLA (ctts.c:3378-3617)
float xcorr(const int16_t* a, const int16_t* b, size_t len) {
  if (len == 0) return 0.0f;
  float sp = 0.0f, s1 = 0.0f, s2 = 0.0f;
  size_t len4 = len & ~static_cast<size_t>(3);
  size_t i = 0;
  for (; i < len4; i += 4) {
    float a0 = a[i], a1 = a[i + 1], a2 = a[i + 2], a3 = a[i + 3];
    float b0 = b[i], b1 = b[i + 1], b2 = b[i + 2], b3 = b[i + 3];
    sp += a0 * b0 + a1 * b1 + a2 * b2 + a3 * b3;
    s1 += a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3;
    s2 += b0 * b0 + b1 * b1 + b2 * b2 + b3 * b3;
  }
  for (; i < len; ++i) {
    float av = a[i], bv = b[i];
    sp += av * bv;
    s1 += av * av;
    s2 += bv * bv;
  }
  float denom = std::sqrt(s1 * s2);
  if (denom < 1.0f) return 0.0f;
  return sp / denom;
}

int wsola_search(const int16_t* in, size_t in_n, const int16_t* prev,
                 size_t overlap, size_t nominal, size_t frame, int max_shift) {
  if (prev == nullptr || overlap == 0) return 0;
  const int16_t* target = prev + frame - overlap;
  float best_corr = -2.0f;
  int best = 0;
  for (int off = -max_shift; off <= max_shift; off += 4) {
    long p = static_cast<long>(nominal) + off;
    if (p < 0 || static_cast<size_t>(p) + frame > in_n) continue;
    float c = xcorr(in + p, target, overlap);
    if (c > best_corr) {
      best_corr = c;
      best = off;
    }
  }
  int lo = std::max(best - 3, -max_shift);
  int hi = std::min(best + 3, max_shift);
  for (int off = lo; off <= hi; ++off) {
    if (off == best) continue;
    long p = static_cast<long>(nominal) + off;
    if (p < 0 || static_cast<size_t>(p) + frame > in_n) continue;
    float c = xcorr(in + p, target, overlap);
    if (c > best_corr) {
      best_corr = c;
      best = off;
    }
  }
  return best;
}

std::vector<int16_t> time_stretch(const std::vector<int16_t>& in, float speed) {
  if (speed < 0.5f) speed = 0.5f;
  if (speed > 2.0f) speed = 2.0f;
  size_t n = in.size();
  if (std::fabs(speed - 1.0f) < 0.01f) return in;

  const size_t frame = 512, ahop = frame / 4, overlap = frame - ahop;
  const int max_shift = static_cast<int>(frame * 0.25f);
  size_t shop = static_cast<size_t>(ahop / speed);
  if (shop < 1) shop = 1;

  size_t num_frames = (n > frame) ? (n - frame) / ahop + 1 : 1;
  size_t cap = num_frames * shop + frame + 1024;

  std::vector<int16_t> out(cap, 0);
  std::vector<float> norm(cap, 0.0f);
  std::vector<float> window(frame);
  for (size_t i = 0; i < frame; ++i)
    window[i] = 0.5f * (1.0f - std::cos(2.0f * kPi * i / frame));

  std::vector<int16_t> prev(frame);
  bool have_prev = false;
  size_t nominal = 0, spos = 0, actual_len = 0;

  while (nominal + frame <= n && spos + frame <= cap) {
    int off = have_prev ? wsola_search(in.data(), n, prev.data(), overlap,
                                       nominal, frame, max_shift)
                        : 0;
    size_t actual = nominal + off;
    if (actual + frame > n) actual = n - frame;
    for (size_t i = 0; i < frame; ++i) {
      float sample = in[actual + i] * window[i];
      out[spos + i] = static_cast<int16_t>(
          out[spos + i] + static_cast<int16_t>(sample));
      norm[spos + i] += window[i];
      prev[i] = in[actual + i];
    }
    have_prev = true;
    if (spos + frame > actual_len) actual_len = spos + frame;
    nominal += ahop;
    spos += shop;
  }
  for (size_t i = 0; i < actual_len; ++i) {
    if (norm[i] > 0.01f) out[i] = clamp_i16(out[i] / norm[i]);
  }
  out.resize(actual_len);
  while (!out.empty() && out.back() == 0) out.pop_back();
  return out;
}

// ---------------------------------------------------------------------------
// Plan executor
// ---------------------------------------------------------------------------

enum OpKind : int32_t {
  kOpUnit = 0,
  kOpSilence = 1,
  kOpWordDsp = 2,
  kOpFadeTail = 3,
  kOpMarkWord = 4,
};

enum PhraseType : int32_t {
  kDeclarative = 0,
  kInterrogative = 1,
  kExclamatory = 2,
  kContinuation = 3,
  kListing = 4,
};

}  // namespace

#include "ctn_api.h"

extern "C" {

void* ctn_db_open(const char* path) {
  auto* db = new Database();
  db->fd = ::open(path, O_RDONLY);
  if (db->fd < 0) {
    delete db;
    return nullptr;
  }
  struct stat st;
  if (fstat(db->fd, &st) < 0) {
    ::close(db->fd);
    delete db;
    return nullptr;
  }
  db->size = st.st_size;
  void* m = mmap(nullptr, db->size, PROT_READ, MAP_PRIVATE, db->fd, 0);
  if (m == MAP_FAILED) {
    ::close(db->fd);
    delete db;
    return nullptr;
  }
  db->data = static_cast<const uint8_t*>(m);
  std::memcpy(&db->header, db->data, sizeof(DbHeader));
  if (db->header.magic != kMagic || db->header.version != kVersion) {
    munmap(m, db->size);
    ::close(db->fd);
    delete db;
    return nullptr;
  }
  db->index = reinterpret_cast<const DbIndexEntry*>(
      db->data + db->header.index_offset);
  db->hash_table = reinterpret_cast<const uint32_t*>(
      db->data + db->header.hash_table_offset);
  db->strings = reinterpret_cast<const char*>(
      db->data + db->header.strings_offset);
  db->audio = reinterpret_cast<const int16_t*>(
      db->data + db->header.audio_offset);
  return db;
}

void ctn_db_close(void* handle) {
  auto* db = static_cast<Database*>(handle);
  if (!db) return;
  munmap(const_cast<uint8_t*>(db->data), db->size);
  ::close(db->fd);
  delete db;
}

void ctn_db_view(void* handle, CtnDbView* out) {
  auto* db = static_cast<Database*>(handle);
  out->data = db->data;
  out->size = db->size;
  out->fd = db->fd;
}

uint32_t ctn_db_unit_count(void* handle) {
  return static_cast<Database*>(handle)->header.unit_count;
}

uint32_t ctn_db_max_unit_chars(void* handle) {
  return static_cast<Database*>(handle)->header.max_unit_chars;
}

// Chained-hash probe (parity: find_unit, ctts.c:1337-1354).
int32_t ctn_db_find_unit(void* handle, const char* text, size_t len) {
  auto* db = static_cast<Database*>(handle);
  uint32_t h = fnv1a(text, len);
  uint32_t idx = db->hash_table[h % db->header.hash_table_size];
  while (idx != 0xFFFFFFFFu) {
    const DbIndexEntry& e = db->index[idx];
    if (e.hash == h && e.string_len == len &&
        std::memcmp(db->strings + e.string_offset, text, len) == 0) {
      return static_cast<int32_t>(idx);
    }
    idx = e.next_hash;
  }
  return -1;
}

const char* ctn_db_unit_text(void* handle, uint32_t idx, uint32_t* len) {
  auto* db = static_cast<Database*>(handle);
  if (idx >= db->header.unit_count) return nullptr;
  const DbIndexEntry& e = db->index[idx];
  if (len) *len = e.string_len;
  return db->strings + e.string_offset;
}

uint32_t ctn_db_unit_sample_count(void* handle, uint32_t idx) {
  auto* db = static_cast<Database*>(handle);
  if (idx >= db->header.unit_count) return 0;
  return db->index[idx].sample_count;
}

// Execute a plan; returns sample count, writes a malloc'd buffer to *out.
int64_t ctn_execute_plan(void* handle, const CtnPlan* plan, int16_t** out) {
  auto* db = static_cast<Database*>(handle);
  std::vector<int16_t> buf;
  buf.reserve(kSampleRate * 10);
  size_t word_start = 0;

  // Intonation scalar helpers (apply_phrase_intonation, ctts.c:2736-2866).
  const float mc = plan->max_pitch_change;
  auto clampp = [mc](float p) {
    float lo = 1.0f - mc, hi = 1.0f + mc;
    if (p < lo) return lo;
    if (p > hi) return hi;
    return p;
  };

  auto apply_intonation = [&](int16_t* s, size_t n, int32_t word_index) {
    int32_t total = plan->word_count;
    if (n < 100 || total == 0) return;
    float ppos = static_cast<float>(word_index) /
                 static_cast<float>(total > 1 ? total - 1 : 1);
    bool is_final = word_index == total - 1;
    bool is_penult = (word_index == total - 2) && total > 1;
    float pf;
    if (ppos <= plan->peak_position) {
      float t = ppos / plan->peak_position;
      t = t * t * (3.0f - 2.0f * t);
      pf = plan->pitch_start + (plan->pitch_peak - plan->pitch_start) * t;
    } else {
      float t = (ppos - plan->peak_position) / (1.0f - plan->peak_position);
      t = t * t * (3.0f - 2.0f * t);
      pf = plan->pitch_peak + (plan->pitch_end - plan->pitch_peak) * t;
    }
    pf = clampp(pf);
    float ws = clampp(pf * 0.98f);
    float we = clampp(pf * 1.02f);
    bool skip_contour = false;

    if (plan->phrase_type == kInterrogative && (is_final || is_penult)) {
      if (is_final) {
        ws = clampp(pf * 0.95f);
        we = clampp(plan->pitch_end);
        size_t rise = static_cast<size_t>(n * 0.6f);
        if (rise > 100 && n - rise > 100) {
          float peak = clampp(plan->pitch_peak);
          pitch_contour(s, rise, ws, peak);
          pitch_contour(s + rise, n - rise, peak, we);
          skip_contour = true;
        }
      } else {
        ws = clampp(pf * 0.98f);
        we = clampp(pf * 1.05f);
      }
    } else if (plan->phrase_type == kExclamatory) {
      if (word_index == 0) {
        ws = clampp(plan->pitch_peak);
        we = clampp(pf);
      } else if (is_final) {
        ws = clampp(pf);
        we = clampp(plan->pitch_end);
      } else {
        ws = clampp(pf * 1.02f);
        we = clampp(pf * 0.98f);
      }
    } else if (plan->phrase_type == kContinuation && is_final) {
      ws = clampp(pf * 0.96f);
      we = clampp(plan->pitch_end);
    } else {
      ws = clampp(pf * 0.98f);
      we = clampp(pf * 1.02f);
      if (is_final) we = clampp(plan->pitch_end);
    }

    if (!skip_contour) pitch_contour(s, n, ws, we);

    if (std::fabs(plan->energy_factor - 1.0f) > 0.01f) {
      float es = plan->energy_factor, ee = plan->energy_factor;
      if (plan->phrase_type == kExclamatory && word_index == 0) {
        es = plan->energy_factor * 1.1f;
        ee = plan->energy_factor * 0.95f;
      }
      for (size_t i = 0; i < n; ++i) {
        float t = static_cast<float>(i) / static_cast<float>(n - 1);
        float e = es + (ee - es) * t;
        s[i] = clamp_i16(s[i] * e);
      }
    }
  };

  for (int32_t op = 0; op < plan->n_ops; ++op) {
    switch (plan->kind[op]) {
      case kOpUnit: {
        int32_t uid = plan->arg0[op];
        int32_t cf = plan->arg1[op];
        bool after_boundary = plan->flags[op] & 1;
        bool smooth = plan->flags[op] & 2;

        const DbIndexEntry& e = db->index[uid];
        std::vector<int16_t> unit(db->audio + e.audio_offset,
                                  db->audio + e.audio_offset + e.sample_count);
        normalize_rms(unit.data(), unit.size(), plan->target_rms);

        if (smooth && !buf.empty()) {
          smooth_boundary(buf.data(), buf.size(), unit.data(), unit.size(), cf);
          match_energy(buf.data(), buf.size(), unit.data(), unit.size(), cf);
        }

        // buffer_append_crossfade (ctts.c:3279-3358)
        bool first = buf.empty() || after_boundary;
        if (plan->remove_dc_offset) remove_dc(unit.data(), unit.size());
        if (first) {
          fade_in_head(unit.data(), unit.size(), plan->fade_in_samples);
          buf.insert(buf.end(), unit.begin(), unit.end());
        } else if (cf == 0) {
          buf.insert(buf.end(), unit.begin(), unit.end());
        } else {
          size_t actual = std::min<size_t>(
              {static_cast<size_t>(cf), buf.size(), unit.size()});
          if (actual > 0) {
            size_t fs = buf.size() - actual;
            float inv = 1.0f / static_cast<float>(actual);
            for (size_t i = 0; i < actual; ++i) {
              float t = static_cast<float>(i) * inv;
              int32_t mixed = static_cast<int32_t>(
                  buf[fs + i] * fade_out_gain(t) + unit[i] * fade_in_gain(t));
              if (mixed > 32767) mixed = 32767;
              if (mixed < -32768) mixed = -32768;
              buf[fs + i] = static_cast<int16_t>(mixed);
            }
          }
          if (unit.size() > actual)
            buf.insert(buf.end(), unit.begin() + actual, unit.end());
        }
        break;
      }
      case kOpSilence:
        buf.insert(buf.end(), plan->arg0[op], 0);
        break;
      case kOpWordDsp: {
        if (plan->remove_word_silence && buf.size() > word_start) {
          size_t wn = buf.size() - word_start;
          if (wn > static_cast<size_t>(plan->min_silence_samples)) {
            size_t nn = remove_silence(buf.data() + word_start, wn,
                                       plan->silence_threshold,
                                       plan->min_silence_samples);
            buf.resize(word_start + nn);
          }
        }
        if (buf.size() > word_start) {
          apply_intonation(buf.data() + word_start, buf.size() - word_start,
                           plan->arg0[op]);
        }
        break;
      }
      case kOpFadeTail:
        if (!buf.empty() && plan->arg0[op] > 0)
          fade_out_tail(buf.data(), buf.size(), plan->arg0[op]);
        break;
      case kOpMarkWord:
        word_start = buf.size();
        break;
    }
  }

  std::vector<int16_t> result = buf;
  float s1 = plan->speed, one = 1.0f;
  if (std::memcmp(&s1, &one, sizeof(float)) != 0) {
    result = time_stretch(buf, plan->speed);
  }

  auto* mem = static_cast<int16_t*>(std::malloc(
      std::max<size_t>(result.size(), 1) * sizeof(int16_t)));
  std::memcpy(mem, result.data(), result.size() * sizeof(int16_t));
  *out = mem;
  return static_cast<int64_t>(result.size());
}

void ctn_free(int16_t* p) { std::free(p); }

// Wire codec decoder (see ctts_tpu/ops/wire.py for the format): each
// 512-sample block stores 1-5 nibble planes of the zigzagged order-2
// delta residual, 64 uint32 words per plane (nibble i of a block at
// bits 4*(i%8) of word i/8). One streaming pass rebuilds the residual,
// undoes the zigzag, and inverts the predictor with two running int32
// sums (exact wraparound inverse of the encoder's double delta).
// Returns the samples written (== nsamples on success, -1 on a class
// out of range). Called off the serving drain thread via ctypes (the
// call releases the GIL).
int64_t ctn_wire_decode(const uint32_t* wire, const int32_t* classes,
                        int64_t nblk, int64_t nsamples, int16_t* out) {
  const int K = 512;
  const uint32_t* w = wire;
  uint32_t c1 = 0;  // running first delta (uint32: defined wraparound)
  uint32_t x = 0;   // running sample
  int64_t idx = 0;
  int32_t z[K];
  for (int64_t b = 0; b < nblk && idx < nsamples; ++b) {
    const int32_t c = classes[b];
    if (c < 1 || c > 5) return -1;
    for (int i = 0; i < K; ++i) z[i] = 0;
    for (int32_t p = 0; p < c; ++p, w += 64) {
      const int shift = 4 * p;
      for (int wi = 0; wi < 64; ++wi) {
        uint32_t v = w[wi];
        int32_t* zp = z + wi * 8;
        for (int k = 0; k < 8; ++k, v >>= 4)
          zp[k] |= static_cast<int32_t>(v & 0xF) << shift;
      }
    }
    const int n = static_cast<int>(
        nsamples - idx < K ? nsamples - idx : K);
    for (int i = 0; i < n; ++i) {
      const uint32_t zi = static_cast<uint32_t>(z[i]);
      const uint32_t r = (zi >> 1) ^ (~(zi & 1u) + 1u);  // zigzag undo
      c1 += r;
      x += c1;
      out[idx + i] = static_cast<int16_t>(x & 0xFFFFu);
    }
    idx += n;
  }
  return idx;
}

}  // extern "C"
