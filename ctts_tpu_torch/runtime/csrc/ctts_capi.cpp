// ctts_capi: drop-in C API for the ctts_tpu native host runtime.
//
// Implements the reference engine's public interface (ctts.h; parity
// sources cited per function as file:line into reference) as a
// standalone shared library: the complete text frontend (UTF-8 codec,
// pt-BR number expansion, POSIX-regex pronunciation rules, selective
// lowercasing, Portuguese phonotactic unit selection, prosody analysis)
// compiles text into the ctts_tpu SynthesisPlan op stream, which the
// native plan executor (ctts_native.cpp, shared TU) renders bit-exactly.
// A C caller of the reference links against libctts.so unchanged.
//
// The frontend here is the C++ twin of the Python modules — each section
// cites its ctts_tpu module; the Python side is the parity-tested mirror
// of the reference and tests/test_capi.py pins this library against it.

#include <cctype>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>

#include <locale.h>
#include <regex.h>

#include "../include/ctts.h"
#include "ctn_api.h"

namespace {

// ---------------------------------------------------------------------------
// UTF-8 codec + FNV-1a (ctts_tpu/utils/textutil.py; ctts.c:174-231)
// ---------------------------------------------------------------------------

size_t utf8_char_len_at(const unsigned char* s) {
  unsigned char c = s[0];
  if (c < 0x80) return 1;
  if ((c & 0xE0) == 0xC0) return 2;
  if ((c & 0xF0) == 0xE0) return 3;
  if ((c & 0xF8) == 0xF0) return 4;
  return 1;
}

// Decode the codepoint at *p (NUL-terminated); advances *p. Tolerates
// truncated sequences and substitutes '?' for invalid lead bytes
// (ctts.c:183-208).
uint32_t utf8_next_cp(const char** p) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(*p);
  unsigned char c = s[0];
  if (c < 0x80) {
    *p += 1;
    return c;
  }
  if ((c & 0xE0) == 0xC0) {
    uint32_t cp = (c & 0x1F) << 6;
    const unsigned char* q = s + 1;
    if ((*q & 0xC0) == 0x80) cp |= *q++ & 0x3F;
    *p = reinterpret_cast<const char*>(q);
    return cp;
  }
  if ((c & 0xF0) == 0xE0) {
    uint32_t cp = (c & 0x0F) << 12;
    const unsigned char* q = s + 1;
    if ((*q & 0xC0) == 0x80) {
      cp |= (uint32_t)(*q++ & 0x3F) << 6;
      if ((*q & 0xC0) == 0x80) cp |= *q++ & 0x3F;
    }
    *p = reinterpret_cast<const char*>(q);
    return cp;
  }
  if ((c & 0xF8) == 0xF0) {
    uint32_t cp = (c & 0x07) << 18;
    const unsigned char* q = s + 1;
    for (int shift = 12; shift >= 0; shift -= 6) {
      if ((*q & 0xC0) == 0x80) {
        cp |= (uint32_t)(*q++ & 0x3F) << shift;
      } else {
        break;
      }
    }
    *p = reinterpret_cast<const char*>(q);
    return cp;
  }
  *p += 1;
  return '?';
}

void utf8_encode_cp(uint32_t cp, std::string& out) {
  if (cp < 0x80) {
    out.push_back((char)cp);
  } else if (cp < 0x800) {
    out.push_back((char)(0xC0 | (cp >> 6)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back((char)(0xE0 | (cp >> 12)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out.push_back((char)(0xF0 | (cp >> 18)));
    out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// Reference lowercase map: ASCII A-Z plus only É/Ó/Ô/Ç (ctts.c:238-246).
uint32_t unicode_tolower_cp(uint32_t cp) {
  if (cp >= 0x41 && cp <= 0x5A) return cp + 32;
  if (cp == 0xC9) return 0xE9;
  if (cp == 0xD3) return 0xF3;
  if (cp == 0xD4) return 0xF4;
  if (cp == 0xC7) return 0xE7;
  return cp;
}

std::string normalize_lowercase(const std::string& text) {
  std::string out;
  out.reserve(text.size());
  const char* p = text.c_str();
  const char* end = p + text.size();
  while (p < end) {
    utf8_encode_cp(unicode_tolower_cp(utf8_next_cp(&p)), out);
  }
  return out;
}

// ---------------------------------------------------------------------------
// pt-BR number expansion (ctts_tpu/text/numbers.py; ctts.c:523-681)
// ---------------------------------------------------------------------------

const char* kUnitsPt[] = {
    "",         "um",        "dois",      "três",     "quatro",
    "cinco",    "seis",      "sete",      "oito",     "nove",
    "dez",      "onze",      "doze",      "treze",    "quatorze",
    "quinze",   "dezesseis", "dezessete", "dezoito",  "dezenove"};
const char* kTensPt[] = {"",         "",        "vinte",   "trinta",
                         "quarenta", "cinquenta", "sessenta", "setenta",
                         "oitenta",  "noventa"};
const char* kHundredsPt[] = {"",          "cento",      "duzentos",
                             "trezentos", "quatrocentos", "quinhentos",
                             "seiscentos", "setecentos", "oitocentos",
                             "novecentos"};

// 0-999 (ctts.c:541-575).
std::string number_to_words_pt(int64_t n) {
  if (n == 0) return "zero";
  if (n == 100) return "cem";
  int64_t h = n / 100, rem = n % 100, t = rem / 10, u = n % 10;
  std::string out;
  if (h > 0) out += kHundredsPt[h];
  if (rem > 0) {
    if (h > 0) out += " e ";
    if (rem < 20) {
      out += kUnitsPt[rem];
    } else {
      out += kTensPt[t];
      if (u > 0) {
        out += " e ";
        out += kUnitsPt[u];
      }
    }
  }
  return out;
}

int32_t wrap_i32(uint64_t v) { return (int32_t)(uint32_t)v; }

// Full number (ctts.c:578-639). `neg` carries the sign so the magnitude
// can exceed INT64_MAX (the -2^63 corner), matching the Python oracle's
// unbounded-int walk of the C's wrapped accumulator.
std::string full_number_to_words_pt(uint64_t mag, bool neg) {
  if (mag == 0) return "zero";
  std::string out;
  if (neg) out += "menos ";
  uint64_t n = mag;
  if (n >= 1000000000ull) {
    int32_t billions = wrap_i32(n / 1000000000ull);
    if (billions >= 0 && billions <= 999)
      out += number_to_words_pt(billions);
    out += (billions == 1) ? " bilhão" : " bilhões";
    n %= 1000000000ull;
    if (n > 0) out += " e ";
  }
  if (n >= 1000000ull) {
    uint64_t millions = n / 1000000ull;
    out += number_to_words_pt((int64_t)millions);
    out += (millions == 1) ? " milhão" : " milhões";
    n %= 1000000ull;
    if (n > 0) out += " e ";
  }
  if (n >= 1000ull) {
    uint64_t thousands = n / 1000ull;
    if (thousands == 1) {
      out += "mil";
    } else {
      out += number_to_words_pt((int64_t)thousands);
      out += " mil";
    }
    n %= 1000ull;
    if (n > 0) out += (n < 100) ? " e " : " ";
  }
  if (n > 0) out += number_to_words_pt((int64_t)n);
  return out;
}

// Replace each ASCII digit run with its words (ctts.c:642-681); the
// accumulator wraps like a C signed 64-bit long.
std::string expand_numbers(const std::string& text) {
  std::string out;
  out.reserve(text.size());
  size_t i = 0, n = text.size();
  while (i < n) {
    unsigned char b = text[i];
    if (b >= '0' && b <= '9') {
      uint64_t acc = 0;
      while (i < n && text[i] >= '0' && text[i] <= '9') {
        acc = acc * 10u + (uint64_t)(text[i] - '0');
        ++i;
      }
      int64_t num = (int64_t)acc;
      bool neg = num < 0;
      uint64_t mag = neg ? (~(uint64_t)num + 1u) : (uint64_t)num;
      out += full_number_to_words_pt(mag, neg);
    } else {
      out.push_back((char)b);
      ++i;
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// Normalization rules (ctts_tpu/text/rules.py; ctts.c:294-519)
// Compiled with the host's POSIX regcomp — identical to the reference
// binary on the same platform (on glibc, \b-converted rules fail
// regcomp and are dropped with the same warning).
// ---------------------------------------------------------------------------

constexpr int kMaxNormRules = 256;
constexpr int kMaxReplaceLen = 256;

// The reference binary never calls setlocale, so its regcomp/regexec
// run in the C locale (byte semantics; ctype classes and \< \> word
// boundaries are ASCII). A host process embedding this library may
// differ — Python coerces LC_CTYPE to C.UTF-8 at startup, under which
// regexec treats multibyte sequences as single word characters and
// 't\>' stops matching before a UTF-8 'á'. Every regcomp/regexec in
// this file runs under this per-thread C-locale scope.
class CLocaleScope {
 public:
  CLocaleScope() : old_(uselocale(c_loc())) {}
  ~CLocaleScope() { uselocale(old_); }
  CLocaleScope(const CLocaleScope&) = delete;
  CLocaleScope& operator=(const CLocaleScope&) = delete;

 private:
  static locale_t c_loc() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return loc;
  }
  locale_t old_;
};

struct NormRule {
  regex_t regex;
  char replace[kMaxReplaceLen];
  bool compiled = false;
};

NormRule g_norm_rules[kMaxNormRules];
size_t g_norm_rule_count = 0;
bool g_norm_rules_loaded = false;

// Portable \b → [[:<:]] / [[:>:]] by following-char context
// (ctts.c:294-340): word-start iff the next char is alphanumeric, '[' or
// '('; word-end otherwise.
std::string convert_word_boundaries(const char* pattern) {
  std::string out;
  const char* p = pattern;
  while (*p) {
    if (p[0] == '\\' && p[1] == 'b') {
      char nxt = p[2];
      bool word_start = (nxt >= 'a' && nxt <= 'z') ||
                        (nxt >= 'A' && nxt <= 'Z') ||
                        (nxt >= '0' && nxt <= '9') || nxt == '[' ||
                        nxt == '(';
      out += word_start ? "[[:<:]]" : "[[:>:]]";
      p += 2;
    } else {
      out.push_back(*p++);
    }
  }
  return out;
}

// Replacement writer with \0..\9 backrefs (ctts.c:411-436).
void write_replacement(std::string& dst, size_t cap, const char* replace,
                       const char* src, const regmatch_t* m) {
  const char* r = replace;
  while (*r && dst.size() < cap) {
    if (r[0] == '\\' && r[1] >= '0' && r[1] <= '9') {
      int group = r[1] - '0';
      if (m[group].rm_so >= 0) {
        size_t glen = (size_t)(m[group].rm_eo - m[group].rm_so);
        glen = std::min(glen, cap - dst.size());
        dst.append(src + m[group].rm_so, glen);
      }
      r += 2;
    } else {
      dst.push_back(*r++);
    }
  }
}

// Sequential whole-string rewrite per rule with the reference's output
// cap and zero-length-match byte skip (ctts.c:439-505).
std::string apply_normalization_str(const std::string& text) {
  if (g_norm_rule_count == 0) return text;
  CLocaleScope c_locale;
  size_t cap = text.size() * 4 + 1024 - 1;
  std::string current = text;
  for (size_t ri = 0; ri < g_norm_rule_count; ++ri) {
    NormRule& rule = g_norm_rules[ri];
    if (!rule.compiled) continue;
    std::string next;
    next.reserve(current.size());
    const char* src = current.c_str();
    regmatch_t m[10];
    while (*src && next.size() < cap) {
      if (regexec(&rule.regex, src, 10, m, 0) == 0 && m[0].rm_so >= 0) {
        size_t before = std::min((size_t)m[0].rm_so, cap - next.size());
        next.append(src, before);
        write_replacement(next, cap, rule.replace, src, m);
        src += m[0].rm_eo;
        if (m[0].rm_eo == 0) ++src;  // zero-length match: skip one byte
      } else {
        next.append(src, std::min(strlen(src), cap - next.size()));
        break;
      }
    }
    current = std::move(next);
  }
  return current;
}

// ---------------------------------------------------------------------------
// Duration rules (ctts_tpu/text/duration_rules.py; ctts.c:2279-2343).
// Loader is live (observable stderr message); application is dead code
// in the reference and intentionally remains so here.
// ---------------------------------------------------------------------------

bool g_duration_rules_loaded = false;

void load_duration_rules(const char* csv_file) {
  if (g_duration_rules_loaded) return;
  FILE* f = std::fopen(csv_file, "r");
  if (!f) {
    g_duration_rules_loaded = true;
    return;
  }
  char line[256];
  size_t count = 0;
  while (std::fgets(line, sizeof line, f) && count < 128) {
    if (line[0] == '#' || line[0] == '\n' || line[0] == '\r') continue;
    char ptype[32];
    int position, stress;
    float factor;
    if (std::sscanf(line, "%31[^,],%d,%d,%f", ptype, &position, &stress,
                    &factor) == 4) {
      ++count;
    }
  }
  std::fclose(f);
  g_duration_rules_loaded = true;
  if (count > 0) {
    std::fprintf(stderr, "Loaded %zu duration rules\n", count);
  }
}

// ---------------------------------------------------------------------------
// Portuguese phonotactics (ctts_tpu/text/phonology.py; ctts.c:3042-3268,
// 1765-1892)
// ---------------------------------------------------------------------------

bool is_vowel_cp(uint32_t cp) {
  switch (cp) {
    case 'a': case 'e': case 'i': case 'o': case 'u':
    case 'A': case 'E': case 'I': case 'O': case 'U':
    case 0xE1: case 0xC1: case 0xE0: case 0xC0: case 0xE2: case 0xC2:
    case 0xE3: case 0xC3: case 0xE9: case 0xC9: case 0xEA: case 0xCA:
    case 0xED: case 0xCD: case 0xF3: case 0xD3: case 0xF4: case 0xD4:
    case 0xF5: case 0xD5: case 0xFA: case 0xDA: case 0xFC: case 0xDC:
      return true;
    default:
      return false;
  }
}

bool is_pt_consonant_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') cp += 32;
  if (cp == 0xC7) cp = 0xE7;
  return (cp >= 'a' && cp <= 'z' && !is_vowel_cp(cp)) || cp == 0xE7;
}

unsigned char lower_ascii(unsigned char b) {
  return (b >= 'A' && b <= 'Z') ? b + 32 : b;
}

// ch/lh/nh/qu/gu on the first two bytes (ctts.c:3146-3164).
bool is_pt_digraph2(unsigned char c1, unsigned char c2) {
  c1 = lower_ascii(c1);
  c2 = lower_ascii(c2);
  if (c2 == 'h') return c1 == 'c' || c1 == 'l' || c1 == 'n';
  if (c2 == 'u') return c1 == 'q' || c1 == 'g';
  return false;
}

bool is_pt_digraph(const char* text, size_t len) {
  if (len < 2) return false;
  return is_pt_digraph2(text[0], text[1]);
}

// Obstruent+liquid onsets (ctts.c:3167-3190).
bool is_pt_valid_cluster(const char* text, size_t len) {
  if (len < 2) return false;
  unsigned char c1 = lower_ascii(text[0]);
  unsigned char c2 = lower_ascii(text[1]);
  if (c2 == 'r')
    return c1 == 'p' || c1 == 'b' || c1 == 't' || c1 == 'd' || c1 == 'c' ||
           c1 == 'g' || c1 == 'f' || c1 == 'v';
  if (c2 == 'l')
    return c1 == 'p' || c1 == 'b' || c1 == 'c' || c1 == 'g' || c1 == 'f';
  return false;
}

// Reject invalid single-consonant matches (ctts.c:3193-3217).
bool pt_reject_single_consonant(const char* text, size_t pos,
                                int match_char_count, bool at_word_start) {
  if (match_char_count != 1) return false;
  const char* p = text + pos;
  uint32_t cp = utf8_next_cp(&p);
  if (is_vowel_cp(cp)) return false;
  if (at_word_start) return true;
  // Mid-word: reject if this consonant starts a digraph with the next
  // byte. The C truncates the codepoint to a char for the test pair
  // (ctts.c:3209-3213).
  if (*p != '\0') {
    uint32_t c0 = (cp >= 'A' && cp <= 'Z') ? cp + 32 : cp;
    unsigned char pair0 = (unsigned char)(c0 & 0xFF);
    if (is_pt_digraph2(pair0, lower_ascii(*p))) return true;
  }
  return false;
}

// Syllable quality score (ctts.c:3220-3268).
int pt_syllable_score(const char* chunk, size_t len, int char_count,
                      bool at_word_start) {
  int score = char_count * 10;
  if (char_count == 0) return -1000;

  const char* p = chunk;
  uint32_t first_cp = utf8_next_cp(&p);
  bool first_is_consonant = is_pt_consonant_cp(first_cp);

  if (char_count >= 2) {
    if (is_pt_digraph(chunk, len)) score += 20;
    if (first_is_consonant && is_pt_valid_cluster(chunk, len)) score += 15;
  }

  if (at_word_start && first_is_consonant) {
    if (char_count == 1) {
      score -= 100;
    } else if (p < chunk + len) {
      uint32_t second_cp = utf8_next_cp(&p);
      if (is_vowel_cp(second_cp)) score += 25;
    }
  }

  // Last character → open-syllable bonus.
  uint32_t last_cp = 0;
  const char* q = chunk;
  while (q < chunk + len) last_cp = utf8_next_cp(&q);
  if (is_vowel_cp(last_cp)) score += 10;
  return score;
}

enum PhonemeType {
  PHONEME_VOWEL = 0,
  PHONEME_PLOSIVE = 1,
  PHONEME_FRICATIVE = 2,
  PHONEME_NASAL = 3,
  PHONEME_LIQUID = 4,
  PHONEME_OTHER = 5,
};

// ctts.c:1775-1814.
PhonemeType classify_first_phoneme(const char* text, size_t len) {
  if (len == 0) return PHONEME_OTHER;
  unsigned char c = lower_ascii(text[0]);
  const char* p = text;
  uint32_t cp = utf8_next_cp(&p);
  if (is_vowel_cp(cp)) return PHONEME_VOWEL;
  if (c == 'p' || c == 't' || c == 'k' || c == 'b' || c == 'd' || c == 'g')
    return PHONEME_PLOSIVE;
  if (c == 'f' || c == 'v' || c == 's' || c == 'z' || c == 'x' || c == 'j')
    return PHONEME_FRICATIVE;
  if (len >= 2 && c == 'c' && (text[1] == 'h' || text[1] == 'H'))
    return PHONEME_FRICATIVE;
  if (c == 'm' || c == 'n') return PHONEME_NASAL;
  if (c == 'l' || c == 'r') return PHONEME_LIQUID;
  return PHONEME_OTHER;
}

// ctts.c:1817-1854.
PhonemeType classify_last_phoneme(const char* text, size_t len) {
  if (len == 0) return PHONEME_OTHER;
  // Last UTF-8 character start.
  size_t p = 0, last = 0;
  while (p < len) {
    last = p;
    p += utf8_char_len_at(
        reinterpret_cast<const unsigned char*>(text) + p);
  }
  const char* lp = text + last;
  uint32_t cp = utf8_next_cp(&lp);
  if (is_vowel_cp(cp)) return PHONEME_VOWEL;

  unsigned char c = lower_ascii(text[len - 1]);
  if (len >= 2) {
    unsigned char c2 = lower_ascii(text[len - 2]);
    if (c2 == 'l' && c == 'h') return PHONEME_LIQUID;
    if (c2 == 'n' && c == 'h') return PHONEME_NASAL;
    if (c2 == 'c' && c == 'h') return PHONEME_FRICATIVE;
  }
  if (c == 'p' || c == 't' || c == 'k' || c == 'b' || c == 'd' || c == 'g')
    return PHONEME_PLOSIVE;
  if (c == 'f' || c == 'v' || c == 's' || c == 'z' || c == 'x' || c == 'j')
    return PHONEME_FRICATIVE;
  if (c == 'm' || c == 'n') return PHONEME_NASAL;
  if (c == 'l' || c == 'r') return PHONEME_LIQUID;
  return PHONEME_OTHER;
}

// Phoneme-aware crossfade duration in ms, f32 order (ctts.c:1857-1892).
float get_adaptive_crossfade(PhonemeType prev_end, PhonemeType next_start,
                             const CTTSConfig* cfg) {
  float base = cfg->crossfade_ms;
  if (next_start == PHONEME_PLOSIVE) return base * 0.2f;
  if (prev_end == PHONEME_PLOSIVE) return base * 0.3f;
  if (next_start == PHONEME_FRICATIVE || prev_end == PHONEME_FRICATIVE)
    return base * 0.4f;
  if (prev_end == PHONEME_VOWEL && next_start == PHONEME_VOWEL)
    return cfg->crossfade_vowel_ms;
  if (prev_end == PHONEME_VOWEL && next_start != PHONEME_VOWEL)
    return base * cfg->vowel_to_consonant_factor;
  if (prev_end == PHONEME_NASAL || prev_end == PHONEME_LIQUID ||
      next_start == PHONEME_NASAL || next_start == PHONEME_LIQUID)
    return base * 0.7f;
  return base;
}

uint32_t last_cp_of(const char* text, size_t len) {
  size_t p = 0, last = 0;
  while (p < len) {
    last = p;
    p += utf8_char_len_at(
        reinterpret_cast<const unsigned char*>(text) + p);
  }
  if (len == 0) return 0;
  const char* lp = text + last;
  return utf8_next_cp(&lp);
}

bool ends_with_s(const char* text, size_t len) {
  uint32_t cp = last_cp_of(text, len);
  return len > 0 && (cp == 's' || cp == 'S');
}
bool ends_with_r(const char* text, size_t len) {
  uint32_t cp = last_cp_of(text, len);
  return len > 0 && (cp == 'r' || cp == 'R');
}

// ---------------------------------------------------------------------------
// Prosody (ctts_tpu/text/prosody.py; ctts.c:2526-2933, 690-714)
// ---------------------------------------------------------------------------

enum PhraseTypeC {
  PHRASE_DECLARATIVE = 0,
  PHRASE_INTERROGATIVE = 1,
  PHRASE_EXCLAMATORY = 2,
  PHRASE_CONTINUATION = 3,
  PHRASE_LISTING = 4,
};

struct Intonation {
  int type;
  float pitch_start, pitch_end, pitch_peak, peak_position;
  float energy_factor, final_lengthening;
};

struct Prosody {
  bool is_question = false, is_exclamation = false;
  int word_count = 0;
  float pitch_modifier = 1.0f;
  int phrase_type = PHRASE_DECLARATIVE;
  Intonation intonation{};
};

float clamp_pitch(float p, float max_change) {
  float lo = 1.0f - max_change, hi = 1.0f + max_change;
  if (p < lo) return lo;
  if (p > hi) return hi;
  return p;
}

// Contour parameter table (ctts.c:2638-2721).
Intonation phrase_intonation(int ptype) {
  switch (ptype) {
    case PHRASE_INTERROGATIVE:
      return {ptype, 0.98f, 1.08f, 1.18f, 0.75f, 1.05f, 1.25f};
    case PHRASE_EXCLAMATORY:
      return {ptype, 1.18f, 0.88f, 1.22f, 0.15f, 1.25f, 1.15f};
    case PHRASE_CONTINUATION:
      return {ptype, 1.0f, 1.12f, 1.08f, 0.7f, 0.95f, 1.20f};
    case PHRASE_LISTING:
      return {ptype, 1.0f, 1.06f, 1.12f, 0.55f, 1.0f, 1.10f};
    default:
      return {ptype, 1.04f, 0.88f, 1.04f, 0.08f, 1.0f, 1.18f};
  }
}

// Scale the contour toward 1.0 to fit the limit (ctts.c:2611-2635).
void scale_intonation_to_limit(Intonation* in, float mc) {
  if (mc <= 0.0f) return;
  float ds = std::fabs(in->pitch_start - 1.0f);
  float de = std::fabs(in->pitch_end - 1.0f);
  float dp = std::fabs(in->pitch_peak - 1.0f);
  float max_dev = std::max(ds, std::max(de, dp));
  if (max_dev <= mc) return;
  float scale = mc / max_dev;
  in->pitch_start = 1.0f + (in->pitch_start - 1.0f) * scale;
  in->pitch_end = 1.0f + (in->pitch_end - 1.0f) * scale;
  in->pitch_peak = 1.0f + (in->pitch_peak - 1.0f) * scale;
}

// Word count + phrase type from the RAW input text (ctts.c:2883-2933);
// only the backward-scanned first non-space byte decides the type.
Prosody analyze_prosody(const char* text, float max_pitch_change) {
  Prosody ctx;
  size_t n = std::strlen(text);
  if (n > 0) {
    bool in_word = false;
    for (size_t i = 0; i < n; ++i) {
      unsigned char b = text[i];
      if (b == ' ' || b == '\t' || b == '\n') {
        in_word = false;
      } else if (!in_word) {
        in_word = true;
        ctx.word_count++;
      }
    }
    for (size_t i = n; i > 0; --i) {
      unsigned char c = text[i - 1];
      if (c == '?') {
        ctx.is_question = true;
        ctx.phrase_type = PHRASE_INTERROGATIVE;
        ctx.pitch_modifier = clamp_pitch(1.05f, max_pitch_change);
        break;
      }
      if (c == '!') {
        ctx.is_exclamation = true;
        ctx.phrase_type = PHRASE_EXCLAMATORY;
        ctx.pitch_modifier = clamp_pitch(1.08f, max_pitch_change);
        break;
      }
      if (c == ',' || c == ';') {
        ctx.phrase_type = PHRASE_CONTINUATION;
        break;
      }
      if (c != ' ' && c != '\t' && c != '\n') {
        ctx.phrase_type = PHRASE_DECLARATIVE;
        break;
      }
    }
  }
  ctx.intonation = phrase_intonation(ctx.phrase_type);
  scale_intonation_to_limit(&ctx.intonation, max_pitch_change);
  return ctx;
}

// Per-punctuation pause as a word-pause multiplier (ctts.c:690-709).
float punctuation_pause_ms(unsigned char punct, float word_pause_ms) {
  float mult;
  switch (punct) {
    case ',': mult = 1.8f; break;
    case ';': mult = 2.2f; break;
    case ':': mult = 2.0f; break;
    case '.': mult = 3.0f; break;
    case '!': mult = 3.2f; break;
    case '?': mult = 3.0f; break;
    case '-': mult = 0.0f; break;
    default: mult = 1.0f; break;
  }
  return word_pause_ms * mult;
}

bool is_sentence_end_c(unsigned char c) {
  return c == '.' || c == '!' || c == '?';
}

// ---------------------------------------------------------------------------
// Unit selection (ctts_tpu/plan/select.py; ctts.c:1357-1554)
// ---------------------------------------------------------------------------

constexpr int kMaxCandidates = 64;

// Byte offset after walking up to max_chars characters from pos.
size_t char_prefix_end(const char* text, size_t pos, size_t n,
                       int max_chars) {
  size_t end = pos;
  int c = 0;
  while (c < max_chars && end < n && text[end] != '\0') {
    end += utf8_char_len_at(
        reinterpret_cast<const unsigned char*>(text) + end);
    ++c;
  }
  return end;
}

// Move `end` back one UTF-8 character (ctts.c:1376-1383).
size_t step_back_one_char(const char* text, size_t pos, size_t end) {
  size_t prev_end = pos, scan = pos;
  while (scan < end) {
    prev_end = scan;
    scan += utf8_char_len_at(
        reinterpret_cast<const unsigned char*>(text) + scan);
    if (scan >= end) break;
  }
  return prev_end;
}

// Longest unit match at pos, in bytes; 0 if none (ctts.c:1357-1387).
// Quirk kept: the initial try length caps character count by the
// remaining BYTE count (ctts.c:1359-1360).
int find_longest_match(void* ndb, const char* text, size_t pos, size_t n,
                       int max_chars) {
  size_t remaining = n - pos;
  int try_chars = std::min((size_t)max_chars, remaining);
  size_t end = char_prefix_end(text, pos, n, try_chars);
  while (end > pos) {
    if (ctn_db_find_unit(ndb, text + pos, end - pos) >= 0)
      return (int)(end - pos);
    end = step_back_one_char(text, pos, end);
  }
  return 0;
}

struct Candidate {
  int byte_len;
  int char_count;
  int32_t unit_idx;
  int next_match_len;
  int pt_score;
};

// Returns (byte_len, unit_idx) via out-params; byte_len 0 when nothing
// matches (ctts.c:1406-1554).
void find_best_match_with_lookahead(void* ndb, const char* text, size_t pos,
                                    size_t n, int max_chars,
                                    bool at_word_start, int* out_len,
                                    int32_t* out_idx) {
  *out_len = 0;
  *out_idx = -1;
  if (pos >= n) return;

  int remaining_chars = 0;
  for (size_t tmp = pos; tmp < n;) {
    remaining_chars++;
    tmp += utf8_char_len_at(
        reinterpret_cast<const unsigned char*>(text) + tmp);
  }
  int try_chars = std::min(max_chars, remaining_chars);

  Candidate cands[kMaxCandidates];
  int n_cands = 0;
  size_t end = char_prefix_end(text, pos, n, try_chars);
  int char_count = try_chars;
  while (end > pos && n_cands < kMaxCandidates) {
    int32_t unit_idx = ctn_db_find_unit(ndb, text + pos, end - pos);
    if (unit_idx >= 0 &&
        !pt_reject_single_consonant(text, pos, char_count, at_word_start)) {
      cands[n_cands++] = {
          (int)(end - pos), char_count, unit_idx, 0,
          pt_syllable_score(text + pos, end - pos, char_count,
                            at_word_start)};
    }
    end = step_back_one_char(text, pos, end);
    char_count--;
  }

  if (n_cands == 0) return;
  if (n_cands == 1) {
    *out_len = cands[0].byte_len;
    *out_idx = cands[0].unit_idx;
    return;
  }

  // Look-ahead: longest match at the next position, whitespace skipped
  // (ctts.c:1486-1495).
  for (int i = 0; i < n_cands; ++i) {
    size_t next_pos = pos + cands[i].byte_len;
    while (next_pos < n &&
           (text[next_pos] == ' ' || text[next_pos] == '\t' ||
            text[next_pos] == '\n'))
      ++next_pos;
    if (next_pos < n)
      cands[i].next_match_len =
          find_longest_match(ndb, text, next_pos, n, max_chars);
  }

  // pt_score, then coverage (chars + next BYTES — reference quirk,
  // ctts.c:1511), then end-of-word tie-breaks (ctts.c:1509-1550).
  int best = 0;
  int best_pt = cands[0].pt_score;
  int best_total = cands[0].char_count + cands[0].next_match_len;
  for (int i = 1; i < n_cands; ++i) {
    const Candidate& c = cands[i];
    int total = c.char_count + c.next_match_len;
    if (c.pt_score > best_pt) {
      best = i;
      best_pt = c.pt_score;
      best_total = total;
    } else if (c.pt_score == best_pt) {
      if (total > best_total) {
        best = i;
        best_total = total;
      } else if (total == best_total) {
        const Candidate& b = cands[best];
        bool best_at_end = b.next_match_len == 0;
        bool curr_at_end = c.next_match_len == 0;
        if (best_at_end && !curr_at_end) {
          // keep best
        } else if (!best_at_end && curr_at_end) {
          best = i;
        } else if (best_at_end && curr_at_end) {
          if (c.char_count > b.char_count) best = i;
        } else {
          if (c.next_match_len > b.next_match_len) best = i;
        }
      }
    }
  }
  *out_len = cands[best].byte_len;
  *out_idx = cands[best].unit_idx;
}

// ---------------------------------------------------------------------------
// Plan compiler (ctts_tpu/plan/compiler.py; control flow of
// ctts_synthesize, ctts.c:3623-3898)
// ---------------------------------------------------------------------------

// (size_t)(ms * CTTS_SAMPLE_RATE / 1000.0f) with f32 order
// (ctts.c:3666-3667).
int32_t ms_to_samples(float ms) {
  return (int32_t)(ms * (float)CTTS_SAMPLE_RATE / 1000.0f);
}

enum OpKind {
  OP_UNIT = 0,
  OP_SILENCE = 1,
  OP_WORD_DSP = 2,
  OP_FADE_TAIL = 3,
  OP_MARK_WORD = 4,
};

struct PlanOps {
  std::vector<int32_t> kind, arg0, arg1, flags;
  uint32_t units_found = 0, units_missing = 0;
  void push(int32_t k, int32_t a0 = 0, int32_t a1 = 0, int32_t fl = 0) {
    kind.push_back(k);
    arg0.push_back(a0);
    arg1.push_back(a1);
    flags.push_back(fl);
  }
};

bool is_ws(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}
bool is_punct_c(unsigned char c) {
  return c == ',' || c == ';' || c == ':' || c == '.' || c == '!' ||
         c == '?';
}
bool is_skip_c(unsigned char c) {
  return c == '(' || c == ')' || c == '[' || c == ']' || c == '"' ||
         c == '\'' || c == '`';
}

PlanOps compile_ops(void* ndb, const std::string& normalized,
                    const CTTSConfig* cfg) {
  PlanOps ops;
  const char* text = normalized.c_str();
  size_t n = normalized.size();
  int max_chars = (int)ctn_db_max_unit_chars(ndb);

  int32_t word_pause = ms_to_samples(cfg->word_pause_ms);
  int32_t unknown_silence = ms_to_samples(cfg->unknown_silence_ms);
  int32_t fade_out = ms_to_samples(cfg->fade_out_ms);

  size_t pos = 0;
  const char* prev_unit_text = nullptr;
  size_t prev_unit_len = 0;
  bool prev_was_word_boundary = true;
  PhonemeType prev_end_phoneme = PHONEME_OTHER;
  int current_word_index = 0;

  while (pos < n) {
    unsigned char c = text[pos];

    if (is_ws(c)) {
      ops.push(OP_WORD_DSP, current_word_index);
      ops.push(OP_FADE_TAIL, fade_out);
      ops.push(OP_SILENCE, word_pause);
      ops.push(OP_MARK_WORD);
      current_word_index++;
      pos++;
      prev_was_word_boundary = true;
      prev_unit_text = nullptr;
      prev_end_phoneme = PHONEME_OTHER;
      continue;
    }

    if (c == '-') {  // soft separator (ctts.c:3736-3741)
      pos++;
      continue;
    }

    if (is_punct_c(c)) {
      float pause_ms = punctuation_pause_ms(c, cfg->word_pause_ms);
      int32_t pause = ms_to_samples(pause_ms);
      ops.push(OP_FADE_TAIL, fade_out);
      if (pause > 0) ops.push(OP_SILENCE, pause);
      if (is_sentence_end_c(c)) {
        current_word_index = 0;
        ops.push(OP_MARK_WORD, 0, 0, 1 /* sentence_end */);
      }
      pos++;
      prev_was_word_boundary = true;
      continue;
    }

    if (is_skip_c(c)) {
      pos++;
      continue;
    }

    int match_len;
    int32_t unit_idx;
    find_best_match_with_lookahead(ndb, text, pos, n, max_chars,
                                   prev_was_word_boundary, &match_len,
                                   &unit_idx);

    if (match_len > 0 && unit_idx >= 0) {
      uint32_t ulen = 0;
      const char* utext = ctn_db_unit_text(ndb, unit_idx, &ulen);
      if (cfg->print_units) {
        std::fprintf(stderr, "  [%.*s] ", (int)ulen, utext);
      }

      PhonemeType curr_start = classify_first_phoneme(utext, ulen);
      PhonemeType curr_end = classify_last_phoneme(utext, ulen);

      float crossfade_ms;
      if (!prev_was_word_boundary && prev_unit_text != nullptr) {
        crossfade_ms =
            get_adaptive_crossfade(prev_end_phoneme, curr_start, cfg);
        if (ends_with_s(prev_unit_text, prev_unit_len) &&
            crossfade_ms > cfg->crossfade_s_ending_ms) {
          crossfade_ms = cfg->crossfade_s_ending_ms;
        } else if (ends_with_r(prev_unit_text, prev_unit_len) &&
                   crossfade_ms > cfg->crossfade_r_ending_ms) {
          crossfade_ms = cfg->crossfade_r_ending_ms;
        }
      } else {
        crossfade_ms = cfg->crossfade_ms;
      }

      int fl = (prev_was_word_boundary ? 1 : 0) |
               (!prev_was_word_boundary ? 2 : 0);
      ops.push(OP_UNIT, unit_idx, ms_to_samples(crossfade_ms), fl);

      prev_unit_text = utext;
      prev_unit_len = ulen;
      prev_end_phoneme = curr_end;
      prev_was_word_boundary = false;
      pos += match_len;
      ops.units_found++;
    } else {
      ops.push(OP_SILENCE, unknown_silence);
      pos += utf8_char_len_at(
          reinterpret_cast<const unsigned char*>(text) + pos);
      ops.units_missing++;
      prev_unit_text = nullptr;
      prev_end_phoneme = PHONEME_OTHER;
    }
  }
  if (cfg->print_units) std::fprintf(stderr, "\n");

  // Trailing word: silence removal + intonation + final fade
  // (ctts.c:3877-3904).
  ops.push(OP_WORD_DSP, current_word_index);
  ops.push(OP_FADE_TAIL, fade_out);
  return ops;
}

// ---------------------------------------------------------------------------
// Config parsing (ctts_tpu/config.py; ctts.c:1190-1311)
// ---------------------------------------------------------------------------

void set_config_key(CTTSConfig* c, const char* key, const char* value) {
  float fv = std::strtof(value, nullptr);
  bool bv = std::strcmp(value, "true") == 0 || std::strcmp(value, "1") == 0;
  if (!std::strcmp(key, "crossfade_ms")) c->crossfade_ms = fv;
  else if (!std::strcmp(key, "crossfade_vowel_ms")) c->crossfade_vowel_ms = fv;
  else if (!std::strcmp(key, "crossfade_s_ending_ms"))
    c->crossfade_s_ending_ms = fv;
  else if (!std::strcmp(key, "crossfade_r_ending_ms"))
    c->crossfade_r_ending_ms = fv;
  else if (!std::strcmp(key, "vowel_to_consonant_factor"))
    c->vowel_to_consonant_factor = fv;
  else if (!std::strcmp(key, "word_pause_ms")) c->word_pause_ms = fv;
  else if (!std::strcmp(key, "unknown_silence_ms")) c->unknown_silence_ms = fv;
  else if (!std::strcmp(key, "fade_in_ms")) c->fade_in_ms = fv;
  else if (!std::strcmp(key, "fade_out_ms")) c->fade_out_ms = fv;
  else if (!std::strcmp(key, "remove_word_silence")) c->remove_word_silence = bv;
  else if (!std::strcmp(key, "silence_threshold")) c->silence_threshold = fv;
  else if (!std::strcmp(key, "min_silence_ms")) c->min_silence_ms = fv;
  else if (!std::strcmp(key, "remove_dc_offset")) c->remove_dc_offset = bv;
  else if (!std::strcmp(key, "normalize_level")) c->normalize_level = fv;
  else if (!std::strcmp(key, "compression")) c->compression = fv;
  else if (!std::strcmp(key, "default_speed")) c->default_speed = fv;
  else if (!std::strcmp(key, "min_speed")) c->min_speed = fv;
  else if (!std::strcmp(key, "max_speed")) c->max_speed = fv;
  else if (!std::strcmp(key, "max_pitch_change")) c->max_pitch_change = fv;
  else if (!std::strcmp(key, "print_units")) c->print_units = bv;
  else if (!std::strcmp(key, "print_timing")) c->print_timing = bv;
}

// ---------------------------------------------------------------------------
// WAV I/O (ctts_tpu/utils/wav.py; ctts.c:721-848)
// ---------------------------------------------------------------------------

void put_u32(std::FILE* f, uint32_t v) { std::fwrite(&v, 4, 1, f); }
void put_u16(std::FILE* f, uint16_t v) { std::fwrite(&v, 2, 1, f); }

// Read a PCM16 WAV as int16 mono (stereo averaged with C truncation;
// ctts.c:721-807). Returns false on any format error.
bool read_wav_file(const char* path, std::vector<int16_t>* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 12) {
    std::fclose(f);
    return false;
  }
  std::vector<uint8_t> data(fsize);
  if (std::fread(data.data(), 1, fsize, f) != (size_t)fsize) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);

  if (std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0)
    return false;

  size_t pos = 12;
  bool have_fmt = false;
  uint16_t audio_format = 0, channels = 0, bits = 0;
  const uint8_t* payload = nullptr;
  size_t payload_size = 0;
  while (pos + 8 <= data.size()) {
    uint32_t size;
    std::memcpy(&size, data.data() + pos + 4, 4);
    size_t body = pos + 8;
    if (std::memcmp(data.data() + pos, "fmt ", 4) == 0) {
      if (size < 16 || body + 16 > data.size()) return false;
      std::memcpy(&audio_format, data.data() + body, 2);
      std::memcpy(&channels, data.data() + body + 2, 2);
      std::memcpy(&bits, data.data() + body + 14, 2);
      have_fmt = true;
      pos = body + size;
    } else if (std::memcmp(data.data() + pos, "data", 4) == 0) {
      payload = data.data() + body;
      payload_size = std::min((size_t)size, data.size() - body);
      break;
    } else {
      pos = body + size;
    }
  }
  if (!have_fmt || !payload) return false;
  if (audio_format != 1 || bits != 16 || channels == 0) return false;

  size_t frames = payload_size / 2 / channels;  // truncation (ctts.c:777)
  out->resize(frames);
  const int16_t* raw = reinterpret_cast<const int16_t*>(payload);
  if (channels == 1) {
    std::memcpy(out->data(), raw, frames * 2);
  } else {
    for (size_t i = 0; i < frames; ++i) {
      int32_t left = raw[i * channels];
      int32_t right = raw[i * channels + 1];
      (*out)[i] = (int16_t)((left + right) / 2);  // trunc toward zero
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Database builder (ctts_tpu/db/builder.py; ctts.c:855-1111)
// ---------------------------------------------------------------------------

struct BuildUnit {
  std::string text;
  int char_count;
  std::vector<int16_t> samples;
  uint32_t hash;
  size_t order;  // load order (stable sort tiebreak, like Python sorted)
};

uint32_t fnv1a_str(const char* s, size_t len) {
  uint32_t h = 2166136261u;
  for (size_t i = 0; i < len; ++i) {
    h ^= (unsigned char)s[i];
    h *= 16777619u;
  }
  return h;
}

int utf8_strlen_str(const std::string& s) {
  int n = 0;
  for (unsigned char c : s)
    if ((c & 0xC0) != 0x80) ++n;
  return n;
}

// Parse one `filename|text|display` index (ctts.c:855-928); unloadable
// WAVs are warned about and skipped.
bool load_units_from_index(const char* wav_dir, const char* index_file,
                           std::vector<BuildUnit>* units) {
  std::FILE* f = std::fopen(index_file, "rb");
  if (!f) return false;
  char line[4096];
  while (std::fgets(line, sizeof line, f)) {
    size_t len = std::strlen(line);
    while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r'))
      line[--len] = '\0';
    if (len == 0) continue;
    char* bar = std::strchr(line, '|');
    if (!bar || bar == line) continue;
    *bar = '\0';
    const char* filename = line;
    const char* text = bar + 1;
    char* bar2 = std::strchr(bar + 1, '|');
    std::string text_s =
        bar2 ? std::string(text, bar2 - text) : std::string(text);

    std::string path = std::string(wav_dir) + "/" + filename + ".wav";
    BuildUnit u;
    if (!read_wav_file(path.c_str(), &u.samples)) {
      std::fprintf(stderr, "Warning: Could not load %s\n", path.c_str());
      continue;
    }
    u.text = normalize_lowercase(text_s);
    u.char_count = utf8_strlen_str(u.text);
    u.hash = fnv1a_str(u.text.data(), u.text.size());
    u.order = units->size();
    units->push_back(std::move(u));
  }
  std::fclose(f);
  return true;
}

#pragma pack(push, 1)
struct CapiDbHeader {
  uint32_t magic, version, unit_count, sample_rate, bits_per_sample;
  uint32_t index_offset, strings_offset, audio_offset, total_samples;
  uint32_t max_unit_chars, hash_table_size, hash_table_offset;
  uint8_t reserved[16];
};
struct CapiDbIndexEntry {
  uint32_t hash, string_offset;
  uint16_t string_len, char_count;
  uint32_t audio_offset, sample_count, flags, next_hash, reserved;
};
#pragma pack(pop)

// ---------------------------------------------------------------------------
// Engine
// ---------------------------------------------------------------------------

// The engine handle: the public transparent struct (include/ctts.h,
// matching the reference layout ctts.h:128-149) followed by the private
// ctn database handle. The pointer handed to callers is &impl->pub, so
// reference-style field access (engine->header.unit_count,
// engine->units_found, &engine->config — ctts.c:3990-4015) works.
struct EngineImpl {
  CTTS pub{};
  void* ndb = nullptr;  // ctn database handle
};
static_assert(offsetof(EngineImpl, pub) == 0, "pub must lead the impl");

EngineImpl* impl_of(CTTS* engine) {
  return reinterpret_cast<EngineImpl*>(engine);
}

}  // namespace

extern "C" {

// ---- utilities (ctts.c:174-287) ----

size_t ctts_utf8_strlen(const char* str) {
  size_t n = 0;
  for (const unsigned char* p = (const unsigned char*)str; *p; ++p)
    if ((*p & 0xC0) != 0x80) ++n;
  return n;
}

uint32_t ctts_utf8_next(const char** str) { return utf8_next_cp(str); }

uint32_t ctts_hash(const char* str, size_t len) {
  return fnv1a_str(str, len);
}

char* ctts_normalize(const char* text) {
  if (!text) return nullptr;
  std::string out = normalize_lowercase(text);
  return strdup(out.c_str());
}

int ctts_load_normalization(const char* csv_file) {
  if (g_norm_rules_loaded) return CTTS_OK;
  CLocaleScope c_locale;  // regcomp must see C-locale ctype tables
  std::FILE* f = std::fopen(csv_file, "r");
  if (!f) {
    g_norm_rules_loaded = true;
    return CTTS_OK;
  }
  char line[512];
  g_norm_rule_count = 0;
  while (std::fgets(line, sizeof line, f) &&
         g_norm_rule_count < kMaxNormRules) {
    size_t len = std::strlen(line);
    while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r'))
      line[--len] = '\0';
    if (len == 0 || line[0] == '#') continue;
    char* comma = std::strchr(line, ',');
    if (!comma) continue;
    *comma = '\0';
    const char* pattern = line;
    const char* replace = comma + 1;

    std::string converted = convert_word_boundaries(pattern);
    NormRule& rule = g_norm_rules[g_norm_rule_count];
    if (regcomp(&rule.regex, converted.c_str(), REG_EXTENDED) != 0) {
      // On glibc this drops every \b rule, exactly like the reference
      // binary on this platform (ctts.c:385-391; rules.py docstring).
      std::fprintf(stderr,
                   "Warning: Invalid regex pattern '%s' (converted from "
                   "'%s')\n",
                   converted.c_str(), pattern);
      continue;
    }
    std::strncpy(rule.replace, replace, kMaxReplaceLen - 1);
    rule.replace[kMaxReplaceLen - 1] = '\0';
    rule.compiled = true;
    g_norm_rule_count++;
  }
  std::fclose(f);
  g_norm_rules_loaded = true;
  if (g_norm_rule_count > 0) {
    std::fprintf(stderr, "Loaded %zu normalization rules\n",
                 g_norm_rule_count);
  }
  return CTTS_OK;
}

char* ctts_apply_normalization(const char* text) {
  if (!text) return nullptr;
  if (g_norm_rule_count == 0) return strdup(text);
  std::string out = apply_normalization_str(text);
  return strdup(out.c_str());
}

void ctts_free_normalization(void) {
  for (size_t i = 0; i < g_norm_rule_count; ++i) {
    if (g_norm_rules[i].compiled) {
      regfree(&g_norm_rules[i].regex);
      g_norm_rules[i].compiled = false;
    }
  }
  g_norm_rule_count = 0;
  g_norm_rules_loaded = false;
}

// ---- configuration (ctts.c:1190-1311) ----

void ctts_config_defaults(CTTSConfig* config) {
  if (!config) return;
  config->crossfade_ms = CTTS_DEFAULT_CROSSFADE_MS;
  config->crossfade_vowel_ms = 45.0f;
  config->crossfade_s_ending_ms = 30.0f;
  config->crossfade_r_ending_ms = 30.0f;
  config->vowel_to_consonant_factor = 0.5f;
  config->word_pause_ms = CTTS_DEFAULT_WORD_PAUSE_MS;
  config->unknown_silence_ms = CTTS_DEFAULT_UNKNOWN_SILENCE_MS;
  config->fade_in_ms = CTTS_DEFAULT_FADE_IN_MS;
  config->fade_out_ms = CTTS_DEFAULT_FADE_OUT_MS;
  config->remove_word_silence = 1;
  config->silence_threshold = 0.02f;
  config->min_silence_ms = 15.0f;
  config->remove_dc_offset = 1;
  config->normalize_level = 0.0f;
  config->compression = 0.0f;
  config->default_speed = CTTS_DEFAULT_SPEED;
  config->min_speed = CTTS_MIN_SPEED;
  config->max_speed = CTTS_MAX_SPEED;
  config->max_pitch_change = 0.10f;
  config->print_units = 0;
  config->print_timing = 0;
}

int ctts_load_config(CTTSConfig* config, const char* config_file) {
  if (!config) return CTTS_ERR_INVALID_ARG;
  ctts_config_defaults(config);
  std::FILE* f = std::fopen(config_file, "r");
  if (!f) return CTTS_OK;  // missing file = defaults (ctts.c:1298-1300)
  char line[256];
  while (std::fgets(line, sizeof line, f)) {
    // Flat key:value parse with 63-char key/value windows
    // (ctts.c:1215-1292).
    const char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (*s == '\0' || *s == '#' || *s == '\n') continue;
    const char* colon = std::strchr(s, ':');
    if (!colon) continue;
    char key[64], value[64];
    size_t klen = std::min((size_t)(colon - s), (size_t)63);
    std::memcpy(key, s, klen);
    key[klen] = '\0';
    // trim key
    size_t ke = klen;
    while (ke > 0 && (key[ke - 1] == ' ' || key[ke - 1] == '\t'))
      key[--ke] = '\0';
    const char* v = colon + 1;
    while (*v == ' ' || *v == '\t') ++v;
    size_t vlen = std::min(std::strlen(v), (size_t)63);
    std::memcpy(value, v, vlen);
    value[vlen] = '\0';
    size_t ve = vlen;
    while (ve > 0 && (value[ve - 1] == ' ' || value[ve - 1] == '\t' ||
                      value[ve - 1] == '\n' || value[ve - 1] == '\r'))
      value[--ve] = '\0';
    set_config_key(config, key, value);
  }
  std::fclose(f);
  return CTTS_OK;
}

// ---- engine lifecycle (ctts.c:1117-1190) ----

CTTS* ctts_init(const char* database_file) {
  if (!database_file) return nullptr;
  void* ndb = ctn_db_open(database_file);
  if (!ndb) return nullptr;
  auto* impl = new EngineImpl();
  impl->ndb = ndb;
  // Populate the transparent reference-layout fields (ctts.c:1103-1161)
  // from the native mapping so callers can read them directly.
  CtnDbView view{};
  ctn_db_view(ndb, &view);
  CTTS& pub = impl->pub;
  pub.db_data = const_cast<uint8_t*>(view.data);
  pub.db_size = view.size;
  pub.db_fd = view.fd;
  std::memcpy(&pub.header, view.data, sizeof(CTTSHeader));
  pub.index = reinterpret_cast<CTTSIndexEntry*>(
      pub.db_data + pub.header.index_offset);
  pub.hash_table = reinterpret_cast<uint32_t*>(
      pub.db_data + pub.header.hash_table_offset);
  pub.strings = reinterpret_cast<char*>(pub.db_data +
                                        pub.header.strings_offset);
  pub.audio = reinterpret_cast<int16_t*>(pub.db_data +
                                         pub.header.audio_offset);
  ctts_config_defaults(&pub.config);
  return &impl->pub;
}

void ctts_free(CTTS* engine) {
  if (!engine) return;
  EngineImpl* impl = impl_of(engine);
  if (impl->ndb) ctn_db_close(impl->ndb);
  delete impl;
  ctts_free_normalization();  // matches the reference (ctts.c:1178)
}

void ctts_free_samples(int16_t* samples) { std::free(samples); }

CTTSConfig* ctts_get_config(CTTS* engine) {
  return engine ? &engine->config : nullptr;
}
uint32_t ctts_units_found(const CTTS* engine) {
  return engine ? engine->units_found : 0;
}
uint32_t ctts_units_missing(const CTTS* engine) {
  return engine ? engine->units_missing : 0;
}

void ctts_set_crossfade(CTTS* engine, float crossfade_ms) {
  if (engine) engine->config.crossfade_ms = crossfade_ms;
}
void ctts_set_word_pause(CTTS* engine, float pause_ms) {
  if (engine) engine->config.word_pause_ms = pause_ms;
}
void ctts_set_unknown_silence(CTTS* engine, float silence_ms) {
  if (engine) engine->config.unknown_silence_ms = silence_ms;
}
void ctts_set_fades(CTTS* engine, float fade_in_ms, float fade_out_ms) {
  if (engine) {
    engine->config.fade_in_ms = fade_in_ms;
    engine->config.fade_out_ms = fade_out_ms;
  }
}

// ---- synthesis (ctts.c:3623-3898) ----

int ctts_synthesize(CTTS* engine, const char* text, int16_t** samples,
                    size_t* sample_count, float speed) {
  if (!engine || !text || !samples || !sample_count)
    return CTTS_ERR_INVALID_ARG;

  load_duration_rules("duration_rules.csv");

  const CTTSConfig* cfg = &engine->config;
  Prosody prosody = analyze_prosody(text, cfg->max_pitch_change);

  // Numbers → CSV regex rules → selective lowercase (ctts.c:3642-3655).
  std::string expanded = expand_numbers(text);
  ctts_load_normalization("normalization.csv");
  std::string ruled = apply_normalization_str(expanded);
  std::string normalized = normalize_lowercase(ruled);

  PlanOps ops = compile_ops(impl_of(engine)->ndb, normalized, cfg);
  engine->units_found = ops.units_found;
  engine->units_missing = ops.units_missing;

  CtnPlan plan{};
  plan.n_ops = (int32_t)ops.kind.size();
  plan.kind = ops.kind.data();
  plan.arg0 = ops.arg0.data();
  plan.arg1 = ops.arg1.data();
  plan.flags = ops.flags.data();
  plan.speed = speed;
  plan.target_rms = 3000.0f;
  plan.silence_threshold = cfg->silence_threshold;
  plan.max_pitch_change = cfg->max_pitch_change;
  plan.min_silence_samples = ms_to_samples(cfg->min_silence_ms);
  plan.fade_in_samples = ms_to_samples(cfg->fade_in_ms);
  plan.remove_dc_offset = cfg->remove_dc_offset ? 1 : 0;
  plan.remove_word_silence = cfg->remove_word_silence ? 1 : 0;
  plan.word_count = prosody.word_count;
  plan.phrase_type = prosody.intonation.type;
  plan.pitch_start = prosody.intonation.pitch_start;
  plan.pitch_end = prosody.intonation.pitch_end;
  plan.pitch_peak = prosody.intonation.pitch_peak;
  plan.peak_position = prosody.intonation.peak_position;
  plan.energy_factor = prosody.intonation.energy_factor;

  int16_t* out = nullptr;
  int64_t count = ctn_execute_plan(impl_of(engine)->ndb, &plan, &out);
  if (count < 0) return CTTS_ERR_OUT_OF_MEMORY;
  *samples = out;
  *sample_count = (size_t)count;
  return CTTS_OK;
}

// ---- WAV writer (ctts.c:809-848) ----

int ctts_write_wav(const char* filename, const int16_t* samples,
                   size_t sample_count, int sample_rate) {
  if (!filename || (!samples && sample_count > 0))
    return CTTS_ERR_INVALID_ARG;
  std::FILE* f = std::fopen(filename, "wb");
  if (!f) return CTTS_ERR_FILE_WRITE;
  uint32_t data_size = (uint32_t)(sample_count * 2);
  std::fwrite("RIFF", 1, 4, f);
  put_u32(f, 36 + data_size);
  std::fwrite("WAVE", 1, 4, f);
  std::fwrite("fmt ", 1, 4, f);
  put_u32(f, 16);
  put_u16(f, 1);  // PCM
  put_u16(f, 1);  // mono
  put_u32(f, (uint32_t)sample_rate);
  put_u32(f, (uint32_t)sample_rate * 2);
  put_u16(f, 2);   // block align
  put_u16(f, 16);  // bits
  std::fwrite("data", 1, 4, f);
  put_u32(f, data_size);
  if (sample_count)
    std::fwrite(samples, 2, sample_count, f);
  std::fclose(f);
  return CTTS_OK;
}

// ---- database building (ctts.c:855-1111) ----

int ctts_build_database(const char* letters_dir, const char* letters_index,
                        const char* syllables_dir,
                        const char* syllables_index,
                        const char* output_file) {
  if (!letters_dir || !letters_index || !output_file)
    return CTTS_ERR_INVALID_ARG;

  std::vector<BuildUnit> units;
  if (!load_units_from_index(letters_dir, letters_index, &units))
    return CTTS_ERR_FILE_NOT_FOUND;
  std::fprintf(stderr, "Loaded %zu letters\n", units.size());
  size_t n_letters = units.size();
  if (syllables_dir && syllables_index) {
    if (!load_units_from_index(syllables_dir, syllables_index, &units)) {
      std::fprintf(stderr, "Failed to load syllables: File not found\n");
    } else {
      std::fprintf(stderr, "Loaded %zu syllables\n",
                   units.size() - n_letters);
    }
  }

  // char_count descending, then byte order, stable (compare_units,
  // ctts.c:931-937; builder.py _sort_units).
  std::sort(units.begin(), units.end(),
            [](const BuildUnit& a, const BuildUnit& b) {
              if (a.char_count != b.char_count)
                return a.char_count > b.char_count;
              int c = a.text.compare(b.text);
              if (c != 0) return c < 0;
              return a.order < b.order;
            });

  uint32_t total_count = (uint32_t)units.size();
  uint64_t strings_size = 0, audio_samples = 0;
  uint32_t max_chars = 0;
  for (const BuildUnit& u : units) {
    strings_size += u.text.size() + 1;
    audio_samples += u.samples.size();
    max_chars = std::max(max_chars, (uint32_t)u.char_count);
  }

  // Next power of two ≥ count / 0.7 (float compare; ctts.c:989-991).
  uint32_t hts = 1;
  while ((float)hts < (float)total_count / 0.7f) hts *= 2;

  uint32_t index_offset = sizeof(CapiDbHeader);
  uint32_t hash_table_offset =
      index_offset + total_count * (uint32_t)sizeof(CapiDbIndexEntry);
  uint32_t strings_offset = hash_table_offset + hts * 4;
  uint32_t audio_offset = strings_offset + (uint32_t)strings_size;

  CapiDbHeader header{};
  header.magic = CTTS_MAGIC;
  header.version = CTTS_VERSION;
  header.unit_count = total_count;
  header.sample_rate = CTTS_SAMPLE_RATE;
  header.bits_per_sample = CTTS_BITS_PER_SAMPLE;
  header.index_offset = index_offset;
  header.strings_offset = strings_offset;
  header.audio_offset = audio_offset;
  header.total_samples = (uint32_t)audio_samples;
  header.max_unit_chars = max_chars;
  header.hash_table_size = hts;
  header.hash_table_offset = hash_table_offset;

  std::vector<CapiDbIndexEntry> index(total_count);
  std::vector<uint32_t> hash_table(hts, 0xFFFFFFFFu);

  uint32_t string_pos = 0, audio_pos = 0;
  for (uint32_t i = 0; i < total_count; ++i) {
    const BuildUnit& u = units[i];
    CapiDbIndexEntry& e = index[i];
    e = CapiDbIndexEntry{};
    e.hash = u.hash;
    e.string_offset = string_pos;
    e.string_len = (uint16_t)u.text.size();
    e.char_count = (uint16_t)u.char_count;
    e.audio_offset = audio_pos;
    e.sample_count = (uint32_t)u.samples.size();
    e.next_hash = 0xFFFFFFFFu;

    // Chain insert: head in the table, later entries at the chain end
    // (ctts.c:1052-1062).
    uint32_t slot = u.hash % hts;
    if (hash_table[slot] == 0xFFFFFFFFu) {
      hash_table[slot] = i;
    } else {
      uint32_t prev = hash_table[slot];
      while (index[prev].next_hash != 0xFFFFFFFFu)
        prev = index[prev].next_hash;
      index[prev].next_hash = i;
    }
    string_pos += (uint32_t)u.text.size() + 1;
    audio_pos += (uint32_t)u.samples.size();
  }

  std::FILE* out = std::fopen(output_file, "wb");
  if (!out) return CTTS_ERR_FILE_WRITE;
  std::fwrite(&header, sizeof header, 1, out);
  std::fwrite(index.data(), sizeof(CapiDbIndexEntry), total_count, out);
  std::fwrite(hash_table.data(), 4, hts, out);
  for (const BuildUnit& u : units) {
    std::fwrite(u.text.data(), 1, u.text.size(), out);
    std::fputc(0, out);
  }
  for (const BuildUnit& u : units) {
    std::fwrite(u.samples.data(), 2, u.samples.size(), out);
  }
  std::fclose(out);

  std::fprintf(stderr, "Database written to %s\n", output_file);
  std::fprintf(stderr, "  Units: %u\n", total_count);
  std::fprintf(stderr, "  Max unit length: %u characters\n", max_chars);
  std::fprintf(stderr, "  Total audio samples: %llu\n",
               (unsigned long long)audio_samples);
  return CTTS_OK;
}

// ---- error strings (ctts.c:149-168) ----

const char* ctts_strerror(int error_code) {
  static const char* const messages[] = {
      "Success",          "Invalid argument", "File not found",
      "File read error",  "File write error", "Invalid format",
      "Out of memory",    "Invalid WAV file", "Version mismatch",
  };
  if (error_code >= 0) return messages[0];
  int idx = -error_code;
  if (idx >= (int)(sizeof(messages) / sizeof(messages[0])))
    return "Unknown error";
  return messages[idx];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch plan lowering for the TPU serving path (ctl_*).
//
// C++ twin of the host half of the device pipeline: compile_plan
// (ctts_tpu/plan/compiler.py) -> split_plan (plan/split.py) ->
// walk_plan + derive_dims + fill_device_plan (synth/device.py:299-564).
// The Python modules remain the parity-tested source of truth;
// tests/test_native_lower.py pins this lowering bit-exactly against
// them (every filled array equal, every derived dim equal).
//
// The serving loop spends its host budget here (1-core hosts measured
// ~48 ms/64-row batch in Python vs ~3 ms native), so this is the
// production text->arrays path; normalization rule files are NOT
// supported here (the Python path handles rules != None).
//
// Not thread-safe per handle: one handle per BatchSynthesizer, used
// from its dispatch thread only.
// ---------------------------------------------------------------------------

namespace {

struct LowerUnit {
  int32_t id, region;
  int64_t off;
  int32_t boundary, cf_in;
  bool fade_in, smooth;
  int32_t analysis, boundary_len, shift_region;
  bool prev_ok;
};

struct LowerRegion {
  int64_t len = 0;
  bool do_dsp = false;
  int32_t word_index = 0;
  int64_t pause_after = 0;
  int32_t fade_after = 0;
};

struct LowerFade {
  int32_t region;
  int64_t pos;
  int32_t len;
};

// One batch row: a walked (dims-independent) plan partition.
struct LowerRow {
  std::vector<LowerUnit> units;
  std::vector<LowerRegion> regions;
  std::vector<LowerFade> fades;
  std::vector<int32_t> shift_cands;
  int32_t cf_max = 1;
  int32_t margin = 0, win = 0, cfmax = 0;
  int64_t max_region_len = 1, total_len = 0;
  bool stretch = false;
  int32_t synth_hop = 0;
  int32_t refine_trips = 0;
  float speed = 1.0f;
  // Shared per-text prosody.
  Intonation inton{};
  int32_t word_count = 0;
};

// Per-handle normalization rule (ctl_set_rules): the batch lowering
// applies rule files itself so the serving loop's fast host path stays
// available with rules loaded (the reference applies normalization.csv
// on every synthesis, ctts.c:3647-3648 — it is live behavior).
struct LowerRule {
  regex_t regex;
  std::string replace;
};

struct LowerHandle {
  void* ndb = nullptr;
  CTTSConfig cfg{};
  int32_t bank_w = 0;  // roundup(max unit sample_count, 1024)
  int32_t min_silence_samples = 0;
  int32_t fade_in_samples = 0;
  std::vector<LowerRule> rules;
  std::vector<LowerRow> rows;
};

// Sequential whole-string rewrite over the handle's rule set — same
// semantics as apply_normalization_str / NormalizationRules.apply
// (output cap, \0..\9 backrefs, zero-length-match byte skip;
// ctts.c:439-505), but per handle instead of the global CTTS rule set.
std::string lower_apply_rules(const LowerHandle* h,
                              const std::string& text) {
  if (h->rules.empty()) return text;
  CLocaleScope c_locale;
  size_t cap = text.size() * 4 + 1024 - 1;
  std::string current = text;
  for (const auto& rule : h->rules) {
    std::string next;
    next.reserve(current.size());
    const char* src = current.c_str();
    regmatch_t m[10];
    while (*src && next.size() < cap) {
      if (regexec(&rule.regex, src, 10, m, 0) == 0 && m[0].rm_so >= 0) {
        size_t before = std::min((size_t)m[0].rm_so, cap - next.size());
        next.append(src, before);
        write_replacement(next, cap, rule.replace.c_str(), src, m);
        src += m[0].rm_eo;
        if (m[0].rm_eo == 0) ++src;  // zero-length match: skip one byte
      } else {
        next.append(src, std::min(strlen(src), cap - next.size()));
        break;
      }
    }
    current = std::move(next);
  }
  return current;
}

// Ceil-to-multiple for non-negative x (C++ int division truncates
// toward zero, so Python's -(-x // m) * m idiom does NOT port).
int64_t lower_roundup(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

int64_t lower_next_pow2(int64_t x, int64_t lo) {
  int64_t n = lo;
  while (n < x) n *= 2;
  return n;
}

// synthesis_hop_for_speed (ops/wsola_jax.py:177; ctts.c:3511-3512).
int32_t lower_synth_hop(float speed) {
  float s = std::min(std::max(speed, 0.5f), 2.0f);
  int32_t hop = (int32_t)(128.0f / s);
  return hop < 1 ? 1 : hop;
}

// _omax_for (synth/device.py:142-155).
int64_t lower_omax(int64_t smax, bool stretch, int32_t hop) {
  if (!stretch) return smax;
  int64_t h = hop < 1 ? 1 : hop;
  int64_t omax = lower_roundup((smax / 128 + 2) * h + 512 + 2048, 128);
  if (hop >= 126) omax = std::max(omax, lower_roundup(smax + 2048, 128));
  return omax;
}

// walk_plan (synth/device.py:299-422) over one op-range row.
void lower_walk(LowerHandle* h, const PlanOps& ops, size_t op_s,
                size_t op_e, int64_t buf_total0, float speed,
                const Prosody& pro, LowerRow* row) {
  row->speed = speed;
  row->inton = pro.intonation;
  row->word_count = pro.word_count;

  int32_t cf_max = 1;
  for (size_t i = op_s; i < op_e; ++i)
    if (ops.kind[i] == OP_UNIT && ops.arg1[i] > cf_max) cf_max = ops.arg1[i];
  row->cf_max = cf_max;
  int64_t win = lower_roundup(std::max<int64_t>(2 * (int64_t)cf_max, 1024),
                              1024);
  int64_t cfmax = lower_roundup(cf_max, 1024);
  row->win = (int32_t)win;
  row->cfmax = (int32_t)cfmax;
  row->margin = (int32_t)(win + cfmax);

  LowerRegion cur;
  int64_t cursor = 0;
  int64_t buf_total = buf_total0;
  bool post_dsp = false;

  auto close_region = [&]() {
    cur.len = cursor;
    row->regions.push_back(cur);
    cur = LowerRegion{};
    cursor = 0;
    post_dsp = false;
  };

  for (size_t oi = op_s; oi < op_e; ++oi) {
    int32_t r = (int32_t)row->regions.size();
    int32_t kind = ops.kind[oi];
    if (kind == OP_UNIT) {
      int64_t n = ctn_db_unit_sample_count(h->ndb, (uint32_t)ops.arg0[oi]);
      int32_t cf = ops.arg1[oi];
      bool awb = (ops.flags[oi] & 1) != 0;
      bool smooth_flag = (ops.flags[oi] & 2) != 0;
      int64_t cf_in;
      bool fade_in;
      if (awb || buf_total == 0) {
        cf_in = 0;
        fade_in = true;
      } else if (cf == 0) {
        cf_in = 0;
        fade_in = false;
      } else {
        cf_in = std::min<int64_t>(std::min<int64_t>(cf, buf_total), n);
        fade_in = false;
      }
      int64_t off = cursor - cf_in;
      LowerUnit u;
      u.id = ops.arg0[oi];
      u.region = r;
      u.off = off;
      u.boundary = cf;
      u.cf_in = (int32_t)cf_in;
      u.fade_in = fade_in;
      u.smooth = smooth_flag && buf_total > 0;
      u.analysis = (int32_t)std::min<int64_t>(
          std::min<int64_t>(2 * (int64_t)cf, buf_total / 2), n / 2);
      u.boundary_len =
          (int32_t)std::min<int64_t>(std::min<int64_t>(cf, buf_total), n);
      u.shift_region = (int32_t)std::min<int64_t>(cf, n / 4);
      u.prev_ok = buf_total >= 200;
      row->units.push_back(u);
      cursor = off + n;
      buf_total += n - cf_in;
    } else if (kind == OP_SILENCE) {
      bool closes = oi + 1 < op_e && ops.kind[oi + 1] == OP_MARK_WORD;
      if (post_dsp || closes) {
        cur.pause_after += ops.arg0[oi];
      } else {
        cursor += ops.arg0[oi];
      }
      buf_total += ops.arg0[oi];
    } else if (kind == OP_FADE_TAIL) {
      if (post_dsp) {
        cur.fade_after = ops.arg0[oi];
      } else {
        row->fades.push_back({r, cursor, ops.arg0[oi]});
      }
    } else if (kind == OP_WORD_DSP) {
      cur.do_dsp = true;
      cur.word_index = ops.arg0[oi];
      post_dsp = true;
    } else if (kind == OP_MARK_WORD) {
      close_region();
    }
  }
  close_region();

  int64_t mrl = 1;
  for (const auto& rg : row->regions) mrl = std::max(mrl, rg.len);
  row->max_region_len = mrl;

  // Head-mod chain depth (device.py:382-410).
  struct DepthRec { int64_t off, m, d; };
  std::vector<std::vector<DepthRec>> depth_by_region(row->regions.size());
  int32_t refine_trips = 0;
  for (const auto& u : row->units) {
    bool modifies = u.smooth && u.boundary > 0;
    int64_t m = std::max<int64_t>(
        std::max<int64_t>(u.cf_in, u.boundary_len), u.shift_region);
    int64_t lo = u.off + u.cf_in - win;
    int64_t hi = u.off + u.cf_in;
    int64_t d = 0;
    if (modifies) {
      d = 1;
      for (const auto& rec : depth_by_region[u.region]) {
        if (rec.d > 0 && rec.off + rec.m > lo && rec.off < hi)
          d = std::max(d, 1 + rec.d);
      }
    }
    depth_by_region[u.region].push_back({u.off, m, d});
    refine_trips = std::max(refine_trips, (int32_t)d);
  }
  row->refine_trips = refine_trips;

  row->stretch = speed != 1.0f;
  row->synth_hop = row->stretch ? lower_synth_hop(speed) : 0;
  int64_t total = 0;
  for (const auto& rg : row->regions) total += rg.len + rg.pause_after;
  row->total_len = total;

  // _shift_candidates (device.py:425-434).
  for (size_t k = 0; k < row->units.size(); ++k) {
    const auto& u = row->units[k];
    if (u.smooth && u.boundary > 0 && u.prev_ok && u.shift_region > 0 &&
        ctn_db_unit_sample_count(h->ndb, (uint32_t)u.id) >= 200)
      row->shift_cands.push_back((int32_t)k);
  }
}

// intonation_scalars (synth/device.py:204-274).
void lower_intonation_scalars(const Intonation& in, int32_t word_index,
                              int32_t total_words, float mpc, float out5[5],
                              bool* qfinal_out, bool* energy_out) {
  auto clampv = [mpc](float p) {
    float lo = 1.0f - mpc, hi = 1.0f + mpc;
    return std::min(std::max(p, lo), hi);
  };
  int32_t denom = total_words > 1 ? total_words - 1 : 1;
  float phrase_pos = (float)word_index / (float)denom;
  bool is_final = word_index == total_words - 1;
  bool is_penult = (word_index == total_words - 2) && total_words > 1;

  float peak_pos = in.peak_position;
  float p_start = in.pitch_start;
  float p_end = in.pitch_end;
  float p_peak = in.pitch_peak;

  float pf;
  if (phrase_pos <= peak_pos) {
    float t = phrase_pos / peak_pos;
    t = t * t * (3.0f - 2.0f * t);
    pf = p_start + (p_peak - p_start) * t;
  } else {
    float t = (phrase_pos - peak_pos) / (1.0f - peak_pos);
    t = t * t * (3.0f - 2.0f * t);
    pf = p_peak + (p_end - p_peak) * t;
  }
  pf = clampv(pf);

  float ws = clampv(pf * 0.98f);
  float we = clampv(pf * 1.02f);
  bool qfinal = false;

  if (in.type == PHRASE_INTERROGATIVE && (is_final || is_penult)) {
    if (is_final) {
      ws = clampv(pf * 0.95f);
      we = clampv(p_end);
      qfinal = true;
    } else {
      ws = clampv(pf * 0.98f);
      we = clampv(pf * 1.05f);
    }
  } else if (in.type == PHRASE_EXCLAMATORY) {
    if (word_index == 0) {
      ws = clampv(p_peak);
      we = clampv(pf);
    } else if (is_final) {
      ws = clampv(pf);
      we = clampv(p_end);
    } else {
      ws = clampv(pf * 1.02f);
      we = clampv(pf * 0.98f);
    }
  } else if (in.type == PHRASE_CONTINUATION && is_final) {
    ws = clampv(pf * 0.96f);
    we = clampv(p_end);
  } else {
    ws = clampv(pf * 0.98f);
    we = clampv(pf * 1.02f);
    if (is_final) we = clampv(p_end);
  }

  float ef = in.energy_factor;
  bool energy_active = std::fabs(ef - 1.0f) > 0.01f;
  float es = ef, ee = ef;
  if (in.type == PHRASE_EXCLAMATORY && word_index == 0) {
    es = ef * 1.1f;
    ee = ef * 0.95f;
  }
  out5[0] = ws;
  out5[1] = we;
  out5[2] = clampv(p_peak);
  out5[3] = es;
  out5[4] = ee;
  *qfinal_out = qfinal;
  *energy_out = energy_active;
}

}  // namespace

extern "C" {

void* ctl_open(const char* db_path, const CTTSConfig* cfg) {
  void* ndb = ctn_db_open(db_path);
  if (!ndb) return nullptr;
  auto* h = new LowerHandle();
  h->ndb = ndb;
  h->cfg = *cfg;
  uint32_t nunits = ctn_db_unit_count(ndb);
  uint32_t mx = 0;
  for (uint32_t i = 0; i < nunits; ++i)
    mx = std::max(mx, ctn_db_unit_sample_count(ndb, i));
  h->bank_w = (int32_t)lower_roundup(std::max<int64_t>(mx, 1), 1024);
  h->min_silence_samples = ms_to_samples(cfg->min_silence_ms);
  h->fade_in_samples = ms_to_samples(cfg->fade_in_ms);
  return h;
}

void ctl_close(void* handle) {
  auto* h = static_cast<LowerHandle*>(handle);
  if (!h) return;
  for (auto& r : h->rules) regfree(&r.regex);
  ctn_db_close(h->ndb);
  delete h;
}

// Install the handle's normalization rules. Patterns arrive already
// word-boundary-converted to POSIX form ([[:<:]]/[[:>:]] — the same
// convert_word_boundaries output the Python loader keeps); glibc
// regcomp rejects those BSD brackets, so they are translated to the
// GNU \< / \> equivalents, which test the identical C-locale word set
// the Python lookaround emulation uses (rules.py _WORD_START/_END).
// Any pattern that still fails regcomp aborts the WHOLE set (rc -1)
// and the caller falls back to the Python lowering — a partially
// installed rule set would silently change synthesis output.
int32_t ctl_set_rules(void* handle, int32_t n, const char** patterns,
                      const char** replaces) {
  auto* h = static_cast<LowerHandle*>(handle);
  CLocaleScope c_locale;  // regcomp must see C-locale ctype tables
  for (auto& r : h->rules) regfree(&r.regex);
  h->rules.clear();
  h->rules.reserve((size_t)(n > 0 ? n : 0));
  for (int32_t i = 0; i < n; ++i) {
    std::string pat(patterns[i]);
    for (size_t pos; (pos = pat.find("[[:<:]]")) != std::string::npos;)
      pat.replace(pos, 7, "\\<");
    for (size_t pos; (pos = pat.find("[[:>:]]")) != std::string::npos;)
      pat.replace(pos, 7, "\\>");
    h->rules.emplace_back();
    if (regcomp(&h->rules.back().regex, pat.c_str(), REG_EXTENDED) != 0) {
      h->rules.pop_back();
      for (auto& r : h->rules) regfree(&r.regex);
      h->rules.clear();
      return -1;
    }
    h->rules.back().replace = replaces[i];
  }
  return 0;
}

void ctl_begin(void* handle) {
  static_cast<LowerHandle*>(handle)->rows.clear();
}

// Compile one text into batch rows: normalize (numbers -> rule file ->
// lowercase, the reference's exact order, ctts.c:3642-3655) ->
// compile_ops -> split at sentence ends (speed 1.0 only;
// plan/split.py) -> walk each row. Returns the number of rows
// appended, or -1 on error.
int32_t ctl_add_text(void* handle, const char* text, int64_t nbytes,
                     float speed, int32_t split) {
  auto* h = static_cast<LowerHandle*>(handle);
  std::string raw(text, (size_t)nbytes);
  Prosody pro = analyze_prosody(raw.c_str(), h->cfg.max_pitch_change);
  std::string normalized =
      normalize_lowercase(lower_apply_rules(h, expand_numbers(raw)));
  CTTSConfig cfg = h->cfg;
  cfg.print_units = 0;
  PlanOps ops = compile_ops(h->ndb, normalized, &cfg);
  size_t n_ops = ops.kind.size();

  // split_plan (plan/split.py:37-107).
  std::vector<size_t> bounds;
  bounds.push_back(0);
  if (split && speed == 1.0f) {
    for (size_t i = 0; i < n_ops; ++i) {
      if (ops.kind[i] == OP_MARK_WORD && (ops.flags[i] & 1)) {
        size_t cut = i;
        if (i >= 1 && ops.kind[i - 1] == OP_SILENCE) cut = i - 1;
        if (cut > 0) bounds.push_back(cut);
      }
    }
  }
  bounds.push_back(n_ops);

  // Per-row start offsets of the pre-removal running length.
  struct Range { size_t s, e; int64_t buf0; };
  std::vector<Range> ranges;
  int64_t buf_total = 0;
  for (size_t bi = 0; bi + 1 < bounds.size(); ++bi) {
    size_t s = bounds[bi], e = bounds[bi + 1];
    if (s == e) continue;
    ranges.push_back({s, e, buf_total});
    for (size_t i = s; i < e; ++i) {
      if (ops.kind[i] == OP_UNIT) {
        int64_t n = ctn_db_unit_sample_count(h->ndb, (uint32_t)ops.arg0[i]);
        int64_t cf_in = 0;
        if (!(ops.flags[i] & 1) && buf_total != 0 && ops.arg1[i] != 0)
          cf_in = std::min<int64_t>(std::min<int64_t>(ops.arg1[i], buf_total),
                                    n);
        buf_total += n - cf_in;
      } else if (ops.kind[i] == OP_SILENCE) {
        buf_total += ops.arg0[i];
      }
    }
  }
  // Merge a trailing unit-less row into its predecessor.
  if (ranges.size() > 1) {
    bool has_unit = false;
    for (size_t i = ranges.back().s; i < ranges.back().e; ++i)
      if (ops.kind[i] == OP_UNIT) { has_unit = true; break; }
    if (!has_unit) {
      ranges[ranges.size() - 2].e = ranges.back().e;
      ranges.pop_back();
    }
  }
  // Single-row result must match the UNSPLIT plan (buf0 = 0, whole ops).
  if (ranges.size() <= 1)
    ranges.assign(1, {0, n_ops, 0});

  for (const auto& rr : ranges) {
    h->rows.emplace_back();
    lower_walk(h, ops, rr.s, rr.e, rr.buf0, speed, pro, &h->rows.back());
  }
  return (int32_t)ranges.size();
}

int32_t ctl_row_count(void* handle) {
  return (int32_t)static_cast<LowerHandle*>(handle)->rows.size();
}

// derive_dims (synth/device.py:437-470): writes 21 int32 values:
//  0 U  1 R  2 FD  3 NSHIFT  4 WREG  5 MARGIN  6 UBUF  7 WIN  8 CFMAX
//  9 SMAX  10 OMAX  11 CONTW  12 FADEW  13 FADE2W  14 fade_in_samples
//  15 min_silence_samples  16 remove_dc  17 stretch  18 synth_hop
//  19 contour_drift  20 refine_trips
int32_t ctl_row_dims(void* handle, int32_t row, int32_t* out) {
  auto* h = static_cast<LowerHandle*>(handle);
  if (row < 0 || (size_t)row >= h->rows.size()) return -1;
  const LowerRow& w = h->rows[row];
  int64_t smax = lower_roundup(std::max<int64_t>(w.total_len, 1024), 128);
  int64_t wreg = lower_roundup(
      (int64_t)w.margin + w.max_region_len + h->bank_w + w.cfmax, 1024);
  out[0] = (int32_t)std::max<size_t>(w.units.size(), 1);
  out[1] = (int32_t)std::max<size_t>(w.regions.size(), 1);
  out[2] = (int32_t)std::max<size_t>(w.fades.size(), 1);
  out[3] = (int32_t)std::max<int64_t>(
      lower_roundup((int64_t)w.shift_cands.size(), 8), 8);
  out[4] = (int32_t)wreg;
  out[5] = w.margin;
  out[6] = h->bank_w;
  out[7] = w.win;
  out[8] = w.cfmax;
  out[9] = (int32_t)smax;
  out[10] = (int32_t)lower_omax(smax, w.stretch, w.synth_hop);
  out[11] = (int32_t)std::min(
      lower_next_pow2(std::max<int64_t>(w.max_region_len, 1024), 1024),
      wreg - w.margin);
  int64_t max_fade = 1;
  for (const auto& f : w.fades) max_fade = std::max<int64_t>(max_fade, f.len);
  out[12] = (int32_t)std::min(lower_roundup(max_fade, 128),
                              (int64_t)w.margin);
  int64_t max_fa = 1;
  for (const auto& rg : w.regions)
    max_fa = std::max<int64_t>(max_fa, rg.fade_after);
  out[13] = (int32_t)lower_next_pow2(max_fa, 128);
  out[14] = h->fade_in_samples;
  out[15] = h->min_silence_samples;
  out[16] = h->cfg.remove_dc_offset ? 1 : 0;
  out[17] = w.stretch ? 1 : 0;
  out[18] = w.synth_hop;
  out[19] = (int32_t)std::min<int64_t>(
      (int64_t)std::ceil(256.0 * std::fabs((double)h->cfg.max_pitch_change))
          + 2,
      256);
  out[20] = w.refine_trips;
  return 0;
}

// fill_device_plan (synth/device.py:473-564) into caller-owned arrays.
// bdims: 0 U  1 R  2 FD  3 NSHIFT  4 MARGIN  5 UBUF  6 CONTW  7 FADEW
// ptrs (manifest order, shared with ctts_tpu/plan/native_lower.py):
//  0 unit_id[i32 U]       1 unit_region[i32 U]    2 unit_off[i32 U]
//  3 unit_boundary[i32 U] 4 unit_cf_in[i32 U]     5 unit_fade_in[u8 U]
//  6 unit_smooth[u8 U]    7 unit_analysis[i32 U]  8 unit_boundary_len[i32 U]
//  9 unit_shift_region[i32 U] 10 unit_prev_ok[u8 U]
// 11 region_len[i32 R]   12 region_do_dsp[u8 R]  13 region_remove[u8 R]
// 14 region_pause[i32 R] 15 region_fade_after[i32 R]
// 16 region_contour[f32 R*5] 17 region_qfinal[u8 R] 18 region_energy[u8 R]
// 19 region_active[u8 R]
// 20 fade_region[i32 FD] 21 fade_pos[i32 FD] 22 fade_len[i32 FD]
// 23 shift_slots[i32 NSHIFT]
int32_t ctl_fill_row(void* handle, int32_t row, const int32_t* bd,
                     void** ptrs) {
  auto* h = static_cast<LowerHandle*>(handle);
  if (row < 0 || (size_t)row >= h->rows.size()) return -1;
  const LowerRow& w = h->rows[row];
  const int32_t U = bd[0], R = bd[1], FD = bd[2], NSHIFT = bd[3],
                MARGIN = bd[4], UBUF = bd[5], CONTW = bd[6], FADEW = bd[7];
  if ((int32_t)w.units.size() > U || (int32_t)w.regions.size() > R ||
      (int32_t)w.fades.size() > FD ||
      (int32_t)w.shift_cands.size() > NSHIFT)
    return -2;
  if (MARGIN < 2 * w.cf_max || UBUF < h->bank_w ||
      CONTW < w.max_region_len || FADEW > MARGIN)
    return -3;
  for (const auto& f : w.fades)
    if (f.len > FADEW) return -3;

  auto i32p = [&](int k) { return static_cast<int32_t*>(ptrs[k]); };
  auto u8p = [&](int k) { return static_cast<uint8_t*>(ptrs[k]); };
  auto f32p = [&](int k) { return static_cast<float*>(ptrs[k]); };

  for (int32_t k = 0; k < U; ++k) {
    i32p(0)[k] = -1;
    i32p(1)[k] = 0;
    i32p(2)[k] = 0;
    i32p(3)[k] = 0;
    i32p(4)[k] = 0;
    u8p(5)[k] = 0;
    u8p(6)[k] = 0;
    i32p(7)[k] = 0;
    i32p(8)[k] = 0;
    i32p(9)[k] = 0;
    u8p(10)[k] = 0;
  }
  for (size_t k = 0; k < w.units.size(); ++k) {
    const LowerUnit& u = w.units[k];
    i32p(0)[k] = u.id;
    i32p(1)[k] = u.region;
    i32p(2)[k] = (int32_t)(u.off + MARGIN);
    i32p(3)[k] = u.boundary;
    i32p(4)[k] = u.cf_in;
    u8p(5)[k] = u.fade_in ? 1 : 0;
    u8p(6)[k] = u.smooth ? 1 : 0;
    i32p(7)[k] = u.analysis;
    i32p(8)[k] = u.boundary_len;
    i32p(9)[k] = u.shift_region;
    u8p(10)[k] = u.prev_ok ? 1 : 0;
  }

  for (int32_t r = 0; r < R; ++r) {
    i32p(11)[r] = 0;
    u8p(12)[r] = 0;
    u8p(13)[r] = 0;
    i32p(14)[r] = 0;
    i32p(15)[r] = 0;
    for (int c = 0; c < 5; ++c) f32p(16)[r * 5 + c] = 1.0f;
    u8p(17)[r] = 0;
    u8p(18)[r] = 0;
    u8p(19)[r] = 0;
  }
  const int32_t wc = w.word_count;
  for (size_t r = 0; r < w.regions.size(); ++r) {
    const LowerRegion& rg = w.regions[r];
    i32p(11)[r] = (int32_t)rg.len;
    u8p(19)[r] = 1;
    u8p(12)[r] = rg.do_dsp ? 1 : 0;
    u8p(13)[r] = (rg.do_dsp && h->cfg.remove_word_silence &&
                  rg.len > h->min_silence_samples)
                     ? 1
                     : 0;
    i32p(14)[r] = (int32_t)rg.pause_after;
    i32p(15)[r] = rg.fade_after;
    if (rg.do_dsp && wc > 0) {
      float c5[5];
      bool qf, ea;
      lower_intonation_scalars(w.inton, rg.word_index, wc,
                               h->cfg.max_pitch_change, c5, &qf, &ea);
      for (int c = 0; c < 5; ++c) f32p(16)[r * 5 + c] = c5[c];
      u8p(17)[r] = qf ? 1 : 0;
      u8p(18)[r] = ea ? 1 : 0;
    }
  }

  for (int32_t k = 0; k < FD; ++k) {
    i32p(20)[k] = 0;
    i32p(21)[k] = -1;
    i32p(22)[k] = 0;
  }
  for (size_t k = 0; k < w.fades.size(); ++k) {
    i32p(20)[k] = w.fades[k].region;
    i32p(21)[k] = (int32_t)w.fades[k].pos;
    i32p(22)[k] = w.fades[k].len;
  }

  for (int32_t k = 0; k < NSHIFT; ++k) i32p(23)[k] = -1;
  for (size_t k = 0; k < w.shift_cands.size(); ++k)
    i32p(23)[k] = w.shift_cands[k];
  return 0;
}

}  // extern "C"
