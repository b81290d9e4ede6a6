/*
 * ctts.h — drop-in C API for the ctts_tpu framework's native host runtime.
 *
 * Source- and ABI-compatible re-declaration of the reference engine's
 * public C interface (parity source: reference/ctts.h:1-351).
 * A program written against the reference header — including the
 * reference's own main(), which reaches into engine->config,
 * engine->header.unit_count and engine->units_found/missing and calls
 * ctts_strerror (ctts.c:3990-4015) — compiles, links and runs against
 * libctts.so unchanged: same struct layouts, same function names and
 * signatures, same database format and error codes. The implementation
 * (csrc/ctts_capi.cpp) is the ctts_tpu native frontend + plan executor,
 * not the reference code.
 *
 * Original implementation for the ctts_tpu project.
 */

#ifndef CTTS_TPU_CTTS_H
#define CTTS_TPU_CTTS_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- constants (ctts.h:18-38) ---- */

#define CTTS_MAGIC 0x53545443u /* the bytes C,T,T,S read as LE u32 */
#define CTTS_VERSION 1
#define CTTS_SAMPLE_RATE 22050
#define CTTS_BITS_PER_SAMPLE 16
#define CTTS_MAX_UNIT_LEN 16

#define CTTS_DEFAULT_CROSSFADE_MS 20.0f
#define CTTS_DEFAULT_WORD_PAUSE_MS 120.0f
#define CTTS_DEFAULT_UNKNOWN_SILENCE_MS 30.0f
#define CTTS_DEFAULT_FADE_IN_MS 3.0f
#define CTTS_DEFAULT_FADE_OUT_MS 3.0f
#define CTTS_DEFAULT_SPEED 1.0f

#define CTTS_MIN_SPEED 0.5f
#define CTTS_MAX_SPEED 2.0f

/* ---- configuration (field order = ABI; ctts.h:44-77) ---- */

typedef struct {
  float crossfade_ms;
  float crossfade_vowel_ms;
  float crossfade_s_ending_ms;
  float crossfade_r_ending_ms;
  float vowel_to_consonant_factor;
  float word_pause_ms;
  float unknown_silence_ms;
  float fade_in_ms;
  float fade_out_ms;

  int remove_word_silence;
  float silence_threshold;
  float min_silence_ms;

  int remove_dc_offset;
  float normalize_level;
  float compression;

  float default_speed;
  float min_speed;
  float max_speed;

  float max_pitch_change;

  int print_units;
  int print_timing;
} CTTSConfig;

/* ---- database structures, on-disk format (ctts.h:79-112) ---- */

/* On-disk header: exactly 64 bytes at file offset 0 */
typedef struct {
  uint32_t magic;             /* must equal CTTS_MAGIC */
  uint32_t version;           /* format revision, currently 1 */
  uint32_t unit_count;        /* how many units the index holds */
  uint32_t sample_rate;       /* Hz of every stored unit (22050) */
  uint32_t bits_per_sample;   /* always 16: PCM int16 */
  uint32_t index_offset;      /* file position of the entry array */
  uint32_t strings_offset;    /* file position of the text pool */
  uint32_t audio_offset;      /* file position of the PCM block */
  uint32_t total_samples;     /* length of the PCM block, in samples */
  uint32_t max_unit_chars;    /* longest unit text, counted in chars */
  uint32_t hash_table_size;   /* bucket count of the lookup table */
  uint32_t hash_table_offset; /* file position of the bucket array */
  uint8_t reserved[16];       /* zero-filled padding, keep zeroed */
} CTTSHeader;

/* One unit's on-disk record: 32 bytes (ctts.h:101-112) */
typedef struct {
  uint32_t hash;          /* FNV-1a over the unit's UTF-8 bytes */
  uint32_t string_offset; /* where the text starts in the pool */
  uint16_t string_len;    /* byte length of that text */
  uint16_t char_count;    /* same text counted in codepoints */
  uint32_t audio_offset;  /* start within the PCM block (samples) */
  uint32_t sample_count;  /* unit duration in samples */
  uint32_t flags;         /* unused, written as 0 */
  uint32_t next_hash;     /* collision chain: index of the next entry */
  uint32_t reserved;      /* unused, written as 0 */
} CTTSIndexEntry;

/* ---- runtime structures (ctts.h:114-155) ---- */

/* Decoded per-unit view (heap-side, not on disk) */
typedef struct {
  char* text;            /* the unit's UTF-8 string */
  uint16_t text_len;     /* strlen of `text` in bytes */
  uint16_t char_count;   /* `text` counted in codepoints */
  int16_t* samples;      /* PCM for this unit */
  uint32_t sample_count; /* how many samples `samples` holds */
  uint32_t hash;         /* cached FNV-1a of `text` */
} CTTSUnit;

/* Main engine structure — transparent, matching the reference layout
 * (ctts.h:128-149) so callers may read engine->header, engine->config,
 * engine->units_found / units_missing directly. Treat every field as
 * read-only except `config`. */
typedef struct CTTS {
  /* Database mapping */
  uint8_t* db_data; /* base of the mmap'd .db file */
  size_t db_size;   /* byte length of the mapping */
  int db_fd;        /* kept open until ctts_free unmaps */

  /* Parsed header */
  CTTSHeader header;

  /* Pointers into mapped data */
  CTTSIndexEntry* index; /* -> entry array inside the mapping */
  uint32_t* hash_table;  /* -> bucket array (constant-time find) */
  char* strings;         /* -> text pool */
  int16_t* audio;        /* -> PCM block */

  /* Configuration */
  CTTSConfig config; /* the engine's tunables; callers may write */

  /* Statistics */
  uint32_t units_found;   /* running tally: lookups that hit */
  uint32_t units_missing; /* running tally: lookups that fell back */
} CTTS;

/* Synthesis result (ctts.h:151-155) */
typedef struct {
  int16_t* samples;    /* synthesized PCM; free with ctts_free_samples */
  size_t sample_count; /* valid samples in `samples` */
  size_t capacity;     /* allocation size (>= sample_count) */
} CTTSSynthResult;

/* ---- database building (ctts.h:160-181) ---- */

int ctts_build_database(const char* letters_dir, const char* letters_index,
                        const char* syllables_dir,
                        const char* syllables_index, const char* output_file);

/* ---- synthesis (ctts.h:183-250) ---- */

CTTS* ctts_init(const char* database_file);
int ctts_synthesize(CTTS* engine, const char* text, int16_t** samples,
                    size_t* sample_count, float speed);
int ctts_write_wav(const char* filename, const int16_t* samples,
                   size_t sample_count, int sample_rate);
void ctts_free(CTTS* engine);
void ctts_free_samples(int16_t* samples);

/* ---- configuration (ctts.h:252-286) ---- */

int ctts_load_config(CTTSConfig* config, const char* config_file);
void ctts_config_defaults(CTTSConfig* config);
void ctts_set_crossfade(CTTS* engine, float crossfade_ms);
void ctts_set_word_pause(CTTS* engine, float pause_ms);
void ctts_set_unknown_silence(CTTS* engine, float silence_ms);
void ctts_set_fades(CTTS* engine, float fade_in_ms, float fade_out_ms);

/* ctts_tpu extensions: accessor forms of the transparent fields, kept
 * for callers written against the round-2 opaque-handle header. */
CTTSConfig* ctts_get_config(CTTS* engine);
uint32_t ctts_units_found(const CTTS* engine);
uint32_t ctts_units_missing(const CTTS* engine);

/* ---- utilities (ctts.h:288-327) ---- */

size_t ctts_utf8_strlen(const char* str);
uint32_t ctts_utf8_next(const char** str);
uint32_t ctts_hash(const char* str, size_t len);
char* ctts_normalize(const char* text);
int ctts_load_normalization(const char* csv_file);
char* ctts_apply_normalization(const char* text);
void ctts_free_normalization(void);

/* ---- error codes (ctts.h:329-346) ---- */

#define CTTS_OK 0
#define CTTS_ERR_INVALID_ARG -1
#define CTTS_ERR_FILE_NOT_FOUND -2
#define CTTS_ERR_FILE_READ -3
#define CTTS_ERR_FILE_WRITE -4
#define CTTS_ERR_INVALID_FORMAT -5
#define CTTS_ERR_OUT_OF_MEMORY -6
#define CTTS_ERR_INVALID_WAV -7
#define CTTS_ERR_VERSION -8

/* Get error message for error code (ctts.c:161-168). */
const char* ctts_strerror(int error_code);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* CTTS_TPU_CTTS_H */
