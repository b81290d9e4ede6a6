// Internal ABI between the ctts_tpu native plan executor
// (ctts_native.cpp) and its consumers: the ctypes wrapper
// (ctts_tpu/runtime/native.py) and the drop-in C API frontend
// (ctts_capi.cpp). Mirrors ctts_tpu.plan.compiler.SynthesisPlan.

#pragma once

#include <cstddef>
#include <cstdint>

extern "C" {

// Packed plan: one entry per PlanOp (kind per ctts_tpu.plan.compiler.OpKind).
struct CtnPlan {
  int32_t n_ops;
  const int32_t* kind;   // OpKind per op
  const int32_t* arg0;   // unit_idx | n_samples | word_index | fade
  const int32_t* arg1;   // crossfade_samples
  const int32_t* flags;  // bit0 after_word_boundary, bit1 smooth
  // config / prosody scalars
  float speed;
  float target_rms;
  float silence_threshold;
  float max_pitch_change;
  int32_t min_silence_samples;
  int32_t fade_in_samples;
  int32_t remove_dc_offset;
  int32_t remove_word_silence;
  int32_t word_count;
  int32_t phrase_type;
  float pitch_start, pitch_end, pitch_peak, peak_position;
  float energy_factor;
};

// Raw view of an open database's memory mapping, for consumers that
// expose the transparent reference engine struct (ctts.h:128-149).
struct CtnDbView {
  const uint8_t* data;
  size_t size;
  int fd;
};

void* ctn_db_open(const char* path);
void ctn_db_close(void* handle);
void ctn_db_view(void* handle, CtnDbView* out);
uint32_t ctn_db_unit_count(void* handle);
uint32_t ctn_db_max_unit_chars(void* handle);
int32_t ctn_db_find_unit(void* handle, const char* text, size_t len);
// Returns the unit's text bytes (NUL-terminated in the string pool) and
// writes its byte length; NULL for an out-of-range index.
const char* ctn_db_unit_text(void* handle, uint32_t idx, uint32_t* len);
uint32_t ctn_db_unit_sample_count(void* handle, uint32_t idx);
int64_t ctn_execute_plan(void* handle, const CtnPlan* plan, int16_t** out);
void ctn_free(int16_t* p);

}  // extern "C"
