// A bucket's rows into their stacked arrays: the host lowering's fill
// (parallel/batch.py `_prepare_native`, bound by plan/native_lower.py
// `NativeLowerer.fill_bucket`).
//
// One call fills every row of a bucket. Each row goes through the
// lowering library's ctl_fill_row (reached through its address, so that
// this library links nothing) into a scratch row of every field; the
// call then writes the fade lengths the walk left at 0 and the three
// scalars, and sums the row's output length. The rows are copied from
// the scratch into their slots in the stable descending order of that
// length, and the pad slots n..bsz-1 become copies of slot n-1. That is
// fill_into a row, then the scalars, then `_order_and_pad`, bit for bit.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

typedef int32_t (*FillRowFn)(void* handle, int32_t row, const int32_t* bd,
                             void** ptrs);

// Where each field the call reads or writes sits in the field table.
enum Role {
  kRegionLen,
  kRegionPause,
  kRegionDoDsp,
  kRegionFadeAfter,
  kFadePos,
  kFadeLen,
  kThreshold,
  kSpeed,
  kRefineTrips,
  kRoles
};

}  // namespace

extern "C" {

// fill_row: ctl_fill_row's address; handle: the lowering handle whose
// rows the ids name; bd: the 8 bucket dims ctl_fill_row takes (R is
// bd[1], FD is bd[2]). The field table has nfield entries, each a
// [bsz, ...] C-contiguous array at bases[f] of row_bytes[f] bytes a
// slot; its first nfill are ctl_fill_row's pointers in their order, and
// roles[k] is the index of the field of Role k. rows: the n row ids in
// arrival order; trips: every row's refine trips, by row id. fade: the
// fade length (samples). Writes the row ids in slot order into
// slot_rows[n]. Returns 0, or a failing ctl_fill_row's code with its row
// id in *bad_row.
int32_t ctf_fill_bucket(void* fill_row, void* handle, const int32_t* bd,
                        int32_t nfield, int32_t nfill, void* const* bases,
                        const int64_t* row_bytes, const int32_t* roles,
                        const int32_t* rows, int32_t n, int32_t bsz,
                        const int32_t* trips, int32_t fade, float threshold,
                        float speed, int32_t* slot_rows, int32_t* bad_row) {
  const FillRowFn fill = reinterpret_cast<FillRowFn>(fill_row);
  const int32_t R = bd[1], FD = bd[2];
  std::vector<int64_t> at(nfield + 1, 0);  // a field's offset in a row
  for (int32_t f = 0; f < nfield; ++f) at[f + 1] = at[f] + row_bytes[f];
  const int64_t stride = at[nfield];
  std::vector<uint8_t> scratch(static_cast<size_t>(stride) * n);
  std::vector<int64_t> key(n);
  std::vector<void*> ptrs(nfill);

  for (int32_t i = 0; i < n; ++i) {
    uint8_t* row = scratch.data() + stride * i;
    for (int32_t f = 0; f < nfill; ++f) ptrs[f] = row + at[f];
    const int32_t rc = fill(handle, rows[i], bd, ptrs.data());
    if (rc != 0) {
      *bad_row = rows[i];
      return rc;
    }
    auto field = [&](Role k) { return row + at[roles[k]]; };
    const int32_t* pos = reinterpret_cast<int32_t*>(field(kFadePos));
    int32_t* len = reinterpret_cast<int32_t*>(field(kFadeLen));
    for (int32_t j = 0; j < FD; ++j) len[j] = pos[j] >= 0 ? fade : 0;
    const uint8_t* dsp = field(kRegionDoDsp);
    int32_t* after = reinterpret_cast<int32_t*>(field(kRegionFadeAfter));
    for (int32_t r = 0; r < R; ++r) after[r] = dsp[r] ? fade : 0;
    const int32_t* rlen = reinterpret_cast<int32_t*>(field(kRegionLen));
    const int32_t* pause = reinterpret_cast<int32_t*>(field(kRegionPause));
    int64_t k = 0;
    for (int32_t r = 0; r < R; ++r) k += int64_t{rlen[r]} + pause[r];
    key[i] = k;
    std::memcpy(field(kThreshold), &threshold, sizeof threshold);
    std::memcpy(field(kSpeed), &speed, sizeof speed);
    std::memcpy(field(kRefineTrips), &trips[rows[i]], sizeof(int32_t));
  }

  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return key[a] > key[b]; });
  for (int32_t f = 0; f < nfield; ++f) {
    uint8_t* base = static_cast<uint8_t*>(bases[f]);
    const int64_t rb = row_bytes[f];
    for (int32_t s = 0; s < n; ++s)
      std::memcpy(base + rb * s, scratch.data() + stride * order[s] + at[f],
                  rb);
    for (int32_t s = n; s < bsz; ++s)
      std::memcpy(base + rb * s, base + rb * (n - 1), rb);
  }
  for (int32_t s = 0; s < n; ++s) slot_rows[s] = rows[order[s]];
  return 0;
}

}  // extern "C"
