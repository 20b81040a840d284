// Batch Levenshtein distance (insert/delete/substitute, unit costs).
//
// Native core for evaluation NED computation (reference uses
// nltk.edit_distance per sample, strhub/models/base.py:138): the pure-Python
// DP was the host-side bottleneck at high device throughput. Strings arrive
// as UTF-32 code points, concatenated, with offsets — one call scores an
// entire batch.
//
// Built by utils/native_build.py into build/native/libeditdist.so (a copy of
// parseq_tpu/utils/editdist.cpp; the port builds and loads its own).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// a/b: concatenated UTF-32 code points; a_off/b_off: n+1 offsets.
// out[i] = levenshtein(a[i], b[i]).
void parseq_editdist_batch(const uint32_t* a, const int64_t* a_off,
                           const uint32_t* b, const int64_t* b_off,
                           int64_t n, int32_t* out) {
  std::vector<int32_t> prev, cur;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t* sa = a + a_off[i];
    const uint32_t* sb = b + b_off[i];
    int64_t la = a_off[i + 1] - a_off[i];
    int64_t lb = b_off[i + 1] - b_off[i];
    if (la < lb) {  // DP over the shorter string's row
      std::swap(sa, sb);
      std::swap(la, lb);
    }
    if (lb == 0) {
      out[i] = static_cast<int32_t>(la);
      continue;
    }
    prev.resize(lb + 1);
    cur.resize(lb + 1);
    for (int64_t j = 0; j <= lb; ++j) prev[j] = static_cast<int32_t>(j);
    for (int64_t r = 1; r <= la; ++r) {
      cur[0] = static_cast<int32_t>(r);
      const uint32_t ca = sa[r - 1];
      for (int64_t j = 1; j <= lb; ++j) {
        int32_t sub = prev[j - 1] + (ca != sb[j - 1] ? 1 : 0);
        cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
      }
      std::swap(prev, cur);
    }
    out[i] = prev[lb];
  }
}

}  // extern "C"
