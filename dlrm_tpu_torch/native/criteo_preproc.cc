// Native Criteo tsv parser: the hot path of offline preprocessing (the
// port's copy of dlrm_tpu/native/criteo_preproc.cc).
//
// Plays the role of the reference's Cython-compiled data_utils extension
// (cython/cython_compile.py:16-25): raw "label \t 13 ints \t 26 hex" lines
// -> int arrays, with optional zero-label subsampling and % max_ind_range
// hashing (process_one_file semantics, data_utils.py:974-1086).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). Two-pass usage:
// criteo_count_rows() with a seed, then criteo_parse() with the same seed
// fills caller-allocated buffers (the xorshift RNG makes both passes drop the
// same rows).
//
// Built with g++ at first use by dlrm_tpu_torch/native/criteo_native.py
// into dlrm_tpu_torch/build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNumDense = 13;
constexpr int kNumCat = 26;
constexpr int kNumCols = 1 + kNumDense + kNumCat;

// xorshift64* — deterministic, fast, good enough for subsampling decisions.
struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  double uniform() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    uint64_t x = s * 0x2545F4914F6CDD1Dull;
    return (x >> 11) * (1.0 / 9007199254740992.0);  // 53-bit mantissa
  }
};

// Parse a decimal int (possibly negative, possibly empty -> 0).
inline int32_t parse_dec(const char* b, const char* e) {
  if (b >= e) return 0;
  bool neg = (*b == '-');
  if (neg) ++b;
  int64_t v = 0;
  for (; b < e; ++b) {
    if (*b < '0' || *b > '9') break;
    v = v * 10 + (*b - '0');
  }
  return static_cast<int32_t>(neg ? -v : v);
}

// Parse a hex categorical (empty -> 0).
inline int64_t parse_hex(const char* b, const char* e) {
  if (b >= e) return 0;
  uint64_t v = 0;
  for (; b < e; ++b) {
    char c = *b;
    uint64_t d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
    else break;
    v = (v << 4) | d;
  }
  return static_cast<int64_t>(v);
}

struct LineView {
  const char* begin;
  const char* end;
};

// Split one line into kNumCols tab-separated fields (missing fields -> empty).
inline void split_fields(const char* b, const char* e, LineView* fields) {
  int col = 0;
  const char* start = b;
  for (const char* p = b; p <= e && col < kNumCols; ++p) {
    if (p == e || *p == '\t') {
      fields[col].begin = start;
      fields[col].end = p;
      ++col;
      start = p + 1;
    }
  }
  for (; col < kNumCols; ++col) {
    fields[col].begin = fields[col].end = e;
  }
}

template <typename RowFn>
int64_t for_each_kept_row(const char* path, double sub_sample_rate,
                          uint64_t seed, RowFn&& fn) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  XorShift rng(seed);
  std::vector<char> buf(1 << 22);
  std::string carry;
  int64_t kept = 0;
  LineView fields[kNumCols];
  for (;;) {
    size_t n = std::fread(buf.data(), 1, buf.size(), f);
    if (n == 0) break;
    const char* data = buf.data();
    size_t pos = 0;
    while (pos < n) {
      const char* nl =
          static_cast<const char*>(memchr(data + pos, '\n', n - pos));
      if (!nl) {
        carry.append(data + pos, n - pos);
        break;
      }
      const char* lb;
      const char* le;
      std::string tmp;
      if (!carry.empty()) {
        tmp.swap(carry);
        tmp.append(data + pos, nl - (data + pos));
        lb = tmp.data();
        le = tmp.data() + tmp.size();
      } else {
        lb = data + pos;
        le = nl;
      }
      if (le > lb) {
        split_fields(lb, le, fields);
        int32_t y = parse_dec(fields[0].begin, fields[0].end);
        bool drop = false;
        if (sub_sample_rate > 0.0 && y == 0) {
          drop = rng.uniform() < sub_sample_rate;
        }
        if (!drop) {
          fn(kept, y, fields);
          ++kept;
        }
      }
      pos = (nl - data) + 1;
    }
  }
  // trailing line without newline
  if (!carry.empty()) {
    split_fields(carry.data(), carry.data() + carry.size(), fields);
    int32_t y = parse_dec(fields[0].begin, fields[0].end);
    bool drop = false;
    if (sub_sample_rate > 0.0 && y == 0) drop = rng.uniform() < sub_sample_rate;
    if (!drop) {
      fn(kept, y, fields);
      ++kept;
    }
  }
  std::fclose(f);
  return kept;
}

}  // namespace

extern "C" {

// Count rows kept after subsampling (pass 1).
int64_t criteo_count_rows(const char* path, double sub_sample_rate,
                          uint64_t seed) {
  return for_each_kept_row(path, sub_sample_rate, seed,
                           [](int64_t, int32_t, LineView*) {});
}

// Fill caller buffers (pass 2, same seed). Returns rows written or -1.
// y: [max_rows] i32; x_int: [max_rows*13] i32; x_cat: [max_rows*26] i64.
int64_t criteo_parse(const char* path, double sub_sample_rate, uint64_t seed,
                     int64_t max_ind_range, int32_t* y, int32_t* x_int,
                     int64_t* x_cat, int64_t max_rows) {
  int64_t rows = for_each_kept_row(
      path, sub_sample_rate, seed,
      [&](int64_t row, int32_t label, LineView* fields) {
        if (row >= max_rows) return;
        y[row] = label;
        int32_t* di = x_int + row * kNumDense;
        for (int c = 0; c < kNumDense; ++c) {
          di[c] = parse_dec(fields[1 + c].begin, fields[1 + c].end);
        }
        int64_t* dc = x_cat + row * kNumCat;
        for (int c = 0; c < kNumCat; ++c) {
          int64_t v =
              parse_hex(fields[1 + kNumDense + c].begin,
                        fields[1 + kNumDense + c].end);
          dc[c] = (max_ind_range > 0) ? (v % max_ind_range) : v;
        }
      });
  return rows > max_rows ? max_rows : rows;
}

// Pack processed arrays into the int32 .bin record layout
// [y, 13 dense, 26 cat] (data_loader_terabyte.py:251-290) — append to file.
int64_t criteo_write_bin(const char* path, const int32_t* y,
                         const int32_t* x_int, const int32_t* x_cat,
                         int64_t rows) {
  FILE* f = std::fopen(path, "ab");
  if (!f) return -1;
  std::vector<int32_t> rec(kNumCols);
  for (int64_t r = 0; r < rows; ++r) {
    rec[0] = y[r];
    std::memcpy(rec.data() + 1, x_int + r * kNumDense,
                kNumDense * sizeof(int32_t));
    std::memcpy(rec.data() + 1 + kNumDense, x_cat + r * kNumCat,
                kNumCat * sizeof(int32_t));
    if (std::fwrite(rec.data(), sizeof(int32_t), kNumCols, f) !=
        static_cast<size_t>(kNumCols)) {
      std::fclose(f);
      return -1;
    }
  }
  std::fclose(f);
  return rows;
}

}  // extern "C"
