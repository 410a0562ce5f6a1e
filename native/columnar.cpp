// Native columnar store + CSV loader for duckdb_imputation_tpu.
//
// Replacement for the reference's host engine storage layer
// (DuckDB 0.9.2 + the column-swap patch, /root/reference/
// duckdb_imputation.patch:26-175): a minimal columnar table whose job is to
// feed the JAX device compute path with dense FEATURES-FIRST buffers:
//
//   * multithreaded CSV parse (row-range partitioned, two-pass: index
//     newlines, then parse chunks in parallel);
//   * type dispatch per the reference's rule (FLOAT/DOUBLE => numeric,
//     INTEGER => categorical, triple/lift.cpp:34-37), auto-inferred;
//     string cells dictionary-encode (sorted labels -> codes; the
//     reference ingests INTEGER categories only);
//   * null handling: empty / NULL / NaN cells set a per-column null bitmap
//     (the <col>_IS_NULL flags of partition.cpp:671-719);
//   * column-major f32 / i64 buffers, 64-byte aligned, zero-copy exposed to
//     Python via ctypes + numpy;
//   * O(1) column swap (pointer exchange) — the storage patch's zero-copy
//     `ALTER TABLE .. SET DEFAULT` write-back contract at buffer level;
//   * per-categorical-column sorted-unique vocab build + value->code
//     encoding (the host half of n_cols_1hot_expansion, ML/utils.cpp:520-576)
//     done in native code, multithreaded.
//
// C ABI only (consumed with ctypes; pybind11 is not available in this
// image).
#include <algorithm>
#include <atomic>
#include <cctype>
#include <charconv>
#include <cstdio>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <utility>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Column {
  std::string name;
  bool is_numeric = false;
  bool is_string = false;  // dictionary-encoded string categorical
  // exactly one of these is populated, features-first contiguous
  std::vector<float> f32;
  std::vector<int64_t> i64;
  std::vector<uint8_t> null_mask;  // 1 = missing
  // categorical vocab (sorted unique observed values) + codes
  std::vector<int64_t> vocab;
  std::vector<int32_t> codes;  // value -> position in vocab; -1 for null
  // for string columns: sorted labels; i64 holds indices into this
  std::vector<std::string> labels;
};

struct Table {
  int64_t n_rows = 0;
  std::vector<Column> cols;
  std::string error;
};

bool cell_is_null(const char* s, size_t len) {
  if (len == 0) return true;
  if (len == 4 && (strncasecmp(s, "null", 4) == 0)) return true;
  if (len == 4 && (strncasecmp(s, "none", 4) == 0)) return true;
  if (len == 3 && (strncasecmp(s, "nan", 3) == 0)) return true;
  if (len == 3 && (strncasecmp(s, "n/a", 3) == 0)) return true;
  if (len == 2 && (strncasecmp(s, "na", 2) == 0)) return true;
  return false;
}

// Parse one row-range of the CSV body into per-column staging vectors.
struct Shard {
  std::vector<std::vector<double>> nums;    // raw parsed values / label ids
  std::vector<std::vector<uint8_t>> nulls;
  std::vector<std::vector<uint8_t>> is_float;  // any cell had . e E
  // string-categorical staging: per col a shard-local label dictionary;
  // strcell marks cells whose nums value is a LOCAL label id
  std::vector<std::vector<uint8_t>> strcell;
  std::vector<std::vector<std::string>> uniq;
  std::vector<std::map<std::string, int32_t>> dict;
  int64_t rows = 0;
};

void parse_range(const char* data, size_t begin, size_t end, size_t ncols,
                 Shard* out) {
  out->nums.assign(ncols, {});
  out->nulls.assign(ncols, {});
  out->is_float.assign(ncols, std::vector<uint8_t>(1, 0));
  out->strcell.assign(ncols, {});
  out->uniq.assign(ncols, {});
  out->dict.assign(ncols, {});
  size_t i = begin;
  while (i < end) {
    size_t col = 0;
    while (i <= end && col < ncols) {
      size_t start = i;
      while (i < end && data[i] != ',' && data[i] != '\n') i++;
      // trim surrounding whitespace / trailing \r before any dispatch
      size_t ts = start, tl = i - start;
      while (tl && (data[ts] == ' ' || data[ts] == '\t')) { ts++; tl--; }
      while (tl && (data[ts + tl - 1] == '\r' || data[ts + tl - 1] == ' ' ||
                    data[ts + tl - 1] == '\t')) tl--;
      bool null = cell_is_null(data + ts, tl);
      double v = 0.0;
      uint8_t sc = 0;
      if (!null) {
        char* endp = nullptr;
        v = strtod(data + ts, &endp);
        if (endp != data + ts + tl) {
          // not a clean number -> string category (dictionary-encode
          // shard-locally; merged and re-mapped at type decision)
          std::string tok(data + ts, tl);
          auto it = out->dict[col].find(tok);
          int32_t id;
          if (it == out->dict[col].end()) {
            id = int32_t(out->uniq[col].size());
            out->uniq[col].push_back(tok);
            out->dict[col].emplace(std::move(tok), id);
          } else {
            id = it->second;
          }
          v = double(id);
          sc = 1;
        } else {
          for (size_t k = ts; k < ts + tl; k++) {
            char ch = data[k];
            if (ch == '.' || ch == 'e' || ch == 'E') {
              out->is_float[col][0] = 1;
              break;
            }
          }
        }
      }
      out->nums[col].push_back(v);
      out->nulls[col].push_back(null ? 1 : 0);
      out->strcell[col].push_back(sc);
      col++;
      if (i < end && data[i] == ',') {
        i++;
      } else {
        break;
      }
    }
    // pad short rows with nulls
    for (; col < ncols; col++) {
      out->nums[col].push_back(0.0);
      out->nulls[col].push_back(1);
      out->strcell[col].push_back(0);
    }
    out->rows++;
    while (i < end && data[i] != '\n') i++;
    if (i < end) i++;  // skip newline
  }
}

void build_vocab_and_codes(Column& c) {
  // sorted unique over observed values (std::map order — matches the
  // reference's ascending key emission)
  std::vector<int64_t> vals;
  vals.reserve(c.i64.size());
  for (size_t i = 0; i < c.i64.size(); i++) {
    if (!c.null_mask[i]) vals.push_back(c.i64[i]);
  }
  std::sort(vals.begin(), vals.end());
  vals.erase(std::unique(vals.begin(), vals.end()), vals.end());
  c.vocab = std::move(vals);
  c.codes.resize(c.i64.size());
  for (size_t i = 0; i < c.i64.size(); i++) {
    if (c.null_mask[i]) {
      c.codes[i] = -1;
      continue;
    }
    auto it = std::lower_bound(c.vocab.begin(), c.vocab.end(), c.i64[i]);
    c.codes[i] = (it != c.vocab.end() && *it == c.i64[i])
                     ? int32_t(it - c.vocab.begin())
                     : int32_t(c.vocab.size());  // find_in_array miss
  }
}

}  // namespace

extern "C" {

// ---- lifecycle ----

void* dbi_load_csv(const char* path, int has_header, int n_threads) {
  auto* t = new Table();
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) {
    t->error = "cannot open file";
    return t;
  }
  size_t size = size_t(f.tellg());
  f.seekg(0);
  std::vector<char> buf(size + 1);
  f.read(buf.data(), size);
  buf[size] = '\n';
  const char* data = buf.data();

  // header / column count
  size_t body_begin = 0;
  std::vector<std::string> names;
  {
    size_t i = 0;
    size_t start = 0;
    while (i < size && data[i] != '\n') {
      if (data[i] == ',') {
        names.emplace_back(data + start, i - start);
        start = i + 1;
      }
      i++;
    }
    names.emplace_back(data + start, i - start);
    if (has_header) {
      body_begin = i + 1;
    } else {
      for (size_t k = 0; k < names.size(); k++) names[k] = "col" + std::to_string(k);
    }
  }
  size_t ncols = names.size();

  if (n_threads <= 0) {
    n_threads = int(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  // split body at newline boundaries
  std::vector<size_t> bounds{body_begin};
  for (int k = 1; k < n_threads; k++) {
    size_t target = body_begin + (size - body_begin) * size_t(k) / size_t(n_threads);
    while (target < size && data[target] != '\n') target++;
    if (target < size) target++;
    bounds.push_back(std::min(target, size));
  }
  bounds.push_back(size);
  std::sort(bounds.begin(), bounds.end());

  std::vector<Shard> shards(bounds.size() - 1);
  std::vector<std::thread> threads;
  for (size_t k = 0; k + 1 < bounds.size(); k++) {
    threads.emplace_back(parse_range, data, bounds[k], bounds[k + 1], ncols,
                         &shards[k]);
  }
  for (auto& th : threads) th.join();

  int64_t n_rows = 0;
  for (auto& s : shards) n_rows += s.rows;
  t->n_rows = n_rows;
  t->cols.resize(ncols);

  // type decision: string if ANY shard saw a non-numeric token (strings
  // beat floats — one "red" makes the column categorical-of-string);
  // else float if ANY shard saw a float-looking token
  for (size_t c = 0; c < ncols; c++) {
    bool is_float = false, saw_string = false;
    for (auto& s : shards) {
      is_float |= (s.is_float[c][0] != 0);
      saw_string |= !s.uniq[c].empty();
    }
    Column& col = t->cols[c];
    col.name = names[c];
    if (saw_string) {
      col.is_numeric = false;
      col.is_string = true;
      // global sorted label dictionary: all shard-local labels plus the
      // canonical "%g" text of numeric-parsed cells (a column with "red"
      // and "3" treats 3 as the label "3")
      std::map<std::string, int32_t> glob;
      char nbuf[64];
      for (auto& s : shards) {
        for (auto& u : s.uniq[c]) glob.emplace(u, 0);
        for (int64_t i = 0; i < s.rows; i++) {
          if (!s.nulls[c][i] && !s.strcell[c][i]) {
            snprintf(nbuf, sizeof nbuf, "%g", s.nums[c][i]);
            glob.emplace(nbuf, 0);
          }
        }
      }
      int32_t next_id = 0;
      for (auto& kv : glob) {
        kv.second = next_id++;
        col.labels.push_back(kv.first);
      }
      col.i64.reserve(n_rows);
      col.null_mask.reserve(n_rows);
      for (auto& s : shards) {
        std::vector<int32_t> remap(s.uniq[c].size());
        for (size_t u = 0; u < s.uniq[c].size(); u++)
          remap[u] = glob[s.uniq[c][u]];
        for (int64_t i = 0; i < s.rows; i++) {
          uint8_t nul = s.nulls[c][i];
          int64_t vv = 0;
          if (!nul) {
            if (s.strcell[c][i]) {
              vv = remap[size_t(s.nums[c][i])];
            } else {
              snprintf(nbuf, sizeof nbuf, "%g", s.nums[c][i]);
              vv = glob[nbuf];
            }
          }
          col.i64.push_back(vv);
          col.null_mask.push_back(nul);
        }
      }
      continue;
    }
    col.is_numeric = is_float;
    col.null_mask.reserve(n_rows);
    if (is_float) {
      col.f32.reserve(n_rows);
      for (auto& s : shards) {
        for (int64_t i = 0; i < s.rows; i++) {
          col.f32.push_back(float(s.nums[c][i]));
          col.null_mask.push_back(s.nulls[c][i]);
        }
      }
    } else {
      col.i64.reserve(n_rows);
      for (auto& s : shards) {
        for (int64_t i = 0; i < s.rows; i++) {
          col.i64.push_back(int64_t(llround(s.nums[c][i])));
          col.null_mask.push_back(s.nulls[c][i]);
        }
      }
    }
  }

  // vocab + codes for categorical columns, in parallel
  {
    std::vector<std::thread> vt;
    for (auto& col : t->cols) {
      if (!col.is_numeric) {
        vt.emplace_back([&col] { build_vocab_and_codes(col); });
      }
    }
    for (auto& th : vt) th.join();
  }
  return t;
}

void* dbi_table_new(int64_t n_rows) {
  auto* t = new Table();
  t->n_rows = n_rows;
  return t;
}

void dbi_free(void* h) { delete static_cast<Table*>(h); }

const char* dbi_error(void* h) {
  return static_cast<Table*>(h)->error.c_str();
}

// ---- shape / metadata ----

int64_t dbi_n_rows(void* h) { return static_cast<Table*>(h)->n_rows; }
int64_t dbi_n_cols(void* h) { return int64_t(static_cast<Table*>(h)->cols.size()); }

int dbi_col_is_numeric(void* h, int64_t c) {
  return static_cast<Table*>(h)->cols[c].is_numeric ? 1 : 0;
}

int dbi_col_is_string(void* h, int64_t c) {
  return static_cast<Table*>(h)->cols[c].is_string ? 1 : 0;
}

// '\n'-joined label blob (this parser has no quoting, so labels can
// contain neither commas nor newlines): total bytes, then fill
int64_t dbi_col_labels_bytes(void* h, int64_t c) {
  int64_t total = 0;
  for (auto& s : static_cast<Table*>(h)->cols[c].labels)
    total += int64_t(s.size()) + 1;
  return total;
}

void dbi_col_labels_fill(void* h, int64_t c, char* buf) {
  for (auto& s : static_cast<Table*>(h)->cols[c].labels) {
    memcpy(buf, s.data(), s.size());
    buf += s.size();
    *buf++ = '\n';
  }
}

const char* dbi_col_name(void* h, int64_t c) {
  return static_cast<Table*>(h)->cols[c].name.c_str();
}

// ---- zero-copy buffer access ----

float* dbi_col_f32(void* h, int64_t c) {
  return static_cast<Table*>(h)->cols[c].f32.data();
}

int64_t* dbi_col_i64(void* h, int64_t c) {
  return static_cast<Table*>(h)->cols[c].i64.data();
}

uint8_t* dbi_col_null_mask(void* h, int64_t c) {
  return static_cast<Table*>(h)->cols[c].null_mask.data();
}

int64_t dbi_col_vocab_size(void* h, int64_t c) {
  return int64_t(static_cast<Table*>(h)->cols[c].vocab.size());
}

int64_t* dbi_col_vocab(void* h, int64_t c) {
  return static_cast<Table*>(h)->cols[c].vocab.data();
}

int32_t* dbi_col_codes(void* h, int64_t c) {
  return static_cast<Table*>(h)->cols[c].codes.data();
}

// ---- mutation ----

// Zero-copy column swap: replace column c's numeric payload with `values`
// (length n_rows) in O(metadata) by vector move — the buffer-level analogue
// of the reference's patched column-segment swap (duckdb_imputation.patch:
// 26-175: MoveSegments of the single-column `rep` table into the target).
void dbi_swap_col_f32(void* h, int64_t c, const float* values) {
  Table* t = static_cast<Table*>(h);
  Column& col = t->cols[c];
  std::vector<float> incoming(values, values + t->n_rows);
  col.f32.swap(incoming);
}

void dbi_swap_col_codes(void* h, int64_t c, const int32_t* codes) {
  Table* t = static_cast<Table*>(h);
  Column& col = t->cols[c];
  std::vector<int32_t> incoming(codes, codes + t->n_rows);
  col.codes.swap(incoming);
  for (int64_t i = 0; i < t->n_rows; i++) {
    int32_t k = col.codes[i];
    col.i64[i] = (k >= 0 && size_t(k) < col.vocab.size()) ? col.vocab[k] : -1;
  }
}

// ---- streaming CSV reader (out-of-core path) ----
//
// Chunked re-entrant parser for files that must not be resident: each
// dbi_csv_next_chunk call reads ~max_bytes (cut at a newline boundary),
// parses it with the same row-range-partitioned multithreaded scheme as
// dbi_load_csv, and returns a standalone chunk Table (caller frees).
// Column types are decided from the FIRST chunk and held fixed for the
// stream (like pandas' chunked readers); later float tokens in an
// int-typed column are rounded. Chunk tables carry raw values + null
// masks only — the global vocab union across chunks is built by the
// Python stream scan (ring/streaming.py scan_schema), since no single
// chunk sees the whole key space.

namespace {

struct CsvStream {
  std::ifstream f;
  std::vector<std::string> names;
  std::vector<uint8_t> col_is_numeric;
  bool types_decided = false;
  std::string carry;   // bytes after the last newline of the previous block
  std::string error;
  bool eof = false;
  int n_threads = 1;
};

}  // namespace

void* dbi_csv_open(const char* path, int has_header, int n_threads) {
  auto* s = new CsvStream();
  if (n_threads <= 0) {
    n_threads = int(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  s->n_threads = n_threads;
  s->f.open(path, std::ios::binary);
  if (!s->f) {
    s->error = "cannot open file";
    return s;
  }
  std::string line;
  if (!std::getline(s->f, line)) {
    s->error = "empty file";
    s->eof = true;
    return s;
  }
  if (!line.empty() && line.back() == '\r') line.pop_back();
  size_t start = 0;
  for (size_t i = 0; i <= line.size(); i++) {
    if (i == line.size() || line[i] == ',') {
      s->names.emplace_back(line, start, i - start);
      start = i + 1;
    }
  }
  if (!has_header) {
    // first line is data: hand it to the first chunk
    s->carry = line + "\n";
    for (size_t k = 0; k < s->names.size(); k++)
      s->names[k] = "col" + std::to_string(k);
  }
  return s;
}

const char* dbi_csv_stream_error(void* sh) {
  return static_cast<CsvStream*>(sh)->error.c_str();
}

int64_t dbi_csv_stream_ncols(void* sh) {
  return int64_t(static_cast<CsvStream*>(sh)->names.size());
}

const char* dbi_csv_stream_col_name(void* sh, int64_t c) {
  return static_cast<CsvStream*>(sh)->names[c].c_str();
}

void dbi_csv_close(void* sh) { delete static_cast<CsvStream*>(sh); }

void* dbi_csv_next_chunk(void* sh, int64_t max_bytes) {
  auto* s = static_cast<CsvStream*>(sh);
  if (!s->error.empty()) return nullptr;
  if (s->eof && s->carry.empty()) return nullptr;

  std::string buf = std::move(s->carry);
  s->carry.clear();
  if (!s->eof) {
    size_t want = size_t(max_bytes > 0 ? max_bytes : (size_t(64) << 20));
    size_t off = buf.size();
    buf.resize(off + want);
    s->f.read(&buf[off], std::streamsize(want));
    size_t got = size_t(s->f.gcount());
    buf.resize(off + got);
    if (got < want) s->eof = true;
  }
  if (!s->eof) {
    size_t cut = buf.find_last_of('\n');
    if (cut == std::string::npos) {
      // one line longer than the block: finish it
      std::string rest;
      if (std::getline(s->f, rest)) {
        buf += rest;
        buf += '\n';
      } else {
        s->eof = true;
      }
    } else {
      s->carry = buf.substr(cut + 1);
      buf.resize(cut + 1);
    }
  }
  if (buf.empty() || buf.find_first_not_of("\r\n") == std::string::npos) {
    return s->eof ? nullptr : dbi_csv_next_chunk(sh, max_bytes);
  }
  if (buf.back() != '\n') buf.push_back('\n');

  const char* data = buf.data();
  const size_t size = buf.size();
  const size_t ncols = s->names.size();
  int nt = s->n_threads;
  std::vector<size_t> bounds{0};
  for (int k = 1; k < nt; k++) {
    size_t target = size * size_t(k) / size_t(nt);
    while (target < size && data[target] != '\n') target++;
    if (target < size) target++;
    bounds.push_back(std::min(target, size));
  }
  bounds.push_back(size);
  std::sort(bounds.begin(), bounds.end());

  std::vector<Shard> shards(bounds.size() - 1);
  std::vector<std::thread> threads;
  for (size_t k = 0; k + 1 < bounds.size(); k++) {
    threads.emplace_back(parse_range, data, bounds[k], bounds[k + 1], ncols,
                         &shards[k]);
  }
  for (auto& th : threads) th.join();

  for (size_t c = 0; c < ncols; c++) {
    for (auto& sh2 : shards) {
      if (!sh2.uniq[c].empty()) {
        s->error = "string categorical column '" + s->names[c] +
                   "': the streaming reader needs a fixed global label "
                   "dictionary; pre-encode to integer categories or load "
                   "with read_csv (which dictionary-encodes)";
        return nullptr;
      }
    }
  }
  if (!s->types_decided) {
    s->col_is_numeric.assign(ncols, 0);
    for (size_t c = 0; c < ncols; c++) {
      for (auto& sh2 : shards) s->col_is_numeric[c] |= sh2.is_float[c][0];
    }
    s->types_decided = true;
  }

  auto* t = new Table();
  int64_t n_rows = 0;
  for (auto& sd : shards) n_rows += sd.rows;
  t->n_rows = n_rows;
  t->cols.resize(ncols);
  for (size_t c = 0; c < ncols; c++) {
    Column& col = t->cols[c];
    col.name = s->names[c];
    col.is_numeric = s->col_is_numeric[c] != 0;
    col.null_mask.reserve(n_rows);
    if (col.is_numeric) {
      col.f32.reserve(n_rows);
      for (auto& sd : shards) {
        for (int64_t i = 0; i < sd.rows; i++) {
          col.f32.push_back(float(sd.nums[c][i]));
          col.null_mask.push_back(sd.nulls[c][i]);
        }
      }
    } else {
      col.i64.reserve(n_rows);
      for (auto& sd : shards) {
        for (int64_t i = 0; i < sd.rows; i++) {
          col.i64.push_back(int64_t(llround(sd.nums[c][i])));
          col.null_mask.push_back(sd.nulls[c][i]);
        }
      }
    }
  }
  return t;
}

// ---- faithful reference-loop CPU baseline ----
//
// Single-core reimplementation of the ALGORITHM CLASS of the reference's
// fused aggregation hot loop (Triple::SumNoLift, sum_no_lift.cpp:53-216,
// written from its description in SURVEY.md §2/§3.1, not its code): per
// row — N++, lin FMA, packed-upper-triangle quad FMA over column pairs,
// per-categorical-column ordered-map upsert of a [count ‖ Σx_j] payload,
// categorical-pair ordered-map upsert. bench.py runs this on the host as
// the honest "reference per-core" baseline; the BLAS sgemm stand-in it
// also prints is a GENEROUS upper bound (dense FMA with no hash maps).
double dbi_ref_agg_seconds(const float* x, const int32_t* codes,
                           const float* w, int64_t n, int d, int c,
                           int reps) {
  using clock_t2 = std::chrono::high_resolution_clock;
  double sink = 0;
  auto t0 = clock_t2::now();
  for (int r = 0; r < reps; r++) {
    const int quad_len = d * (d + 1) / 2;
    int64_t cnt = 0;
    std::vector<float> lin(size_t(d), 0.f), quad(size_t(quad_len), 0.f);
    std::vector<float> payload(size_t(d), 0.f);
    std::vector<std::map<int, std::vector<float>>> num_cat;
    num_cat.resize(size_t(c));
    std::vector<std::map<std::pair<int, int>, float>> cat_cat;
    for (int a = 0; a < c; a++)
      for (int b = a; b < c; b++) cat_cat.emplace_back();
    for (int64_t i = 0; i < n; i++) {
      if (w[i] == 0.f) continue;
      cnt++;
      for (int j = 0; j < d; j++) payload[size_t(j)] = x[j * n + i];
      int qi = 0;
      for (int j = 0; j < d; j++) {
        lin[size_t(j)] += payload[size_t(j)];
        for (int k = j; k < d; k++)
          quad[size_t(qi++)] += payload[size_t(j)] * payload[size_t(k)];
      }
      for (int a = 0; a < c; a++) {
        auto& m = num_cat[size_t(a)];
        int key = codes[a * n + i];
        auto it = m.find(key);
        if (it == m.end()) {
          std::vector<float> v(size_t(d + 1), 0.f);
          v[0] = 1.f;
          for (int j = 0; j < d; j++) v[size_t(j + 1)] = payload[size_t(j)];
          m.emplace(key, std::move(v));
        } else {
          it->second[0] += 1.f;
          for (int j = 0; j < d; j++)
            it->second[size_t(j + 1)] += payload[size_t(j)];
        }
      }
      int pi = 0;
      for (int a = 0; a < c; a++) {
        for (int b = a; b < c; b++) {
          cat_cat[size_t(pi++)][{codes[a * n + i], codes[b * n + i]}] += 1.f;
        }
      }
    }
    sink += double(cnt) + (d ? lin[0] + quad[0] : 0.0)
        + (c ? double(num_cat[0].size()) : 0.0);
  }
  auto t1 = clock_t2::now();
  if (sink == -1.0) return -1.0;  // keep the loop observable
  return std::chrono::duration<double>(t1 - t0).count() / reps;
}

// ---------------------------------------------------------------------------
// Streaming CSV WRITER — the write-back half of the out-of-core path.
// np.savetxt formats ~0.5-1M values/s single-threaded in Python; at 100M
// rows the write pass would dwarf every device phase. This formats m rows
// × k cols (f64 matrix, FEATURES-FIRST [k, m]) into `out`, rows split
// across threads, each into its own disjoint region, compacted at the
// end. is_int[c] selects "%lld" (exact to 2^53 — the loader's int64
// contract) vs "%.9g"; NaN cells emit an empty field (the loader's null
// convention, so nulls round-trip). Returns bytes written, -1 if cap is
// too small (caller sizes cap >= m * (27*k + 2)).
int64_t dbi_format_csv(const double* data, int64_t k, int64_t m,
                       const uint8_t* is_int, char* out, int64_t cap,
                       int n_threads) {
  if (n_threads <= 0) {
    n_threads = int(std::thread::hardware_concurrency());
    if (n_threads < 1) n_threads = 1;
  }
  if (int64_t(n_threads) > m) n_threads = int(m > 0 ? m : 1);
  const int64_t stride = 27 * k + 2;  // worst-case bytes per row
  if (cap < m * stride) return -1;
  const int64_t per = (m + n_threads - 1) / n_threads;
  std::vector<int64_t> lens(size_t(n_threads), 0);
  std::vector<std::thread> th;
  for (int t = 0; t < n_threads; t++) {
    th.emplace_back([&, t]() {
      const int64_t lo = int64_t(t) * per;
      const int64_t hi = std::min<int64_t>(m, lo + per);
      char* p = out + lo * stride;
      char* q = p;
      for (int64_t i = lo; i < hi; i++) {
        for (int64_t c2 = 0; c2 < k; c2++) {
          if (c2) *q++ = ',';
          const double v = data[c2 * m + i];
          if (std::isnan(v)) {
            // null cell -> empty field
          } else if (is_int[c2]) {
            q = std::to_chars(q, q + 26, (long long)(llround(v))).ptr;
          } else {
            // shortest-round-trip float to_chars (Ryu). The precision
            // overload silently falls back to printf in libstdc++
            // (~300 ns/value); shortest is ~20 ns AND exact: the table's
            // numerics are f32, so emitting the shortest f32 repr
            // round-trips the stored value bit-for-bit through reload.
            q = std::to_chars(q, q + 26, float(v)).ptr;
          }
        }
        *q++ = '\n';
      }
      lens[size_t(t)] = q - p;
    });
  }
  for (auto& x : th) x.join();
  int64_t total = lens[0];
  for (int t = 1; t < n_threads; t++) {
    memmove(out + total, out + int64_t(t) * per * stride,
            size_t(lens[size_t(t)]));
    total += lens[size_t(t)];
  }
  return total;
}

int64_t dbi_version() { return 3; }

}  // extern "C"
