// Matrix Market reader, a copy of the JAX package's csrc/mtx_reader.cpp.
//
// Behaviour equal to the port's Python reader (formats/mtx.py): '%'
// comment lines, the "NRow NCol NNZ" header, 1-based indices, a missing
// value reads as 1.0 (and every value of a "pattern" file), and
// "symmetric" / "skew-symmetric" headers mirror off-diagonal entries
// (negated for skew). It parses the file in one buffer sweep with
// hand-rolled integer parsing and strtod for values (parsed as double,
// then rounded to float, as the Python reader does).
//
// Plain C ABI for ctypes (runtime/native.py); runtime/build.py builds it
// with g++ at first use. A failure (no file, a bad header, an index out
// of range) returns nullptr, which the caller raises on.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct MtxData {
  int64_t nrows = 0;
  int64_t ncols = 0;
  std::vector<int32_t> rows;
  std::vector<int32_t> cols;
  std::vector<float> vals;
};

// Advance past spaces/tabs (not newlines).
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* skip_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_f64(const char* p, const char* end, double* out,
                             bool* found) {
  p = skip_ws(p, end);
  *found = false;
  if (p >= end || *p == '\n') return p;
  char* q = nullptr;
  double v = strtod(p, &q);
  if (q == p) return p;
  *found = true;
  *out = v;
  return q;
}

}  // namespace

extern "C" {

// Returns an opaque handle (MtxData*) or nullptr on failure.
void* osp_mtx_read(const char* path, int expand_symmetric) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (size > 0 && fread(&buf[0], 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  const char* p = buf.data();
  const char* end = p + buf.size();

  bool symmetric = false;
  bool skew = false;
  bool pattern = false;
  if (buf.size() > 14 && strncmp(p, "%%MatrixMarket", 14) == 0) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    std::string header(p, line_end);
    for (auto& ch : header) ch = tolower(ch);
    bool skew_local = header.find("skew-symmetric") != std::string::npos;
    symmetric = skew_local || header.find("symmetric") != std::string::npos;
    skew = skew_local;
    pattern = header.find("pattern") != std::string::npos;
    p = skip_line(p, end);
  }
  // Skip comments.
  while (p < end) {
    const char* q = skip_ws(p, end);
    if (q < end && (*q == '%' || *q == '\n')) {
      p = skip_line(p, end);
    } else {
      p = q;
      break;
    }
  }
  int64_t nrow = 0, ncol = 0, nnz = 0;
  p = parse_i64(p, end, &nrow);
  p = parse_i64(p, end, &ncol);
  p = parse_i64(p, end, &nnz);
  p = skip_line(p, end);
  if (nrow <= 0 || ncol <= 0 || nnz < 0) return nullptr;

  auto* m = new MtxData();
  m->nrows = nrow;
  m->ncols = ncol;
  m->rows.reserve(symmetric && expand_symmetric ? nnz * 2 : nnz);
  m->cols.reserve(m->rows.capacity());
  m->vals.reserve(m->rows.capacity());

  for (int64_t i = 0; i < nnz && p < end; ++i) {
    // Skip stray comment/blank lines inside the body.
    while (p < end) {
      const char* q = skip_ws(p, end);
      if (q < end && (*q == '%' || *q == '\n')) p = skip_line(p, end);
      else { p = q; break; }
    }
    if (p >= end) break;
    int64_t r = 0, c = 0;
    p = parse_i64(p, end, &r);
    p = parse_i64(p, end, &c);
    double v = 1.0;
    bool found = false;
    if (!pattern) p = parse_f64(p, end, &v, &found);
    if (pattern || !found) v = 1.0;
    p = skip_line(p, end);
    if (r < 1 || c < 1 || r > nrow || c > ncol) {
      delete m;
      return nullptr;
    }
    m->rows.push_back(static_cast<int32_t>(r - 1));
    m->cols.push_back(static_cast<int32_t>(c - 1));
    m->vals.push_back(static_cast<float>(v));
    if (symmetric && expand_symmetric && r != c) {
      m->rows.push_back(static_cast<int32_t>(c - 1));
      m->cols.push_back(static_cast<int32_t>(r - 1));
      m->vals.push_back(static_cast<float>(skew ? -v : v));
    }
  }
  return m;
}

int64_t osp_mtx_nrows(void* h) { return static_cast<MtxData*>(h)->nrows; }
int64_t osp_mtx_ncols(void* h) { return static_cast<MtxData*>(h)->ncols; }
int64_t osp_mtx_nnz(void* h) {
  return static_cast<int64_t>(static_cast<MtxData*>(h)->rows.size());
}

void osp_mtx_copy(void* h, int32_t* rows, int32_t* cols, float* vals) {
  auto* m = static_cast<MtxData*>(h);
  memcpy(rows, m->rows.data(), m->rows.size() * sizeof(int32_t));
  memcpy(cols, m->cols.data(), m->cols.size() * sizeof(int32_t));
  memcpy(vals, m->vals.data(), m->vals.size() * sizeof(float));
}

void osp_mtx_free(void* h) { delete static_cast<MtxData*>(h); }

}  // extern "C"
