// CPU reference SpGEMM, a copy of the JAX package's csrc/ref_spgemm.cpp:
// the outer-product algorithm as a plain C++ program, the host baseline
// the port is timed against.
//
// Multiply phase: for each outer index k, every element of column k of A
// scales row k of B into a partial-product row appended to its output
// row's list. Merge phase: per output row, sort by column and accumulate
// equal columns. Plain C ABI for ctypes (runtime/native.py); built with
// g++ at first use by runtime/build.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Elem {
  int32_t idx;
  float val;
};

struct RefResult {
  std::vector<int64_t> indptr;
  std::vector<int32_t> cols;
  std::vector<float> vals;
};

}  // namespace

extern "C" {

// A in CSC (indptr int64[k+1], rows int32[nnzA], vals float[nnzA]),
// B in CSR (indptr int64[k+1], cols int32[nnzB], vals float[nnzB]).
// Returns an opaque handle to the CSR result C (m x n).
void* osp_ref_spgemm(int64_t m, int64_t n, int64_t k,
                     const int64_t* a_indptr, const int32_t* a_rows,
                     const float* a_vals, const int64_t* b_indptr,
                     const int32_t* b_cols, const float* b_vals) {
  // Multiply phase: per-output-row lists of partial-product elements.
  std::vector<std::vector<Elem>> partial(m);
  for (int64_t kk = 0; kk < k; ++kk) {
    const int64_t a_lo = a_indptr[kk], a_hi = a_indptr[kk + 1];
    const int64_t b_lo = b_indptr[kk], b_hi = b_indptr[kk + 1];
    if (a_lo == a_hi || b_lo == b_hi) continue;
    for (int64_t e = a_lo; e < a_hi; ++e) {
      const int32_t r = a_rows[e];
      const float av = a_vals[e];
      auto& row = partial[r];
      const size_t base = row.size();
      row.resize(base + (b_hi - b_lo));
      for (int64_t j = b_lo; j < b_hi; ++j) {
        row[base + (j - b_lo)] = {b_cols[j], av * b_vals[j]};
      }
    }
  }
  // Merge phase: per row sort by column id + accumulate equal columns.
  auto* out = new RefResult();
  out->indptr.assign(m + 1, 0);
  size_t total = 0;
  for (int64_t r = 0; r < m; ++r) total += partial[r].size();
  out->cols.reserve(total / 2 + 16);
  out->vals.reserve(total / 2 + 16);
  for (int64_t r = 0; r < m; ++r) {
    auto& row = partial[r];
    std::sort(row.begin(), row.end(),
              [](const Elem& a, const Elem& b) { return a.idx < b.idx; });
    size_t row_start = out->cols.size();
    for (size_t i = 0; i < row.size(); ++i) {
      if (i > 0 && row[i].idx == row[i - 1].idx) {
        out->vals.back() += row[i].val;
      } else {
        out->cols.push_back(row[i].idx);
        out->vals.push_back(row[i].val);
      }
    }
    out->indptr[r + 1] = out->cols.size();
    (void)row_start;
    row.clear();
    row.shrink_to_fit();
  }
  return out;
}

int64_t osp_ref_nnz(void* h) {
  return static_cast<int64_t>(static_cast<RefResult*>(h)->cols.size());
}

void osp_ref_copy(void* h, int64_t* indptr, int32_t* cols, float* vals) {
  auto* r = static_cast<RefResult*>(h);
  memcpy(indptr, r->indptr.data(), r->indptr.size() * sizeof(int64_t));
  memcpy(cols, r->cols.data(), r->cols.size() * sizeof(int32_t));
  memcpy(vals, r->vals.data(), r->vals.size() * sizeof(float));
}

void osp_ref_free(void* h) { delete static_cast<RefResult*>(h); }

}  // extern "C"
