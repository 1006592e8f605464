// Native setup kernels for agglomerationmultigrid1d.
//
// The hierarchy setup runs on the host (see utils/host.py); its hot spots are
// batched tiny-matrix factorizations and block products over millions of
// elements, where NumPy's per-matrix LAPACK gufunc loop pays ~1 us of dispatch
// per 4x4 block.  These C-ABI kernels do the same math in tight loops; the
// Python side (ops/native.py) loads them via ctypes with a NumPy fallback.
//
// All matrices are row-major with batch leading: blocks[k*bs*bs + i*bs + j].

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// In-place Gauss-Jordan inverse with partial pivoting for every block.
// Returns the number of singular blocks encountered (0 on success).
int64_t aggmg_batched_inv(double* blocks, int64_t n, int64_t bs) {
  const int64_t bb = bs * bs;
  std::vector<double> a(bb);
  std::vector<double> inv(bb);
  int64_t failures = 0;

  for (int64_t k = 0; k < n; ++k) {
    double* blk = blocks + k * bb;
    std::memcpy(a.data(), blk, bb * sizeof(double));
    // identity
    std::memset(inv.data(), 0, bb * sizeof(double));
    for (int64_t i = 0; i < bs; ++i) inv[i * bs + i] = 1.0;

    bool ok = true;
    for (int64_t col = 0; col < bs; ++col) {
      // partial pivot
      int64_t piv = col;
      double best = std::fabs(a[col * bs + col]);
      for (int64_t r = col + 1; r < bs; ++r) {
        double v = std::fabs(a[r * bs + col]);
        if (v > best) { best = v; piv = r; }
      }
      if (best == 0.0) { ok = false; break; }
      if (piv != col) {
        for (int64_t j = 0; j < bs; ++j) {
          std::swap(a[col * bs + j], a[piv * bs + j]);
          std::swap(inv[col * bs + j], inv[piv * bs + j]);
        }
      }
      const double d = 1.0 / a[col * bs + col];
      for (int64_t j = 0; j < bs; ++j) {
        a[col * bs + j] *= d;
        inv[col * bs + j] *= d;
      }
      for (int64_t r = 0; r < bs; ++r) {
        if (r == col) continue;
        const double f = a[r * bs + col];
        if (f == 0.0) continue;
        for (int64_t j = 0; j < bs; ++j) {
          a[r * bs + j] -= f * a[col * bs + j];
          inv[r * bs + j] -= f * inv[col * bs + j];
        }
      }
    }
    if (!ok) { ++failures; continue; }
    std::memcpy(blk, inv.data(), bb * sizeof(double));
  }
  return failures;
}

// out[k] = a[k] @ b[k]  for (n, bs, bs) batches.
void aggmg_batched_matmul(const double* a, const double* b, double* out,
                          int64_t n, int64_t bs) {
  const int64_t bb = bs * bs;
  for (int64_t k = 0; k < n; ++k) {
    const double* ak = a + k * bb;
    const double* bk = b + k * bb;
    double* ok_ = out + k * bb;
    for (int64_t i = 0; i < bs; ++i) {
      for (int64_t j = 0; j < bs; ++j) {
        double acc = 0.0;
        for (int64_t l = 0; l < bs; ++l) acc += ak[i * bs + l] * bk[l * bs + j];
        ok_[i * bs + j] = acc;
      }
    }
  }
}

// Block-tridiagonal product C = A @ B where A has (lower, diag, upper) and B
// likewise, assuming the distance-2 products vanish (see ops/block_tridiag.py).
// Layout here is batch-leading (n, bs, bs) per diagonal.
void aggmg_bt_mul_bt(const double* al, const double* ad, const double* au,
                     const double* bl, const double* bd, const double* bu,
                     double* cl, double* cd, double* cu,
                     int64_t n, int64_t bs) {
  const int64_t bb = bs * bs;
  std::vector<double> tmp(bb);
  auto mm_acc = [bs](const double* x, const double* y, double* out) {
    for (int64_t i = 0; i < bs; ++i)
      for (int64_t j = 0; j < bs; ++j) {
        double acc = 0.0;
        for (int64_t l = 0; l < bs; ++l) acc += x[i * bs + l] * y[l * bs + j];
        out[i * bs + j] += acc;
      }
  };
  std::memset(cl, 0, n * bb * sizeof(double));
  std::memset(cd, 0, n * bb * sizeof(double));
  std::memset(cu, 0, n * bb * sizeof(double));
  for (int64_t k = 0; k < n; ++k) {
    // C_d[k] = A_l[k] B_u[k-1] + A_d[k] B_d[k] + A_u[k] B_l[k+1]
    if (k > 0) mm_acc(al + k * bb, bu + (k - 1) * bb, cd + k * bb);
    mm_acc(ad + k * bb, bd + k * bb, cd + k * bb);
    if (k + 1 < n) mm_acc(au + k * bb, bl + (k + 1) * bb, cd + k * bb);
    // C_l[k] = A_l[k] B_d[k-1] + A_d[k] B_l[k]
    if (k > 0) {
      mm_acc(al + k * bb, bd + (k - 1) * bb, cl + k * bb);
      mm_acc(ad + k * bb, bl + k * bb, cl + k * bb);
    }
    // C_u[k] = A_d[k] B_u[k] + A_u[k] B_d[k+1]
    if (k + 1 < n) {
      mm_acc(ad + k * bb, bu + k * bb, cu + k * bb);
      mm_acc(au + k * bb, bd + (k + 1) * bb, cu + k * bb);
    }
  }
}

}  // extern "C"
