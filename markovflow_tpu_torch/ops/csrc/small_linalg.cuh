// Small dense linear algebra for the Kalman scan kernels.
//
// Matrices are row-major in flat arrays whose sizes are compile-time
// constants, so once the loops unroll every array lives in registers.
// inv uses the closed forms of markovflow_tpu/ops/pallas_scan.py (_inv) for
// d <= 3.  For 4 <= d <= 6 it uses Gauss-Jordan elimination with
// partial pivoting, where the TPU kernels use one unpivoted Schur-complement
// level, which loses accuracy when the leading block is near singular (the
// filter composition inverts I + C J, which is not symmetric).  The plain
// PyTorch version is _gauss_jordan_tl in markovflow_tpu_torch/ops/kalman.py.
// The kernels for 7 <= d <= 12 invert with the same pivoting, a warp per
// matrix (winv in wide_scan.cuh).  The general filter at o > 1 solves its
// o x o systems, which need not be symmetric, and takes their determinants
// with the same elimination (gauss_jordan_solve).  No output argument may
// alias an input.
#pragma once

#include <cuda_runtime.h>

#define MF_DEV __device__ __forceinline__

namespace mf {

// out [R x C] = a [R x K] @ b [K x C]
template <typename T, int R, int K, int C>
MF_DEV void mm(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      T acc = a[i * K] * b[k];
#pragma unroll
      for (int j = 1; j < K; ++j) acc += a[i * K + j] * b[j * C + k];
      out[i * C + k] = acc;
    }
  }
}

// out [R x C] = a @ b^T with a [R x K], b [C x K]
template <typename T, int R, int K, int C>
MF_DEV void mm_nt(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      T acc = a[i * K] * b[k * K];
#pragma unroll
      for (int j = 1; j < K; ++j) acc += a[i * K + j] * b[k * K + j];
      out[i * C + k] = acc;
    }
  }
}

// out [R x C] = a^T @ b with a [K x R], b [K x C]
template <typename T, int R, int K, int C>
MF_DEV void mm_tn(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      T acc = a[i] * b[k];
#pragma unroll
      for (int j = 1; j < K; ++j) acc += a[j * R + i] * b[j * C + k];
      out[i * C + k] = acc;
    }
  }
}

// a += b over n entries
template <typename T, int N>
MF_DEV void add_to(T* a, const T* b) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] += b[i];
}

// a = (a + a^T) / 2 in place, a [N x N]
template <typename T, int N>
MF_DEV void sym(T* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const T s = T(0.5) * (a[i * N + j] + a[j * N + i]);
      a[i * N + j] = s;
      a[j * N + i] = s;
    }
  }
}

// a += I, a [N x N]
template <typename T, int N>
MF_DEV void add_eye(T* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i * N + i] += T(1);
}

template <typename T, int N>
MF_DEV void set_eye(T* a) {
#pragma unroll
  for (int i = 0; i < N * N; ++i) a[i] = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) a[i * N + i] = T(1);
}

template <typename T>
MF_DEV T cof(const T* m, int i1, int j1, int i2, int j2) {
  return m[i1 * 3 + j1] * m[i2 * 3 + j2] - m[i1 * 3 + j2] * m[i2 * 3 + j1];
}

// Gauss-Jordan elimination on [m | rhs], m [N x N], rhs [N x K], with
// partial pivoting, unrolled so that the augmented matrix stays in
// registers.  The pivot search swaps row j with each later row whose entry
// in column j is larger in magnitude, by selects (no indexing by a runtime
// row); any row order gives the same solution.  Columns left of j are zero
// in the rows it touches, so each step works on columns j.. only.  Writes
// m^-1 rhs to out (K = 0: neither is read) and returns the product of the
// pivots, det(m) up to its sign.
template <typename T, int N, int K>
MF_DEV T gauss_jordan_solve(const T* m, const T* rhs, T* out) {
  T a[N][N + K];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = m[i * N + j];
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][N + j] = rhs[i * K + j];
  }
  T det = T(1);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      const bool s = fabs(a[i][j]) > fabs(a[j][j]);
#pragma unroll
      for (int c = j; c < N + K; ++c) {
        const T x = a[j][c], y = a[i][c];
        a[j][c] = s ? y : x;
        a[i][c] = s ? x : y;
      }
    }
    det *= a[j][j];
    const T r = T(1) / a[j][j];
#pragma unroll
    for (int c = j; c < N + K; ++c) a[j][c] *= r;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == j) continue;
      const T f = a[i][j];
#pragma unroll
      for (int c = j; c < N + K; ++c) a[i][c] -= f * a[j][c];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) out[i * K + j] = a[i][N + j];
  }
  return det;
}

// The inverse of m by gauss_jordan_solve on [m | I].
template <typename T, int D>
MF_DEV void gauss_jordan(const T* m, T* out) {
  T eye[D * D];
  set_eye<T, D>(eye);
  gauss_jordan_solve<T, D, D>(m, eye, out);
}

template <typename T, int D>
MF_DEV void inv(const T* m, T* out) {
  static_assert(D >= 1 && D <= 6, "instantiated for d <= 6");
  if constexpr (D == 1) {
    out[0] = T(1) / m[0];
  } else if constexpr (D == 2) {
    const T det = m[0] * m[3] - m[1] * m[2];
    out[0] = m[3] / det;
    out[1] = -m[1] / det;
    out[2] = -m[2] / det;
    out[3] = m[0] / det;
  } else if constexpr (D == 3) {
    const T c00 = cof(m, 1, 1, 2, 2), c10 = cof(m, 1, 0, 2, 2),
            c20 = cof(m, 1, 0, 2, 1);
    const T det = m[0] * c00 - m[1] * c10 + m[2] * c20;
    out[0] = c00 / det;
    out[1] = -cof(m, 0, 1, 2, 2) / det;
    out[2] = cof(m, 0, 1, 1, 2) / det;
    out[3] = -c10 / det;
    out[4] = cof(m, 0, 0, 2, 2) / det;
    out[5] = -cof(m, 0, 0, 1, 2) / det;
    out[6] = c20 / det;
    out[7] = -cof(m, 0, 0, 2, 1) / det;
    out[8] = cof(m, 0, 0, 1, 1) / det;
  } else {
    gauss_jordan<T, D>(m, out);
  }
}

}  // namespace mf
