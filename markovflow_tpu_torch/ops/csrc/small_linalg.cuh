// Small dense linear algebra for the Kalman scan kernels.
//
// Matrices are row-major in flat arrays whose sizes are compile-time
// constants, so once the loops unroll every array lives in registers.
// inv/det use the closed forms of markovflow_tpu/ops/pallas_scan.py (_inv,
// _det) for d <= 3.  For 4 <= d <= 6 they use Gauss-Jordan elimination with
// partial pivoting, where the TPU kernels use one unpivoted Schur-complement
// level, which loses accuracy when the leading block is near singular (the
// filter composition inverts I + C J, which is not symmetric).  The plain
// PyTorch version is _gauss_jordan_tl in markovflow_tpu_torch/ops/kalman.py.
// The kernels for 7 <= d <= 12 invert with the same pivoting, a warp per
// matrix (winv in wide_scan.cuh); they need no determinant above o = 1.
// No output argument may alias an input.
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

// Gauss-Jordan elimination on [m | I] with partial pivoting, unrolled so
// that the augmented matrix stays in registers.  The pivot search swaps row
// j with each later row whose entry in column j is larger in magnitude, by
// selects (no indexing by a runtime row); any row order gives the same
// inverse.  Columns left of j are zero in the rows it touches, so each step
// works on columns j.. only.  Returns the determinant; writes the inverse
// to out when INV.
template <typename T, int D, bool INV>
MF_DEV T gauss_jordan(const T* m, T* out) {
  T a[D][2 * D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      a[i][j] = m[i * D + j];
      a[i][D + j] = i == j ? T(1) : T(0);
    }
  }
  T det = T(1);
#pragma unroll
  for (int j = 0; j < D; ++j) {
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      const bool s = fabs(a[i][j]) > fabs(a[j][j]);
#pragma unroll
      for (int c = j; c < 2 * D; ++c) {
        const T x = a[j][c], y = a[i][c];
        a[j][c] = s ? y : x;
        a[i][c] = s ? x : y;
      }
      det = s ? -det : det;
    }
    const T p = a[j][j];
    det *= p;
    const T r = T(1) / p;
#pragma unroll
    for (int c = j; c < 2 * D; ++c) a[j][c] *= r;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (i == j) continue;
      const T f = a[i][j];
#pragma unroll
      for (int c = j; c < 2 * D; ++c) a[i][c] -= f * a[j][c];
    }
  }
  if constexpr (INV) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) out[i * D + j] = a[i][D + j];
    }
  }
  return det;
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
    gauss_jordan<T, D, true>(m, out);
  }
}

template <typename T, int D>
MF_DEV T det(const T* m) {
  static_assert(D >= 1 && D <= 6, "instantiated for d <= 6");
  if constexpr (D == 1) {
    return m[0];
  } else if constexpr (D == 2) {
    return m[0] * m[3] - m[1] * m[2];
  } else if constexpr (D == 3) {
    return m[0] * cof(m, 1, 1, 2, 2) - m[1] * cof(m, 1, 0, 2, 2) +
           m[2] * cof(m, 1, 0, 2, 1);
  } else {
    return gauss_jordan<T, D, false>(m, nullptr);
  }
}

}  // namespace mf
