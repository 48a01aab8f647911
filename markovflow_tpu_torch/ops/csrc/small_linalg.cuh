// Small dense linear algebra for the Kalman scan kernels.
//
// Matrices are row-major in flat arrays whose sizes are compile-time
// constants, so once the loops unroll every array lives in registers.
// inv/det are the device counterparts of the closed forms and the one-level
// Schur reduction in markovflow_tpu/ops/pallas_scan.py (_inv, _det): adjugate
// formulas for d <= 3 and inv([[A, B], [C, D]]) with S = D - C A^-1 B for
// 4 <= d <= 6.  The reduction does not pivot, as on the TPU, so it loses
// accuracy when the leading block is near singular (ROADMAP.md, queue 3).
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

// copy the [ROWS x COLS] block at (r0, c0) of a [D x D] matrix
template <typename T, int D, int ROWS, int COLS>
MF_DEV void block(const T* m, int r0, int c0, T* out) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) out[i * COLS + j] = m[(r0 + i) * D + c0 + j];
  }
}

template <typename T, int D>
MF_DEV void inv(const T* m, T* out) {
  static_assert(D >= 1 && D <= 6, "closed forms cover d <= 6");
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
    constexpr int K = D / 2, L = D - K;
    T a[K * K], b[K * L], c[L * K], s[L * L];
    block<T, D, K, K>(m, 0, 0, a);
    block<T, D, K, L>(m, 0, K, b);
    block<T, D, L, K>(m, K, 0, c);
    block<T, D, L, L>(m, K, K, s);
    T ai[K * K], aib[K * L], cab[L * L], si[L * L], cai[L * K], sicai[L * K];
    inv<T, K>(a, ai);
    mm<T, K, K, L>(ai, b, aib);
    mm<T, L, K, L>(c, aib, cab);
#pragma unroll
    for (int i = 0; i < L * L; ++i) s[i] -= cab[i];
    inv<T, L>(s, si);
    mm<T, L, K, K>(c, ai, cai);
    mm<T, L, L, K>(si, cai, sicai);
    T tl[K * K], tr[K * L];
    mm<T, K, L, K>(aib, sicai, tl);
    mm<T, K, L, L>(aib, si, tr);
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) out[i * D + j] = ai[i * K + j] + tl[i * K + j];
#pragma unroll
      for (int j = 0; j < L; ++j) out[i * D + K + j] = -tr[i * L + j];
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) out[(K + i) * D + j] = -sicai[i * K + j];
#pragma unroll
      for (int j = 0; j < L; ++j) out[(K + i) * D + K + j] = si[i * L + j];
    }
  }
}

template <typename T, int D>
MF_DEV T det(const T* m) {
  static_assert(D >= 1 && D <= 6, "closed forms cover d <= 6");
  if constexpr (D == 1) {
    return m[0];
  } else if constexpr (D == 2) {
    return m[0] * m[3] - m[1] * m[2];
  } else if constexpr (D == 3) {
    return m[0] * cof(m, 1, 1, 2, 2) - m[1] * cof(m, 1, 0, 2, 2) +
           m[2] * cof(m, 1, 0, 2, 1);
  } else {
    // det = det(A) det(D - C A^-1 B)
    constexpr int K = D / 2, L = D - K;
    T a[K * K], b[K * L], c[L * K], s[L * L];
    block<T, D, K, K>(m, 0, 0, a);
    block<T, D, K, L>(m, 0, K, b);
    block<T, D, L, K>(m, K, 0, c);
    block<T, D, L, L>(m, K, K, s);
    T ai[K * K], aib[K * L], cab[L * L];
    inv<T, K>(a, ai);
    mm<T, K, K, L>(ai, b, aib);
    mm<T, L, K, L>(c, aib, cab);
#pragma unroll
    for (int i = 0; i < L * L; ++i) s[i] -= cab[i];
    return det<T, K>(a) * det<T, L>(s);
  }
}

}  // namespace mf
