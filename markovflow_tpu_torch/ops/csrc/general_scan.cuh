// General-grid Kalman filter, smoother-scan and filter-scan kernels for
// Hopper (sm_90a).
//
// Replace the TPU kernels of markovflow_tpu/ops/pallas_scan.py:
//   * filter:        pallas_filter_pipeline (_pipeline_kernel)
//   * smoother scan: pallas_smoother_scan (_smoother_kernel)
//   * filter scan:   pallas_filter_scan (_filter_kernel)
// The plain PyTorch versions are filter_pipeline_plain / smoother_scan_plain
// / filter_scan_plain in markovflow_tpu_torch/ops/cuda_scan.py.  The passes
// are those of scan_core.cuh.  The filter reads per-step (F, c, Q, H) through
// their strides (F_0 = 0 is the prior row; for GPR, H is a stride-0
// expansion of one row), so one kernel serves any time grid.  The smoother
// scan composes prebuilt (E, g, L) elements: the RTS elements of the general
// smoother.  The filter scan composes prebuilt (A, b, C, J, eta) elements
// (the ops filter API, ops.kalman.parallel_filter) with the filter's passes,
// without sites or log-likelihood, and writes the b and C legs.  It moves
// 3 d^2 + 2 d values a step in and d^2 + d out (88 B at d = 2, float32) and
// does one composition a step with a d x d inverse, so it is bound as the
// general filter is.
//
// What bounds them on an H100: the filter does the uniform filter's
// arithmetic (~500 dependent flops a step at d = 2) and reads the prior
// steps besides the sites, 2 d^2 + d values a step (40 B at d = 2, float32)
// twice, so it stays latency-bound with ~2x the uniform filter's bytes.  The
// smoother scan reads 2 d^2 + d values a step twice and writes d^2 + d, with
// one composition per step and no inverse: at d = 2, float32, ~104 B a step,
// 31 us at 3.35 TB/s for N = 1e6, close to its arithmetic.  The TPU kernels
// take d <= 12: d = 1..6 are instantiated here, with every element in
// registers; d = 7..12 (an FElem at d = 12 has 456 values) run through the
// warp-per-element kernels of wide_scan.cuh with the Wide*Row sources below.
#pragma once

#include "scan_core.cuh"
#include "wide_scan.cuh"

namespace mf {

// per-step prior and emission, any strides: F [B, d, d, N], c [B, d, 1, N],
// Q [B, d, d, N], H [B, o, d, N]
template <typename T>
struct GeneralPrior {
  const T *f, *c, *q, *h;
  int64_t f_sb, f_si, f_sj, f_st;
  int64_t c_sb, c_si, c_st;
  int64_t q_sb, q_si, q_sj, q_st;
  int64_t h_sb, h_si, h_sj, h_st;
};

template <typename T_, int D_, int O_>
struct GeneralRow {
  using T = T_;
  static constexpr int D = D_, O = O_;
  static constexpr bool PREBUILT = false;
  using Prior = GeneralPrior<T>;

  MF_DEV void load(const Prior&, int64_t) {}

  MF_DEV void step(const Prior& a, int64_t b, int64_t k, FilterStep<T, D, O>& s) const {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        s.f[i * D + j] = a.f[b * a.f_sb + i * a.f_si + j * a.f_sj + k * a.f_st];
        s.q[i * D + j] = a.q[b * a.q_sb + i * a.q_si + j * a.q_sj + k * a.q_st];
      }
      s.c[i] = a.c[b * a.c_sb + i * a.c_si + k * a.c_st];
    }
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        s.h[i * D + j] = a.h[b * a.h_sb + i * a.h_si + j * a.h_sj + k * a.h_st];
    }
  }

  // F_{k+1}, 0 at the last step (the Koopman backward's L_k)
  MF_DEV void next_f(const Prior& a, int64_t b, int64_t k, int64_t n, T* out) const {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        out[i * D + j] = k == n - 1
                             ? T(0)
                             : a.f[b * a.f_sb + i * a.f_si + j * a.f_sj + (k + 1) * a.f_st];
    }
  }
};

// prebuilt filtering elements, contiguous: A, C, J [B, d, d, N],
// b, eta [B, d, 1, N]
template <typename T>
struct FilterPrebuilt {
  const T *a, *b, *c, *j, *e;
};

template <typename T_, int D_>
struct FilterPrebuiltRow {
  using T = T_;
  static constexpr int D = D_, O = 1;
  static constexpr bool PREBUILT = true;
  using Prior = FilterPrebuilt<T>;

  MF_DEV void load(const Prior&, int64_t) {}

  MF_DEV void elem(const Prior& a, int64_t b, int64_t k, int64_t n,
                   FElem<T, D>& out) const {
    using E = FElem<T, D>;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      out.v[E::OB + i] = a.b[(b * D + i) * n + k];
      out.v[E::OE + i] = a.e[(b * D + i) * n + k];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int64_t at = ((b * D + i) * D + j) * n + k;
        out.v[E::OA + i * D + j] = a.a[at];
        out.v[E::OC + i * D + j] = a.c[at];
        out.v[E::OJ + i * D + j] = a.j[at];
      }
    }
  }
};

// prebuilt smoothing elements: Prebuilt (wide_scan.cuh)
template <typename T_, int D_>
struct PrebuiltRow {
  using T = T_;
  static constexpr int D = D_;
  using Prior = Prebuilt<T>;

  MF_DEV void load(const Prior&, int64_t) {}

  MF_DEV void elem(const Prior& a, int64_t b, int64_t k, int64_t n,
                   SElem<T, D>& out) const {
    using E = SElem<T, D>;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      out.v[E::OG + i] = a.g[(b * D + i) * n + k];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        out.v[E::OE + i * D + j] = a.e[((b * D + i) * D + j) * n + k];
        out.v[E::OL + i * D + j] = a.l[((b * D + i) * D + j) * n + k];
      }
    }
  }
};

// The same three sources for d = 7..12 (wide_scan.cuh), all lanes together.
template <typename T_>
struct WideGeneralRow {
  using T = T_;
  static constexpr bool PREBUILT = false;
  using Prior = GeneralPrior<T>;

  // value v of step k's [F, Q, c, H]
  static MF_DEV const T* src(const Prior& a, int64_t b, int v, int64_t k, int d) {
    const int dd = d * d;
    if (v < 2 * dd) {
      const int e = v < dd ? v : v - dd, i = e / d, j = e - i * d;
      return v < dd ? a.f + (b * a.f_sb + i * a.f_si + j * a.f_sj + k * a.f_st)
                    : a.q + (b * a.q_sb + i * a.q_si + j * a.q_sj + k * a.q_st);
    }
    v -= 2 * dd;
    return v < d ? a.c + (b * a.c_sb + v * a.c_si + k * a.c_st)
                 : a.h + (b * a.h_sb + (v - d) * a.h_sj + k * a.h_st);
  }
};

template <typename T_>
struct WidePrebuiltRow : WideReadRow<T_> {
  using Prior = Prebuilt<T_>;

  static MF_DEV WideRows<const T_*> rows(const Prior& a, int d) {
    return wide_element_rows(a, d);
  }
};

template <typename T_>
struct WideFilterPrebuiltRow {
  using T = T_;
  static constexpr bool PREBUILT = true;
  using Prior = FilterPrebuilt<T>;

  // the element [A, b, C, J, eta]
  static MF_DEV WideRows<const T*> rows(const Prior& a, int d) {
    const int dd = d * d;
    return {{a.a, a.b, a.c, a.j, a.e}, {dd, d, dd, dd, d}};
  }
};

}  // namespace mf

// C entry points for one dtype (T, suffix), as in uniform_scan.cuh.  The
// filter's strides: F (batch, row, column, step), c (batch, row, step),
// Q and H as F, then the sites as set_site_strides takes them.
#define MF_DEFINE_GENERAL_ENTRY_POINTS(T, SUFFIX)                                      \
  extern "C" int mf_general_filter_##SUFFIX(                                           \
      const T* f, const T* c, const T* q, const T* h, const T* nu, const T* lam,       \
      const T* mask, const int64_t* st, T* m_f, T* p_f, T* loglik, T* scratch,         \
      int64_t batch, int64_t n, int64_t d, void* stream) {                             \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::GeneralPrior<T> p{f, c, q, h,                                                  \
                          st[0], st[1], st[2], st[3],                                  \
                          st[4], st[5], st[6],                                         \
                          st[7], st[8], st[9], st[10],                                 \
                          st[11], st[12], st[13], st[14]};                             \
    mf::FilterArgs<T> a{};                                                             \
    a.nu = nu; a.lam = lam; a.mask = mask;                                             \
    mf::set_site_strides(a, st + 15);                                                  \
    a.m_f = m_f; a.p_f = p_f; a.loglik = loglik; a.n = n;                              \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_filter<mf::WideGeneralRow<T>>(a, p, scratch, batch, int(d), \
                                                           s);                         \
    MF_SWITCH_D(d, (mf::launch_filter<mf::GeneralRow<T, D_, 1>>(a, p, scratch, batch,  \
                                                                s)),                   \
                int(cudaErrorInvalidValue))                                            \
  }                                                                                    \
  extern "C" int mf_smoother_scan_##SUFFIX(                                            \
      const T* e, const T* g, const T* l, T* m_s, T* p_s, T* scratch, int64_t batch,   \
      int64_t n, int64_t d, void* stream) {                                            \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::Prebuilt<T> p{e, g, l};                                                        \
    mf::SmootherArgs<T> a{m_s, p_s, nullptr, n, 0};                                    \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_smoother<mf::WidePrebuiltRow<T>>(a, p, scratch, batch,    \
                                                              int(d), s);              \
    MF_SWITCH_D(d, (mf::launch_smoother<mf::PrebuiltRow<T, D_>>(a, p, scratch, batch,  \
                                                                s)),                   \
                int(cudaErrorInvalidValue))                                            \
  }                                                                                    \
  extern "C" int mf_filter_scan_##SUFFIX(                                              \
      const T* fa, const T* fb, const T* fc, const T* fj, const T* fe, T* m_f, T* p_f, \
      T* scratch, int64_t batch, int64_t n, int64_t d, void* stream) {                 \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::FilterPrebuilt<T> p{fa, fb, fc, fj, fe};                                       \
    mf::FilterArgs<T> a{};                                                             \
    a.m_f = m_f; a.p_f = p_f; a.n = n;                                                 \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_filter<mf::WideFilterPrebuiltRow<T>>(a, p, scratch, batch,  \
                                                                  int(d), s);          \
    MF_SWITCH_D(d, (mf::launch_filter<mf::FilterPrebuiltRow<T, D_>>(a, p, scratch,     \
                                                                    batch, s)),        \
                int(cudaErrorInvalidValue))                                            \
  }
