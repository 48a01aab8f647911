// Uniform-grid Kalman filter and RTS smoother kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of markovflow_tpu/ops/pallas_scan.py:
//   * filter:   pallas_filter_pipeline_uniform (_uniform_pipeline_kernel)
//   * smoother: pallas_smoother_pipeline_uniform (_uniform_smoother_kernel)
// They compute the same functions; the plain PyTorch versions are
// filter_pipeline_uniform_plain / smoother_pipeline_uniform_plain in
// markovflow_tpu_torch/ops/cuda_scan.py.  The passes (reduce, scan, fix up)
// are those of scan_core.cuh; this file supplies the element sources: the
// constant prior step (Fc, cc, Qc, Hc) of a batch row, with the prior
// (0, mu0, P0) at global step 0, and for the smoother the RTS element built
// from the filtered moments, with the boundary element at global step N-1.
//
// What bounds them on an H100: at d = 2, o = 1, float32 the filter reads
// about 12 B of sites per step twice and writes 24 B of moments, ~48 B a
// step in all (48 MB at N = 1e6, ~15 us at 3.35 TB/s), while it does some
// 500 flops a step in dependent chains with divisions (element build, two
// compositions, the likelihood).  So the bound is arithmetic latency, not
// bytes.  The design keeps every element in registers, does ~2 compositions
// per step (work-efficient sequential runs instead of a log-depth tree) and
// keeps the sites out of shared memory.  The smoother reads 24 B and writes
// 24 B a step with one d x d inverse per step: the same reasoning holds.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (N = 1e6,
// d = 2, float32, torch.profiler): filter_outputs 94 us, filter_totals
// 27 us, scan_totals 23 us; the outputs pass moves ~28 B a step for GPR
// (lam is one expanded value), an 8 us floor at 3.35 TB/s.
// ptxas (CUDA 12.8) gives filter_outputs 80 registers a thread at d = 2,
// float32, with 8 bytes spilled; the single-block scan of the ~500 block
// totals is serial.
#pragma once

#include "scan_core.cuh"
#include "wide_scan.cuh"

namespace mf {

// constants, [B, ...] contiguous: Fc [d, d], cc [d], Qc [d, d], mu0 [d],
// P0 [d, d], Hc [o, d]
template <typename T>
struct UniformPrior {
  const T *fc, *cc, *qc, *mu0, *p0, *hc;
};

template <typename T_, int D_, int O_>
struct UniformRow {
  using T = T_;
  static constexpr int D = D_, O = O_;
  static constexpr bool PREBUILT = false;
  using Prior = UniformPrior<T>;
  T f[D * D], c[D], q[D * D], m0[D], p0[D * D], h[O * D];

  MF_DEV void load(const Prior& a, int64_t b) {
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      f[i] = a.fc[b * D * D + i];
      q[i] = a.qc[b * D * D + i];
      p0[i] = a.p0[b * D * D + i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      c[i] = a.cc[b * D + i];
      m0[i] = a.mu0[b * D + i];
    }
#pragma unroll
    for (int i = 0; i < O * D; ++i) h[i] = a.hc[b * O * D + i];
  }

  // prior step and emission of global step k
  MF_DEV void step(const Prior&, int64_t, int64_t k, FilterStep<T, D, O>& s) const {
    const bool first = k == 0;
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      s.f[i] = first ? T(0) : f[i];
      s.q[i] = first ? p0[i] : q[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) s.c[i] = first ? m0[i] : c[i];
#pragma unroll
    for (int i = 0; i < O * D; ++i) s.h[i] = h[i];
  }

  // F_{k+1}, 0 at the last step (the Koopman backward's L_k)
  MF_DEV void next_f(const Prior&, int64_t, int64_t k, int64_t n, T* out) const {
#pragma unroll
    for (int i = 0; i < D * D; ++i) out[i] = k == n - 1 ? T(0) : f[i];
  }
};

// constants Fc, cc, Qc as UniformPrior; filtered moments, contiguous:
// m_f [B, d, 1, N], P_f [B, d, d, N]
template <typename T>
struct UniformRts {
  const T *fc, *cc, *qc, *m_f, *p_f;
};

template <typename T_, int D_>
struct UniformRtsRow {
  using T = T_;
  static constexpr int D = D_;
  using Prior = UniformRts<T>;
  T f[D * D], c[D], q[D * D];

  MF_DEV void load(const Prior& a, int64_t b) {
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      f[i] = a.fc[b * D * D + i];
      q[i] = a.qc[b * D * D + i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) c[i] = a.cc[b * D + i];
  }

  // RTS element of global step k (smoother_pipeline_tl /
  // _uniform_smoother_kernel): E = P_k F^T Pp^-1 with Pp = sym(F P_k F^T + Q),
  // g = m_k - E (F m_k + c), L = sym(P_k - E F P_k); the last step is the
  // boundary element (0, m_f[N-1], P_f[N-1]).
  MF_DEV void elem(const Prior& a, int64_t b, int64_t k, int64_t n,
                   SElem<T, D>& out) const {
    using E = SElem<T, D>;
    T mk[D], pk[D * D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      mk[i] = a.m_f[(b * D + i) * n + k];
#pragma unroll
      for (int j = 0; j < D; ++j) pk[i * D + j] = a.p_f[((b * D + i) * D + j) * n + k];
    }
    if (k == n - 1) {
#pragma unroll
      for (int i = 0; i < D * D; ++i) {
        out.v[E::OE + i] = T(0);
        out.v[E::OL + i] = pk[i];
      }
#pragma unroll
      for (int i = 0; i < D; ++i) out.v[E::OG + i] = mk[i];
      return;
    }
    T pft[D * D], pp[D * D], pinv[D * D];
    mm_nt<T, D, D, D>(pk, f, pft);  // P F^T
    mm<T, D, D, D>(f, pft, pp);
    add_to<T, D * D>(pp, q);
    sym<T, D>(pp);
    inv<T, D>(pp, pinv);
    T* gain = out.v + E::OE;
    mm<T, D, D, D>(pft, pinv, gain);
    T fm[D], gfm[D];
    mm<T, D, D, 1>(f, mk, fm);
    add_to<T, D>(fm, c);
    mm<T, D, D, 1>(gain, fm, gfm);
#pragma unroll
    for (int i = 0; i < D; ++i) out.v[E::OG + i] = mk[i] - gfm[i];
    T fp[D * D];
    mm<T, D, D, D>(f, pk, fp);
    mm<T, D, D, D>(gain, fp, pp);
#pragma unroll
    for (int i = 0; i < D * D; ++i) out.v[E::OL + i] = pk[i] - pp[i];
    sym<T, D>(out.v + E::OL);
  }
};

// The same two sources for d = 7..12 (wide_scan.cuh), all lanes together.
template <typename T_>
struct WideUniformRow {
  using T = T_;
  static constexpr bool PREBUILT = false;
  using Prior = UniformPrior<T>;

  // value v of step k's [F, Q, c, H]: the prior (0, P0, mu0) at k = 0
  static MF_DEV const T* src(const Prior& a, int64_t b, int v, int64_t k, int d) {
    const bool first = k == 0;
    const int dd = d * d;
    if (v < dd) return first ? nullptr : a.fc + (b * dd + v);
    if (v < 2 * dd) return (first ? a.p0 : a.qc) + (b * dd + v - dd);
    v -= 2 * dd;
    return v < d ? (first ? a.mu0 : a.cc) + (b * d + v) : a.hc + (b * d + v - d);
  }
};

// The RTS source of the d = 7..12 smoother passes: a step's filtered
// moments land in its slot where the element's g and L legs go, and build
// turns them into the element in place.
template <typename T_>
struct WideUniformRtsRow {
  using T = T_;
  using Prior = UniformRts<T>;
  // Pass 1 builds the elements and keeps them for pass 3, which reads them
  // back rather than building them again (PERF.md: store or recompute).
  static constexpr bool BUILD = true;

  static __host__ __device__ int consts(int d) { return 2 * d * d + d; }

  // Fc, Qc, cc of batch row b, once a warp
  static MF_DEV void load(const Prior& a, int64_t b, T* cst, int d) {
    const int dd = d * d;
    for (int e = lane_id(); e < dd; e += 32) {
      cst[e] = a.fc[b * dd + e];
      cst[dd + e] = a.qc[b * dd + e];
    }
    for (int e = lane_id(); e < d; e += 32) cst[2 * dd + e] = a.cc[b * d + e];
    __syncwarp();
  }

  static MF_DEV int offset(int d) { return d * d; }

  // [m_f, P_f]
  static MF_DEV WideRows<const T*> rows(const Prior& a, int d) {
    return {{a.m_f, a.p_f}, {d, d * d}};
  }

  // UniformRtsRow::elem over the slot st = [E, m, P]: the gain from the
  // pivoted solve Pp G^T = F P (winv's pivoting, d right-hand sides), as
  // E = G = P F^T Pp^-1; F P formed once, P F^T read as its transpose.
  static MF_DEV void build(const T* cst, T* st, int64_t k, int64_t n, WideTemps<T>& w,
                           int d) {
    const int dd = d * d, OG = dd, OL = dd + d;
    if (k == n - 1) {  // the boundary element (0, m_f, P_f)
      for (int e = lane_id(); e < dd; e += 32) st[e] = T(0);
      __syncwarp();
      return;
    }
    const T *f = cst, *q = cst + dd, *c = cst + 2 * dd;
    T *fp = w.m[0], *pp = w.m[1], *fm = w.v[0];
    WProd<T> p1[] = {wnn(f, st + OL, fp, d), wnv(f, st + OG, fm, d, c)};  // F P, F m + c
    wprods(p1);
    WProd<T> p2[] = {wsym_nt(fp, f, pp, d, q)};  // Pp = sym(F P F^T + Q)
    wprods(p2);
    wsolve<T, true>(pp, fp, nullptr, st, nullptr, d);
    // L = sym(P - E F P), g = m - E (F m + c)
    WProd<T> p3[] = {wnn(st, fp, st + OL, d, st + OL), wnv(st, fm, st + OG, d, st + OG)};
    p3[0].alpha = p3[1].alpha = T(-1);
    p3[0].sym = true;
    wprods(p3);
  }
};

}  // namespace mf

// C entry points for one dtype (T, suffix).  The state dimension is a
// runtime argument dispatched to the compile-time instantiations d = 1..6,
// or to the runtime-d kernels for d = 7..12; the output dimension is 1.
// Sizes are int64; every pointer, and the stream, is passed as an address;
// strides come as a host array of int64.
#define MF_DEFINE_UNIFORM_ENTRY_POINTS(T, SUFFIX)                                      \
  extern "C" int mf_uniform_filter_##SUFFIX(                                           \
      const T* fc, const T* cc, const T* qc, const T* mu0, const T* p0, const T* hc,   \
      const T* nu, const T* lam, const T* mask, const int64_t* site_strides, T* m_f,   \
      T* p_f, T* loglik, T* scratch, int64_t batch, int64_t n, int64_t d,              \
      void* stream) {                                                                  \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::UniformPrior<T> p{fc, cc, qc, mu0, p0, hc};                                    \
    mf::FilterArgs<T> a{};                                                             \
    a.nu = nu; a.lam = lam; a.mask = mask;                                             \
    mf::set_site_strides(a, site_strides);                                             \
    a.m_f = m_f; a.p_f = p_f; a.loglik = loglik; a.n = n;                              \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_filter<mf::WideUniformRow<T>>(a, p, scratch, batch, int(d), \
                                                           s);                         \
    MF_SWITCH_D(d, (mf::launch_filter<mf::UniformRow<T, D_, 1>>(a, p, scratch, batch,  \
                                                                s)),                   \
                int(cudaErrorInvalidValue))                                            \
  }                                                                                    \
  extern "C" int mf_uniform_smoother_##SUFFIX(                                         \
      const T* fc, const T* cc, const T* qc, const T* m_f, const T* p_f, T* m_s,       \
      T* p_s, T* scratch, int64_t batch, int64_t n, int64_t d, void* stream) {         \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::UniformRts<T> p{fc, cc, qc, m_f, p_f};                                         \
    mf::SmootherArgs<T> a{m_s, p_s, nullptr, n, 0};                                    \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_smoother<mf::WideUniformRtsRow<T>>(a, p, scratch, batch,  \
                                                                int(d), s);            \
    MF_SWITCH_D(d, (mf::launch_smoother<mf::UniformRtsRow<T, D_>>(a, p, scratch,       \
                                                                  batch, s)),          \
                int(cudaErrorInvalidValue))                                            \
  }
