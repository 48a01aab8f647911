// Uniform-grid Kalman filter and RTS smoother kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of markovflow_tpu/ops/pallas_scan.py:
//   * filter:   pallas_filter_pipeline_uniform (_uniform_pipeline_kernel)
//   * smoother: pallas_smoother_pipeline_uniform (_uniform_smoother_kernel)
// They compute the same functions; the plain PyTorch versions are
// filter_pipeline_uniform_plain / smoother_pipeline_uniform_plain in
// markovflow_tpu_torch/ops/cuda_scan.py.  At d <= 6 the filter runs the
// staged filter passes of general_scan.cuh with the step source
// UniformSteps (below): the constant prior step (Fc, cc, Qc, Hc) of a batch
// row in registers, with the prior (0, mu0, P0) at global step 0, and the
// sites staged through shared memory; the smoother runs the RTS smoother
// passes of general_scan.cuh with the step source UniformRtsRow (below):
// the RTS element built in registers from the filtered moments (staged the
// same way in pass 3) and the boundary element at global step N-1.  At
// o x o sites (o = 2..d, d <= 6) the filter's source is UniformStepsO, which
// builds each step's element and composes it as kernel 4 does at o > 1.
//
// What bounds them on an H100: at d = 2, o = 1, float32 the filter reads
// one site value a step (nu; GPR's lam is one expanded value) in each of
// passes 1 and 3 and writes 24 B of moments, ~32 B a step in all (32 MB at
// N = 1e6, ~10 us at 3.35 TB/s), plus the stored in-block prefix of every
// thread (16 values a thread, 8 MB written and read).  Per step it does a
// rank-one fold in pass 1 and a Kalman predict/update in pass 3 (two or
// three d^3 products, no inverse) in dependent chains.  Before its own
// passes the filter's reads and writes of a warp fell on 32 sectors each
// (a thread owns R consecutive steps); staging makes them whole rows.  The
// smoother reads (m_f, P_f) in each of passes 1 and 3 (24 B a step at
// d = 2, float32) and writes (m_s, P_s) in pass 3 (24 B), ~72 B a step in
// all, plus the stored in-block suffix (10 values a thread): ~24 us at
// 3.35 TB/s for N = 1e6.  Per step it builds the RTS element in both passes
// (one d x d inverse, five d^3 products) and composes it in full in pass 1
// (three d^3 products) and on the moments only in pass 3 (two); the
// staged, moments-only pass 3 replaces one that rebuilt the in-block suffix
// and wrote each step where it lies (PERF.md has the times).
#pragma once

#include "general_scan.cuh"

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

  // The inputs of lane l's step r, global step k (GeneralIn): the constant
  // prior step, (0, P0, mu0) at step 0; nu, lam and the mask from the warp's
  // stage where sl has a slot for them, else read once (once: the thread's
  // first step read).  A: FilterArgs or AdjointPrior (the site fields).
  template <int R, class A>
  MF_DEV void read_step(GeneralIn<T, D>& in, const WarpStage<T, R>& st, const GeneralSlots& sl,
                        int l, int r, const A& a, int64_t b, int64_t k, bool once) const {
    static_assert(O == 1, "one output");
    const bool first = r == 0 && k == 0;  // global step 0 is a thread's first
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      in.f[i] = first ? T(0) : f[i];
      in.q[i] = first ? p0[i] : q[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      in.c[i] = first ? m0[i] : c[i];
      in.h[i] = h[i];
    }
    if (once && sl.nu < 0) in.s.nu = a.nu[b * a.nu_sb + k * a.nu_st];
    if (once && sl.lam < 0) in.s.lam = a.lam[b * a.lam_sb + k * a.lam_st];
    if (sl.nu >= 0) in.s.nu = *st.at(sl.nu, l, r);
    if (sl.lam >= 0) in.s.lam = *st.at(sl.lam, l, r);
    in.s.keep = sl.mask < 0 || *st.at(sl.mask, l, r) > T(0.5);
  }

  // The same at o x o sites (GeneralInO): the constants as above and Hc;
  // when STAGED, nu, lam and the mask from the stage where sl has slots
  // for them and what has none read once, once; else each from step k
  // (only once, once, where its step stride is 0).
  template <bool STAGED, int R, class A>
  MF_DEV void read_step(GeneralInO<T, D, O>& in, const WarpStage<T, R>& st,
                        const GeneralSlots& sl, int l, int r, const A& a, int64_t b, int64_t k,
                        bool once) const {
    const bool first = r == 0 && k == 0;  // global step 0 is a thread's first
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      in.f[i] = first ? T(0) : f[i];
      in.q[i] = first ? p0[i] : q[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) in.c[i] = first ? m0[i] : c[i];
#pragma unroll
    for (int i = 0; i < O * D; ++i) in.h[i] = h[i];
    if constexpr (STAGED) in.read_staged_sites(st, sl, l, r, a, b, k, once);
    else in.read_site_values(a, b, k, once);
  }
};

// Kernel 1's step source of the filter passes (general_scan.cuh): the
// constants of batch row b in registers, loaded once a thread (UniformRow),
// with the prior (0, P0, mu0) at global step 0; nu, lam and the mask staged
// where they change with the step, and in pass 3 P_f and m_f staged over
// them from slot 0 (each lane reads its step's sites before it writes that
// step's moments).  d^2 + d values a step at most: every d <= 6 is staged
// (5,376 values a warp at d = 6, R = 4).
template <typename T_, int D_>
struct UniformSteps : UniformRow<T_, D_, 1> {
  using T = T_;
  static constexpr int D = D_;
  using Prior = UniformPrior<T>;
  using In = GeneralIn<T, D>;
  static constexpr bool LOGLIK = true;
  static constexpr int NV_IN = 3, NV = D * D + D > 3 ? D * D + D : 3;
  static constexpr int P_OUT = 0, M_OUT = D * D;

  static __host__ __device__ GeneralSlots slots(const Prior&, const FilterArgs<T>& a,
                                                bool outputs) {
    GeneralSlots s{-1, -1, -1, -1, -1, -1, 0};
    s.nu = a.nu_st != 0 ? s.nv++ : -1;
    s.lam = a.lam_st != 0 ? s.nv++ : -1;
    s.mask = a.mask != nullptr ? s.nv++ : -1;
    if (outputs && s.nv < D * D + D) s.nv = D * D + D;
    return s;
  }

  template <class G, bool OUTPUTS>
  MF_DEV void stage(const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t t, int64_t n,
                    WarpStage<T, G::R>& st, GeneralSlots& sl) const {
    static_assert(G::STAGED, "kernel 1 stages every d <= 6");
    sl = slots(p, a, OUTPUTS);
    st.place(t, sl.nv, n);
    if (sl.nu >= 0) st.fetch(sl.nu, a.nu + b * a.nu_sb, a.nu_st);
    if (sl.lam >= 0) st.fetch(sl.lam, a.lam + b * a.lam_sb, a.lam_st);
    if (sl.mask >= 0) st.fetch(sl.mask, a.mask + b * a.mask_sb, a.mask_st);
    wide_fetch_wait();
  }

  template <bool STAGED, int R>
  MF_DEV void read(In& in, const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                   const Prior&, const FilterArgs<T>& a, int64_t b, int64_t k,
                   bool once) const {
    this->read_step(in, st, sl, l, r, a, b, k, once);
  }

  static MF_DEV void fold(FElem<T, D>& run, const In& in, bool) { fold_site<T, D>(run, in); }
  static MF_DEV T step(T* m, T* P, const In& in) { return kalman_step<T, D>(m, P, in); }
};

// Kernel 1 at o = 2..d (d <= 6): UniformSteps with o x o sites and a
// constant [o, d] Hc in registers, each step's element built and composed
// as kernel 4's at o (GeneralStepsO: site_element_o, FilterOp in pass 1,
// the moments through the element and _ll_slice's likelihood in pass 3).
// nu (o values), lam (o^2) and the mask staged where they change with the
// step, and in pass 3 P_f and m_f over them from slot 0; at most
// max(d^2 + d, o^2 + o + 1) values a step: every pair is staged (5,504
// values a warp at d = o = 6, R = 4).
template <typename T_, int D_, int O_>
struct UniformStepsO : UniformRow<T_, D_, O_> {
  using T = T_;
  static constexpr int D = D_, O = O_;
  using Prior = UniformPrior<T>;
  using In = GeneralInO<T, D, O>;
  static constexpr bool LOGLIK = true;
  static constexpr int NV_IN = O * O + O + 1, NV = D * D + D > NV_IN ? D * D + D : NV_IN;
  static constexpr int P_OUT = 0, M_OUT = D * D;

  static __host__ __device__ GeneralSlots slots(const Prior&, const FilterArgs<T>& a,
                                                bool outputs) {
    GeneralSlots s{-1, -1, -1, -1, -1, -1, 0};
    if (a.nu_st != 0) {
      s.nu = s.nv;
      s.nv += O;
    }
    if (a.lam_st != 0) {
      s.lam = s.nv;
      s.nv += O * O;
    }
    s.mask = a.mask != nullptr ? s.nv++ : -1;
    if (outputs && s.nv < D * D + D) s.nv = D * D + D;
    return s;
  }

  template <class G, bool OUTPUTS>
  MF_DEV void stage(const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t t, int64_t n,
                    WarpStage<T, G::R>& st, GeneralSlots& sl) const {
    static_assert(G::STAGED, "kernel 1 stages every (d, o) pair");
    sl = slots(p, a, OUTPUTS);
    st.place(t, sl.nv, n);
    fetch_sites_o<O>(st, sl, a, b);
    wide_fetch_wait();
  }

  template <bool STAGED, int R>
  MF_DEV void read(In& in, const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                   const Prior&, const FilterArgs<T>& a, int64_t b, int64_t k,
                   bool once) const {
    this->template read_step<STAGED>(in, st, sl, l, r, a, b, k, once);
  }

  static MF_DEV void fold(FElem<T, D>& run, const In& in, bool first) {
    GeneralStepsO<T, D, O>::fold(run, in, first);
  }
  static MF_DEV T step(T* m, T* P, const In& in) { return GeneralStepsO<T, D, O>::step(m, P, in); }
};

// Kernel 1 at o with lam constant (GPR's sites): UniformStepsO's constants,
// slots and staging, the rank-o fold and Kalman step of GeneralStepsRankO,
// and from d = 4 runs of 16 steps a thread in pass 1 (4 in pass 3,
// FilterSplit; on an H100 runs of 32 took 6% longer at (6, 3), of 64
// 19%).  lam is never staged; nu and the mask are staged in both passes,
// and pass 3's outputs over them (slot 0 on).  Every step after step 0
// has the same F, Q, H and lam, so the A, C and J legs of a thread's run,
// and what its fold of step r takes from them (fold_site_o's W, lz, ph
// and G), do not depend on the data: gfilter_table
// folds them once a batch row into the table (build_table), and a thread
// whose run is whole and holds no step 0 folds only the b and eta legs
// (fold_site_terms, ~1/20 of fold_site_o's work) and takes its A, C and J
// legs from the table (finish).  The thread that holds step 0 (the prior
// element) and a run cut short by the last step fold in full.  A mask
// changes only the likelihood.
template <typename T_, int D_, int O_>
struct UniformStepsRankO : UniformStepsO<T_, D_, O_> {
  using T = T_;
  static constexpr int D = D_, O = O_;
  using Prior = UniformPrior<T>;
  using In = RankInO<T, D, O>;
  using E = FElem<T, D>;
  static constexpr int RUN = D <= 3 ? Tiling<D>::R : 16;
  static constexpr int NV_IN = O + 1, NV = D * D + D > NV_IN ? D * D + D : NV_IN;
  // a row of the table: the terms of step r < RUN of a run, then the A, C
  // and J legs of runs of j R3 steps, j = 1..RUN / R3 (R3: pass 3's run)
  static constexpr int TERMS = 2 * O * O + 2 * D * O, LEGS = 3 * D * D;
  static constexpr int TABLE = RUN * TERMS + RUN / Tiling<D>::R * LEGS;
  const T* tab = nullptr;  // this row's table
  bool table_run = false;  // this thread's run folds from the table
  int r_ = 0;              // the step of the run read last

  template <bool STAGED, int R>
  MF_DEV void read(In& in, const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                   const Prior&, const FilterArgs<T>& a, int64_t b, int64_t k, bool once) {
    this->template read_step<STAGED>(in, st, sl, l, r, a, b, k, once);
    if (once) {
      in.prep();
      tab = a.table + b * TABLE;
      table_run = k != 0 && k + R <= a.n;  // pass 1: R = RUN
    }
    r_ = r;
  }

  MF_DEV void fold(E& run, const In& in, bool) const {
    if (table_run) fold_site_terms<T, D, O>(run, in, tab + r_ * TERMS);
    else fold_site_o_aside<T, D, O>(run, in);
  }

  // the A, C and J legs of a table run of r steps (r a multiple of R3)
  template <int R3>
  MF_DEV void finish(E& run, int r) const {
    if (!table_run) return;
    const T* legs = tab + RUN * TERMS + (r / R3 - 1) * LEGS;
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      run.v[E::OA + i] = legs[i];
      run.v[E::OC + i] = legs[D * D + i];
      run.v[E::OJ + i] = legs[2 * D * D + i];
    }
  }

  // Row b's table: the A, C and J legs of a run folded from the identity
  // over steps with the constants and lam (nu = 0: the b and eta legs are
  // not kept), and each step's terms.
  static MF_DEV void build_table(const FilterArgs<T>& a, const Prior& p, int64_t b) {
    constexpr int R3 = Tiling<D>::R;
    UniformStepsRankO src;
    src.load(p, b);
    In in;
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      in.f[i] = src.f[i];
      in.q[i] = src.q[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) in.c[i] = src.c[i];
#pragma unroll
    for (int i = 0; i < O * D; ++i) in.h[i] = src.h[i];
#pragma unroll
    for (int i = 0; i < O; ++i) {
      in.nu[i] = T(0);
#pragma unroll
      for (int j = 0; j < O; ++j)
        in.lam[i * O + j] = a.lam[b * a.lam_sb + i * a.lam_si + j * a.lam_sj];
    }
    T* tab = a.table + b * TABLE;
    E run;
    FilterOp<T, D>::identity(run);
    for (int r = 0; r < RUN; ++r) {
      fold_site_o<T, D, O, true>(run, in, tab + r * TERMS);
      if ((r + 1) % R3 == 0) {
        T* legs = tab + RUN * TERMS + ((r + 1) / R3 - 1) * LEGS;
        for (int i = 0; i < D * D; ++i) {
          legs[i] = run.v[E::OA + i];
          legs[D * D + i] = run.v[E::OC + i];
          legs[2 * D * D + i] = run.v[E::OJ + i];
        }
      }
    }
  }

  static MF_DEV T step(T* m, T* P, const In& in) { return kalman_step_o<T, D, O>(m, P, in); }
};

// constants Fc, cc, Qc as UniformPrior; filtered moments, contiguous:
// m_f [B, d, 1, N], P_f [B, d, d, N]
template <typename T>
struct UniformRts {
  const T *fc, *cc, *qc, *m_f, *p_f;
};

// Kernel 2's step source of the RTS smoother passes (general_scan.cuh): the
// constant prior step of batch row b in registers, and the RTS element of a
// step built from its filtered moments, read where they lie in pass 1 and
// staged in pass 3, where (m_s, P_s)_k go over the step's (m_f, P_f)_k.
// d^2 + d values a step: every d <= 6 is staged (5,376 values a warp at
// d = 6, R = 4).  Pass 3 builds each E_k again: faster than keeping it from
// pass 1 (PERF.md).
template <typename T_, int D_>
struct UniformRtsRow {
  using T = T_;
  static constexpr int D = D_;
  using Prior = UniformRts<T>;
  static constexpr int NV = D * D + D;
  static constexpr int P_OUT = 0, M_OUT = D * D;  // the staged P_f and m_f
  static constexpr bool STAGE_TOTALS = false;     // pass 1 reads each step where it lies
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

  // Thread t's warp's stage of (P_f, m_f) of its steps of batch row b
  // (pass 3), started and waited for.  Every lane of the warp must call it.
  template <int R>
  MF_DEV void stage(const Prior& a, int64_t b, int64_t t, int64_t n, WarpStage<T, R>& st) const {
    st.place(t, NV, n);
#pragma unroll
    for (int i = 0; i < D * D; ++i) st.fetch(P_OUT + i, a.p_f + (b * D * D + i) * n, 1);
#pragma unroll
    for (int i = 0; i < D; ++i) st.fetch(M_OUT + i, a.m_f + (b * D + i) * n, 1);
    wide_fetch_wait();
  }

  // The element of global step k from (m_f, P_f)_k where they lie (pass 1)
  MF_DEV void elem(const Prior& a, int64_t b, int64_t k, int64_t n, SElem<T, D>& out) const {
    T mk[D], pk[D * D];
#pragma unroll
    for (int i = 0; i < D; ++i) mk[i] = a.m_f[(b * D + i) * n + k];
#pragma unroll
    for (int i = 0; i < D * D; ++i) pk[i] = a.p_f[(b * D * D + i) * n + k];
    build(mk, pk, k, n, out);
  }

  // The element of lane l's step r, global step k, from its stage (pass 3)
  template <int R>
  MF_DEV void elem(const WarpStage<T, R>& st, int l, int r, int64_t k, int64_t n,
                   SElem<T, D>& out) const {
    T mk[D], pk[D * D];
#pragma unroll
    for (int i = 0; i < D; ++i) mk[i] = *st.at(M_OUT + i, l, r);
#pragma unroll
    for (int i = 0; i < D * D; ++i) pk[i] = *st.at(P_OUT + i, l, r);
    build(mk, pk, k, n, out);
  }

  // The RTS element of global step k from (m, P) = (m_f, P_f)_k
  // (smoother_pipeline_tl / _uniform_smoother_kernel): E = P F^T Pp^-1 with
  // Pp = sym(F P F^T + Q) (inv: pivoted from d = 4), g = m - E (F m + c),
  // L = sym(P - E F P); at the last step the boundary element (0, m, P).
  MF_DEV void build(const T* mk, const T* pk, int64_t k, int64_t n, SElem<T, D>& out) const {
    using E = SElem<T, D>;
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
// or to the runtime-d kernels for d = 7..12; the filter's output dimension
// o is 1 or, at d <= 6, one of MF_GENERAL_O_PAIRS (UniformStepsRankO where
// lam's step stride is 0, else UniformStepsO).
// Sizes are int64; every pointer, and the stream, is passed as an address;
// strides come as a host array of int64.
#define MF_DEFINE_UNIFORM_ENTRY_POINTS(T, SUFFIX)                                      \
  extern "C" int mf_uniform_filter_##SUFFIX(                                           \
      const T* fc, const T* cc, const T* qc, const T* mu0, const T* p0, const T* hc,   \
      const T* nu, const T* lam, const T* mask, const int64_t* site_strides, T* m_f,   \
      T* p_f, T* loglik, T* scratch, int64_t batch, int64_t n, int64_t d, int64_t o,   \
      void* stream) {                                                                  \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::UniformPrior<T> p{fc, cc, qc, mu0, p0, hc};                                    \
    mf::FilterArgs<T> a{};                                                             \
    a.nu = nu; a.lam = lam; a.mask = mask;                                             \
    mf::set_site_strides(a, site_strides);                                             \
    a.m_f = m_f; a.p_f = p_f; a.loglik = loglik; a.n = n; a.o = o;                     \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (o > d)                                                                         \
      MF_SWITCH_D5(d, (mf::launch_general_filter<mf::UniformStepsW<T, D_>>(a, p, scratch, \
                                                                        batch, s)),    \
                   int(cudaErrorInvalidValue))                                         \
    if (o != 1 && a.lam_st == 0)                                                       \
      MF_SWITCH_DO(d, o, (mf::launch_general_filter<mf::UniformStepsRankO<T, D_, O_>>(  \
                             a, p, scratch, batch, s)),                                \
                   int(cudaErrorInvalidValue))                                         \
    if (o != 1)                                                                        \
      MF_SWITCH_DO(d, o, (mf::launch_general_filter<mf::UniformStepsO<T, D_, O_>>(      \
                             a, p, scratch, batch, s)),                                \
                   int(cudaErrorInvalidValue))                                         \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_filter<mf::WideUniformRow<T>>(a, p, scratch, batch, int(d), \
                                                           s);                         \
    MF_SWITCH_D(d, (mf::launch_general_filter<mf::UniformSteps<T, D_>>(a, p, scratch,   \
                                                                       batch, s)),     \
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
    MF_SWITCH_D(d, (mf::launch_rts<mf::UniformRtsRow<T, D_>>(a, p, scratch, batch, s)), \
                int(cudaErrorInvalidValue))                                            \
  }
