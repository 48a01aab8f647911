// General-grid Kalman filter, smoother-scan and filter-scan kernels for
// Hopper (sm_90a), the d <= 6 filter passes that the uniform-grid filter
// (uniform_scan.cuh) shares, and the d <= 6 RTS smoother passes that the
// uniform-grid smoother runs.
//
// Replace the TPU kernels of markovflow_tpu/ops/pallas_scan.py:
//   * filter:        pallas_filter_pipeline (_pipeline_kernel)
//   * smoother scan: pallas_smoother_scan (_smoother_kernel)
//   * filter scan:   pallas_filter_scan (_filter_kernel)
// The plain PyTorch versions are filter_pipeline_plain / smoother_scan_plain
// / filter_scan_plain in markovflow_tpu_torch/ops/cuda_scan.py.  The
// filter reads per-step (F, c, Q, H) through their strides (F_0 = 0 is the
// prior row; for GPR, H is a stride-0 expansion of one row), so one kernel
// serves any time grid.  The smoother scan composes prebuilt (E, g, L)
// elements, the RTS elements of the general smoother, and writes the g and
// L legs.  The filter scan composes prebuilt (A, b, C, J, eta) elements
// (the ops filter API, ops.kalman.parallel_filter) without sites or
// log-likelihood, and writes the b and C legs.  At d <= 6 the filter, the
// filter scan and the uniform-grid filter run the filter passes below, one
// template over their step sources, and the smoother scan and the
// uniform-grid smoother the RTS smoother passes, another.
//
// What bounds them on an H100: the filter reads the prior steps besides the
// sites, 2 d^2 + d values a step (40 B at d = 2, float32) twice, and writes
// d^2 + d; per step it does a rank-one fold in pass 1 and a Kalman
// predict/update in pass 3 (two or three d^3 products, no inverse), so at
// d = 2 its ~100 dependent flops a step leave it latency-bound.  The filter
// scan moves 3 d^2 + 2 d values a step in twice and d^2 + d out (152 B at
// d = 2, float32, 45 us at 3.35 TB/s for N = 1e6): pass 1 composes whole
// elements (a d x d inverse a step), pass 3 carries only the moments (one
// inverse a step).  The smoother scan reads 2 d^2 + d values a step twice
// and writes d^2 + d, with no inverse: a full composition a step in pass 1
// (three d^3 products), the g and L legs only in pass 3 (two); at d = 2,
// float32, ~104 B a step and the stored in-block suffix (10 values a
// thread), 34 us at 3.35 TB/s for N = 1e6.  The TPU kernels take d <= 12:
// d = 1..6 are instantiated here, with every element in registers; d =
// 7..12 (an FElem at d = 12 has 456 values) run through the
// warp-per-element kernels of wide_scan.cuh with the Wide* sources below.
#pragma once

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The d = 1..6 filter passes, with the elements in registers and a run of R
// consecutive steps a thread, for three step sources at o = 1 (below):
// GeneralSteps (kernel 4, the general filter), UniformSteps (kernel 1, the
// uniform-grid filter, uniform_scan.cuh) and PrebuiltSteps (kernel 6, the
// filter scan); and four at o x o sites, GeneralStepsO and UniformStepsO
// (the element form) and GeneralStepsRankO and UniformStepsRankO (rank-o
// folds, with longer runs in pass 1 than in pass 3: FilterSplit), after
// GeneralSteps.  The general Koopman backward (kernel 7,
// general_adjoint.cuh) shares the tiling and the staging.
//   1. each thread folds its steps into its run: kernels 1 and 4 as
//      rank-one site updates (fold_site, the register twin of
//      wide_fold_site: three d^3 products and no inverse a step), kernel 6
//      with the full composition (FilterOp, a d x d inverse); the block scan
//      gives every thread its exclusive prefix within the block, which goes
//      to the scratch (store_thread_elem), and the block total;
//   2. scan_totals (scan_core.cuh);
//   3. each thread composes the b and C legs of its block's carry with its
//      stored prefix (filter_moments_through: the filtered moments before
//      its first step, one d x d inverse a thread) and carries only the
//      moments through its steps: kernels 1 and 4 by the Kalman
//      predict/update (kalman_step, the twin of wide_kalman_step), whose
//      prediction also gives the step's log-likelihood; kernel 6 by the b
//      and C legs of each element (filter_moments_through again, the twin
//      of wide_filter_moments).
// Pass 3 thus neither rebuilds the in-block prefix nor forms the A, J and
// eta legs.
//
// Steps staged through shared memory.  A thread owns R consecutive steps of
// the time-last arrays, so a warp's load of one value reads 32 sectors R
// steps apart, and a step's few products cannot hide the wait for them.
// Where a warp's steps are at most 6,144 values (STAGED, 24 KB in float32),
// each warp first copies the values of its 32 R steps into shared memory
// with cp.async, the lanes of one copy on 32 neighbouring steps of one value,
// all in flight at once; each lane then reads its own steps there, and
// writes its outputs there (over inputs it has consumed, or kernel 1's own
// slots), which the warp stores the same way.  Values that do not change
// with the step (stride 0: GPR's emission row and lam) are read once, and
// kernel 1's constant prior step is loaded once a thread.  What is staged
// at d = 1..6: kernel 1 every d (the sites, and d^2 + d output slots in pass
// 3); kernel 4 to d = 4; kernel 6 to d = 3; kernel 7 to d = 3; the passes 3
// of kernels 2 and 3 (the RTS smoother passes below, adjoint_scan.cuh)
// every d; kernel 5 (passes 1 and 3) to d = 4.  Larger d read each step's
// values where they lie.
// ---------------------------------------------------------------------------

// The tiling of passes that stage at most NV_ values a step, R_ steps a
// thread (and WARPS_ warps a block where it is not 0).
template <typename T, int D, int NV_, int R_ = Tiling<D>::R, int WARPS_ = 0>
struct StagedTiling {
  static constexpr int R = R_;
  static constexpr int NV = NV_;
  static constexpr int WARP_BYTES = NV * 32 * R * int(sizeof(T));
  static constexpr bool STAGED = NV * 32 * R <= 6144;
  // staged: 8 warps a block, or as many as 192 KB hold (float64): the
  // block's tile of steps sets the number of totals that pass 2 scans in
  // one block, whose chain of compositions grows with them
  static constexpr int WARPS =
      WARPS_ != 0 ? WARPS_
      : !STAGED   ? Tiling<D>::THREADS / 32
                  : (8 * WARP_BYTES <= 196608 ? 8 : 196608 / WARP_BYTES);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int64_t TILE = int64_t(THREADS) * R;
  static constexpr int SCAN_THREADS = 512;  // pass 2's block: 1 or 2 totals a thread at N = 1e6
};

// Kernels 4 and 7: the values of a step at most are F, Q, c, H, nu, lam,
// the mask and, with MOMENTS (kernel 7), P_{k-1} and m_{k-1}.
template <typename T, int D, bool MOMENTS>
using GeneralTiling = StagedTiling<T, D, (MOMENTS ? 3 : 2) * (D * D + D) + 3>;

// The staged values of a step and their slots: F, Q, c, with MOMENTS
// P_{k-1} and m_{k-1}, then H, nu, lam and the mask where they change with
// the step (-1: not staged).
struct GeneralSlots {
  int pprev, mprev, h, nu, lam, mask, nv;
};

template <int D, typename T, class A>
__host__ __device__ inline GeneralSlots general_slots(const GeneralPrior<T>& p, const A& a,
                                                      bool moments) {
  GeneralSlots s;
  int v = 2 * D * D + D;
  s.pprev = moments ? v : -1;
  s.mprev = moments ? v + D * D : -1;
  v += moments ? D * D + D : 0;
  s.h = p.h_st != 0 ? v : -1;
  v += p.h_st != 0 ? D : 0;
  s.nu = a.nu_st != 0 ? v++ : -1;
  s.lam = a.lam_st != 0 ? v++ : -1;
  s.mask = a.mask != nullptr ? v++ : -1;
  s.nv = v;
  return s;
}

// A warp's staged steps: value v of lane l's step r at
// base[v * 32 R + l R + (r ^ (l R / 32))].  The xor puts the 32 lanes'
// reads of one r, and the copies of 32 neighbouring steps, on 32 banks.
template <typename T, int R>
struct WarpStage {
  T* base;
  int64_t w0, n;  // the warp's first step; the steps of the row

  MF_DEV T* at(int v, int l, int r) const {
    return base + v * 32 * R + l * R + (r ^ (l * R / 32));
  }
  // the slot of value v of the warp's step s
  MF_DEV T* step(int v, int s) const { return at(v, s / R, s % R); }

  // Starts the copies of value v of the warp's steps from row[k * stride]
  // (k - 1 with SHIFT, 0 before step 0).
  template <bool SHIFT = false>
  MF_DEV void fetch(int v, const T* row, int64_t stride) const {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = j * 32 + lane_id();
      const int64_t k = w0 + s;
      if (k >= n) break;
      if (SHIFT && k == 0) *step(v, s) = T(0);
      else cp_async(step(v, s), row + (SHIFT ? k - 1 : k) * stride);
    }
  }

  // Stores value v of the warp's steps to row[k], contiguous.
  MF_DEV void store(int v, T* row) const {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = j * 32 + lane_id();
      const int64_t k = w0 + s;
      if (k >= n) break;
      row[k] = *step(v, s);
    }
  }

  // Thread t's warp's stage of nv values a step in the dynamic shared
  // memory, of the steps below n.
  MF_DEV void place(int64_t t, int nv, int64_t steps) {
    base = reinterpret_cast<T*>(mf_wide_smem) + (threadIdx.x >> 5) * nv * 32 * R;
    w0 = (t - lane_id()) * R;
    n = steps;
  }
};

// The inputs of global step k: F, Q, c, H and the sites.  H, nu and lam are
// read only once when their step stride is 0, as GPR's expanded emission
// row and noise are.
template <typename T, int D>
struct GeneralIn {
  T f[D * D], q[D * D], c[D], h[D];
  WideSite<T> s;

  // A: FilterArgs or GeneralAdjointPrior (the site fields); through the
  // strides, what does not change with the step only once (once)
  template <class A>
  MF_DEV void read_global(const GeneralPrior<T>& p, const A& a, int64_t b, int64_t k,
                          bool once) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        f[i * D + j] = p.f[b * p.f_sb + i * p.f_si + j * p.f_sj + k * p.f_st];
        q[i * D + j] = p.q[b * p.q_sb + i * p.q_si + j * p.q_sj + k * p.q_st];
      }
      c[i] = p.c[b * p.c_sb + i * p.c_si + k * p.c_st];
    }
    read_sites(p, a, b, k, once);
  }

  template <class A>
  MF_DEV void read_sites(const GeneralPrior<T>& p, const A& a, int64_t b, int64_t k,
                         bool once) {
    if (once || p.h_st != 0) {
#pragma unroll
      for (int j = 0; j < D; ++j) h[j] = p.h[b * p.h_sb + j * p.h_sj + k * p.h_st];
    }
    if (once || a.nu_st != 0) s.nu = a.nu[b * a.nu_sb + k * a.nu_st];
    if (once || a.lam_st != 0) s.lam = a.lam[b * a.lam_sb + k * a.lam_st];
    s.keep = a.mask == nullptr || a.mask[b * a.mask_sb + k * a.mask_st] > T(0.5);
  }

  // Lane l's step r, global step k: from the warp's stage when STAGED (what
  // is not staged read once, once, from step k), else where it lies.
  template <bool STAGED, int R, class A>
  MF_DEV void read(const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                   const GeneralPrior<T>& p, const A& a, int64_t b, int64_t k, bool once) {
    if constexpr (!STAGED) {
      read_global(p, a, b, k, once);
      return;
    }
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      f[i] = *st.at(i, l, r);
      q[i] = *st.at(D * D + i, l, r);
    }
#pragma unroll
    for (int i = 0; i < D; ++i) c[i] = *st.at(2 * D * D + i, l, r);
    if (once && (sl.h < 0 || sl.nu < 0 || sl.lam < 0)) read_sites(p, a, b, k, true);
    if (sl.h >= 0) {
#pragma unroll
      for (int j = 0; j < D; ++j) h[j] = *st.at(sl.h + j, l, r);
    }
    if (sl.nu >= 0) s.nu = *st.at(sl.nu, l, r);
    if (sl.lam >= 0) s.lam = *st.at(sl.lam, l, r);
    s.keep = sl.mask < 0 || *st.at(sl.mask, l, r) > T(0.5);
  }
};

// Thread t's warp's stage (only when G::STAGED): its slots in the dynamic
// shared memory, and the copies of its steps of batch row b started and
// waited for: F, Q, c and what general_slots lists (with MOMENTS, from m_f
// and p_f the moments of the step before each step).  Every lane of the
// warp must call it.
template <class G, int D, typename T, class A>
MF_DEV void stage_steps(const GeneralPrior<T>& p, const A& a, int64_t b, int64_t t, int64_t n,
                        const T* m_f, const T* p_f, WarpStage<T, G::R>& st,
                        GeneralSlots& sl) {
  st = {nullptr, (t - lane_id()) * G::R, n};
  if constexpr (G::STAGED) {
    sl = general_slots<D>(p, a, m_f != nullptr);
    st.place(t, sl.nv, n);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        st.fetch(i * D + j, p.f + (b * p.f_sb + i * p.f_si + j * p.f_sj), p.f_st);
        st.fetch(D * D + i * D + j, p.q + (b * p.q_sb + i * p.q_si + j * p.q_sj), p.q_st);
        if (sl.pprev >= 0)
          st.template fetch<true>(sl.pprev + i * D + j, p_f + ((b * D + i) * D + j) * n, 1);
      }
      st.fetch(2 * D * D + i, p.c + (b * p.c_sb + i * p.c_si), p.c_st);
      if (sl.mprev >= 0) st.template fetch<true>(sl.mprev + i, m_f + (b * D + i) * n, 1);
      if (sl.h >= 0) st.fetch(sl.h + i, p.h + (b * p.h_sb + i * p.h_sj), p.h_st);
    }
    if (sl.nu >= 0) st.fetch(sl.nu, a.nu + b * a.nu_sb, a.nu_st);
    if (sl.lam >= 0) st.fetch(sl.lam, a.lam + b * a.lam_sb, a.lam_st);
    if (sl.mask >= 0) st.fetch(sl.mask, a.mask + b * a.mask_sb, a.mask_st);
    wide_fetch_wait();
  }
}

template <typename T, int D>
MF_DEV T dot(const T* a, const T* b) {
  T s = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < D; ++i) s += a[i] * b[i];
  return s;
}

// Pass 1: fold the step into the run (A, b, C, J, eta), the element of the
// steps so far given the state before them.  The step's element has
// J = lz (H F)^T (H F), rank one, so composing it (FilterOp) is the
// sequential Kalman step of the run's conditional moments, with the gain
// row g = H F A (wide_fold_site):
//   Pp = sym(F C F^T + Q), mp = F b + c, ph = Pp H^T, z = 1 / (lam H ph + 1),
//   lz = lam z, r = z nu - lz H mp;
//   A <- F A - lz ph g, b <- mp + ph r, C <- Pp - lz ph ph^T,
//   J <- J + lz g^T g, eta <- eta + g^T r.
template <typename T, int D>
MF_DEV void fold_site(FElem<T, D>& x, const GeneralIn<T, D>& in) {
  using E = FElem<T, D>;
  T *A = x.v + E::OA, *bb = x.v + E::OB, *C = x.v + E::OC, *J = x.v + E::OJ,
    *eta = x.v + E::OE;
  T fa[D * D], fc[D * D], pp[D * D], mp[D], g[D], ph[D];
  mm<T, D, D, D>(in.f, A, fa);
  mm<T, D, D, D>(in.f, C, fc);
  mm<T, D, D, 1>(in.f, bb, mp);
  add_to<T, D>(mp, in.c);
  mm_nt<T, D, D, D>(fc, in.f, pp);
  add_to<T, D * D>(pp, in.q);
  sym<T, D>(pp);
  mm_tn<T, D, D, 1>(fa, in.h, g);  // (H F A)^T
  mm<T, D, D, 1>(pp, in.h, ph);
  const T z = T(1) / (in.s.lam * dot<T, D>(in.h, ph) + T(1)), lz = in.s.lam * z;
  const T r = z * in.s.nu - lz * dot<T, D>(in.h, mp);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      A[i * D + j] = fa[i * D + j] - lz * ph[i] * g[j];
      C[i * D + j] = pp[i * D + j] - lz * (ph[i] * ph[j]);
      J[i * D + j] += lz * (g[i] * g[j]);
    }
    bb[i] = mp[i] + ph[i] * r;
    eta[i] += g[i] * r;
  }
}

// Pass 3: the b and C legs of (xb, xc) composed with y (FilterOp's b and C
// legs read nothing of the earlier element but its b and C): the filtered
// moments (m, P) after y's steps from those before them.
//   m = yA (I + xc yJ)^-1 (xb + xc yeta) + yb,
//   P = sym(yA (I + xc yJ)^-1 xc yA^T + yC).
template <typename T, int D>
MF_DEV void filter_moments_through(const T* xb, const T* xc, const FElem<T, D>& y, T* m,
                                   T* P) {
  using E = FElem<T, D>;
  T t1[D * D], t2[D * D], minv[D * D], v1[D], v2[D];
  mm<T, D, D, D>(xc, y.v + E::OJ, t1);
  add_eye<T, D>(t1);
  inv<T, D>(t1, minv);
  mm<T, D, D, 1>(xc, y.v + E::OE, v1);
  add_to<T, D>(v1, xb);
  mm<T, D, D, 1>(minv, v1, v2);
  mm<T, D, D, 1>(y.v + E::OA, v2, m);
  add_to<T, D>(m, y.v + E::OB);
  mm<T, D, D, D>(minv, xc, t1);
  mm_nt<T, D, D, D>(t1, y.v + E::OA, t2);
  mm<T, D, D, D>(y.v + E::OA, t2, P);
  add_to<T, D * D>(P, y.v + E::OC);
  sym<T, D>(P);
}

// Pass 3: the Kalman step from the filtered moments (m, P) of the step before
// to this step's, in place (wide_kalman_step); returns the step's site
// log-likelihood from the same prediction.
template <typename T, int D>
MF_DEV T kalman_step(T* m, T* P, const GeneralIn<T, D>& in) {
  T fp[D * D], pp[D * D], mp[D], ph[D];
  mm<T, D, D, D>(in.f, P, fp);
  mm_nt<T, D, D, D>(fp, in.f, pp);  // Ppred = sym(F P F^T + Q)
  add_to<T, D * D>(pp, in.q);
  sym<T, D>(pp);
  mm<T, D, D, 1>(in.f, m, mp);
  add_to<T, D>(mp, in.c);
  mm<T, D, D, 1>(pp, in.h, ph);
  const T hpht = dot<T, D>(in.h, ph), hm = dot<T, D>(in.h, mp);
  const T z = T(1) / (in.s.lam * hpht + T(1)), lz = in.s.lam * z;
  const T r = z * in.s.nu - lz * hm;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) P[i * D + j] = pp[i * D + j] - lz * (ph[i] * ph[j]);
    m[i] = mp[i] + ph[i] * r;
  }
  return wide_loglik(in.s, hm, hpht);
}

// A step source of the filter passes, for batch row b (Src src;
// src.load(prior, b)):
//   T, D, Prior; In, what a step's read fills; LOGLIK, whether pass 3 sums
//   the steps' log-likelihoods; NV_IN and NV, the most values a step that
//   pass 1 and pass 3 stage; P_OUT and M_OUT, the slots where pass 3 puts a
//   step's P_f and m_f;
//   slots(prior, a, outputs): the staged slots (with pass 3's outputs);
//   stage<G, OUTPUTS>(prior, a, b, t, n, st, sl): thread t's warp's stage
//     of pass 1 or, with OUTPUTS, of pass 3, started and waited for, when
//     G::STAGED; every lane of the warp must call it;
//   read<STAGED>(in, st, sl, l, r, prior, a, b, k, once): lane l's step r,
//     global step k (once: the thread's first step);
//   fold(run, in, first): pass 1, the step folded into the thread's run
//     (first: the run's first step);
//   step(m, P, in): pass 3, the moments carried through the step; returns
//     its log-likelihood.

// Kernel 4: per-step F, Q, c and H through their strides, staged with the
// sites; pass 3 puts P_f over the staged Q and m_f over c.
template <typename T_, int D_>
struct GeneralSteps {
  using T = T_;
  static constexpr int D = D_;
  using Prior = GeneralPrior<T>;
  using In = GeneralIn<T, D>;
  static constexpr bool LOGLIK = true;
  static constexpr int NV_IN = GeneralTiling<T, D, false>::NV, NV = NV_IN;
  static constexpr int P_OUT = D * D, M_OUT = 2 * D * D;

  MF_DEV void load(const Prior&, int64_t) {}

  static __host__ __device__ GeneralSlots slots(const Prior& p, const FilterArgs<T>& a, bool) {
    return general_slots<D>(p, a, false);
  }

  template <class G, bool OUTPUTS>
  MF_DEV void stage(const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t t, int64_t n,
                    WarpStage<T, G::R>& st, GeneralSlots& sl) const {
    stage_steps<G, D>(p, a, b, t, n, (const T*)nullptr, (const T*)nullptr, st, sl);
  }

  template <bool STAGED, int R>
  MF_DEV void read(In& in, const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                   const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t k,
                   bool once) const {
    in.template read<STAGED>(st, sl, l, r, p, a, b, k, once);
  }

  static MF_DEV void fold(FElem<T, D>& run, const In& in, bool) { fold_site<T, D>(run, in); }
  static MF_DEV T step(T* m, T* P, const In& in) { return kalman_step<T, D>(m, P, in); }
};

// ---------------------------------------------------------------------------
// Kernel 4 at o = 2..d (d <= 6): o x o sites, as the natural-gradient
// family's theta -> SSM inversion gives them (an identity emission and full
// site precisions, ssm_gaussian_transformations.naturals_to_ssm_params_
// parallel_tl) and a multi-output GPR on an irregular grid (a
// block-diagonal emission, one full noise precision).  The filter passes
// above over one more step source, GeneralStepsO, in the element form;
// kernel 1 at o = 2..d builds and composes its elements the same way
// (UniformStepsO, uniform_scan.cuh).  Where lam does not change with the
// step both take the rank-o sources below instead (GeneralStepsRankO,
// UniformStepsRankO).  Each step's filtering element is built in registers
// (site_element_o: pallas_scan._make_elem_slice's element), and composed
// as the filter scan composes prebuilt ones: pass 1 folds it into the run
// with FilterOp (a d x d inverse a step), pass 3 carries the moments
// through it (filter_moments_through).  The rank-one path's covariance-form
// steps (fold_site, kalman_step) would subtract O(1) numbers to reach the
// tiny conditional covariances of the inversion's synthetic model (lam ~
// dt^-3, indefinite, so that P_f is too): 1e-7 of P_f at N = 4099 against
// 1e-10 for the elements (a 40-digit reference, d = 2).  The site terms
// come from one o x o solve (site_solve)
//   (I + lam S) [X | W | y] = [lam | I | nu],   S = H Q H^T,
// X = lam (I + S lam)^-1 (the element's lam z), W = (I + lam S)^-1 and
// y = z^T nu; I + lam S is neither symmetric nor definite, so the solve
// pivots (gauss_jordan_solve), and X is averaged with its transpose after
// it, as the TPU element symmetrises lam z after its inverse.  The
// element's C leg is Q after the site in Joseph's form (joseph_update),
// which the solve's error reaches only at second order.  Pass 3's
// log-likelihood is _ll_slice's lam form from the predicted moments,
// w = nu - lam H mp, quad = w^T (lam + lam Sp lam)^-1 w and
// log|det(I + Sp lam)| - log|det lam|, by two more eliminations
// (site_loglik_o); a singular lam makes it infinite, but the moments never
// read it.
// ---------------------------------------------------------------------------

// The staged values of a step at o: F, Q, c, then H (o d values), nu (o),
// lam (o^2) and the mask where they change with the step.
template <int D, int O, typename T>
__host__ __device__ inline GeneralSlots general_slots_o(const GeneralPrior<T>& p,
                                                        const FilterArgs<T>& a) {
  GeneralSlots s{-1, -1, -1, -1, -1, -1, 0};
  int v = 2 * D * D + D;
  if (p.h_st != 0) {
    s.h = v;
    v += O * D;
  }
  if (a.nu_st != 0) {
    s.nu = v;
    v += O;
  }
  if (a.lam_st != 0) {
    s.lam = v;
    v += O * O;
  }
  if (a.mask != nullptr) s.mask = v++;
  s.nv = v;
  return s;
}

// The inputs of global step k at o: F, Q, c, H [o x d], nu [o], lam [o x o]
// and the mask; H, nu and lam read only once when their step stride is 0.
// A (the site fields): FilterArgs, or a Koopman backward's prior.
template <typename T, int D, int O>
struct GeneralInO {
  T f[D * D], q[D * D], c[D], h[O * D], nu[O], lam[O * O];
  bool keep;

  // nu, lam (through their strides, only once, once, where the step stride
  // is 0) and the mask of step k
  template <class A>
  MF_DEV void read_site_values(const A& a, int64_t b, int64_t k, bool once) {
    if (once || a.nu_st != 0) {
#pragma unroll
      for (int i = 0; i < O; ++i) nu[i] = a.nu[b * a.nu_sb + i * a.nu_si + k * a.nu_st];
    }
    if (once || a.lam_st != 0) {
#pragma unroll
      for (int i = 0; i < O; ++i) {
#pragma unroll
        for (int j = 0; j < O; ++j)
          lam[i * O + j] = a.lam[b * a.lam_sb + i * a.lam_si + j * a.lam_sj + k * a.lam_st];
      }
    }
    keep = a.mask == nullptr || a.mask[b * a.mask_sb + k * a.mask_st] > T(0.5);
  }

  // H of step k
  MF_DEV void read_h(const GeneralPrior<T>& p, int64_t b, int64_t k) {
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        h[i * D + j] = p.h[b * p.h_sb + i * p.h_si + j * p.h_sj + k * p.h_st];
    }
  }

  // nu, lam and the mask of lane l's step r from the warp's stage where sl
  // has slots for them; what has none is read once, once, from step k
  template <int R, class A>
  MF_DEV void read_staged_sites(const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                                const A& a, int64_t b, int64_t k, bool once) {
    if (once && (sl.nu < 0 || sl.lam < 0)) read_site_values(a, b, k, true);
    if (sl.nu >= 0) {
#pragma unroll
      for (int i = 0; i < O; ++i) nu[i] = *st.at(sl.nu + i, l, r);
    }
    if (sl.lam >= 0) {
#pragma unroll
      for (int i = 0; i < O * O; ++i) lam[i] = *st.at(sl.lam + i, l, r);
    }
    keep = sl.mask < 0 || *st.at(sl.mask, l, r) > T(0.5);
  }

  // Lane l's step r, global step k, as GeneralIn::read.
  template <bool STAGED, int R, class A>
  MF_DEV void read(const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                   const GeneralPrior<T>& p, const A& a, int64_t b, int64_t k, bool once) {
    if constexpr (!STAGED) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          f[i * D + j] = p.f[b * p.f_sb + i * p.f_si + j * p.f_sj + k * p.f_st];
          q[i * D + j] = p.q[b * p.q_sb + i * p.q_si + j * p.q_sj + k * p.q_st];
        }
        c[i] = p.c[b * p.c_sb + i * p.c_si + k * p.c_st];
      }
      if (once || p.h_st != 0) read_h(p, b, k);
      read_site_values(a, b, k, once);
      return;
    }
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      f[i] = *st.at(i, l, r);
      q[i] = *st.at(D * D + i, l, r);
    }
#pragma unroll
    for (int i = 0; i < D; ++i) c[i] = *st.at(2 * D * D + i, l, r);
    if (sl.h >= 0) {
#pragma unroll
      for (int i = 0; i < O * D; ++i) h[i] = *st.at(sl.h + i, l, r);
    } else if (once) {
      read_h(p, b, k);
    }
    read_staged_sites(st, sl, l, r, a, b, k, once);
  }
};

// Starts the copies of nu, lam and the mask of a warp's steps of batch row b
// into their slots of sl (those with a slot: the strided ones).
template <int O, typename T, int R>
MF_DEV void fetch_sites_o(const WarpStage<T, R>& st, const GeneralSlots& sl,
                          const FilterArgs<T>& a, int64_t b) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
    if (sl.nu >= 0) st.fetch(sl.nu + i, a.nu + (b * a.nu_sb + i * a.nu_si), a.nu_st);
    if (sl.lam >= 0) {
#pragma unroll
      for (int j = 0; j < O; ++j)
        st.fetch(sl.lam + i * O + j, a.lam + (b * a.lam_sb + i * a.lam_si + j * a.lam_sj),
                 a.lam_st);
    }
  }
  if (sl.mask >= 0) st.fetch(sl.mask, a.mask + b * a.mask_sb, a.mask_st);
}

// The site's terms from S = H P H^T [o x o] and hm = H m [o], by one
// pivoted solve (I + lam S) [X | W | y] = [lam | I | nu]:
// lz = sym(X) = sym(lam (I + S lam)^-1), W = (I + lam S)^-1 and
// r = y - lz hm; returns det(I + lam S) up to its sign.
template <typename T, int O>
MF_DEV T site_solve(const T* s, const T* lam, const T* nu, const T* hm, T* lz, T* r, T* w) {
  constexpr int K = 2 * O + 1;
  T mt[O * O], rhs[O * K], x[O * K];
  mm<T, O, O, O>(lam, s, mt);
  add_eye<T, O>(mt);
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < O; ++j) {
      rhs[i * K + j] = lam[i * O + j];
      rhs[i * K + O + j] = T(i == j);
    }
    rhs[i * K + 2 * O] = nu[i];
  }
  const T det = gauss_jordan_solve<T, O, K>(mt, rhs, x);
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < O; ++j) {
      lz[i * O + j] = T(0.5) * (x[i * K + j] + x[j * K + i]);
      w[i * O + j] = x[i * K + O + j];
    }
  }
#pragma unroll
  for (int i = 0; i < O; ++i) {
    T acc = x[i * K + 2 * O];
#pragma unroll
    for (int j = 0; j < O; ++j) acc -= lz[i * O + j] * hm[j];
    r[i] = acc;
  }
  return det;
}

// The covariance a [d x d] after the site, in Joseph's form, over the
// upper triangle, mirrored, with ph = a H^T [d x o] and W (site_solve):
//   c = (I - u H) a (I - u H)^T + v lam v^T,  u = ph W lam, v = ph W,
// u the gain and v lam v^T = u lam^-1 u^T without lam^-1.  As a function
// of W it is stationary at the exact W, so the solve's error in W (which
// grows with the condition of I + lam S) enters only at second order;
// a - ph lz ph^T takes it at first order: where the site cancels most of a
// state's variance (a dense H over a Matern52's f'', of variance ~400) that
// form lost 2-3 more digits in float32 than this one.
template <typename T, int D, int O>
MF_DEV void joseph_update(const T* a, const T* h, const T* ph, const T* w, const T* lam,
                          T* c) {
  T wl[O * O], u[D * O], v[D * O], ikh[D * D], t[D * D], vl[D * O];
  mm<T, O, O, O>(w, lam, wl);
  mm<T, D, O, O>(ph, wl, u);
  mm<T, D, O, O>(ph, w, v);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = T(i == j);
#pragma unroll
      for (int k = 0; k < O; ++k) acc -= u[i * O + k] * h[k * D + j];
      ikh[i * D + j] = acc;
    }
  }
  mm<T, D, D, D>(ikh, a, t);
  mm<T, D, O, O>(v, lam, vl);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = i; j < D; ++j) {
      T acc = vl[i * O] * v[j * O];
#pragma unroll
      for (int k = 1; k < O; ++k) acc += vl[i * O + k] * v[j * O + k];
#pragma unroll
      for (int k = 0; k < D; ++k) acc += t[i * D + k] * ikh[j * D + k];
      c[i * D + j] = acc;
      c[j * D + i] = acc;
    }
  }
}

// The step's filtering element (make_filter_elements_tl), with
// qht = Q H^T [d x o], hf = H F [o x d] and the site terms of S = H qht,
// hm = H c (site_solve):
//   A = F - qht lz hf, b = c + qht r, C = Q after the site in Joseph's form
//   (joseph_update), J = sym(hf^T lz hf), eta = hf^T r.
template <typename T, int D, int O>
MF_DEV void site_element_o(const GeneralInO<T, D, O>& in, FElem<T, D>& e) {
  using E = FElem<T, D>;
  T qht[D * O], s[O * O], hm[O], lz[O * O], r[O], w[O * O], hf[O * D], ql[D * O], lh[O * D];
  mm_nt<T, D, D, O>(in.q, in.h, qht);
  mm<T, O, D, O>(in.h, qht, s);
  mm<T, O, D, 1>(in.h, in.c, hm);
  site_solve<T, O>(s, in.lam, in.nu, hm, lz, r, w);
  mm<T, O, D, D>(in.h, in.f, hf);
  mm<T, D, O, O>(qht, lz, ql);
  mm<T, D, O, D>(ql, hf, e.v + E::OA);
#pragma unroll
  for (int i = 0; i < D * D; ++i) e.v[E::OA + i] = in.f[i] - e.v[E::OA + i];
  mm<T, D, O, 1>(qht, r, e.v + E::OB);
  add_to<T, D>(e.v + E::OB, in.c);
  joseph_update<T, D, O>(in.q, in.h, qht, w, in.lam, e.v + E::OC);
  mm<T, O, O, D>(lz, hf, lh);
  mm_tn<T, D, O, D>(hf, lh, e.v + E::OJ);
  sym<T, D>(e.v + E::OJ);
  mm_tn<T, D, O, 1>(hf, r, e.v + E::OE);
}

// The site log-likelihood of a step at o (_ll_slice) from the moments of
// the step before, (m, P); masked steps give 0.  With w = nu - lam H mp,
// quad = w^T (lam + lam Sp lam)^-1 w = e^T v for v = (I + lam Sp)^-1 w and
// e = lam^-1 w: two eliminations, whose pivots also give det(I + lam Sp)
// and det(lam), and no lam Sp lam (its entries reach lam^2 Sp, and the
// third elimination on it lost float32 digits at a dense H over a
// Matern52's f'').
template <typename T, int D, int O>
MF_DEV T site_loglik_o(const GeneralInO<T, D, O>& in, const T* m, const T* P) {
  if (!in.keep) return T(0);
  T fp[D * D], pp[D * D], mp[D], ph[D * O], s[O * O], hm[O], w[O], mt[O * O], v[O], e[O];
  mm<T, D, D, D>(in.f, P, fp);
  mm_nt<T, D, D, D>(fp, in.f, pp);
  add_to<T, D * D>(pp, in.q);
  sym<T, D>(pp);
  mm<T, D, D, 1>(in.f, m, mp);
  add_to<T, D>(mp, in.c);
  mm_nt<T, D, D, O>(pp, in.h, ph);
  mm<T, O, D, O>(in.h, ph, s);
  mm<T, O, D, 1>(in.h, mp, hm);
  mm<T, O, O, 1>(in.lam, hm, w);
#pragma unroll
  for (int i = 0; i < O; ++i) w[i] = in.nu[i] - w[i];
  mm<T, O, O, O>(in.lam, s, mt);
  add_eye<T, O>(mt);
  const T det_m = gauss_jordan_solve<T, O, 1>(mt, w, v);  // det(I + lam S)
  const T det_lam = gauss_jordan_solve<T, O, 1>(in.lam, w, e);
  const T log_det_s = log(fabs(det_m)) - log(fabs(det_lam));
  return T(-0.5) * (dot<T, O>(e, v) + log_det_s + T(O * 1.8378770664093453));
}

// Kernel 4 at o: GeneralSteps' passes and slots with o x o sites.
template <typename T_, int D_, int O_>
struct GeneralStepsO {
  using T = T_;
  static constexpr int D = D_, O = O_;
  using Prior = GeneralPrior<T>;
  using In = GeneralInO<T, D, O>;
  static constexpr bool LOGLIK = true;
  static constexpr int NV_IN = 2 * D * D + D + O * D + O + O * O + 1, NV = NV_IN;
  static constexpr int P_OUT = D * D, M_OUT = 2 * D * D;

  MF_DEV void load(const Prior&, int64_t) {}

  static __host__ __device__ GeneralSlots slots(const Prior& p, const FilterArgs<T>& a, bool) {
    return general_slots_o<D, O>(p, a);
  }

  template <class G, bool OUTPUTS>
  MF_DEV void stage(const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t t, int64_t n,
                    WarpStage<T, G::R>& st, GeneralSlots& sl) const {
    st = {nullptr, (t - lane_id()) * G::R, n};
    if constexpr (G::STAGED) {
      sl = general_slots_o<D, O>(p, a);
      st.place(t, sl.nv, n);
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          st.fetch(i * D + j, p.f + (b * p.f_sb + i * p.f_si + j * p.f_sj), p.f_st);
          st.fetch(D * D + i * D + j, p.q + (b * p.q_sb + i * p.q_si + j * p.q_sj), p.q_st);
        }
        st.fetch(2 * D * D + i, p.c + (b * p.c_sb + i * p.c_si), p.c_st);
      }
      if (sl.h >= 0) {
#pragma unroll
        for (int i = 0; i < O; ++i) {
#pragma unroll
          for (int j = 0; j < D; ++j)
            st.fetch(sl.h + i * D + j, p.h + (b * p.h_sb + i * p.h_si + j * p.h_sj), p.h_st);
        }
      }
      fetch_sites_o<O>(st, sl, a, b);
      wide_fetch_wait();
    }
  }

  template <bool STAGED, int R>
  MF_DEV void read(In& in, const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                   const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t k,
                   bool once) const {
    in.template read<STAGED>(st, sl, l, r, p, a, b, k, once);
  }

  // the run's first step is its element (one composition fewer)
  static MF_DEV void fold(FElem<T, D>& run, const In& in, bool first) {
    FElem<T, D> e;
    site_element_o<T, D, O>(in, e);
    if (first) {
      run = e;
      return;
    }
    FElem<T, D> t;
    FilterOp<T, D>::combine(run, e, t);
    run = t;
  }

  // the log-likelihood from the moments before the step, then
  // m <- A (I + P J)^-1 (m + P eta) + b, P <- sym(A (I + P J)^-1 P A^T + C)
  static MF_DEV T step(T* m, T* P, const In& in) {
    const T ll = site_loglik_o<T, D, O>(in, m, P);
    FElem<T, D> e;
    site_element_o<T, D, O>(in, e);
    T m1[D], p1[D * D];
    filter_moments_through<T, D>(m, P, e, m1, p1);
#pragma unroll
    for (int i = 0; i < D; ++i) m[i] = m1[i];
#pragma unroll
    for (int i = 0; i < D * D; ++i) P[i] = p1[i];
    return ll;
  }
};

// ---------------------------------------------------------------------------
// Kernels 4 and 1 at o = 2..d (d <= 6) where lam does not change with the
// step (stride 0: a multi-output GPR's one noise precision), the rank-o
// twins of the rank-one passes: pass 1 folds each step into the run as a
// conditional Kalman step (fold_site_o: one o x o solve, no d x d inverse,
// one FElem live), pass 3 carries the moments by the Kalman step
// (kalman_step_o), whose one o x o solve also gives the step's
// log-likelihood.  The launch takes them when lam's step stride is 0 and
// the element form above (GeneralStepsO, UniformStepsO) otherwise: the
// natural-gradient inversion's per-step, indefinite sites lose digits in
// the covariance form (above).  A cheaper fold pays for a longer run a
// thread in pass 1 (RUN), which cuts the block scan's full compositions a
// step; pass 3 keeps short runs (FilterSplit).
// ---------------------------------------------------------------------------

// The inputs of a step at o with lam constant: GeneralInO, and lam^-1 and
// log|det lam| for the log-likelihood, made when lam is read (prep).
template <typename T, int D, int O>
struct RankInO : GeneralInO<T, D, O> {
  T linv[O * O], log_det_lam;

  MF_DEV void prep() {
    T eye[O * O];
    set_eye<T, O>(eye);
    log_det_lam = log(fabs(gauss_jordan_solve<T, O, O>(this->lam, eye, linv)));
  }
};

// The site terms of a step at o from the predicted Pp and mp: ph = Pp H^T
// [d x o], hm = H mp, and site_solve's lz, r and W of S = H ph; returns
// det(I + lam S) up to its sign.
template <typename T, int D, int O>
MF_DEV T site_terms_o(const GeneralInO<T, D, O>& in, const T* pp, const T* mp, T* ph, T* hm,
                      T* lz, T* r, T* w) {
  T s[O * O];
  mm_nt<T, D, D, O>(pp, in.h, ph);
  mm<T, O, D, O>(in.h, ph, s);
  mm<T, O, D, 1>(in.h, mp, hm);
  return site_solve<T, O>(s, in.lam, in.nu, hm, lz, r, w);
}

// Pass 1 at o: fold_site with o x o sites.  With G = H F A [o x d] (the
// site's view of the state before the run):
//   Pp = sym(F C F^T + Q), mp = F b + c, ph = Pp H^T, lz, r, W (site_terms_o);
//   A <- F A - ph lz G, b <- mp + ph r, C <- Pp after the site in Joseph's
//   form (joseph_update), J <- J + G^T lz G, eta <- eta + G^T r.
template <typename T, int D, int O, bool TERMS = false>
MF_DEV void fold_site_o(FElem<T, D>& x, const GeneralInO<T, D, O>& in, T* terms = nullptr) {
  using E = FElem<T, D>;
  T *A = x.v + E::OA, *bb = x.v + E::OB, *C = x.v + E::OC, *J = x.v + E::OJ,
    *eta = x.v + E::OE;
  T fa[D * D], pp[D * D], mp[D], ph[D * O], hm[O], lz[O * O], r[O], w[O * O], g[O * D];
  {
    T fc[D * D];
    mm<T, D, D, D>(in.f, C, fc);
    mm_nt<T, D, D, D>(fc, in.f, pp);
  }
  add_to<T, D * D>(pp, in.q);
  sym<T, D>(pp);
  mm<T, D, D, D>(in.f, A, fa);
  mm<T, D, D, 1>(in.f, bb, mp);
  add_to<T, D>(mp, in.c);
  site_terms_o<T, D, O>(in, pp, mp, ph, hm, lz, r, w);
  mm<T, O, D, D>(in.h, fa, g);
  if constexpr (TERMS) {  // what fold_site_terms needs of the step: W, lz, ph, G
#pragma unroll
    for (int i = 0; i < O * O; ++i) {
      terms[i] = w[i];
      terms[O * O + i] = lz[i];
    }
#pragma unroll
    for (int i = 0; i < D * O; ++i) {
      terms[2 * O * O + i] = ph[i];
      terms[2 * O * O + D * O + i] = g[i];
    }
  }
  joseph_update<T, D, O>(pp, in.h, ph, w, in.lam, C);
  T pl[D * O], lg[O * D];
  mm<T, D, O, O>(ph, lz, pl);
  mm<T, O, O, D>(lz, g, lg);
  // A <- fa - pl g; J <- J + g^T lg over the upper triangle, mirrored
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = fa[i * D + j];
#pragma unroll
      for (int k = 0; k < O; ++k) acc -= pl[i * O + k] * g[k * D + j];
      A[i * D + j] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = i; j < D; ++j) {
      T acc = J[i * D + j];
#pragma unroll
      for (int k = 0; k < O; ++k) acc += g[k * D + i] * lg[k * D + j];
      J[i * D + j] = acc;
      J[j * D + i] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T bi = mp[i], ei = eta[i];
#pragma unroll
    for (int k = 0; k < O; ++k) {
      bi += ph[i * O + k] * r[k];
      ei += g[k * D + i] * r[k];
    }
    bb[i] = bi;
    eta[i] = ei;
  }
}

// fold_site_o where a pass folds most steps otherwise (kernel 1's rank-o
// route: the runs that hold step 0 or end short): from d = 4 a call, on
// copies of the run and the step, so that neither is kept in local memory
// for the rest of the pass.
template <typename T, int D, int O>
__device__ __noinline__ void fold_site_o_call(FElem<T, D>& x, const GeneralInO<T, D, O>& in) {
  fold_site_o<T, D, O>(x, in);
}

template <typename T, int D, int O>
MF_DEV void fold_site_o_aside(FElem<T, D>& run, const GeneralInO<T, D, O>& in) {
  if constexpr (D >= 4) {
    FElem<T, D> x = run;
    GeneralInO<T, D, O> g = in;
    fold_site_o_call<T, D, O>(x, g);
    run = x;
  } else {
    fold_site_o<T, D, O>(run, in);
  }
}

// fold_site_o's b and eta legs alone, from the step's terms (W, lz, ph, G,
// as fold_site_o<..., true> writes them) where the run's A, C and J legs
// do not depend on the data: mp = F b + c, r = W nu - lz H mp,
// b <- mp + ph r, eta <- eta + G^T r.
template <typename T, int D, int O>
MF_DEV void fold_site_terms(FElem<T, D>& x, const GeneralInO<T, D, O>& in, const T* terms) {
  using E = FElem<T, D>;
  const T *w = terms, *lz = terms + O * O, *ph = terms + 2 * O * O, *g = ph + D * O;
  T mp[D], hm[O], r[O];
  mm<T, D, D, 1>(in.f, x.v + E::OB, mp);
  add_to<T, D>(mp, in.c);
  mm<T, O, D, 1>(in.h, mp, hm);
#pragma unroll
  for (int i = 0; i < O; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < O; ++j) acc += w[i * O + j] * in.nu[j] - lz[i * O + j] * hm[j];
    r[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T bi = mp[i], ei = x.v[E::OE + i];
#pragma unroll
    for (int k = 0; k < O; ++k) {
      bi += ph[i * O + k] * r[k];
      ei += g[k * D + i] * r[k];
    }
    x.v[E::OB + i] = bi;
    x.v[E::OE + i] = ei;
  }
}

// Pass 3 at o: the Kalman step from the filtered moments (m, P) of the step
// before to this step's, in place (P in Joseph's form); returns the step's
// site log-likelihood (0 where masked) from the same solve: with
// e = lam^-1 nu - H mp (the observation less its prediction),
// (S + lam^-1)^-1 e = r and det(S + lam^-1) = det(I + lam S) / det(lam), so
//   ll = -(e^T r + log|det(I + lam S)| - log|det lam| + o log 2 pi) / 2.
template <typename T, int D, int O>
MF_DEV T kalman_step_o(T* m, T* P, const RankInO<T, D, O>& in) {
  T pp[D * D], mp[D], ph[D * O], hm[O], lz[O * O], r[O], w[O * O];
  {
    T fp[D * D];
    mm<T, D, D, D>(in.f, P, fp);
    mm_nt<T, D, D, D>(fp, in.f, pp);
  }
  add_to<T, D * D>(pp, in.q);
  sym<T, D>(pp);
  mm<T, D, D, 1>(in.f, m, mp);
  add_to<T, D>(mp, in.c);
  const T det = site_terms_o<T, D, O>(in, pp, mp, ph, hm, lz, r, w);
  joseph_update<T, D, O>(pp, in.h, ph, w, in.lam, P);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T mi = mp[i];
#pragma unroll
    for (int k = 0; k < O; ++k) mi += ph[i * O + k] * r[k];
    m[i] = mi;
  }
  if (!in.keep) return T(0);
  T quad = T(0);
#pragma unroll
  for (int i = 0; i < O; ++i) {
    T e = -hm[i];
#pragma unroll
    for (int j = 0; j < O; ++j) e += in.linv[i * O + j] * in.nu[j];
    quad += e * r[i];
  }
  return T(-0.5) * (quad + log(fabs(det)) - in.log_det_lam + T(O * 1.8378770664093453));
}

// Kernel 4 at o with lam constant: GeneralStepsO's slots and staging, the
// rank-o fold and Kalman step, and from d = 4 (where no step is staged)
// runs of 8 steps a thread in pass 1 (4 in pass 3, FilterSplit).
template <typename T_, int D_, int O_>
struct GeneralStepsRankO : GeneralStepsO<T_, D_, O_> {
  using T = T_;
  static constexpr int D = D_, O = O_;
  using Prior = GeneralPrior<T>;
  using In = RankInO<T, D, O>;
  static constexpr int RUN = D <= 3 ? Tiling<D>::R : 8;

  template <bool STAGED, int R>
  MF_DEV void read(In& in, const WarpStage<T, R>& st, const GeneralSlots& sl, int l, int r,
                   const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t k,
                   bool once) const {
    in.template read<STAGED>(st, sl, l, r, p, a, b, k, once);
    if (once) in.prep();
  }

  static MF_DEV void fold(FElem<T, D>& run, const In& in, bool) { fold_site_o<T, D, O>(run, in); }
  static MF_DEV T step(T* m, T* P, const In& in) { return kalman_step_o<T, D, O>(m, P, in); }
};

// The (d, o) pairs of GeneralStepsO that generalo_inst.cu instantiates
// (-DMF_D, -DMF_O, as ops/cuda_scan.py's _UNITS list them): o = 2..d.
#define MF_GENERAL_O_PAIRS(X)                                                      \
  X(2, 2) X(3, 2) X(3, 3) X(4, 2) X(4, 3) X(4, 4) X(5, 2) X(5, 3) X(5, 4) X(5, 5) \
  X(6, 2) X(6, 3) X(6, 4) X(6, 5) X(6, 6)

// switch over the instantiated (d, o) pairs of MF_GENERAL_O_PAIRS
#define MF_SWITCH_DO(d, o, EXPR_OF_DO, BAD) \
  switch ((d) * 8 + (o)) { \
    case 2 * 8 + 2: { constexpr int D_ = 2, O_ = 2; return EXPR_OF_DO; } \
    case 3 * 8 + 2: { constexpr int D_ = 3, O_ = 2; return EXPR_OF_DO; } \
    case 3 * 8 + 3: { constexpr int D_ = 3, O_ = 3; return EXPR_OF_DO; } \
    case 4 * 8 + 2: { constexpr int D_ = 4, O_ = 2; return EXPR_OF_DO; } \
    case 4 * 8 + 3: { constexpr int D_ = 4, O_ = 3; return EXPR_OF_DO; } \
    case 4 * 8 + 4: { constexpr int D_ = 4, O_ = 4; return EXPR_OF_DO; } \
    case 5 * 8 + 2: { constexpr int D_ = 5, O_ = 2; return EXPR_OF_DO; } \
    case 5 * 8 + 3: { constexpr int D_ = 5, O_ = 3; return EXPR_OF_DO; } \
    case 5 * 8 + 4: { constexpr int D_ = 5, O_ = 4; return EXPR_OF_DO; } \
    case 5 * 8 + 5: { constexpr int D_ = 5, O_ = 5; return EXPR_OF_DO; } \
    case 6 * 8 + 2: { constexpr int D_ = 6, O_ = 2; return EXPR_OF_DO; } \
    case 6 * 8 + 3: { constexpr int D_ = 6, O_ = 3; return EXPR_OF_DO; } \
    case 6 * 8 + 4: { constexpr int D_ = 6, O_ = 4; return EXPR_OF_DO; } \
    case 6 * 8 + 5: { constexpr int D_ = 6, O_ = 5; return EXPR_OF_DO; } \
    case 6 * 8 + 6: { constexpr int D_ = 6, O_ = 6; return EXPR_OF_DO; } \
    default: return BAD; \
  }

// prebuilt filtering elements, contiguous: A, C, J [B, d, d, N],
// b, eta [B, d, 1, N]
template <typename T>
struct FilterPrebuilt {
  const T *a, *b, *c, *j, *e;
};

// Kernel 6: prebuilt elements (A, b, C, J, eta), each value staged in the
// slot of its place in FElem; pass 3 puts m_f over the staged b and P_f
// over C.  No sites, no log-likelihood.
template <typename T_, int D_>
struct PrebuiltSteps {
  using T = T_;
  static constexpr int D = D_;
  using Prior = FilterPrebuilt<T>;
  using E = FElem<T, D>;
  using In = E;
  static constexpr bool LOGLIK = false;
  static constexpr int NV_IN = E::SIZE, NV = E::SIZE;
  static constexpr int P_OUT = E::OC, M_OUT = E::OB;

  MF_DEV void load(const Prior&, int64_t) {}

  static __host__ __device__ GeneralSlots slots(const Prior&, const FilterArgs<T>&, bool) {
    return {-1, -1, -1, -1, -1, -1, E::SIZE};
  }

  // value i of the matrices' and the vectors' rows of batch row b
  static MF_DEV const T* mat(const T* x, int64_t b, int i, int64_t n) {
    return x + (b * D * D + i) * n;
  }
  static MF_DEV const T* vec(const T* x, int64_t b, int i, int64_t n) {
    return x + (b * D + i) * n;
  }

  template <class G, bool OUTPUTS>
  MF_DEV void stage(const Prior& p, const FilterArgs<T>&, int64_t b, int64_t t, int64_t n,
                    WarpStage<T, G::R>& st, GeneralSlots& sl) const {
    if constexpr (G::STAGED) {
      sl.nv = E::SIZE;
      st.place(t, E::SIZE, n);
#pragma unroll
      for (int i = 0; i < D * D; ++i) {
        st.fetch(E::OA + i, mat(p.a, b, i, n), 1);
        st.fetch(E::OC + i, mat(p.c, b, i, n), 1);
        st.fetch(E::OJ + i, mat(p.j, b, i, n), 1);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        st.fetch(E::OB + i, vec(p.b, b, i, n), 1);
        st.fetch(E::OE + i, vec(p.e, b, i, n), 1);
      }
      wide_fetch_wait();
    }
  }

  template <bool STAGED, int R>
  MF_DEV void read(E& e, const WarpStage<T, R>& st, const GeneralSlots&, int l, int r,
                   const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t k, bool) const {
    if constexpr (STAGED) {
#pragma unroll
      for (int v = 0; v < E::SIZE; ++v) e.v[v] = *st.at(v, l, r);
    } else {
#pragma unroll
      for (int i = 0; i < D * D; ++i) {
        e.v[E::OA + i] = mat(p.a, b, i, a.n)[k];
        e.v[E::OC + i] = mat(p.c, b, i, a.n)[k];
        e.v[E::OJ + i] = mat(p.j, b, i, a.n)[k];
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        e.v[E::OB + i] = vec(p.b, b, i, a.n)[k];
        e.v[E::OE + i] = vec(p.e, b, i, a.n)[k];
      }
    }
  }

  // the run's first step is its element (one composition fewer)
  static MF_DEV void fold(E& run, const E& e, bool first) {
    if (first) {
      run = e;
      return;
    }
    E t;
    FilterOp<T, D>::combine(run, e, t);
    run = t;
  }

  // m <- A (I + P J)^-1 (m + P eta) + b, P <- sym(A (I + P J)^-1 P A^T + C)
  static MF_DEV T step(T* m, T* P, const E& e) {
    T m1[D], p1[D * D];
    filter_moments_through<T, D>(m, P, e, m1, p1);
#pragma unroll
    for (int i = 0; i < D; ++i) m[i] = m1[i];
#pragma unroll
    for (int i = 0; i < D * D; ++i) P[i] = p1[i];
    return T(0);
  }
};

// Pass 3's tiling, and pass 1's unless the source sets a longer run.
template <class Src>
using FilterTiling = StagedTiling<typename Src::T, Src::D, Src::NV>;

// A step source's run of steps a thread in pass 1: Src::RUN where it sets
// one, else pass 3's.
template <class Src, class = void>
struct RunOf {
  static constexpr int value = FilterTiling<Src>::R;
};
template <class Src>
struct RunOf<Src, std::void_t<decltype(Src::RUN)>> {
  static constexpr int value = Src::RUN;
};

// Pass 1's tiling: with a longer run (RUN) only the NV_IN values a step of
// pass 1 are staged, in blocks of at most pass 3's warps.  Its tile is BPB of
// pass 3's tiles, and each thread's run SUB of pass 3's threads' runs:
// pass 1 keeps its exclusive prefix and its run as it stood before each
// later pass-3 run, and each pass-3 thread carries the moments through
// both, so that pass 3 runs short runs (its steps' values read, and its
// outputs written, as at SUB = 1) while pass 1 folds long ones (fewer
// block-scan compositions a step).
constexpr int split_warps(int w3, int cap, int sub) {
  int w = w3 < cap ? w3 : cap;  // the most warps whose tile is whole pass-3 tiles
  while (w > 1 && (w * sub) % w3 != 0) --w;
  return w;
}

template <class Src>
using FilterTiling1 = std::conditional_t<
    RunOf<Src>::value == FilterTiling<Src>::R, FilterTiling<Src>,
    StagedTiling<typename Src::T, Src::D, Src::NV_IN, RunOf<Src>::value,
                 split_warps(FilterTiling<Src>::WARPS,
                             StagedTiling<typename Src::T, Src::D, Src::NV_IN,
                                          RunOf<Src>::value>::WARPS,
                             RunOf<Src>::value / FilterTiling<Src>::R)>>;

// Sources whose fold leaves the A, C and J legs to Src::finish(run, r)
// (r: the steps folded), and the values a batch row of their table holds
// (Src::TABLE; gfilter_table fills it before pass 1).
template <class Src, class = void>
struct FinishesRuns : std::false_type {};
template <class Src>
struct FinishesRuns<Src, std::void_t<decltype(&Src::template finish<0>)>> : std::true_type {};
template <class Src, class = void>
struct TableOf {
  static constexpr int value = 0;
};
template <class Src>
struct TableOf<Src, std::void_t<decltype(Src::TABLE)>> {
  static constexpr int value = Src::TABLE;
};

// The slot of pass-3 thread t's stored prefix among the pre of a row: with
// SUB > 1 the j-th of each pass-1 thread's SUB prefixes in the j-th run of
// pre / SUB slots, so that pass 1's lanes store to neighbouring slots.
template <int SUB>
MF_DEV int64_t prefix_slot(int64_t t, int64_t pre) {
  return SUB == 1 ? t : (t % SUB) * (pre / SUB) + t / SUB;
}

// Pass 1's tiling G1 against pass 3's G3: SUB pass-3 runs a pass-1 run,
// BPB pass-3 blocks a pass-1 block.
template <class G1, class G3>
struct RunSplit {
  static_assert(G1::R % G3::R == 0 && G1::TILE % G3::TILE == 0,
                "pass 1's runs and tile are whole pass-3 runs and tiles");
  static constexpr int SUB = G1::R / G3::R;
  static constexpr int BPB = int(G1::TILE / G3::TILE);
};

template <class Src>
using FilterSplit = RunSplit<FilterTiling1<Src>, FilterTiling<Src>>;

template <class Src>
__global__ void __launch_bounds__(FilterTiling1<Src>::THREADS)
gfilter_totals(FilterArgs<typename Src::T> a, typename Src::Prior p) {
  using T = typename Src::T;
  constexpr int D = Src::D;
  using G = FilterTiling1<Src>;
  using Op = FilterOp<T, D>;
  using E = FElem<T, D>;
  constexpr int THREADS = G::THREADS, R = G::R, SUB = FilterSplit<Src>::SUB, R3 = R / SUB;
  __shared__ E smem[THREADS / 32 + 1];
  const int64_t b = blockIdx.y, n = a.n, t = blockIdx.x * int64_t(THREADS) + threadIdx.x;
  const int64_t pre = a.nblk * THREADS * SUB;  // the stored prefixes of a row
  const int lane = lane_id();
  Src src;
  src.load(p, b);
  WarpStage<T, R> st;
  GeneralSlots sl{};
  src.template stage<G, false>(p, a, b, t, n, st, sl);
  E run, excl, total;
  Op::identity(run);
  typename Src::In in;
  int folded = 0;
  for (int r = 0; r < R; ++r) {
    if (t * R + r >= n) break;
    // the run so far: what comes before pass-3 run r / R3 within the run
    if (SUB > 1 && r > 0 && r % R3 == 0) {
      if constexpr (FinishesRuns<Src>::value) src.template finish<R3>(run, r);
      store_thread_elem(a.prefix, run, b, prefix_slot<SUB>(t * SUB + r / R3, pre), pre);
    }
    src.template read<G::STAGED>(in, st, sl, lane, r, p, a, b, t * R + r, r == 0);
    src.fold(run, in, r == 0);
    folded = r + 1;
  }
  if constexpr (FinishesRuns<Src>::value) src.template finish<R3>(run, folded);
  block_scan<Op, THREADS, false>(run, excl, total, smem);
  store_thread_elem(a.prefix, excl, b, prefix_slot<SUB>(t * SUB, pre), pre);
  if (threadIdx.x == 0) reinterpret_cast<E*>(a.totals)[b * a.nblk + blockIdx.x] = total;
}

template <class Src>
__global__ void __launch_bounds__(FilterTiling<Src>::THREADS)
gfilter_outputs(FilterArgs<typename Src::T> a, typename Src::Prior p) {
  using T = typename Src::T;
  constexpr int D = Src::D;
  using G = FilterTiling<Src>;
  using E = FElem<T, D>;
  constexpr int THREADS = G::THREADS, R = G::R, BPB = FilterSplit<Src>::BPB,
                SUB = FilterSplit<Src>::SUB;
  __shared__ T red[THREADS / 32];
  const int64_t b = blockIdx.y, n = a.n, t = blockIdx.x * int64_t(THREADS) + threadIdx.x;
  const int64_t pre = a.nblk * BPB * THREADS;  // the stored prefixes of a row
  const int lane = lane_id();
  // the moments before the thread's first step: all earlier blocks of pass
  // 1, then the earlier threads of this one (b = 0, C = 0 before step 0),
  // then, where SUB > 1, the earlier steps of its pass-1 thread's run
  T m[D], P[D * D];
  {
    E y;
    load_thread_elem(a.prefix, y, b, prefix_slot<SUB>(t - t % SUB, pre), pre);
    const E& x = reinterpret_cast<const E*>(a.totals)[b * a.nblk + blockIdx.x / BPB];
    filter_moments_through<T, D>(x.v + E::OB, x.v + E::OC, y, m, P);
    if (SUB > 1 && t % SUB != 0) {
      T m1[D], p1[D * D];
      load_thread_elem(a.prefix, y, b, prefix_slot<SUB>(t, pre), pre);
      filter_moments_through<T, D>(m, P, y, m1, p1);
#pragma unroll
      for (int i = 0; i < D; ++i) m[i] = m1[i];
#pragma unroll
      for (int i = 0; i < D * D; ++i) P[i] = p1[i];
    }
  }
  Src src;
  src.load(p, b);
  WarpStage<T, R> st;
  GeneralSlots sl{};
  src.template stage<G, true>(p, a, b, t, n, st, sl);
  T ll[1] = {T(0)};
  typename Src::In in;
  for (int r = 0; r < R; ++r) {
    const int64_t k = t * R + r;
    if (k >= n) break;
    src.template read<G::STAGED>(in, st, sl, lane, r, p, a, b, k, r == 0);
    ll[0] += src.step(m, P, in);
    // P_f and m_f to the step's staged slots, or to step k
    T *pf = G::STAGED ? st.at(Src::P_OUT, lane, r) : a.p_f + b * D * D * n + k,
      *mf = G::STAGED ? st.at(Src::M_OUT, lane, r) : a.m_f + b * D * n + k;
    const int64_t stride = G::STAGED ? 32 * R : n;
#pragma unroll
    for (int i = 0; i < D * D; ++i) pf[i * stride] = P[i];
#pragma unroll
    for (int i = 0; i < D; ++i) mf[i * stride] = m[i];
  }
  if constexpr (G::STAGED) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D * D; ++i) st.store(Src::P_OUT + i, a.p_f + (b * D * D + i) * n);
#pragma unroll
    for (int i = 0; i < D; ++i) st.store(Src::M_OUT + i, a.m_f + (b * D + i) * n);
  }
  if constexpr (Src::LOGLIK) {
    block_sum<T, THREADS, 1>(ll, red);
    if (threadIdx.x == 0) a.partials[b * a.nblk * BPB + blockIdx.x] = ll[0];
  }
}

// The source's table of batch row blockIdx.x (one thread a row).
template <class Src>
__global__ void __launch_bounds__(32) gfilter_table(FilterArgs<typename Src::T> a,
                                                    typename Src::Prior p) {
  if (threadIdx.x == 0) Src::build_table(a, p, blockIdx.x);
}

// Scratch of the filter passes in elements of T: pass 1's block totals,
// pass 3's partial sums, every pass-3 thread's in-block prefix and the
// source's table.
template <class Src>
int64_t general_filter_scratch(int64_t batch, int64_t n) {
  using G1 = FilterTiling1<Src>;
  constexpr int64_t BPB = FilterSplit<Src>::BPB;
  return batch * num_blocks(n, G1::TILE) *
             (FElem<typename Src::T, Src::D>::SIZE * (1 + BPB * FilterTiling<Src>::THREADS) + BPB) +
         batch * TableOf<Src>::value;
}

// The larger scratch of two step sources, for an entry point that takes
// either.
template <class S1, class S2>
int64_t general_filter_scratch_max(int64_t batch, int64_t n) {
  const int64_t a = general_filter_scratch<S1>(batch, n), b = general_filter_scratch<S2>(batch, n);
  return a > b ? a : b;
}

// Dynamic shared memory of a staged pass: nv values of 32 R steps a warp.
template <class G, typename T>
size_t general_stage_bytes(int nv) {
  return G::STAGED ? size_t(G::THREADS / 32) * nv * 32 * G::R * sizeof(T) : 0;
}

// pass_occupancy of passes 1, 3 and 2 (out[0..11]), staged for the most
// values a step of each pass.
template <class Src>
int general_filter_occupancy(int64_t* out) {
  using T = typename Src::T;
  using G = FilterTiling<Src>;
  using G1 = FilterTiling1<Src>;
  const size_t b1 = general_stage_bytes<G1, T>(Src::NV_IN), b3 = general_stage_bytes<G, T>(Src::NV);
  int err = wide_smem_bytes(gfilter_totals<Src>, b1);
  if (err == 0) err = wide_smem_bytes(gfilter_outputs<Src>, b3);
  if (err == 0) err = pass_occupancy(gfilter_totals<Src>, G1::THREADS, b1, out);
  if (err == 0) err = pass_occupancy(gfilter_outputs<Src>, G::THREADS, b3, out + 4);
  if (err == 0)
    err = pass_occupancy(scan_totals<FilterOp<T, Src::D>, G::SCAN_THREADS, false>,
                         G::SCAN_THREADS, 0, out + 8);
  return err;
}

template <class Src>
int launch_general_filter(FilterArgs<typename Src::T> a, typename Src::Prior p,
                          typename Src::T* scratch, int64_t batch, cudaStream_t stream) {
  using T = typename Src::T;
  using G = FilterTiling<Src>;
  using G1 = FilterTiling1<Src>;
  constexpr int SIZE = FElem<T, Src::D>::SIZE, BPB = FilterSplit<Src>::BPB;
  a.nblk = num_blocks(a.n, G1::TILE);
  const int64_t nblk3 = a.nblk * BPB;
  a.totals = scratch;
  a.partials = scratch + batch * a.nblk * SIZE;
  a.prefix = a.partials + batch * nblk3;
  a.table = a.prefix + batch * SIZE * nblk3 * G::THREADS;
  const size_t b1 = general_stage_bytes<G1, T>(Src::slots(p, a, false).nv),
               b3 = general_stage_bytes<G, T>(Src::slots(p, a, true).nv);
  int err = wide_smem_bytes(gfilter_totals<Src>, b1);
  if (err == 0) err = wide_smem_bytes(gfilter_outputs<Src>, b3);
  if (err != 0) return err;
  if constexpr (TableOf<Src>::value > 0) {
    gfilter_table<Src><<<unsigned(batch), 32, 0, stream>>>(a, p);
    MF_CHECK_LAUNCH();
  }
  gfilter_totals<Src><<<dim3(unsigned(a.nblk), unsigned(batch)), G1::THREADS, b1, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  scan_totals<FilterOp<T, Src::D>, G::SCAN_THREADS, false>
      <<<unsigned(batch), G::SCAN_THREADS, 0, stream>>>(
      reinterpret_cast<FElem<T, Src::D>*>(a.totals), a.nblk);
  MF_CHECK_LAUNCH();
  gfilter_outputs<Src><<<dim3(unsigned(nblk3), unsigned(batch)), G::THREADS, b3, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  if constexpr (Src::LOGLIK) {
    sum_partials<T, 256><<<dim3(1u, unsigned(batch)), 256, 0, stream>>>(
        a.partials, nblk3, 1, nullptr, a.loglik);
    MF_CHECK_LAUNCH();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The d = 1..6 RTS smoother passes, with the elements in registers and a
// run of R consecutive steps a thread, over a step source: UniformRtsRow
// (kernel 2, uniform_scan.cuh) and PrebuiltRts (kernel 5, below).
//   1. each thread takes the element of each of its steps (Src::elem),
//      from the warp's stage with Src::STAGE_TOTALS where the steps are
//      staged (below), else from where the step's values lie, and folds
//      them, last first, with the full composition (SmootherOp: pass 2
//      needs the E leg); the block scan gives every thread its exclusive
//      in-block suffix, which goes to the scratch (store_thread_elem), and
//      the block total.  Kernel 2 reads its d^2 + d values a step where
//      they lie: a thread's R steps of a value share their sectors, which
//      stay in L1 (staged, it was as fast at d = 2 and slower at d = 6).
//      Kernel 5's 2 d^2 + d outgrow L1 that way (0.052 ms against 0.025
//      staged at d = 2, N = 1e6; PERF.md);
//   2. scan_totals (scan_core.cuh) over Tiling<D>'s block;
//   3. where a warp's steps are at most 6,144 values (StagedTiling::STAGED:
//      kernel 2 every d <= 6, kernel 5 to d = 4), each warp stages the
//      Src::NV values of its 32 R steps (Src::stage); each thread composes
//      the g and L legs of its stored suffix with its block's carry
//      (smoother_gl): the smoothed moments after its last step; then, last
//      step first, it takes each step's element from the stage (Src::elem
//      again), or where it lies when not staged, and carries only the
//      moments, m_s = g + E m_s, P_s = sym(E P_s E^T + L) (smoother_gl
//      again), written to the step's slots Src::P_OUT and Src::M_OUT (values
//      the lane has read), which the warp then stores, or to step k.
// Pass 3 thus neither rebuilds the in-block suffix nor composes the E leg.
// ---------------------------------------------------------------------------

template <class Src>
using RtsTiling = StagedTiling<typename Src::T, Src::D, Src::NV>;

template <class Src>
__global__ void __launch_bounds__(RtsTiling<Src>::THREADS)
rts_totals(SmootherArgs<typename Src::T> a, typename Src::Prior p) {
  using T = typename Src::T;
  using G = RtsTiling<Src>;
  using Op = SmootherOp<T, Src::D>;
  using E = SElem<T, Src::D>;
  constexpr int THREADS = G::THREADS, R = G::R;
  __shared__ E smem[THREADS / 32 + 1];
  const int64_t b = blockIdx.y, n = a.n, t = blockIdx.x * int64_t(THREADS) + threadIdx.x;
  Src src;
  src.load(p, b);
  WarpStage<T, R> st;
  if constexpr (G::STAGED && Src::STAGE_TOTALS) src.stage(p, b, t, n, st);
  E run, excl, total;
  Op::identity(run);
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int64_t k = t * R + r;
    if (k >= n) continue;
    E e, u;
    if constexpr (G::STAGED && Src::STAGE_TOTALS) src.elem(st, lane_id(), r, k, n, e);
    else src.elem(p, b, k, n, e);
    Op::combine(e, run, u);
    run = u;
  }
  block_scan<Op, THREADS, true>(run, excl, total, smem);
  store_thread_elem(a.prefix, excl, b, t, a.nblk * THREADS);
  if (threadIdx.x == 0) reinterpret_cast<E*>(a.totals)[b * a.nblk + blockIdx.x] = total;
}

template <class Src>
__global__ void __launch_bounds__(RtsTiling<Src>::THREADS)
rts_outputs(SmootherArgs<typename Src::T> a, typename Src::Prior p) {
  using T = typename Src::T;
  constexpr int D = Src::D;
  using G = RtsTiling<Src>;
  using E = SElem<T, D>;
  constexpr int THREADS = G::THREADS, R = G::R;
  const int64_t b = blockIdx.y, n = a.n, t = blockIdx.x * int64_t(THREADS) + threadIdx.x;
  const int lane = lane_id();
  // the smoothed moments after the thread's last step: the later threads
  // of this block, then all later blocks
  T ms[D], ps[D * D];
  {
    E x;
    load_thread_elem(a.prefix, x, b, t, a.nblk * THREADS);
    const E& c = reinterpret_cast<const E*>(a.totals)[b * a.nblk + blockIdx.x];
    smoother_gl<T, D>(x.v + E::OE, x.v + E::OG, x.v + E::OL, c.v + E::OG, c.v + E::OL, ms, ps);
  }
  Src src;
  src.load(p, b);
  WarpStage<T, R> st;
  if constexpr (G::STAGED) src.stage(p, b, t, n, st);
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int64_t k = t * R + r;
    if (k >= n) continue;
    E e;
    if constexpr (G::STAGED) src.elem(st, lane, r, k, n, e);
    else src.elem(p, b, k, n, e);
    T mk[D], pk[D * D];
    smoother_gl<T, D>(e.v + E::OE, e.v + E::OG, e.v + E::OL, ms, ps, mk, pk);
    // m_s and P_s to the step's staged slots, or to step k
    if constexpr (G::STAGED) {
#pragma unroll
      for (int i = 0; i < D; ++i) ms[i] = *st.at(Src::M_OUT + i, lane, r) = mk[i];
#pragma unroll
      for (int i = 0; i < D * D; ++i) ps[i] = *st.at(Src::P_OUT + i, lane, r) = pk[i];
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) ms[i] = a.m_s[(b * D + i) * n + k] = mk[i];
#pragma unroll
      for (int i = 0; i < D * D; ++i) ps[i] = a.p_s[(b * D * D + i) * n + k] = pk[i];
    }
  }
  if constexpr (G::STAGED) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D * D; ++i) st.store(Src::P_OUT + i, a.p_s + (b * D * D + i) * n);
#pragma unroll
    for (int i = 0; i < D; ++i) st.store(Src::M_OUT + i, a.m_s + (b * D + i) * n);
  }
}

// Scratch of the RTS smoother passes in elements of T: the block totals
// and every thread's in-block suffix.
template <class Src>
int64_t rts_scratch(int64_t batch, int64_t n) {
  using G = RtsTiling<Src>;
  return batch * num_blocks(n, G::TILE) * SElem<typename Src::T, Src::D>::SIZE * (1 + G::THREADS);
}

// Dynamic shared memory of passes 1 and 3.
template <class Src>
void rts_stage_bytes(size_t* bytes) {
  bytes[1] = general_stage_bytes<RtsTiling<Src>, typename Src::T>(Src::NV);
  bytes[0] = Src::STAGE_TOTALS ? bytes[1] : 0;
}

// pass_occupancy of passes 1, 3 and 2 (out[0..11]).
template <class Src>
int rts_occupancy(int64_t* out) {
  using T = typename Src::T;
  using G = RtsTiling<Src>;
  size_t bytes[2];
  rts_stage_bytes<Src>(bytes);
  int err = wide_smem_bytes(rts_totals<Src>, bytes[0]);
  if (err == 0) err = wide_smem_bytes(rts_outputs<Src>, bytes[1]);
  if (err == 0) err = pass_occupancy(rts_totals<Src>, G::THREADS, bytes[0], out);
  if (err == 0) err = pass_occupancy(rts_outputs<Src>, G::THREADS, bytes[1], out + 4);
  if (err == 0)
    err = pass_occupancy(scan_totals<SmootherOp<T, Src::D>, Tiling<Src::D>::THREADS, true>,
                         Tiling<Src::D>::THREADS, 0, out + 8);
  return err;
}

template <class Src>
int launch_rts(SmootherArgs<typename Src::T> a, typename Src::Prior p, typename Src::T* scratch,
               int64_t batch, cudaStream_t stream) {
  using T = typename Src::T;
  constexpr int D = Src::D;
  using G = RtsTiling<Src>;
  a.nblk = num_blocks(a.n, G::TILE);
  a.totals = scratch;
  a.prefix = scratch + batch * a.nblk * SElem<T, D>::SIZE;
  size_t bytes[2];
  rts_stage_bytes<Src>(bytes);
  int err = wide_smem_bytes(rts_totals<Src>, bytes[0]);
  if (err == 0) err = wide_smem_bytes(rts_outputs<Src>, bytes[1]);
  if (err != 0) return err;
  const dim3 grid(unsigned(a.nblk), unsigned(batch));
  rts_totals<Src><<<grid, G::THREADS, bytes[0], stream>>>(a, p);
  MF_CHECK_LAUNCH();
  scan_totals<SmootherOp<T, D>, Tiling<D>::THREADS, true>
      <<<unsigned(batch), Tiling<D>::THREADS, 0, stream>>>(
      reinterpret_cast<SElem<T, D>*>(a.totals), a.nblk);
  MF_CHECK_LAUNCH();
  rts_outputs<Src><<<grid, G::THREADS, bytes[1], stream>>>(a, p);
  MF_CHECK_LAUNCH();
  return 0;
}

// Kernel 5: prebuilt smoothing elements (Prebuilt, wide_scan.cuh), the
// RTS elements of the general smoother with the last step's boundary
// element (0, m, P) among them.  2 d^2 + d values a step, staged E, then L,
// then g, in passes 1 and 3, so that pass 3 puts P_s over the staged L and
// m_s over g: to d = 4; at d = 5 and 6 both read each step where it lies.
template <typename T_, int D_>
struct PrebuiltRts {
  using T = T_;
  static constexpr int D = D_;
  using Prior = Prebuilt<T>;
  using E = SElem<T, D>;
  static constexpr int NV = 2 * D * D + D;
  static constexpr int P_OUT = D * D, M_OUT = 2 * D * D;  // the staged L and g
  static constexpr bool STAGE_TOTALS = true;

  MF_DEV void load(const Prior&, int64_t) {}

  // Thread t's warp's stage of the elements of its steps of batch row b,
  // started and waited for.  Every lane of the warp must call it.
  template <int R>
  MF_DEV void stage(const Prior& a, int64_t b, int64_t t, int64_t n, WarpStage<T, R>& st) const {
    st.place(t, NV, n);
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      st.fetch(i, a.e + (b * D * D + i) * n, 1);
      st.fetch(P_OUT + i, a.l + (b * D * D + i) * n, 1);
    }
#pragma unroll
    for (int i = 0; i < D; ++i) st.fetch(M_OUT + i, a.g + (b * D + i) * n, 1);
    wide_fetch_wait();
  }

  // The element of global step k where it lies
  MF_DEV void elem(const Prior& a, int64_t b, int64_t k, int64_t n, E& out) const {
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      out.v[E::OE + i] = a.e[(b * D * D + i) * n + k];
      out.v[E::OL + i] = a.l[(b * D * D + i) * n + k];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) out.v[E::OG + i] = a.g[(b * D + i) * n + k];
  }

  // The element of lane l's step r from its stage
  template <int R>
  MF_DEV void elem(const WarpStage<T, R>& st, int l, int r, int64_t, int64_t, E& out) const {
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      out.v[E::OE + i] = *st.at(i, l, r);
      out.v[E::OL + i] = *st.at(P_OUT + i, l, r);
    }
#pragma unroll
    for (int i = 0; i < D; ++i) out.v[E::OG + i] = *st.at(M_OUT + i, l, r);
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
struct WidePrebuiltRts : WideReadRow<T_> {
  using Prior = Prebuilt<T_>;

  static MF_DEV WideRows<const T_*> rows(const Prior& a, int d) {
    return wide_element_rows(a, d);
  }
};

template <typename T_>
struct WidePrebuiltSteps {
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
// Q and H as F, then the sites as set_site_strides takes them; its output
// dim o is 1 or, at d <= 6, one of MF_GENERAL_O_PAIRS (GeneralStepsRankO
// where lam's step stride is 0, else GeneralStepsO) or o > d
// (GeneralStepsW, info_scan.cuh), or at d = 7..12 2..12
// (launch_wide_info_filter, wide_info.cuh; entry_points.cu includes both).
#define MF_DEFINE_GENERAL_ENTRY_POINTS(T, SUFFIX)                                      \
  extern "C" int mf_general_filter_##SUFFIX(                                           \
      const T* f, const T* c, const T* q, const T* h, const T* nu, const T* lam,       \
      const T* mask, const int64_t* st, T* m_f, T* p_f, T* loglik, T* scratch,         \
      int64_t batch, int64_t n, int64_t d, int64_t o, void* stream) {                  \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::GeneralPrior<T> p{f, c, q, h,                                                  \
                          st[0], st[1], st[2], st[3],                                  \
                          st[4], st[5], st[6],                                         \
                          st[7], st[8], st[9], st[10],                                 \
                          st[11], st[12], st[13], st[14]};                             \
    mf::FilterArgs<T> a{};                                                             \
    a.nu = nu; a.lam = lam; a.mask = mask;                                             \
    mf::set_site_strides(a, st + 15);                                                  \
    a.m_f = m_f; a.p_f = p_f; a.loglik = loglik; a.n = n; a.o = o;                     \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (o != 1 && d >= mf::WIDE_MIN_D)                                                 \
      return mf::launch_wide_info_filter<T>(a, p, scratch, batch, int(d), s);          \
    if (o > d)                                                                         \
      MF_SWITCH_D(d, (mf::launch_general_filter<mf::GeneralStepsW<T, D_>>(a, p, scratch,  \
                                                                        batch, s)),    \
                  int(cudaErrorInvalidValue))                                          \
    if (o != 1 && a.lam_st == 0)                                                       \
      MF_SWITCH_DO(d, o, (mf::launch_general_filter<mf::GeneralStepsRankO<T, D_, O_>>(  \
                             a, p, scratch, batch, s)),                                \
                   int(cudaErrorInvalidValue))                                         \
    if (o != 1)                                                                        \
      MF_SWITCH_DO(d, o, (mf::launch_general_filter<mf::GeneralStepsO<T, D_, O_>>(      \
                             a, p, scratch, batch, s)),                                \
                   int(cudaErrorInvalidValue))                                         \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_filter<mf::WideGeneralRow<T>>(a, p, scratch, batch, int(d), \
                                                           s);                         \
    MF_SWITCH_D(d, (mf::launch_general_filter<mf::GeneralSteps<T, D_>>(a, p, scratch,   \
                                                                       batch, s)),     \
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
      return mf::launch_wide_smoother<mf::WidePrebuiltRts<T>>(a, p, scratch, batch,    \
                                                              int(d), s);              \
    MF_SWITCH_D(d, (mf::launch_rts<mf::PrebuiltRts<T, D_>>(a, p, scratch, batch, s)),  \
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
      return mf::launch_wide_filter<mf::WidePrebuiltSteps<T>>(a, p, scratch, batch,    \
                                                              int(d), s);              \
    MF_SWITCH_D(d, (mf::launch_general_filter<mf::PrebuiltSteps<T, D_>>(a, p, scratch,  \
                                                                        batch, s)),    \
                int(cudaErrorInvalidValue))                                            \
  }
