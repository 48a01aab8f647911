// Kernels 4, 1, 7 and 3 at output dims o > d (d <= 6) for Hopper (sm_90a):
// the step sources GeneralStepsW (kernel 4, general_scan.cuh's filter
// passes), UniformStepsW (kernel 1), GeneralAdjStepsW (kernel 7,
// general_adjoint.cuh's Koopman backward passes) and UniformAdjStepsW
// (kernel 3), with o a run-time bound: one unit per (dtype, d), not per
// (dtype, d, o).  GP factor analysis feeds them: many outputs driven by a
// few latent processes (kernels.FactorAnalysisKernel), H = A(t) B H_inner
// [o x d] changing with the step, one full noise precision.  The TPU
// kernels (markovflow_tpu/ops/pallas_scan.py) take o <= 12 in kernels 4
// and 7 (pick_scan_engine) and o <= 6 in kernels 1 and 3 (_uniform_engine);
// the plain PyTorch versions (filter_pipeline_plain and the others) work
// in o space at any o.
//
// Each step's o x o site is folded into state space inside the kernel, by
// loops over o at run time (info_js, info_hs):
//   J = H^T lam H [d x d],  h = H^T nu [d],
// and the update works in d space.  With M = I + Pp J (its eigenvalues
// are >= 1 for a definite lam) and X = M^-1 Pp,
//   P = X M^-T + X J X^T  (Joseph's form: (I - K H) = M^-1 and
//                          K lam^-1 K^T = X J X^T),
//   m = mp + X v,  v = h - J mp,
// the filtering element's A = M^-1 F A, J_el += (F A)^T J M^-1 (F A) and
// eta += (F A)^T M^-T v (info_fold), and the Koopman element
// L_k = F_{k+1} M^-1, H^T e = M^-T (h - J a), H^T W H = sym(J M^-1)
// (GadjStage1W): a d x d pivoted inverse a step in place of an o x o one.
// The log-likelihood's o-space scalars (info_step): by the determinant
// lemma log|det(lam^-1 + H Pp H^T)| = log|det M| - log|det lam|, and by
// Woodbury the quadratic form is e^T lam e - v^T X v with e = lam^-1 nu -
// H mp, the residual itself (not nu^T lam^-1 nu - ..., whose terms cancel
// in float32 where the noise is small); lam^-1 nu and log|det lam| by a
// pivoted elimination at run-time o (gj_solve_rt, in local memory), once
// a thread where lam's step stride is 0 (GPR), else at each step.  The
// Koopman backward's observation terms (gH [o x d], gnu, glam) loop over
// o the same way (info_obs).  Every step is read where it lies (no
// stage): a simple design, not tuned (PERF.md has the times).
//
// What bounds them on an H100: not bytes (kernel 4 at (6, 12) reads ~800 B
// a step, a 0.24 ms floor at N = 1e6, float32), but a step's arithmetic in
// both passes (J and h: 2 d o (o + d) operations, ~1.7k at (6, 12); the
// fold or the Kalman step: a d x d inverse and some ten d^3 products, ~4k;
// the block scan's compositions in pass 1), at 255 registers with the
// run-time-o arrays (lam^-1, y) in local memory; and pass 2's one block.
#pragma once

#include "adjoint_scan.cuh"

namespace mf {

// The most outputs of these sources (GENERAL_MAX_OUTPUT_DIM in
// ops/cuda_scan.py), and of the uniform ones (UNIFORM_MAX_OUTPUT_DIM).
constexpr int INFO_MAX_O = 12;
constexpr int INFO_UNIFORM_MAX_O = 6;

// Pivoted Gauss-Jordan elimination at run-time size: a [o x o] (row
// stride o), b [o x kc] (row stride kc), in place: b <- a^-1 b (a is
// destroyed).  Returns log|det a|.
template <typename T>
MF_DEV T gj_solve_rt(T* a, T* b, int o, int kc) {
  T logdet = T(0);
  for (int j = 0; j < o; ++j) {
    int piv = j;
    T best = fabs(a[j * o + j]);
    for (int i = j + 1; i < o; ++i) {
      const T v = fabs(a[i * o + j]);
      if (v > best) {
        best = v;
        piv = i;
      }
    }
    if (piv != j) {
      for (int c = j; c < o; ++c) {
        const T x = a[j * o + c];
        a[j * o + c] = a[piv * o + c];
        a[piv * o + c] = x;
      }
      for (int c = 0; c < kc; ++c) {
        const T x = b[j * kc + c];
        b[j * kc + c] = b[piv * kc + c];
        b[piv * kc + c] = x;
      }
    }
    const T p = a[j * o + j];
    logdet += log(fabs(p));
    const T r = T(1) / p;
    for (int c = j; c < o; ++c) a[j * o + c] *= r;
    for (int c = 0; c < kc; ++c) b[j * kc + c] *= r;
    for (int i = 0; i < o; ++i) {
      if (i == j) continue;
      const T f = a[i * o + j];
      for (int c = j; c < o; ++c) a[i * o + c] -= f * a[j * o + c];
      for (int c = 0; c < kc; ++c) b[i * kc + c] -= f * b[j * kc + c];
    }
  }
  return logdet;
}

// H of a step: entry (i, j) at p[i * si + j * sj].
template <typename T>
struct Rows {
  const T* p;
  int64_t si, sj;
  MF_DEV T operator()(int i, int j) const { return p[i * si + j * sj]; }
};

// The sites of step k of batch row b, through A's site fields (FilterArgs
// or a Koopman backward's prior): nu_i and lam_ij.
template <typename T, class A>
MF_DEV T site_nu(const A& a, int64_t b, int64_t k, int i) {
  return a.nu[b * a.nu_sb + i * a.nu_si + k * a.nu_st];
}
template <typename T, class A>
MF_DEV T site_lam(const A& a, int64_t b, int64_t k, int i, int j) {
  return a.lam[b * a.lam_sb + i * a.lam_si + j * a.lam_sj + k * a.lam_st];
}

// hs = H^T nu [d] of step k
template <typename T, int D, class A>
MF_DEV void info_hs(const Rows<T>& h, const A& a, int64_t b, int64_t k, int o, T* hs) {
#pragma unroll
  for (int j = 0; j < D; ++j) hs[j] = T(0);
  for (int i = 0; i < o; ++i) {
    const T v = site_nu<T>(a, b, k, i);
#pragma unroll
    for (int j = 0; j < D; ++j) hs[j] += h(i, j) * v;
  }
}

// js = sym(H^T lam H) [d x d] of step k
template <typename T, int D, class A>
MF_DEV void info_js(const Rows<T>& h, const A& a, int64_t b, int64_t k, int o, T* js) {
#pragma unroll
  for (int i = 0; i < D * D; ++i) js[i] = T(0);
  for (int i = 0; i < o; ++i) {
    T t[D];
#pragma unroll
    for (int j = 0; j < D; ++j) t[j] = T(0);
    for (int l = 0; l < o; ++l) {
      const T v = site_lam<T>(a, b, k, i, l);
#pragma unroll
      for (int j = 0; j < D; ++j) t[j] += v * h(l, j);
    }
    T hi[D];
#pragma unroll
    for (int j = 0; j < D; ++j) hi[j] = h(i, j);
#pragma unroll
    for (int r = 0; r < D; ++r) {
#pragma unroll
      for (int c = 0; c < D; ++c) js[r * D + c] += hi[r] * t[c];
    }
  }
  sym<T, D>(js);
}

// lam of step k in local memory: y = lam^-1 nu [o] and, where linv is
// not null, lam^-1 [o x o]; returns log|det lam|.
template <typename T, class A>
MF_DEV T info_lam_solve(const A& a, int64_t b, int64_t k, int o, T* y, T* linv) {
  T m[INFO_MAX_O * INFO_MAX_O], r[INFO_MAX_O * (INFO_MAX_O + 1)];
  const int kc = linv != nullptr ? o + 1 : 1;
  for (int i = 0; i < o; ++i) {
    for (int j = 0; j < o; ++j) m[i * o + j] = site_lam<T>(a, b, k, i, j);
    for (int j = 0; j + 1 < kc; ++j) r[i * kc + j] = T(i == j);
    r[i * kc + kc - 1] = site_nu<T>(a, b, k, i);
  }
  const T ld = gj_solve_rt<T>(m, r, o, kc);
  for (int i = 0; i < o; ++i) {
    y[i] = r[i * kc + kc - 1];
    if (linv != nullptr) {
      for (int j = 0; j < o; ++j) linv[i * o + j] = r[i * kc + j];
    }
  }
  return ld;
}

// lam^-1 nu of step k from a lam^-1 made once (lam of step stride 0)
template <typename T, class A>
MF_DEV void info_y(const T* linv, const A& a, int64_t b, int64_t k, int o, T* y) {
  for (int i = 0; i < o; ++i) {
    T acc = T(0);
    for (int j = 0; j < o; ++j) acc += linv[i * o + j] * site_nu<T>(a, b, k, j);
    y[i] = acc;
  }
}

// The inputs of a step in state space: the prior step (F, Q, c), the
// site's J = H^T lam H and h = H^T nu, the mask, and where H lies (for
// the likelihood and the observation terms).
template <typename T, int D>
struct InfoIn {
  T f[D * D], q[D * D], c[D], js[D * D], hs[D];
  bool keep;
  int64_t k;
  Rows<T> hv;
  const T* h = nullptr;  // (no row-one emission: gadjoint_fold's argument)
};

// What these sources keep of lam where its step stride is 0: lam^-1 and
// log|det lam|, made once a thread (ready), and J where H is also
// constant.
template <typename T, int D>
struct LamOnce {
  T linv[INFO_MAX_O * INFO_MAX_O];
  T ldl;
  T js[D * D];
  bool ready = false, js_ready = false;

  template <class A>
  MF_DEV void prepare(const A& a, int64_t b, int o) {
    if (ready) return;
    T y[INFO_MAX_O];
    ldl = info_lam_solve<T>(a, b, 0, o, y, linv);
    ready = true;
  }
};

// The site terms of step k into in: h always, J once where H and lam do
// not change with the step (hconst), else at each step.
template <typename T, int D, class A>
MF_DEV void info_site_terms(InfoIn<T, D>& in, LamOnce<T, D>& once, bool hconst, const A& a,
                            int64_t b, int64_t k, int o) {
  info_hs<T, D>(in.hv, a, b, k, o, in.hs);
  if (hconst && a.lam_st == 0) {
    if (!once.js_ready) {
      info_js<T, D>(in.hv, a, b, k, o, once.js);
      once.js_ready = true;
    }
#pragma unroll
    for (int i = 0; i < D * D; ++i) in.js[i] = once.js[i];
  } else {
    info_js<T, D>(in.hv, a, b, k, o, in.js);
  }
  in.keep = a.mask == nullptr || a.mask[b * a.mask_sb + k * a.mask_st] > T(0.5);
}

// M = I + pp js, its inverse minv and X = minv pp; returns log|det M|.
template <typename T, int D>
MF_DEV T info_gain(const T* pp, const T* js, T* minv, T* x) {
  T mt[D * D], eye[D * D];
  mm<T, D, D, D>(pp, js, mt);
  add_eye<T, D>(mt);
  set_eye<T, D>(eye);
  const T det = gauss_jordan_solve<T, D, D>(mt, eye, minv);
  mm<T, D, D, D>(minv, pp, x);
  return log(fabs(det));
}

// The predicted moments pp = sym(F P F^T + Q), mp = F m + c
template <typename T, int D>
MF_DEV void info_predict(const InfoIn<T, D>& in, const T* m, const T* P, T* pp, T* mp) {
  T fp[D * D];
  mm<T, D, D, D>(in.f, P, fp);
  mm_nt<T, D, D, D>(fp, in.f, pp);
  add_to<T, D * D>(pp, in.q);
  sym<T, D>(pp);
  mm<T, D, D, 1>(in.f, m, mp);
  add_to<T, D>(mp, in.c);
}

// v = h - J mp
template <typename T, int D>
MF_DEV void info_resid(const InfoIn<T, D>& in, const T* mp, T* v) {
  T jm[D];
  mm<T, D, D, 1>(in.js, mp, jm);
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = in.hs[i] - jm[i];
}

// The covariance after the site in Joseph's form: c = sym(x minv^T + x J x^T)
template <typename T, int D>
MF_DEV void info_joseph(const T* x, const T* minv, const T* js, T* c) {
  T t1[D * D], t2[D * D], t3[D * D];
  mm_nt<T, D, D, D>(x, minv, t1);
  mm<T, D, D, D>(x, js, t2);
  mm_nt<T, D, D, D>(t2, x, t3);
#pragma unroll
  for (int i = 0; i < D * D; ++i) c[i] = t1[i] + t3[i];
  sym<T, D>(c);
}

// Pass 1: the step folded into the run (A, b, C, J, eta), the element of
// the steps so far given the state before them, as a conditional Kalman
// step (fold_site_o) in state space.  With fa = F A, pp = sym(F C F^T +
// Q), mp = F b + c, M = I + pp J, X = M^-1 pp, v = h - J mp:
//   A <- M^-1 fa, b <- mp + X v, C <- Joseph (info_joseph),
//   J_el <- J_el + sym(fa^T J M^-1 fa), eta <- eta + fa^T M^-T v.
template <typename T, int D>
MF_DEV void info_fold(FElem<T, D>& x, const InfoIn<T, D>& in) {
  using E = FElem<T, D>;
  T *A = x.v + E::OA, *bb = x.v + E::OB, *C = x.v + E::OC, *J = x.v + E::OJ,
    *eta = x.v + E::OE;
  T fa[D * D], pp[D * D], mp[D], minv[D * D], xg[D * D], v[D];
  mm<T, D, D, D>(in.f, A, fa);
  info_predict<T, D>(in, bb, C, pp, mp);
  info_gain<T, D>(pp, in.js, minv, xg);
  info_resid<T, D>(in, mp, v);
  mm<T, D, D, D>(minv, fa, A);
  T xv[D];
  mm<T, D, D, 1>(xg, v, xv);
#pragma unroll
  for (int i = 0; i < D; ++i) bb[i] = mp[i] + xv[i];
  info_joseph<T, D>(xg, minv, in.js, C);
  T y[D * D], t[D * D], u[D * D], w[D], e[D];
  mm<T, D, D, D>(in.js, minv, y);
  mm<T, D, D, D>(y, fa, t);
  mm_tn<T, D, D, D>(fa, t, u);
  sym<T, D>(u);
  add_to<T, D * D>(J, u);
  mm_tn<T, D, D, 1>(minv, v, w);
  mm_tn<T, D, D, 1>(fa, w, e);
  add_to<T, D>(eta, e);
}

// Pass 3: the Kalman step from the filtered moments (m, P) of the step
// before to this step's, in place; returns the step's log-likelihood (0
// where masked) from lam^-1 nu = y and log|det lam| = ldl:
//   ll = -(e^T lam e - v^T X v + log|det M| - ldl + o log 2 pi) / 2,
//   e = y - H mp.
template <typename T, int D, class A>
MF_DEV T info_step(T* m, T* P, const InfoIn<T, D>& in, const T* y, T ldl, const A& a,
                   int64_t b, int o) {
  T pp[D * D], mp[D], minv[D * D], xg[D * D], v[D];
  info_predict<T, D>(in, m, P, pp, mp);
  const T ldm = info_gain<T, D>(pp, in.js, minv, xg);
  info_resid<T, D>(in, mp, v);
  T xv[D];
  mm<T, D, D, 1>(xg, v, xv);
#pragma unroll
  for (int i = 0; i < D; ++i) m[i] = mp[i] + xv[i];
  info_joseph<T, D>(xg, minv, in.js, P);
  if (!in.keep) return T(0);
  T e[INFO_MAX_O];
  for (int i = 0; i < o; ++i) {
    T acc = y[i];
#pragma unroll
    for (int j = 0; j < D; ++j) acc -= in.hv(i, j) * mp[j];
    e[i] = acc;
  }
  T quad = T(0);
  for (int i = 0; i < o; ++i) {
    T acc = T(0);
    for (int j = 0; j < o; ++j) acc += site_lam<T>(a, b, in.k, i, j) * e[j];
    quad += e[i] * acc;
  }
  quad -= dot<T, D>(v, xv);
  return T(-0.5) * (quad + ldm - ldl + T(o) * T(1.8378770664093453));
}

// lam^-1 nu and log|det lam| of step k: from what is kept once where lam's
// step stride is 0, else by an elimination at the step.
template <typename T, int D, class A>
MF_DEV T info_lam_terms(LamOnce<T, D>& once, const A& a, int64_t b, int64_t k, int o, T* y) {
  if (a.lam_st == 0) {
    once.prepare(a, b, o);
    info_y<T>(once.linv, a, b, k, o, y);
    return once.ldl;
  }
  return info_lam_solve<T>(a, b, k, o, y, nullptr);
}

// Kernel 4 at o > d: per-step F, Q, c, H and the sites through their
// strides, read where they lie.
template <typename T_, int D_>
struct GeneralStepsW {
  using T = T_;
  static constexpr int D = D_;
  using Prior = GeneralPrior<T>;
  using In = InfoIn<T, D>;
  static constexpr bool LOGLIK = true;
  // more values a step than a warp's stage holds: every step read where it
  // lies (StagedTiling::STAGED is false)
  static constexpr int NV_IN = 1024, NV = NV_IN;
  static constexpr int P_OUT = 0, M_OUT = 0;
  LamOnce<T, D> once;
  int o = 0;
  const FilterArgs<T>* args = nullptr;  // the sites, and the batch row, of the steps read
  int64_t row = 0;

  MF_DEV void load(const Prior&, int64_t) {}

  static __host__ __device__ GeneralSlots slots(const Prior&, const FilterArgs<T>&, bool) {
    return {-1, -1, -1, -1, -1, -1, 0};
  }

  template <class G, bool OUTPUTS>
  MF_DEV void stage(const Prior&, const FilterArgs<T>&, int64_t, int64_t t, int64_t n,
                    WarpStage<T, G::R>& st, GeneralSlots&) const {
    st = {nullptr, (t - lane_id()) * G::R, n};
  }

  template <bool STAGED, int R>
  MF_DEV void read(In& in, const WarpStage<T, R>&, const GeneralSlots&, int, int,
                   const Prior& p, const FilterArgs<T>& a, int64_t b, int64_t k, bool) {
    o = int(a.o);
    args = &a;
    row = b;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        in.f[i * D + j] = p.f[b * p.f_sb + i * p.f_si + j * p.f_sj + k * p.f_st];
        in.q[i * D + j] = p.q[b * p.q_sb + i * p.q_si + j * p.q_sj + k * p.q_st];
      }
      in.c[i] = p.c[b * p.c_sb + i * p.c_si + k * p.c_st];
    }
    in.k = k;
    in.hv = {p.h + b * p.h_sb + k * p.h_st, p.h_si, p.h_sj};
    info_site_terms<T, D>(in, once, p.h_st == 0, a, b, k, o);
  }

  MF_DEV void fold(FElem<T, D>& run, const In& in, bool) const { info_fold<T, D>(run, in); }

  // pass 3 (gfilter_outputs): the Kalman step and the step's likelihood
  MF_DEV T step(T* m, T* P, const In& in) {
    T y[INFO_MAX_O];
    const T ldl = in.keep ? info_lam_terms<T, D>(once, *args, row, in.k, o, y) : T(0);
    return info_step<T, D>(m, P, in, y, ldl, *args, row, o);
  }
};

// Kernel 1 at o > d (d <= 5, o <= 6): the constant prior step of batch row
// b in registers (UniformRow), (0, P0, mu0) at global step 0, Hc [o, d]
// read where it lies, J made once a thread where lam's step stride is 0,
// nu, lam and the mask read where they lie.
template <typename T_, int D_>
struct UniformStepsW : UniformRow<T_, D_, 1> {
  using T = T_;
  static constexpr int D = D_;
  using Prior = UniformPrior<T>;
  using In = InfoIn<T, D>;
  static constexpr bool LOGLIK = true;
  static constexpr int NV_IN = 1024, NV = NV_IN;
  static constexpr int P_OUT = 0, M_OUT = 0;
  LamOnce<T, D> once;
  int o = 0;
  const T* hc = nullptr;
  const FilterArgs<T>* args = nullptr;  // the sites, and the batch row, of the steps read
  int64_t row = 0;

  MF_DEV void load(const Prior& p, int64_t b) {
    UniformRow<T, D, 1>::load(p, b);  // its h (one row) is not read
    hc = p.hc;
  }

  static __host__ __device__ GeneralSlots slots(const Prior&, const FilterArgs<T>&, bool) {
    return {-1, -1, -1, -1, -1, -1, 0};
  }

  template <class G, bool OUTPUTS>
  MF_DEV void stage(const Prior&, const FilterArgs<T>&, int64_t, int64_t t, int64_t n,
                    WarpStage<T, G::R>& st, GeneralSlots&) const {
    st = {nullptr, (t - lane_id()) * G::R, n};
  }

  template <bool STAGED, int R>
  MF_DEV void read(In& in, const WarpStage<T, R>&, const GeneralSlots&, int, int, const Prior&,
                   const FilterArgs<T>& a, int64_t b, int64_t k, bool) {
    o = int(a.o);
    args = &a;
    row = b;
    const bool first = k == 0;
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      in.f[i] = first ? T(0) : this->f[i];
      in.q[i] = first ? this->p0[i] : this->q[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) in.c[i] = first ? this->m0[i] : this->c[i];
    in.k = k;
    in.hv = {hc + b * o * D, D, 1};
    info_site_terms<T, D>(in, once, true, a, b, k, o);
  }

  MF_DEV void fold(FElem<T, D>& run, const In& in, bool) const { info_fold<T, D>(run, in); }

  MF_DEV T step(T* m, T* P, const In& in) {
    T y[INFO_MAX_O];
    const T ldl = in.keep ? info_lam_terms<T, D>(once, *args, row, in.k, o, y) : T(0);
    return info_step<T, D>(m, P, in, y, ldl, *args, row, o);
  }
};

// ---------------------------------------------------------------------------
// The Koopman backwards at o > d.
// ---------------------------------------------------------------------------

// Stage 1 of step k in state space: fp = F P_{k-1}, Pp = sym(fp F^T + Q),
// a = F m_{k-1} + c, M = I + Pp J; the element's L_k = F_{k+1} M^-1,
// H^T e = M^-T (h - J a) and H^T W H = sym(J M^-1).  Pp and a are kept for
// the observation terms.
template <typename T, int D>
struct GadjStage1W {
  T mp[D], fp[D * D], lk[D * D], he[D], hwh[D * D], pp[D * D], a[D];

  MF_DEV void build(const InfoIn<T, D>& in, const T* pprev, const T* fn) {
    mm<T, D, D, D>(in.f, pprev, fp);
    mm_nt<T, D, D, D>(fp, in.f, pp);
    add_to<T, D * D>(pp, in.q);
    sym<T, D>(pp);
    mm<T, D, D, 1>(in.f, mp, a);
    add_to<T, D>(a, in.c);
    T mt[D * D], eye[D * D], minv[D * D], v[D];
    mm<T, D, D, D>(pp, in.js, mt);
    add_eye<T, D>(mt);
    set_eye<T, D>(eye);
    gauss_jordan_solve<T, D, D>(mt, eye, minv);
    mm<T, D, D, D>(fn, minv, lk);
    info_resid<T, D>(in, a, v);
    mm_tn<T, D, D, 1>(minv, v, he);
    mm<T, D, D, D>(in.js, minv, hwh);
    sym<T, D>(hwh);
  }
};

// The step's element (L_k^T, H^T e, H^T W H) composed with the suffix x:
// g <- L_k^T g + H^T e, L <- sym(L_k^T L L_k + H^T W H) and, when FULL,
// E <- L_k^T E.
template <typename T, int D, bool FULL>
MF_DEV void gadjoint_fold(SElem<T, D>& x, const GadjStage1W<T, D>& st, const T*) {
  using E = SElem<T, D>;
  T *ee = x.v + E::OE, *g = x.v + E::OG, *l = x.v + E::OL;
  T t[D * D], u[D * D], v[D];
  mm_tn<T, D, D, 1>(st.lk, g, v);
  mm<T, D, D, D>(l, st.lk, t);
  mm_tn<T, D, D, D>(st.lk, t, u);
  if constexpr (FULL) {
    mm_tn<T, D, D, D>(st.lk, ee, t);
#pragma unroll
    for (int i = 0; i < D * D; ++i) ee[i] = t[i];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) g[i] = v[i] + st.he[i];
#pragma unroll
  for (int i = 0; i < D * D; ++i) l[i] = u[i] + st.hwh[i];
  sym<T, D>(l);
}

// Stage 2's observation terms at o > d, scaled by gs, through the smoothed
// moments m_s = a + Pp r and A = sym(Pp - Pp NDK Pp) + m_s m_s^T, with
// y = lam^-1 nu (gadjoint_obs_o):
//   gH_i = nu_i m_s - A (lam H)_i^T,  gnu = H m_s - y,
//   glam = (y y^T - H A H^T + lam^-1) / 2;
// each written where its pointer is not null (row b, step k; masked steps
// get zeros).  gH is written, or added to the sums at acc[(i d + j) *
// stride] where acc is not null (kernel 3's gHc).
template <typename T, int D, class A>
MF_DEV void info_obs(const A& p, LamOnce<T, D>& once, const InfoIn<T, D>& in,
                     const GadjStage1W<T, D>& s1, const T* r, const T* ndk, T gs, T* gh,
                     T* gnu, T* glam, T* acc, int stride, int64_t b, int64_t k, int64_t n,
                     int o) {
  if (!in.keep) {
    for (int i = 0; i < o; ++i) {
      if (gh != nullptr) {
#pragma unroll
        for (int j = 0; j < D; ++j) gh[((b * o + i) * D + j) * n + k] = T(0);
      }
      if (gnu != nullptr) gnu[(b * o + i) * n + k] = T(0);
      if (glam != nullptr) {
        for (int j = 0; j < o; ++j) glam[((b * o + i) * o + j) * n + k] = T(0);
      }
    }
    return;
  }
  T ms[D], am[D * D], t1[D * D];
  mm<T, D, D, 1>(s1.pp, r, ms);
  add_to<T, D>(ms, s1.a);
  mm<T, D, D, D>(ndk, s1.pp, t1);
  mm<T, D, D, D>(s1.pp, t1, am);
#pragma unroll
  for (int i = 0; i < D * D; ++i) am[i] = s1.pp[i] - am[i];
  sym<T, D>(am);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) am[i * D + j] += ms[i] * ms[j];
  }
  if (gh != nullptr || acc != nullptr) {
    for (int i = 0; i < o; ++i) {
      T t[D], at[D];
#pragma unroll
      for (int j = 0; j < D; ++j) t[j] = T(0);
      for (int l = 0; l < o; ++l) {
        const T v = site_lam<T>(p, b, k, i, l);
#pragma unroll
        for (int j = 0; j < D; ++j) t[j] += v * in.hv(l, j);
      }
      mm<T, D, D, 1>(am, t, at);
      const T nui = site_nu<T>(p, b, k, i);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const T g = nui * ms[j] - at[j];
        if (acc != nullptr) acc[(i * D + j) * stride] += g;
        else gh[((b * o + i) * D + j) * n + k] = gs * g;
      }
    }
  }
  if (gnu == nullptr && glam == nullptr) return;
  T y[INFO_MAX_O], linv_step[INFO_MAX_O * INFO_MAX_O];
  const T* linv = linv_step;
  if (p.lam_st == 0) {
    once.prepare(p, b, o);
    info_y<T>(once.linv, p, b, k, o, y);
    linv = once.linv;
  } else {
    info_lam_solve<T>(p, b, k, o, y, linv_step);
  }
  T ha[INFO_MAX_O * D];
  for (int i = 0; i < o; ++i) {
    T hi[D];
#pragma unroll
    for (int j = 0; j < D; ++j) hi[j] = in.hv(i, j);
    if (gnu != nullptr) gnu[(b * o + i) * n + k] = gs * (dot<T, D>(hi, ms) - y[i]);
    mm<T, 1, D, D>(hi, am, ha + i * D);
  }
  if (glam == nullptr) return;
  for (int i = 0; i < o; ++i) {
    for (int j = 0; j < o; ++j) {
      T hah = T(0);
#pragma unroll
      for (int l = 0; l < D; ++l) hah += ha[i * D + l] * in.hv(j, l);
      glam[((b * o + i) * o + j) * n + k] =
          gs * (T(0.5) * (y[i] * y[j] - hah + linv[i * o + j]));
    }
  }
}

// Kernel 7 at o > d: per-step F, Q, c, H [o, d] and the sites through
// their strides, each step read where it lies, every gradient written to
// step k (the observation terms where asked for).
template <typename T_, int D_>
struct GeneralAdjStepsW {
  using T = T_;
  static constexpr int D = D_;
  using Prior = GeneralAdjointPrior<T>;
  using G = UnstagedTiling<D>;
  using In = InfoIn<T, D>;
  using Stage1 = GadjStage1W<T, D>;
  static constexpr int NSUM = 0;
  static constexpr bool STAGED1 = false;
  mutable LamOnce<T, D> once;  // read is const: gadjoint_walk takes a const source
  int o = 0;

  MF_DEV void load(const Prior& p, int64_t) { o = int(p.o); }

  static __host__ __device__ GeneralSlots slots(const Prior&) {
    return {-1, -1, -1, -1, -1, -1, 0};
  }

  template <bool STAGED, int R>
  MF_DEV void stage(const Prior&, int64_t, int64_t, int64_t, WarpStage<T, R>&,
                    GeneralSlots&) const {}

  template <int R>
  MF_DEV void f_after(const Prior& p, int64_t b, int64_t first, int64_t last, int64_t n,
                      const WarpStage<T, R>&, T* fn) const {
    const GeneralPrior<T>& q = p.k;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        fn[i * D + j] = last < first || last + 1 >= n
                            ? T(0)
                            : q.f[b * q.f_sb + i * q.f_si + j * q.f_sj + (last + 1) * q.f_st];
    }
  }

  template <bool STAGED, int R>
  MF_DEV void read(In& in, T* mp, T* pprev, const WarpStage<T, R>& st, const GeneralSlots& sl,
                   int lane, int r, const Prior& p, int64_t b, int64_t k, bool,
                   int64_t n) const {
    const GeneralPrior<T>& q = p.k;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        in.f[i * D + j] = q.f[b * q.f_sb + i * q.f_si + j * q.f_sj + k * q.f_st];
        in.q[i * D + j] = q.q[b * q.q_sb + i * q.q_si + j * q.q_sj + k * q.q_st];
      }
      in.c[i] = q.c[b * q.c_sb + i * q.c_si + k * q.c_st];
    }
    in.k = k;
    in.hv = {q.h + b * q.h_sb + k * q.h_st, q.h_si, q.h_sj};
    info_site_terms<T, D>(in, once, q.h_st == 0, p, b, k, o);
    read_prev_moments<false, D>(p, st, sl, lane, r, b, k, n, mp, pprev);
  }

  // gF, gc, gQ (gadjoint_prior_grads) and the observation terms asked
  // for, scaled by gs, at step k
  MF_DEV void out(const Prior& p, const In& in, const Stage1& s1, const T* rv, const T* ndk,
                  T gs, const WarpStage<T, G::R>&, int, int, int64_t b, int64_t k, int64_t n) {
    T nm[D * D];
    gadjoint_n<T, D>(rv, ndk, nm);
    const auto at = [&](T* arr, int rows) { return arr == nullptr ? arr : arr + b * rows * n + k; };
    gadjoint_prior_grads<T, D>(s1, rv, nm, gs, at(p.gf, D * D), at(p.gc, D), at(p.gq, D * D), n);
    if (p.gh != nullptr || p.gnu != nullptr || p.glam != nullptr)
      info_obs<T, D>(p, once, in, s1, rv, ndk, gs, p.gh, p.gnu, p.glam, nullptr, 0, b, k, n, o);
  }

  template <int THREADS>
  MF_DEV void finish(const Prior&, const SmootherArgs<T>&, const WarpStage<T, G::R>&, int64_t,
                     T*) const {}
};

// Kernel 3 at o > d (d <= 5, o <= 6): UniformAdjStepsO's constants in the
// block's shared memory and sums in its dynamic shared memory (NSUM
// values a thread, Hc's for INFO_UNIFORM_MAX_O rows, those past o left 0),
// with stage 1 and the observation terms in state space; gHc is summed at
// every call (the wrapper returns it only where asked).
template <typename T_, int D_>
struct UniformAdjStepsW {
  using T = T_;
  static constexpr int D = D_;
  using Prior = AdjointPrior<T>;
  using G = UnstagedTiling<D>;
  using In = InfoIn<T, D>;
  using Stage1 = GadjStage1W<T, D>;
  using S = AdjointSums<D, INFO_UNIFORM_MAX_O>;
  static constexpr int NSUM = S::NV;
  static constexpr bool STAGED1 = false;
  static constexpr int OF = 0, OQ = D * D, OC = 2 * D * D, OP0 = OC + D, OM0 = OP0 + D * D,
                       OH = OM0 + D, NROW = OH + INFO_UNIFORM_MAX_O * D;
  static constexpr int SMEM3 = NSUM;
  const volatile T* row;
  T* acc;
  mutable LamOnce<T, D> once;
  int o = 0;

  // Every thread of the block calls it (a barrier).
  MF_DEV void load(const Prior& p, int64_t b) {
    __shared__ T consts[NROW];
    o = int(p.o);
    const UniformPrior<T>& u = p.k;
    const int nrow = OH + o * D;
    for (int i = threadIdx.x; i < nrow; i += blockDim.x)
      consts[i] = i < OQ    ? u.fc[b * D * D + i - OF]
                  : i < OC  ? u.qc[b * D * D + i - OQ]
                  : i < OP0 ? u.cc[b * D + i - OC]
                  : i < OM0 ? u.p0[b * D * D + i - OP0]
                  : i < OH  ? u.mu0[b * D + i - OM0]
                            : u.hc[b * o * D + i - OH];
    __syncthreads();
    row = consts;
  }

  MF_DEV void sums_in(T* smem) {
    acc = smem + threadIdx.x;
#pragma unroll
    for (int i = 0; i < NSUM; ++i) acc[i * G::THREADS] = T(0);
  }

  static __host__ __device__ GeneralSlots slots(const Prior&) {
    return {-1, -1, -1, -1, -1, -1, 0};
  }

  template <bool STAGED, int R>
  MF_DEV void stage(const Prior&, int64_t, int64_t, int64_t, WarpStage<T, R>&,
                    GeneralSlots&) const {}

  template <int R>
  MF_DEV void f_after(const Prior&, int64_t, int64_t, int64_t last, int64_t n,
                      const WarpStage<T, R>&, T* fn) const {
#pragma unroll
    for (int i = 0; i < D * D; ++i) fn[i] = last + 1 >= n ? T(0) : row[OF + i];
  }

  template <bool STAGED, int R>
  MF_DEV void read(In& in, T* mp, T* pprev, const WarpStage<T, R>& st, const GeneralSlots& sl,
                   int lane, int r, const Prior& p, int64_t b, int64_t k, bool,
                   int64_t n) const {
    const bool first = k == 0;
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      in.f[i] = first ? T(0) : row[OF + i];
      in.q[i] = row[(first ? OP0 : OQ) + i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) in.c[i] = row[(first ? OM0 : OC) + i];
    in.k = k;
    in.hv = {const_cast<const T*>(row) + OH, D, 1};
    info_site_terms<T, D>(in, once, true, p, b, k, o);
    read_prev_moments<false, D>(p, st, sl, lane, r, b, k, n, mp, pprev);
  }

  // the prior-step sums (adjoint_prior_sums), Hc += gH of every step, and
  // gnu, glam, scaled by gs, to step k where asked for
  MF_DEV void out(const Prior& p, const In& in, const Stage1& s1, const T* rv, const T* ndk,
                  T gs, const WarpStage<T, G::R>&, int, int, int64_t b, int64_t k, int64_t n) {
    T nm[D * D];
    gadjoint_n<T, D>(rv, ndk, nm);
    adjoint_prior_sums<T, D, Stage1, G::THREADS>(p, s1, rv, nm, gs, acc, b, k);
    info_obs<T, D>(p, once, in, s1, rv, ndk, gs, nullptr, p.gnu, p.glam, acc + S::OH * G::THREADS,
                   G::THREADS, b, k, n, o);
  }

  // the block's sums to its partial: sum v of the columns in thread order
  template <int THREADS>
  MF_DEV void finish(const Prior& p, const SmootherArgs<T>& a, int64_t b) {
    __syncthreads();
    const T* col0 = acc - threadIdx.x;
    for (int v = threadIdx.x; v < NSUM; v += THREADS) {
      T sum = T(0);
      for (int i = 0; i < THREADS; ++i) sum += col0[v * THREADS + i];
      p.partials[(b * a.nblk + blockIdx.x) * NSUM + v] = sum;
    }
  }
};

}  // namespace mf

// Dispatch of a run-time state dimension to the instantiations d = 1..5 of
// the uniform sources above (o > d and o <= INFO_UNIFORM_MAX_O leave d <= 5).
#define MF_SWITCH_D5(d, EXPR_OF_D, BAD) \
  switch (d) {                          \
    case 1: { constexpr int D_ = 1; return EXPR_OF_D; } \
    case 2: { constexpr int D_ = 2; return EXPR_OF_D; } \
    case 3: { constexpr int D_ = 3; return EXPR_OF_D; } \
    case 4: { constexpr int D_ = 4; return EXPR_OF_D; } \
    case 5: { constexpr int D_ = 5; return EXPR_OF_D; } \
    default: return BAD;                \
  }
