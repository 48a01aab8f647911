// Kernels 4 and 7 at o x o sites, o = 2..12, for state dims 7..12 on
// Hopper (sm_90a): the general filter (the port of pallas_filter_pipeline)
// and the general Koopman backward (pallas_adjoint_pipeline) on
// wide_scan.cuh's machinery, a warp per run of steps, with d and o bound
// at run time: one unit per (kernel, dtype), not one per (d, o).  The TPU
// kernels (markovflow_tpu/ops/pallas_scan.py) take o <= 12 at every
// d <= 12 (pick_scan_engine); a multi-output GPR of Matern52 children
// (d = 9, o = 3) and a factor analysis of Matern52 latents (d = 9, o = 12)
// feed them.  The plain PyTorch versions are filter_pipeline_plain
// (ops/cuda_scan.py) and adjoint_pipeline_plain (ops/adjoint.py).
//
// Where lam's step stride is 0 (GPR: one noise precision) each step's
// o x o site is folded into state space, as info_scan.cuh does at d <= 6,
// by the warp's products at run-time o:
//   J = H^T lam H [d x d],  h = H^T nu [d],
// and everything after works in d space.  With M = I + Pp J and
// X = M^-1 Pp (one pivoted d x d inverse a step, wsolve's register
// Gauss-Jordan):
//   P = sym(X M^-T + X J X^T)  (Joseph's form: the solve's error enters P
//                               at second order, as joseph_update does),
//   m = mp + X v,  v = h - J mp;
// pass 1 of the filter folds the step into the run (A, b, C, J, eta) as a
// conditional Kalman step (winfo_fold); pass 3 carries the moments
// (winfo_kalman_step), the log-likelihood from the determinant lemma and
// the residual: ll = -(e^T lam e - v^T X v + log|det M| - log|det lam| +
// o log 2 pi) / 2 with e = lam^-1 nu - H mp.  The Koopman element is
// L_k = F_{k+1} M^-1, H^T e = M^-T (h - J a), H^T W H = sym(J M^-1)
// (winfo_stage1), and stage 2's observation terms loop over o the same way
// (winfo_stage2).  One source then serves o <= d and o > d alike.  Where
// lam changes with the step (the natural-gradient inversion's indefinite
// sites at o = d) kernel 4 takes the element form instead, as GeneralStepsO
// does at d <= 6: each step's filtering element built by one pivoted o x o
// solve (winfo_element), composed by WideFilterOp in pass 1 as a binary
// tree (the runs of 1, 2, 4, ... steps that the step count's bits stand
// for; folded in order, float64 on those sites left the log-likelihood
// 15x the plain version's one-ulp spread at d = 9, N = 200, and 90x at
// d = 7, N = 300), and carried through by wide_filter_moments in pass 3,
// the log-likelihood in lam form (winfo_loglik_lam).  Kernel 7 keeps the
// d-space stage 1 on every lam.
//
// A step's inputs go through the chunks of wide_scan.cuh (cp.async, CH
// steps a chunk, two chunks in flight): F, Q, c (and for kernel 7 P_{k-1},
// m_{k-1}), nu, and H and lam only where they change with the step.  An
// input of step stride 0 (GPR's lam, expanded from one noise precision;
// mo9's H) is loaded once a warp into its constants, with lam^-1 and
// log|det lam|, and J and lam H where both are constant.  Kernel 7's
// gradients go to an output region of each slot and out a chunk at a time
// (only those asked for; the observation terms gH, gnu, glam not at all
// where none is asked, as GPR's backward asks).  The warps a block are
// sized by (d, o): as many as the block's 227 KB of shared memory hold,
// up to WIDE_WARPS; a launch that fails is an error.
//
// A simple design, not tuned: what bounds it on an H100 is the chain of a
// warp's steps (about ten phases of d^3 products a step and a d x d
// inverse, each phase ended by a __syncwarp()), as at o = 1 (PERF.md has
// the times).
#pragma once

#include "general_adjoint.cuh"

namespace mf {

constexpr int WIDE_INFO_MAX_O = 12;

// A product of a fused phase (WProd) with any strides: out [r x c] =
// op(a) op(b) (+ add), op(a)(i, l) = a[i * ai + l * al], op(b)(l, j) =
// b[l * bl + j * bj].
template <typename T>
MF_DEV WProd<T> wgen(const T* a, int ai, int al, const T* b, int bl, int bj, T* out, int r,
                     int c, int k, const T* add = nullptr) {
  return {a, ai, al, b, bl, bj, out, r, c, k, add, T(1), false, false};
}

// Where a launch's site inputs lie in a step's slot: after the base
// values of the prior (and moments), H [o x d] where it changes with the
// step (hs), nu [o], and lam [o x o] where it changes with the step (ls);
// nin values in all.
struct WideInfoSlot {
  int d, o, mx;
  bool hs, ls;
  int oh, onu, olam, nin;
  int levels = 0;  // kernel 4's element form: the levels of pass 1's tree

  __host__ __device__ WideInfoSlot(int d_, int o_, bool hs_, bool ls_, int base)
      : d(d_), o(o_), mx(d_ > o_ ? d_ : o_), hs(hs_), ls(ls_) {
    oh = base;
    onu = oh + (hs ? o * d : 0);
    olam = onu + o;
    nin = olam + (ls ? o * o : 0);
  }
};

// Value v >= s.oh of step k's slot: H, nu, lam of batch row b (the site
// fields of A: FilterArgs or GeneralAdjointPrior).
template <typename T, class A>
MF_DEV const T* winfo_site_src(const GeneralPrior<T>& p, const A& a, const WideInfoSlot& s,
                               int64_t b, int v, int64_t k) {
  v -= s.oh;
  if (s.hs) {
    if (v < s.o * s.d) {
      const int i = v / s.d, j = v - i * s.d;
      return p.h + (b * p.h_sb + i * p.h_si + j * p.h_sj + k * p.h_st);
    }
    v -= s.o * s.d;
  }
  if (v < s.o) return a.nu + (b * a.nu_sb + v * a.nu_si + k * a.nu_st);
  v -= s.o;
  const int i = v / s.o, j = v - i * s.o;
  return a.lam + (b * a.lam_sb + i * a.lam_si + j * a.lam_sj + k * a.lam_st);
}

// A warp's workspace: the run (nrun values) and the next run (nnxt), naux
// values (kernel 7's F_{k+1}, kernel 4's element of a step), two chunks of
// CH slots of per values, the
// constants (H, lam, lam^-1, J and lam H of step stride 0), a step's site
// terms (J, h, lam H), NM temporaries of max(d, o)^2 values and NV of
// max(d, o), and s.levels runs of pass 1's tree (kernel 4's element form).
template <typename T, int CH_, int NM, int NV>
struct WideInfoWork {
  static constexpr int CH = CH_;
  T *run, *nxt, *aux, *chunk[2];
  T *ch, *cl, *cli, *cj, *clh;
  T *js, *hs, *lh;
  T *m[NM], *v[NV];
  T* tree;  // s.levels runs of nrun values (kernel 4's element form)

  static __host__ __device__ int floats(const WideInfoSlot& s, int nrun, int nnxt, int naux,
                                        int per) {
    const int d = s.d, o = s.o, mx = s.mx;
    return nrun + nnxt + naux + 2 * CH * per + 2 * o * d + 2 * o * o + d * d + d * d + d +
           o * d + NM * mx * mx + NV * mx + s.levels * nrun;
  }

  MF_DEV WideInfoWork(T* p, const WideInfoSlot& s, int nrun, int nnxt, int naux, int per) {
    const int d = s.d, o = s.o, mx = s.mx;
    run = p; p += nrun;
    nxt = p; p += nnxt;
    aux = p; p += naux;
    chunk[0] = p; p += CH * per;
    chunk[1] = p; p += CH * per;
    ch = p; p += o * d;
    cl = p; p += o * o;
    cli = p; p += o * o;
    cj = p; p += d * d;
    clh = p; p += o * d;
    js = p; p += d * d;
    hs = p; p += d;
    lh = p; p += o * d;
    for (int i = 0; i < NM; ++i) { m[i] = p; p += mx * mx; }
    for (int i = 0; i < NV; ++i) { v[i] = p; p += mx; }
    tree = p;
  }
};

// The step's site terms: h = H^T nu always, and lam H and J = sym(H^T lam H)
// unless they are the warp's constants (jconst).
template <typename T>
MF_DEV WProd<T> winfo_h(const T* h, const T* nu, T* hs, int d, int o) {
  return wgen(h, 1, d, nu, 1, 0, hs, d, 1, o);
}
template <typename T>
MF_DEV WProd<T> winfo_lh(const T* lam, const T* h, T* lh, int d, int o) {
  return wgen(lam, o, 1, h, d, 1, lh, o, d, o);
}
template <typename T>
MF_DEV WProd<T> winfo_j(const T* h, const T* lh, T* js, int d, int o) {
  WProd<T> pr = wgen(h, 1, d, lh, d, 1, js, d, d, o);
  pr.sym = true;
  return pr;
}

// The constants of batch row b, once a warp: H and lam where their step
// stride is 0, with lam^-1 (returns log|det lam|, 0 unless linv is asked)
// and, where both are constant, lam H and J.
template <typename T, class W, class A>
MF_DEV T winfo_consts(const GeneralPrior<T>& p, const A& a, const WideInfoSlot& s, int64_t b,
                      W& w, bool linv) {
  const int d = s.d, o = s.o;
  for (int e = lane_id(); e < o * d && !s.hs; e += 32) {
    const int i = e / d, j = e - i * d;
    w.ch[e] = p.h[b * p.h_sb + i * p.h_si + j * p.h_sj];
  }
  for (int e = lane_id(); e < o * o && !s.ls; e += 32) {
    const int i = e / o, j = e - i * o;
    w.cl[e] = a.lam[b * a.lam_sb + i * a.lam_si + j * a.lam_sj];
  }
  __syncwarp();
  T ldl = T(0);
  if (!s.ls && linv) ldl = wsolve<T, false, true>(w.cl, nullptr, nullptr, w.cli, nullptr, o);
  if (!s.hs && !s.ls) {
    WProd<T> p1[] = {winfo_lh(w.cl, w.ch, w.clh, d, o)};
    wprods(p1);
    WProd<T> p2[] = {winfo_j(w.ch, w.clh, w.cj, d, o)};
    wprods(p2);
  }
  return ldl;
}

// ---------------------------------------------------------------------------
// Kernel 4.
// ---------------------------------------------------------------------------

// The temporaries (m, then v) hold WideTemps (6 d^2 + 4 d values) for the
// element form's composition.
template <typename T>
using WideInfoFilterWork = WideInfoWork<T, 32 / sizeof(T), 9, 6>;

// A step's slot: F, Q, c, then the site (WideInfoSlot).
__host__ __device__ inline WideInfoSlot winfo_filter_slot(int d, int o, bool hs, bool ls) {
  return WideInfoSlot(d, o, hs, ls, 2 * d * d + d);
}

template <typename T>
__host__ __device__ int winfo_filter_floats(const WideInfoSlot& s) {
  const int size = wide_filter_size(s.d);
  return WideInfoFilterWork<T>::floats(s, size, size, size, s.nin);
}

// Pass 1: the step (f, q, c; site h, nu, lam) folded into the run (A, b,
// C, J, eta), the element of the steps so far given the state before
// them, as a conditional Kalman step in state space (info_fold).  With
// fa = F A, Pp = sym(F C F^T + Q), mp = F b + c, M = I + Pp J,
// X = M^-1 Pp, v = h - J mp:
//   A <- M^-1 fa, b <- mp + X v, C <- sym(X M^-T + X J X^T),
//   J_el <- J_el + sym(fa^T J M^-1 fa), eta <- eta + fa^T M^-T v.
template <typename T, class W>
MF_DEV void winfo_fold(W& w, const T* f, const T* q, const T* c, const T* h, const T* nu,
                       const T* lam, bool jconst, const WideInfoSlot& s) {
  const int d = s.d, o = s.o, dd = d * d;
  T *A = w.run, *bb = w.run + dd, *C = w.run + dd + d, *J = w.run + 2 * dd + d,
    *eta = w.run + 3 * dd + d;
  T *fa = w.m[0], *fc = w.m[1], *pp = w.m[2], *minv = w.m[3], *X = w.m[4], *t2 = w.m[5],
    *u = w.m[6];
  T *mp = w.v[0], *v = w.v[1], *mv = w.v[2];
  const T* js = jconst ? w.cj : w.js;
  const WProd<T> pa = wnn(f, A, fa, d), pc = wnn(f, C, fc, d), pm = wnv(f, bb, mp, d, c),
                 ph = winfo_h(h, nu, w.hs, d, o);
  if (jconst) {
    WProd<T> p1[] = {pa, pc, pm, ph};
    wprods(p1);
    WProd<T> p2[] = {wsym_nt(fc, f, pp, d, q)};
    wprods(p2);
  } else {
    WProd<T> p1[] = {pa, pc, pm, ph, winfo_lh(lam, h, w.lh, d, o)};
    wprods(p1);
    WProd<T> p2[] = {wsym_nt(fc, f, pp, d, q), winfo_j(h, w.lh, w.js, d, o)};
    wprods(p2);
  }
  // M = I + Pp J (over fc), v = h - J mp
  WProd<T> p3[] = {wnn(pp, js, fc, d), wnv(js, mp, v, d, w.hs)};
  p3[0].eye = true;
  p3[1].alpha = T(-1);
  wprods(p3);
  winv(fc, minv, d);
  // X = M^-1 Pp, A = M^-1 fa, M^-T v, J M^-1 (over fc)
  WProd<T> p4[] = {wnn(minv, pp, X, d), wnn(minv, fa, A, d), wtv(minv, v, mv, d),
                   wnn(js, minv, fc, d)};
  wprods(p4);
  // b = X v + mp, X M^-T (over pp), X J, eta += fa^T M^-T v, J M^-1 fa
  WProd<T> p5[] = {wnv(X, v, bb, d, mp), wnt(X, minv, pp, d), wnn(X, js, t2, d),
                   wtv(fa, mv, eta, d, eta), wnn(fc, fa, u, d)};
  wprods(p5);
  // C = sym(X J X^T + X M^-T), J_el = sym(fa^T J M^-1 fa + J_el)
  WProd<T> p6[] = {wsym_nt(t2, X, C, d, pp), wtn(fa, u, J, d, J)};
  p6[1].sym = true;
  wprods(p6);
}

// Pass 3: the Kalman step from the filtered moments (m, P) of the step
// before (the run's b and C legs) to this step's, in place (info_step);
// returns the step's log-likelihood (0 where masked, the same value in
// every lane).  ldl: log|det lam| of a constant lam (its inverse in w.cli).
template <typename T, class W>
MF_DEV T winfo_kalman_step(W& w, const T* f, const T* q, const T* c, const T* h, const T* nu,
                           const T* lam, bool jconst, bool keep, T ldl,
                           const WideInfoSlot& s) {
  const int d = s.d, o = s.o, dd = d * d;
  T *m = w.run + dd, *P = w.run + dd + d;
  T *fp = w.m[0], *mm = w.m[1], *pp = w.m[2], *minv = w.m[3], *X = w.m[4], *t2 = w.m[5],
    *li = w.m[6];
  T *mp = w.v[0], *v = w.v[1], *xv = w.v[2], *y = w.v[3], *e = w.v[4], *le = w.v[5];
  const T* js = jconst ? w.cj : w.js;
  const WProd<T> pf = wnn(f, P, fp, d), pm = wnv(f, m, mp, d, c), ph = winfo_h(h, nu, w.hs, d, o);
  if (jconst) {
    WProd<T> p1[] = {pf, pm, ph};
    wprods(p1);
    WProd<T> p2[] = {wsym_nt(fp, f, pp, d, q)};
    wprods(p2);
  } else {
    WProd<T> p1[] = {pf, pm, ph, winfo_lh(lam, h, w.lh, d, o)};
    wprods(p1);
    WProd<T> p2[] = {wsym_nt(fp, f, pp, d, q), winfo_j(h, w.lh, w.js, d, o)};
    wprods(p2);
  }
  WProd<T> p3[] = {wnn(pp, js, mm, d), wnv(js, mp, v, d, w.hs)};  // M = I + Pp J, v = h - J mp
  p3[0].eye = true;
  p3[1].alpha = T(-1);
  wprods(p3);
  const T ldm = wsolve<T, false, true>(mm, nullptr, nullptr, minv, nullptr, d);
  // lam^-1 nu: by a solve where lam changes with the step, else from w.cli
  if (keep && s.ls) ldl = wsolve<T, false, true>(lam, nullptr, nu, li, y, o);
  if (keep && !s.ls) {
    WProd<T> p4[] = {wnn(minv, pp, X, d), wgen(w.cli, o, 1, nu, 1, 0, y, o, 1, o)};
    wprods(p4);
  } else {
    WProd<T> p4[] = {wnn(minv, pp, X, d)};
    wprods(p4);
  }
  // m = X v + mp, X v, X M^-T (over pp), X J; e = y - H mp
  const WProd<T> q1 = wnv(X, v, m, d, mp), q2 = wnv(X, v, xv, d), q3 = wnt(X, minv, pp, d),
                 q4 = wnn(X, js, t2, d);
  if (keep) {
    WProd<T> p5[] = {q1, q2, q3, q4, wgen(h, d, 1, mp, 1, 0, e, o, 1, d, y)};
    p5[4].alpha = T(-1);
    wprods(p5);
    WProd<T> p6[] = {wsym_nt(t2, X, P, d, pp), wgen(lam, o, 1, e, 1, 0, le, o, 1, o)};
    wprods(p6);
  } else {
    WProd<T> p5[] = {q1, q2, q3, q4};
    wprods(p5);
    WProd<T> p6[] = {wsym_nt(t2, X, P, d, pp)};
    wprods(p6);
    return T(0);
  }
  const T quad = wdot(e, le, o) - wdot(v, xv, d);
  return T(-0.5) * (quad + ldm - ldl + T(o) * T(1.8378770664093453));
}

// The step's filtering element (make_filter_elements_tl; site_element_o
// at run-time d and o) into w.aux, for a lam that changes with the step:
// with qht = Q H^T [d x o], hf = H F [o x d], hm = H c and one pivoted
// o x o solve (I + lam S) [W | y] = [I | nu], S = H qht,
//   lz = sym(W lam), r = y - lz hm,
//   A = F - qht lz hf, b = c + qht r, J = sym(hf^T lz hf), eta = hf^T r,
//   C = sym((I - u H) Q) with the gain u = v lam, v = qht W, in float64;
//   in float32 Q after the site in Joseph's form (joseph_update),
//   C = sym((I - u H) Q (I - u H)^T + u v^T), which the solve's error
//   reaches only at second order (a dense H, unscaled, over a Matern52's
//   f'': the simple form lost float32 digits there at d <= 6).
// The natural-gradient inversion's sites (lam ~ dt^-3, indefinite, float64
// only) lost digits in the d-space fold (winfo_fold: 1e-6 of P_f at d = 9,
// N = 200, where the plain version's one-ulp spread is 6e-10): Joseph's
// two terms there are large and of opposite signs (u v^T = K lam^-1 K^T
// with an indefinite lam), and the elements in Joseph's form still lost
// 100-600x the plain version's error against a 50-digit reference (d = 7,
// N = 100; d = 9, N = 50), the simple form 0.3-4x.
template <typename T, class W>
MF_DEV void winfo_element(W& w, const T* f, const T* q, const T* c, const T* h, const T* nu,
                          const T* lam, const WideInfoSlot& s) {
  const int d = s.d, o = s.o, dd = d * d;
  T *A = w.aux, *bb = w.aux + dd, *C = w.aux + dd + d, *J = w.aux + 2 * dd + d,
    *eta = w.aux + 3 * dd + d;
  T *qht = w.m[0], *hf = w.m[1], *sm = w.m[2], *mo = w.m[3], *wi = w.m[4], *lz = w.m[5],
    *vv = w.m[6], *lh = w.m[7], *uv = w.m[8];
  T *hm = w.v[0], *y = w.v[1], *r = w.v[2];
  WProd<T> p1[] = {wgen(q, d, 1, h, 1, d, qht, d, o, d), wgen(h, d, 1, f, d, 1, hf, o, d, d),
                   wgen(h, d, 1, c, 1, 0, hm, o, 1, d)};
  wprods(p1);
  WProd<T> p2[] = {wgen(h, d, 1, qht, o, 1, sm, o, o, d)};  // S = H Q H^T
  wprods(p2);
  WProd<T> p3[] = {wgen(lam, o, 1, sm, o, 1, mo, o, o, o)};  // I + lam S
  p3[0].eye = true;
  wprods(p3);
  wsolve<T>(mo, nullptr, nu, wi, y, o);
  WProd<T> p4[] = {wgen(wi, o, 1, lam, o, 1, lz, o, o, o), wgen(qht, o, 1, wi, o, 1, vv, d, o, o)};
  p4[0].sym = true;
  wprods(p4);
  // r = y - lz hm, u = v lam (over S), qht lz (over I + lam S)
  T *u = sm, *ql = mo;
  WProd<T> p5[] = {wgen(lz, o, 1, hm, 1, 0, r, o, 1, o, y), wgen(vv, o, 1, lam, o, 1, u, d, o, o),
                   wgen(qht, o, 1, lz, o, 1, ql, d, o, o)};
  p5[0].alpha = T(-1);
  wprods(p5);
  // I - u H (over W), A, b, lz hf, eta
  T* ikh = wi;
  WProd<T> p6[] = {wgen(u, o, 1, h, d, 1, ikh, d, d, o), wgen(ql, o, 1, hf, d, 1, A, d, d, o, f),
                   wgen(qht, o, 1, r, 1, 0, bb, d, 1, o, c), wgen(lz, o, 1, hf, d, 1, lh, o, d, o),
                   wgen(hf, 1, d, r, 1, 0, eta, d, 1, o)};
  p6[0].alpha = T(-1);
  p6[0].eye = true;
  p6[1].alpha = T(-1);
  wprods(p6);
  // (I - u H) Q (over qht lz), J, u v^T
  T* t = ql;
  WProd<T> p7[] = {wnn(ikh, q, t, d), wgen(hf, 1, d, lh, d, 1, J, d, d, o),
                   wgen(u, o, 1, vv, 1, o, uv, d, d, o)};
  p7[1].sym = true;
  wprods(p7);
  if constexpr (sizeof(T) == 4) {
    WProd<T> p8[] = {wsym_nt(t, ikh, C, d, uv)};
    wprods(p8);
  } else {
    for (int e = lane_id(); e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      C[e] = T(0.5) * (t[e] + t[j * d + i]);
    }
    __syncwarp();
  }
}

// The step's site log-likelihood in lam form (site_loglik_o) from the
// filtered moments (m, P) of the step before (the run's b and C legs):
// with Sp = H Pp H^T and w = nu - lam H mp, quad = e^T v for
// v = (I + lam Sp)^-1 w and e = lam^-1 w (two pivoted eliminations, whose
// pivots also give the determinants), for the element form.
template <typename T, class W>
MF_DEV T winfo_loglik_lam(W& w, const T* f, const T* q, const T* c, const T* h, const T* nu,
                          const T* lam, const WideInfoSlot& s) {
  const int d = s.d, o = s.o, dd = d * d;
  const T *m = w.run + dd, *P = w.run + dd + d;
  T *fp = w.m[0], *pp = w.m[1], *ph = w.m[2], *sm = w.m[3], *mt = w.m[4], *junk = w.m[5];
  T *mp = w.v[0], *hm = w.v[1], *wv = w.v[2], *v = w.v[3], *e = w.v[4];
  WProd<T> p1[] = {wnn(f, P, fp, d), wnv(f, m, mp, d, c)};
  wprods(p1);
  WProd<T> p2[] = {wsym_nt(fp, f, pp, d, q)};
  wprods(p2);
  WProd<T> p3[] = {wgen(pp, d, 1, h, 1, d, ph, d, o, d), wgen(h, d, 1, mp, 1, 0, hm, o, 1, d)};
  wprods(p3);
  WProd<T> p4[] = {wgen(h, d, 1, ph, o, 1, sm, o, o, d),
                   wgen(lam, o, 1, hm, 1, 0, wv, o, 1, o, nu)};
  p4[1].alpha = T(-1);
  wprods(p4);
  WProd<T> p5[] = {wgen(lam, o, 1, sm, o, 1, mt, o, o, o)};
  p5[0].eye = true;
  wprods(p5);
  const T ldm = wsolve<T, false, true>(mt, nullptr, wv, junk, v, o);
  const T ldl = wsolve<T, false, true>(lam, nullptr, wv, junk, e, o);
  return T(-0.5) * (wdot(e, v, o) + ldm - ldl + T(o) * T(1.8378770664093453));
}

// Passes 1 (OUTPUTS = false: fold the warp's steps into its total) and 3
// (OUTPUTS: restart from the carry's b and C legs, write P_f over Q and
// m_f over c in each slot, then out a chunk at a time, and the warp's
// log-likelihood partial).
template <typename T, bool OUTPUTS>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_info_filter(FilterArgs<T> a, GeneralPrior<T> p, WideInfoSlot s, int64_t steps) {
  using W = WideInfoFilterWork<T>;
  constexpr int CH = W::CH;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = lane_id();
  const int d = s.d, dd = d * d, size = wide_filter_size(d);
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * nw + warp, n = a.n;
  if (u >= a.nblk) return;  // the whole warp; this kernel has no block barrier
  W w(reinterpret_cast<T*>(mf_wide_smem) + warp * winfo_filter_floats<T>(s), s, size, size,
      size, s.nin);
  WideTemps<T> wt(w.m[0], d);  // over the temporaries, for the element form
  const auto src = [&](int v, int64_t k) {
    return v < 2 * dd + d ? WideGeneralRow<T>::src(p, b, v, k, d)
                          : winfo_site_src(p, a, s, b, v, k);
  };
  // P_f over Q and m_f over c: values v < dd + d from slot offset dd
  const auto dst = [&](int v, int64_t k) {
    return v < dd ? a.p_f + ((b * dd + v) * n + k) : a.m_f + ((b * d + v - dd) * n + k);
  };
  const T ldl = winfo_consts(p, a, s, b, w, OUTPUTS);
  const bool jconst = !s.hs && !s.ls;
  T* total = a.totals + (b * a.nblk + u) * size;
  if (OUTPUTS) wcopy(w.run + dd, total + dd, d + dd);  // the moments of step k0 - 1
  else wide_identity(w.run, size, d);
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, n);
  T *cur = w.chunk[0], *ahead = w.chunk[1];
  fetch_chunk<CH>(cur, s.nin, k0, int(imin(CH, k1 - k0)), src);
  wide_fetch_wait();
  T ll = T(0);
  for (int64_t kc = k0; kc < k1; kc += CH) {
    const int cnt = int(imin(CH, k1 - kc));
    if (kc + CH < k1) fetch_chunk<CH>(ahead, s.nin, kc + CH, int(imin(CH, k1 - kc - CH)), src);
    for (int j = 0; j < cnt; ++j) {
      T* st = cur + j * s.nin;
      const T *h = s.hs ? st + s.oh : w.ch, *nu = st + s.onu, *lam = s.ls ? st + s.olam : w.cl;
      if constexpr (OUTPUTS) {
        const bool keep = a.mask == nullptr || a.mask[b * a.mask_sb + (kc + j) * a.mask_st] > T(0.5);
        if (s.ls) {  // the element form: the moments through the step's element
          if (keep) ll += winfo_loglik_lam(w, st, st + dd, st + 2 * dd, h, nu, lam, s);
          winfo_element(w, st, st + dd, st + 2 * dd, h, nu, lam, s);
          wide_filter_moments(w.aux, w.run + dd, wt, d);
          wcopy(w.run + dd, w.aux + dd, d + dd);
        } else {
          ll += winfo_kalman_step(w, st, st + dd, st + 2 * dd, h, nu, lam, jconst, keep, ldl, s);
        }
        for (int e = lane; e < dd + d; e += 32) st[dd + e] = w.run[e < dd ? dd + d + e : e];
        __syncwarp();
      } else if (s.ls) {
        // the element of the warp's i-th step merged with the runs of 1, 2,
        // 4, ... steps before it that the set low bits of i stand for
        winfo_element(w, st, st + dd, st + 2 * dd, h, nu, lam, s);
        T *cur = w.aux, *spare = w.nxt;
        int lvl = 0;
        for (int64_t i = kc + j - k0; i & 1; i >>= 1, ++lvl) {
          WideFilterOp<T>::combine(w.tree + lvl * size, cur, spare, wt, d);
          T* t = cur; cur = spare; spare = t;
        }
        wcopy(w.tree + lvl * size, cur, size);
      } else {
        winfo_fold(w, st, st + dd, st + 2 * dd, h, nu, lam, jconst, s);
      }
    }
    if (OUTPUTS) store_chunk<CH>(cur, s.nin, dd, dd + d, kc, cnt, dst);
    wide_fetch_wait();
    T* t = cur; cur = ahead; ahead = t;
  }
  if (OUTPUTS) {
    if (lane == 0) a.partials[b * a.nblk + u] = ll;
    return;
  }
  if (s.ls) {  // the runs of the set bits of the step count, the earliest first
    bool first = true;
    for (int lvl = s.levels - 1; lvl >= 0; --lvl) {
      if (!((k1 - k0) >> lvl & 1)) continue;
      if (first) {
        wcopy(w.run, w.tree + lvl * size, size);
        first = false;
      } else {
        WideFilterOp<T>::combine(w.run, w.tree + lvl * size, w.nxt, wt, d);
        T* t = w.run; w.run = w.nxt; w.nxt = t;
      }
    }
  }
  wcopy(total, w.run, size);
}

// The warps a block of a pass whose warps take warp_bytes of dynamic
// shared memory each: as many as a block's opt-in shared memory holds, up
// to WIDE_WARPS (0: not even one).
inline int wide_info_warps(size_t warp_bytes) {
  int dev = 0, most = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const size_t fit = size_t(most) / warp_bytes;
  return int(fit < size_t(WIDE_WARPS) ? fit : size_t(WIDE_WARPS));
}

// Kernel 4 at o = 2..12, d = 7..12: the scratch is wide_filter_scratch's.
template <typename T>
int launch_wide_info_filter(FilterArgs<T> a, GeneralPrior<T> p, T* scratch, int64_t batch, int d,
                            cudaStream_t stream) {
  const int o = int(a.o);
  if (d < WIDE_MIN_D || d > WIDE_MAX_D || o < 2 || o > WIDE_INFO_MAX_O)
    return int(cudaErrorInvalidValue);
  WideInfoSlot s = winfo_filter_slot(d, o, p.h_st != 0, a.lam_st != 0);
  const int64_t steps = wide_steps(a.n);
  if (s.ls)
    while (int64_t(1) << s.levels <= steps) ++s.levels;
  a.nblk = num_blocks(a.n, steps);
  a.totals = scratch;
  a.partials = scratch + batch * a.nblk * wide_filter_size(d);
  T* levels = a.partials + batch * a.nblk;
  const size_t warp_bytes = size_t(winfo_filter_floats<T>(s)) * sizeof(T);
  const int nw = wide_info_warps(warp_bytes);
  if (nw < 1) return int(cudaErrorInvalidValue);
  const size_t bytes = nw * warp_bytes;
  int err = wide_smem_bytes(wide_info_filter<T, false>, bytes);
  if (err == 0) err = wide_smem_bytes(wide_info_filter<T, true>, bytes);
  if (err != 0) return err;
  const dim3 grid(unsigned(num_blocks(a.nblk, nw)), unsigned(batch));
  wide_info_filter<T, false><<<grid, nw * 32, bytes, stream>>>(a, p, s, steps);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<WideFilterOp<T>, false, T>(a.totals, a.nblk, batch, d, levels, stream);
  if (err != 0) return err;
  wide_info_filter<T, true><<<grid, nw * 32, bytes, stream>>>(a, p, s, steps);
  MF_CHECK_LAUNCH();
  sum_partials<T, 128><<<dim3(1u, unsigned(batch)), 128, 0, stream>>>(a.partials, a.nblk, 1,
                                                                       nullptr, a.loglik);
  MF_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// Kernel 7.  Both passes walk a warp's steps from the last to the first, as
// wide_gadjoint_pass does; a slot holds F, Q, c, P_{k-1}, m_{k-1} and the
// site, and in pass 3 an output region after them: gQ, gc, gF, and where
// an observation term is asked for gH [o x d], gnu [o], glam [o x o].
// ---------------------------------------------------------------------------

template <typename T>
using WideInfoAdjWork = WideInfoWork<T, 16 / sizeof(T), 9, 6>;

__host__ __device__ inline WideInfoSlot winfo_adj_slot(int d, int o, bool hs, bool ls) {
  return WideInfoSlot(d, o, hs, ls, 3 * d * d + 2 * d);
}

// Values of pass 3's output region.
__host__ __device__ inline int winfo_adj_nout(const WideInfoSlot& s, bool obs) {
  const int d = s.d, o = s.o;
  return 2 * d * d + d + (obs ? o * d + o + o * o : 0);
}

template <typename T>
__host__ __device__ int winfo_adj_floats(const WideInfoSlot& s, int per) {
  const int size = wide_smoother_size(s.d);
  return WideInfoAdjWork<T>::floats(s, size, size, s.d * s.d, per);
}

// Stage 1 of the step in slot st with F_{k+1} = fnext (GadjStage1W):
// fp = F P_{k-1}, Pp = sym(fp F^T + Q), a = F m_{k-1} + c, M = I + Pp J;
// L_k = F_{k+1} M^-1, H^T e = M^-T (h - J a), H^T W H = sym(J M^-1).
// fp, Pp and a stay for stage 2 (m[0], m[1], v[0]); L_k in m[4], H^T W H
// in m[5], H^T e in v[2].
template <typename T, class W>
MF_DEV void winfo_stage1(W& w, const T* st, const T* fnext, const T* h, const T* nu,
                         const T* lam, bool jconst, const WideInfoSlot& s) {
  const int d = s.d, o = s.o, dd = d * d;
  const T *f = st, *q = st + dd, *c = st + 2 * dd, *pprev = st + 2 * dd + d,
          *mprev = st + 3 * dd + d;
  T *fp = w.m[0], *pp = w.m[1], *mm = w.m[2], *minv = w.m[3], *lk = w.m[4], *hwh = w.m[5];
  T *a = w.v[0], *ra = w.v[1], *he = w.v[2];
  const T* js = jconst ? w.cj : w.js;
  const WProd<T> pf = wnn(f, pprev, fp, d), pa = wnv(f, mprev, a, d, c),
                 ph = winfo_h(h, nu, w.hs, d, o);
  if (jconst) {
    WProd<T> p1[] = {pf, pa, ph};
    wprods(p1);
    WProd<T> p2[] = {wsym_nt(fp, f, pp, d, q)};
    wprods(p2);
  } else {
    WProd<T> p1[] = {pf, pa, ph, winfo_lh(lam, h, w.lh, d, o)};
    wprods(p1);
    WProd<T> p2[] = {wsym_nt(fp, f, pp, d, q), winfo_j(h, w.lh, w.js, d, o)};
    wprods(p2);
  }
  WProd<T> p3[] = {wnn(pp, js, mm, d), wnv(js, a, ra, d, w.hs)};  // M = I + Pp J, h - J a
  p3[0].eye = true;
  p3[1].alpha = T(-1);
  wprods(p3);
  winv(mm, minv, d);
  WProd<T> p4[] = {wnn(fnext, minv, lk, d), wtv(minv, ra, he, d), wnn(js, minv, hwh, d)};
  p4[2].sym = true;
  wprods(p4);
}

// nxt = the step's element (E = L_k^T, g = H^T e, ell = H^T W H) composed
// with the suffix run, then swapped into run; the E leg only when FULL
// (pass 1).
template <typename T, bool FULL, class W>
MF_DEV void winfo_adj_fold(W& w, int d) {
  const int dd = d * d, OE = 0, OG = dd, OL = dd + d;
  const T *lk = w.m[4], *hwh = w.m[5], *he = w.v[2];
  T* t = w.m[2];
  const WProd<T> g = wtv(lk, w.run + OG, w.nxt + OG, d, he), l = wnn(w.run + OL, lk, t, d);
  if constexpr (FULL) {
    WProd<T> p1[] = {g, l, wtn(lk, w.run + OE, w.nxt + OE, d)};
    wprods(p1);
  } else {
    WProd<T> p1[] = {g, l};
    wprods(p1);
  }
  WProd<T> p2[] = {wtn(lk, t, w.nxt + OL, d, hwh)};  // sym(L_k^T L L_k + ell)
  p2[0].sym = true;
  wprods(p2);
  T* x = w.run; w.run = w.nxt; w.nxt = x;
}

// Stage 2 of the step in slot st (gadjoint_stage2 and info_obs) from
// r = run.g and NDK = run.L, scaled by gs, into the output region out:
//   N = (r r^T - NDK) / 2, gQ = N, gc = r, gF = r m_{k-1}^T + 2 N F P_{k-1};
// with obs, through the smoothed moments m_s = a + Pp r and
// A = sym(Pp - Pp NDK Pp) + m_s m_s^T, y = lam^-1 nu:
//   gH = nu m_s^T - lam H A, gnu = H m_s - y,
//   glam = (y y^T - H A H^T + lam^-1) / 2,
// zeros where the step is masked.
template <typename T, class W>
MF_DEV void winfo_stage2(const GeneralAdjointPrior<T>& p, W& w, const T* st, T* out,
                         const T* h, const T* nu, const T* lam, bool jconst, bool keep,
                         bool obs, T gs, const WideInfoSlot& s) {
  const int d = s.d, o = s.o, dd = d * d, lane = lane_id();
  const T *r = w.run + dd, *ndk = w.run + dd + d, *mprev = st + 3 * dd + d;
  const T *fp = w.m[0], *pp = w.m[1], *a = w.v[0];
  T *nm = w.m[2], *nfp = w.m[3];
  T *gq = out, *gc = out + dd, *gf = out + dd + d, *gh = out + 2 * dd + d,
    *gnu = gh + o * d, *glam = gnu + o;
  for (int e = lane; e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    nm[e] = T(0.5) * (r[i] * r[j] - ndk[e]);
  }
  __syncwarp();
  if (p.gf != nullptr) {
    WProd<T> pn[] = {wnn(nm, fp, nfp, d)};
    wprods(pn);
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      gf[e] = gs * (r[i] * mprev[j] + T(2) * nfp[e]);
    }
  }
  for (int e = lane; e < d; e += 32) gc[e] = gs * r[e];
  for (int e = lane; e < dd; e += 32) gq[e] = gs * nm[e];
  __syncwarp();
  if (!obs) return;
  if (!keep) {
    for (int e = lane; e < o * d + o + o * o; e += 32) gh[e] = T(0);
    __syncwarp();
    return;
  }
  T *npp = w.m[4], *ps = w.m[5], *ghr = w.m[6], *ha = w.m[7], *hah = w.m[8];
  T *li = s.ls ? w.m[3] : w.cli;
  T *ms = w.v[1], *hms = w.v[2], *y = w.v[3];
  const T* lh = jconst ? w.clh : w.lh;
  WProd<T> p1[] = {wnv(pp, r, ms, d, a), wnn(ndk, pp, npp, d)};
  wprods(p1);
  WProd<T> p2[] = {wnn(pp, npp, ps, d, pp)};  // sym(Pp - Pp NDK Pp)
  p2[0].alpha = T(-1);
  p2[0].sym = true;
  wprods(p2);
  if (s.ls) wsolve<T>(lam, nullptr, nu, li, y, o);  // lam^-1 and lam^-1 nu of the step
  for (int e = lane; e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    ps[e] += ms[i] * ms[j];
  }
  __syncwarp();
  // lam H A, H m_s, H A (and lam^-1 nu from the constant lam^-1)
  const WProd<T> q1 = wgen(lh, d, 1, ps, d, 1, ghr, o, d, d),
                 q2 = wgen(h, d, 1, ms, 1, 0, hms, o, 1, d),
                 q3 = wgen(h, d, 1, ps, d, 1, ha, o, d, d);
  if (s.ls) {
    WProd<T> p3[] = {q1, q2, q3};
    wprods(p3);
  } else {
    WProd<T> p3[] = {q1, q2, q3, wgen(li, o, 1, nu, 1, 0, y, o, 1, o)};
    wprods(p3);
  }
  WProd<T> p4[] = {wgen(ha, d, 1, h, 1, d, hah, o, o, d)};  // H A H^T
  wprods(p4);
  for (int e = lane; e < o * d; e += 32) {
    const int i = e / d, j = e - i * d;
    gh[e] = gs * (nu[i] * ms[j] - ghr[e]);
  }
  for (int e = lane; e < o; e += 32) gnu[e] = gs * (hms[e] - y[e]);
  for (int e = lane; e < o * o; e += 32) {
    const int i = e / o, j = e - i * o;
    glam[e] = gs * (T(0.5) * (y[i] * y[j] - hah[e] + li[e]));
  }
  __syncwarp();
}

// Passes 1 (OUTPUTS = false: fold the warp's steps into its suffix total)
// and 3 (OUTPUTS: fold them into the suffix of all later warps, g and L
// only, and write each step's gradients), a chunk of CH steps at a time,
// last chunk first.  per: the values of a slot.
template <typename T, bool OUTPUTS>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_info_adjoint(SmootherArgs<T> a, GeneralAdjointPrior<T> p, WideInfoSlot s, int per,
                  int64_t steps) {
  using W = WideInfoAdjWork<T>;
  constexpr int CH = W::CH;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int d = s.d, o = s.o, dd = d * d, size = wide_smoother_size(d);
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * nw + warp, n = a.n;
  if (u >= a.nblk) return;  // the whole warp; this kernel has no block barrier
  W w(reinterpret_cast<T*>(mf_wide_smem) + warp * winfo_adj_floats<T>(s, per), s, size, size,
      dd, per);
  const bool obs = p.gh != nullptr || p.gnu != nullptr || p.glam != nullptr;
  const GeneralPrior<T>& q = p.k;
  // F, Q, c, P_{k-1}, m_{k-1} (0 before step 0), the site
  const auto src = [&](int v, int64_t k) -> const T* {
    if (v < 2 * dd + d) return WideGeneralRow<T>::src(q, b, v, k, d);
    if (v < s.oh) {
      if (k == 0) return nullptr;
      v -= 2 * dd + d;
      return v < dd ? p.p_f + ((b * dd + v) * n + k - 1)
                    : p.m_f + ((b * d + v - dd) * n + k - 1);
    }
    return winfo_site_src(q, p, s, b, v, k);
  };
  // [gQ, gc, gF, gH, gnu, glam] from the output region
  const auto dst = [&](int v, int64_t k) -> T* {
    if (v < dd) return p.gq == nullptr ? nullptr : p.gq + ((b * dd + v) * n + k);
    if ((v -= dd) < d) return p.gc == nullptr ? nullptr : p.gc + ((b * d + v) * n + k);
    if ((v -= d) < dd) return p.gf == nullptr ? nullptr : p.gf + ((b * dd + v) * n + k);
    if ((v -= dd) < o * d) return p.gh == nullptr ? nullptr : p.gh + ((b * o * d + v) * n + k);
    if ((v -= o * d) < o) return p.gnu == nullptr ? nullptr : p.gnu + ((b * o + v) * n + k);
    v -= o;
    return p.glam == nullptr ? nullptr : p.glam + ((b * o * o + v) * n + k);
  };
  winfo_consts(q, p, s, b, w, OUTPUTS && obs);
  const bool jconst = !s.hs && !s.ls;
  T* total = a.totals + (b * a.nblk + u) * size;
  if (OUTPUTS) wcopy(w.run + dd, total + dd, d + dd);  // g, L of all later warps
  else wide_identity(w.run, size, d);
  const T gs = OUTPUTS ? p.gscale[b] : T(0);
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, n);
  int64_t kc = k0 + (k1 - 1 - k0) / CH * CH;  // k0 is a multiple of CH
  fetch_chunk<1>(w.aux, dd, k1, 1, [&](int v, int64_t k) {  // F_{k1}, 0 past the grid
    return k < n ? WideGeneralRow<T>::src(q, b, v, k, d) : nullptr;
  });
  T *cur = w.chunk[0], *ahead = w.chunk[1];
  fetch_chunk<CH>(cur, per, kc, int(k1 - kc), src, s.nin);
  wide_fetch_wait();
  for (; kc >= k0; kc -= CH) {
    const int cnt = int(imin(CH, k1 - kc));
    if (kc > k0) fetch_chunk<CH>(ahead, per, kc - CH, CH, src, s.nin);
    for (int j = cnt - 1; j >= 0; --j) {
      T* st = cur + j * per;
      const T *h = s.hs ? st + s.oh : w.ch, *nu = st + s.onu, *lam = s.ls ? st + s.olam : w.cl;
      const bool keep =
          !OUTPUTS || p.mask == nullptr || p.mask[b * p.mask_sb + (kc + j) * p.mask_st] > T(0.5);
      winfo_stage1(w, st, j + 1 < cnt ? st + per : w.aux, h, nu, lam, jconst, s);
      winfo_adj_fold<T, !OUTPUTS>(w, d);
      if (OUTPUTS) winfo_stage2(p, w, st, st + s.nin, h, nu, lam, jconst, keep, obs, gs, s);
    }
    if (OUTPUTS) store_chunk<CH>(cur, per, s.nin, per - s.nin, kc, cnt, dst);
    wcopy(w.aux, cur, dd);  // F_kc: F_{k+1} of step kc - 1
    wide_fetch_wait();
    T* t = cur; cur = ahead; ahead = t;
  }
  if (!OUTPUTS) wcopy(total, w.run, size);
}

// Kernel 7 at o = 2..12, d = 7..12: the scratch is wide_smoother_scratch's.
template <typename T>
int launch_wide_info_adjoint(GeneralAdjointPrior<T> p, T* scratch, int64_t batch, int64_t n,
                             int d, cudaStream_t stream) {
  const int o = int(p.o);
  if (d < WIDE_MIN_D || d > WIDE_MAX_D || o < 2 || o > WIDE_INFO_MAX_O)
    return int(cudaErrorInvalidValue);
  const WideInfoSlot s = winfo_adj_slot(d, o, p.k.h_st != 0, p.lam_st != 0);
  const bool obs = p.gh != nullptr || p.gnu != nullptr || p.glam != nullptr;
  const int per1 = s.nin, per3 = s.nin + winfo_adj_nout(s, obs);
  const size_t wb1 = size_t(winfo_adj_floats<T>(s, per1)) * sizeof(T),
               wb3 = size_t(winfo_adj_floats<T>(s, per3)) * sizeof(T);
  const int nw1 = wide_info_warps(wb1), nw3 = wide_info_warps(wb3);
  if (nw1 < 1 || nw3 < 1) return int(cudaErrorInvalidValue);
  const int64_t steps = wide_steps(n);
  SmootherArgs<T> a{nullptr, nullptr, scratch, n, num_blocks(n, steps)};
  int err = wide_smem_bytes(wide_info_adjoint<T, false>, nw1 * wb1);
  if (err == 0) err = wide_smem_bytes(wide_info_adjoint<T, true>, nw3 * wb3);
  if (err != 0) return err;
  wide_info_adjoint<T, false><<<dim3(unsigned(num_blocks(a.nblk, nw1)), unsigned(batch)),
                                nw1 * 32, nw1 * wb1, stream>>>(a, p, s, per1, steps);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<WideSmootherOp<T>, true, T>(
      a.totals, a.nblk, batch, d, a.totals + batch * a.nblk * wide_smoother_size(d), stream);
  if (err != 0) return err;
  wide_info_adjoint<T, true><<<dim3(unsigned(num_blocks(a.nblk, nw3)), unsigned(batch)),
                               nw3 * 32, nw3 * wb3, stream>>>(a, p, s, per3, steps);
  MF_CHECK_LAUNCH();
  return 0;
}

}  // namespace mf
