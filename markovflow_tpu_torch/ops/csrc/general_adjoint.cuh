// General-grid (per-step) Koopman backward kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel markovflow_tpu/ops/pallas_scan.py::
// pallas_adjoint_pipeline (_adjoint_kernel): stage 1, the reverse scan and
// stage 2 of the Koopman score in one kernel, for per-step prior steps
// (F, c, Q) and emission H on any time grid.  The plain PyTorch version is
// adjoint_pipeline_plain in markovflow_tpu_torch/ops/adjoint.py (the plain
// stages around the plain reverse scan).
//
// For each step k, stage 1 (GadjStage1, at o = 1) reads F_k, c_k, Q_k, H_k
// through their strides, the sites, (m, P)_{k-1} from the saved filtered
// moments and F_{k+1} (0 at the last step), and builds the smoothing
// element (L_k^T, H^T e, H^T W H).  The
// reverse scan of those elements gives r_k and NDK_k; stage 2 turns them into
// the step's gradients, scaled by the row's cotangent gscale:
//   gF_k = r m_{k-1}^T + 2 N F_k P_{k-1},  gc_k = r,  gQ_k = N,
//   N = (r r^T - NDK) / 2,
// and, through the smoothed moments, gH_k, gnu_k, glam_k (0 at masked steps).
// Each output may be null: the kernel writes only what autograd asks for
// (GPR asks for gF, gc and gQ).  Unlike the uniform backward there are no
// sums across steps, so no partials and no fourth pass.
//
// Passes: block totals of the reverse reduce, scan_totals, then an output
// pass that folds each step into the suffix of all later steps and writes
// its gradients.  d = 1..6 (below) keep the elements in registers, a run of
// steps a thread, and pass 3 starts from each thread's in-block suffix,
// which pass 1 stores; those passes are one template over a step source,
// which the uniform Koopman backward (kernel 3, adjoint_scan.cuh) shares.
// d = 7..12 run the same three passes a warp per element
// (wide_gadjoint_pass and the pass 2 of wide_scan.cuh), with stage 1 and
// stage 2 composed warp-cooperatively in the warp's workspace (see the
// notes above wide_gadjoint_pass).
//
// What bounds it on an H100: per step it reads F, c, Q (2 d^2 + d values),
// the sites (one expanded value each for GPR) and (m, P)_{k-1} (d^2 + d)
// twice, and writes gF, gc, gQ (2 d^2 + d): ~108 B a step at d = 2, float32,
// a 32 us floor at N = 1e6 (52 us at d = 9, N = 1e5).  Both routes cut the
// arithmetic of a step to a rank-one stage 1 (two d^3 products), three d^3
// products of the fold in pass 1 and two in pass 3 (no E leg), and one for
// stage 2's gF: at d = 2 some 150 dependent flops a step, so latency, not
// bytes, bounds it; at d = 7..12 the chain of a warp's steps, each a few
// shared-memory products of d x d matrices, and a pass 2 over many SMs.
#pragma once

#include "general_scan.cuh"

namespace mf {

template <typename T>
struct GeneralAdjointPrior {
  GeneralPrior<T> k;  // per-step F, c, Q, H, any strides
  // sites, any strides, as in FilterArgs
  const T *nu, *lam, *mask;
  int64_t nu_sb, nu_si, nu_st;
  int64_t lam_sb, lam_si, lam_sj, lam_st;
  int64_t mask_sb, mask_st;
  // filtered moments, contiguous: m_f [B, d, 1, N], P_f [B, d, d, N]
  const T *m_f, *p_f;
  const T* gscale;  // [B], the cotangent of each row's log-likelihood
  // per-step gradients, contiguous, each may be null: gF [B, d, d, N],
  // gc [B, d, 1, N], gQ [B, d, d, N], gH [B, o, d, N], gnu [B, o, 1, N],
  // glam [B, o, o, N]
  T *gf, *gc, *gq, *gh, *gnu, *glam;
  T* kept;  // scratch: the stage 1 pass 1 keeps for the lean pass 3 (o > 1), or null
  int64_t o;  // the output dim, for the sources that take it at run time (o > d)
};

// ---------------------------------------------------------------------------
// d = 1..6, with the elements in registers (the tiling and the staging of
// steps through shared memory of general_scan.cuh, with the moments
// P_{k-1}, m_{k-1} staged beside each step's inputs), for two step sources
// at o = 1: GeneralAdjSteps (kernel 7, below) and UniformAdjSteps (kernel 3,
// the uniform grid, adjoint_scan.cuh, whose pass 3 sums the gradients over
// the steps to one partial a block; sum_partials adds them); and two at
// o x o sites, GeneralAdjStepsO and UniformAdjStepsO (after
// GeneralAdjSteps).
//
// Each thread walks its R steps from the last to the first, carrying F_{k+1}
// from the step it has just done (gadjoint_walk).  Stage 1 needs no inverse
// at o = 1 (Zt, W and e are scalars), and L_k is a rank-one update of
// F_{k+1}: L_k = F_{k+1} - (F_{k+1} Pp H^T)(W H), so a step's stage 1 is two
// d^3 products (F P_{k-1} F^T); F P_{k-1} is also what stage 2's gF needs.
//   1. each thread folds its steps into its suffix with the full composition
//      (gadjoint_fold: pass 2 needs the E leg); the block scan gives every
//      thread its exclusive suffix within the block, which goes to the
//      scratch (store_thread_elem), and the block total;
//   2. scan_totals (scan_core.cuh);
//   3. each thread composes its stored suffix with its block's carry, g and L
//      legs only (stage 2 reads r = g and NDK = L, and no E product is
//      formed), folds its steps into them and writes each step's gradients:
//      (the source's out: kernel 7 gF, gc and gQ over the step's staged F,
//      c and Q, which the warp then stores; gH, gnu and glam, not on GPR's
//      path, where they lie).
// ---------------------------------------------------------------------------

// Stage 1 of step k: fp = F P_{k-1}, a = F m_{k-1} + c, Pp = sym(fp F^T + Q),
// Zt = 1 / (1 + lam H Pp H^T), W = Zt lam, e = Zt (nu - lam H a) and
// L_k = F_{k+1} - (F_{k+1} Pp H^T)(W H) (= F_{k+1} (I - Pp H^T W H)); the
// step's smoothing element is (E = L_k^T, g = H^T e, ell = W H^T H).
template <typename T, int D>
struct GadjStage1 {
  T mp[D], fp[D * D], a[D], pp[D * D], lk[D * D];
  T ev, w;

  MF_DEV void build(const GeneralIn<T, D>& in, const T* pprev, const T* fn) {
    mm<T, D, D, D>(in.f, pprev, fp);
    mm_nt<T, D, D, D>(fp, in.f, pp);
    add_to<T, D * D>(pp, in.q);
    sym<T, D>(pp);
    mm<T, D, D, 1>(in.f, mp, a);
    add_to<T, D>(a, in.c);
    T ph[D], fph[D];
    mm<T, D, D, 1>(pp, in.h, ph);
    const T zt = T(1) / (in.s.lam * dot<T, D>(in.h, ph) + T(1));
    w = zt * in.s.lam;
    ev = zt * (in.s.nu - in.s.lam * dot<T, D>(in.h, a));
    mm<T, D, D, 1>(fn, ph, fph);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) lk[i * D + j] = fn[i * D + j] - fph[i] * (w * in.h[j]);
    }
  }
};

// Walks thread t's steps t R .. t R + R - 1 (those below n; R: the pass's
// tiling GP's run) of batch row b from the last to the first: reads each
// step's inputs and the filtered moments of the step before (from the
// warp's stage when STAGED), builds stage 1 with F_{k+1} carried from the
// later step (F_{last + 1} from src.f_after) and calls body(in, st, k, r).
// Every lane of the warp must call it.
template <class GP, bool STAGED, class Src, class Body>
MF_DEV void gadjoint_walk(const Src& src, const typename Src::Prior& p, int64_t b, int64_t t,
                          int64_t n, const WarpStage<typename Src::T, GP::R>& st,
                          const GeneralSlots& sl, const Body& body) {
  using T = typename Src::T;
  constexpr int D = Src::D, R = GP::R;
  const int lane = lane_id();
  const int64_t first = t * R, last = imin(first + R, n) - 1;
  T fn[D * D], pprev[D * D];
  src.f_after(p, b, first, last, n, st, fn);
  typename Src::In in;
  typename Src::Stage1 s1;
  for (int r = int(last - first); r >= 0; --r) {
    const int64_t k = first + r;
    src.template read<STAGED>(in, s1.mp, pprev, st, sl, lane, r, p, b, k, k == last, n);
    s1.build(in, pprev, fn);
    body(in, s1, k, r);
#pragma unroll
    for (int i = 0; i < D * D; ++i) fn[i] = in.f[i];
  }
}

// The step's element (L_k^T, H^T e, W H^T H) composed with the suffix x
// (SmootherOp): g <- L_k^T g + H^T e, L <- sym(L_k^T L L_k + W H^T H) and,
// when FULL, E <- L_k^T E.
template <typename T, int D, bool FULL>
MF_DEV void gadjoint_fold(SElem<T, D>& x, const GadjStage1<T, D>& st, const T* h) {
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
  for (int i = 0; i < D; ++i) {
    g[i] = v[i] + h[i] * st.ev;
#pragma unroll
    for (int j = 0; j < D; ++j) l[i * D + j] = u[i * D + j] + st.w * (h[i] * h[j]);
  }
  sym<T, D>(l);
}

// nm = N = (r r^T - NDK) / 2
template <typename T, int D>
MF_DEV void gadjoint_n(const T* r, const T* ndk, T* nm) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) nm[i * D + j] = T(0.5) * (r[i] * r[j] - ndk[i * D + j]);
  }
}

// Stage 2's prior-step gradients from r, N = nm and stage 1's fp = F P_{k-1}
// and mp = m_{k-1}, scaled by gs: gF = r m_{k-1}^T + 2 N F P_{k-1}, gc = r,
// gQ = N, to gf[i * stride], gc[i * stride], gq[i * stride] (null: not
// asked for).
template <typename T, int D, class S1>
MF_DEV void gadjoint_prior_grads(const S1& st, const T* r, const T* nm, T gs, T* gf, T* gc,
                                 T* gq, int64_t stride) {
  if (gf != nullptr) {
    T nfp[D * D];
    mm<T, D, D, D>(nm, st.fp, nfp);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        gf[(i * D + j) * stride] = gs * (r[i] * st.mp[j] + T(2) * nfp[i * D + j]);
    }
  }
  if (gc != nullptr) {
#pragma unroll
    for (int i = 0; i < D; ++i) gc[i * stride] = gs * r[i];
  }
  if (gq != nullptr) {
#pragma unroll
    for (int i = 0; i < D * D; ++i) gq[i * stride] = gs * nm[i];
  }
}

// Stage 2: the step's gradients from r = g and NDK = L of the suffix from
// step k on, scaled by the row's cotangent gs (adjoint_grads_from_scan):
//   gF = r m_{k-1}^T + 2 N F P_{k-1},  gc = r,  gQ = N = (r r^T - NDK) / 2,
// to gf[i * stride], gc[i * stride], gq[i * stride] (null: not asked for);
// and, through the smoothed moments m_s = a + Pp r, A = sym(Pp - Pp NDK Pp)
// + m_s m_s^T, with y = nu / lam: gH = nu m_s^T - lam H A, gnu = H m_s - y,
// glam = (y^2 - H A H^T + 1 / lam) / 2 (0 at masked steps), to step k of
// p's arrays.
template <typename T, int D>
MF_DEV void gadjoint_stage2(const GeneralAdjointPrior<T>& p, const GeneralIn<T, D>& in,
                            const GadjStage1<T, D>& st, const T* r, const T* ndk, T gs,
                            T* gf, T* gc, T* gq, int64_t stride, int64_t b, int64_t k,
                            int64_t n) {
  T nm[D * D];
  gadjoint_n<T, D>(r, ndk, nm);
  gadjoint_prior_grads<T, D>(st, r, nm, gs, gf, gc, gq, stride);
  if (p.gh == nullptr && p.gnu == nullptr && p.glam == nullptr) return;
  T gh[D], gnu = T(0), glam = T(0);
#pragma unroll
  for (int j = 0; j < D; ++j) gh[j] = T(0);
  if (in.s.keep) {
    T ms[D], ps[D * D], t1[D * D], hak[D];
    mm<T, D, D, 1>(st.pp, r, ms);
    add_to<T, D>(ms, st.a);
    mm<T, D, D, D>(ndk, st.pp, t1);
    mm<T, D, D, D>(st.pp, t1, ps);
#pragma unroll
    for (int i = 0; i < D * D; ++i) ps[i] = st.pp[i] - ps[i];
    sym<T, D>(ps);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) ps[i * D + j] += ms[i] * ms[j];
    }
    mm_tn<T, D, D, 1>(ps, in.h, hak);  // (H A)^T
    const T li = T(1) / in.s.lam, y = li * in.s.nu;
    gnu = gs * (dot<T, D>(in.h, ms) - y);
    glam = gs * (T(0.5) * (y * y - dot<T, D>(hak, in.h) + li));
#pragma unroll
    for (int j = 0; j < D; ++j) gh[j] = gs * (in.s.nu * ms[j] - in.s.lam * hak[j]);
  }
  if (p.gh != nullptr) {
#pragma unroll
    for (int j = 0; j < D; ++j) p.gh[(b * D + j) * n + k] = gh[j];
  }
  if (p.gnu != nullptr) p.gnu[b * n + k] = gnu;
  if (p.glam != nullptr) p.glam[b * n + k] = glam;
}

// (m, P)_{k-1} of lane l's step r, global step k (0 before step 0): from
// the warp's stage when STAGED, else from p's m_f and p_f where they lie.
template <bool STAGED, int D, typename T, int R, class P>
MF_DEV void read_prev_moments(const P& p, const WarpStage<T, R>& st, const GeneralSlots& sl,
                              int lane, int r, int64_t b, int64_t k, int64_t n, T* mp,
                              T* pprev) {
  if constexpr (STAGED) {
#pragma unroll
    for (int i = 0; i < D; ++i) mp[i] = *st.at(sl.mprev + i, lane, r);
#pragma unroll
    for (int i = 0; i < D * D; ++i) pprev[i] = *st.at(sl.pprev + i, lane, r);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      mp[i] = k > 0 ? p.m_f[(b * D + i) * n + k - 1] : T(0);
#pragma unroll
      for (int j = 0; j < D; ++j)
        pprev[i * D + j] = k > 0 ? p.p_f[((b * D + i) * D + j) * n + k - 1] : T(0);
    }
  }
}

// A step source of the Koopman backward passes below, for batch row b
// (Src src; src.load(prior, b)):
//   T, D, Prior; In, what a step's read fills; Stage1, its stage 1
//   (GadjStage1, or GadjStage1O at o x o sites); G, the tiling
//   (StagedTiling): pass 3 stages when
//   G::STAGED, pass 1 when STAGED1; NSUM, the number of sums that pass 3
//   reduces over the steps to one partial per block (0: none);
//   slots(prior): the staged slots, (m, P)_{k-1} in mprev and pprev;
//   stage<STAGED>(prior, b, t, n, st, sl): thread t's warp's stage,
//     started and waited for when STAGED; every lane of the warp must call
//     it;
//   f_after(prior, b, first, last, n, st, fn): F_{last + 1} of the thread's
//     last step (0 past step n - 1); every lane of the warp must call it;
//   read<STAGED>(in, mp, pprev, st, sl, l, r, prior, b, k, once, n): lane
//     l's step r, global step k: its inputs and (m, P)_{k-1} (0 before step
//     0); once: the thread's first step read (its last);
//   out(prior, in, s1, rv, ndk, gs, st, l, r, b, k, n): pass 3, the step's
//     gradients from r = rv and NDK = ndk of the suffix from step k on;
//   finish<THREADS>(prior, a, st, b, red): pass 3's end, after every step
//     (red: NSUM values a warp of the block's shared memory); a source with
//     SMEM3 (Smem3Of) takes finish<THREADS>(prior, a, b), its sums in the
//     dynamic shared memory.

// Kernel 7: per-step F, Q, c and H through their strides, staged with the
// sites and (m, P)_{k-1} to d = 3; pass 3 puts gF over the staged F, gQ
// over Q and gc over c, and writes gH, gnu and glam (not on GPR's path)
// where they lie.
template <typename T_, int D_>
struct GeneralAdjSteps {
  using T = T_;
  static constexpr int D = D_;
  using Prior = GeneralAdjointPrior<T>;
  using G = GeneralTiling<T, D, true>;
  using In = GeneralIn<T, D>;
  using Stage1 = GadjStage1<T, D>;
  static constexpr int NSUM = 0;
  static constexpr bool STAGED1 = G::STAGED;

  MF_DEV void load(const Prior&, int64_t) {}

  static __host__ __device__ GeneralSlots slots(const Prior& p) {
    return general_slots<D>(p.k, p, true);
  }

  template <bool STAGED>
  MF_DEV void stage(const Prior& p, int64_t b, int64_t t, int64_t n, WarpStage<T, G::R>& st,
                    GeneralSlots& sl) const {
    stage_steps<G, D>(p.k, p, b, t, n, p.m_f, p.p_f, st, sl);
  }

  // from the stage when step last + 1 is one of the warp's steps (the next
  // lane's first), read before any lane writes over it
  MF_DEV void f_after(const Prior& p, int64_t b, int64_t first, int64_t last, int64_t n,
                      const WarpStage<T, G::R>& st, T* fn) const {
    const GeneralPrior<T>& q = p.k;
    const int64_t next = last + 1 - st.w0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        fn[i * D + j] =
            last < first || last + 1 >= n ? T(0)
            : G::STAGED && next < 32 * G::R
                ? *st.step(i * D + j, int(next))
                : q.f[b * q.f_sb + i * q.f_si + j * q.f_sj + (last + 1) * q.f_st];
    }
    if constexpr (G::STAGED) __syncwarp();
  }

  template <bool STAGED>
  MF_DEV void read(In& in, T* mp, T* pprev, const WarpStage<T, G::R>& st,
                   const GeneralSlots& sl, int lane, int r, const Prior& p, int64_t b,
                   int64_t k, bool once, int64_t n) const {
    in.template read<STAGED>(st, sl, lane, r, p.k, p, b, k, once);
    read_prev_moments<STAGED, D>(p, st, sl, lane, r, b, k, n, mp, pprev);
  }

  // gF, gc and gQ over the step's staged F, c and Q, or at step k
  MF_DEV void out(const Prior& p, const In& in, const GadjStage1<T, D>& s1, const T* rv,
                  const T* ndk, T gs, const WarpStage<T, G::R>& st, int lane, int r, int64_t b,
                  int64_t k, int64_t n) {
    const auto at = [&](T* arr, int v, int rows) -> T* {
      if (arr == nullptr) return nullptr;
      return G::STAGED ? st.at(v, lane, r) : arr + b * rows * n + k;
    };
    gadjoint_stage2<T, D>(p, in, s1, rv, ndk, gs, at(p.gf, 0, D * D), at(p.gc, 2 * D * D, D),
                          at(p.gq, D * D, D * D), G::STAGED ? 32 * G::R : n, b, k, n);
  }

  template <int THREADS>
  MF_DEV void finish(const Prior& p, const SmootherArgs<T>& a, const WarpStage<T, G::R>& st,
                     int64_t b, T*) const {
    if constexpr (G::STAGED) {
      const int64_t n = a.n;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < D * D; ++i) {
        if (p.gf != nullptr) st.store(i, p.gf + (b * D * D + i) * n);
        if (p.gq != nullptr) st.store(D * D + i, p.gq + (b * D * D + i) * n);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        if (p.gc != nullptr) st.store(2 * D * D + i, p.gc + (b * D + i) * n);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Kernels 7 and 3 at o = 2..d (d <= 6): o x o sites, as a multi-output GPR
// gives them (a block-diagonal [o, d] emission and one full noise
// precision, IndependentMultiOutput with MultivariateGaussian noise).  The
// passes above over two more step sources, GeneralAdjStepsO (kernel 7) and
// UniformAdjStepsO (kernel 3, adjoint_scan.cuh); the sources at o = 1 keep
// their code.  Stage 1 (GadjStage1O, _adjoint_elem_slice) takes one pivoted
// o x o solve,
//   (I + lam S) [X | e] = [lam | nu - lam H a],   S = H Pp H^T,
// X = Zt lam, W = sym(X), and L_k = F_{k+1} - (F_{k+1} Pp H^T)(W H); the
// element is (L_k^T, H^T e, H^T W H), whose g and L legs the fold forms
// from e and W.  Stage 2's observation terms (gadjoint_obs_o,
// _adjoint_grads_slice) take a second solve, lam [X | y] = [I | nu], for
// lam^-1 and y; a masked step gives zero gH, gnu and glam.  Each source
// reads a step's values where they lie (at d = 6 they outgrow the warp's
// stage, StagedTiling::STAGED) and writes its per-step gradients to step k.
//
// What bounds them at d = 6, o = 3 (PERF.md has the times): the arithmetic of a
// step (stage 1 ~1.1k FMAs, the fold ~0.7k), in pass 1 the block scan's
// full compositions (~0.65k FMAs each, six or seven a thread) and pass 2's
// chain of them, at 255 registers a thread; and kernel 7's reads of its
// 120 values a step (F, Q, c, P_{k-1}, m_{k-1}) where they lie, lanes R
// steps apart, in passes 1 and 3, and its writes of gF, gQ and gc.  So:
//   - where no observation term is asked for (GPR's backward: no gH, gnu
//     or glam, and for kernel 3 no gHc), the entry points launch a lean
//     pass 3 (OBS = false), whose stage 1 (GadjStage1O) is m_{k-1},
//     F P_{k-1}, L_k, e and W alone (not Pp, a and Pp H^T: GadjStage1ObsO)
//     and whose kernel 3 sums no gHc.  Kernel 7's pass 1 then keeps each
//     step's stage 1 (KEEP: 90 values at d = 6, o = 3) in the scratch, in
//     rows of pass-1 threads, so that its stores and pass 3's loads are
//     whole rows, and its lean pass 3 reads that and H, not the step's
//     inputs, and builds no stage 1 (pass 3 1.52 -> 0.87 ms, pass 1 +0.4 at
//     (6, 3)).  Kernel 3 in float32 rebuilds stage 1 in pass 3 (it reads
//     only P_{k-1} and m_{k-1} there; kept, pass 1's stores cost it more
//     than pass 3 gained), in float64 it keeps it too (UniformAdjStepsO);
//   - from d = 4 pass 1 runs 8 warps a block and runs of 8 steps a thread
//     (pass 3: Tiling<D>'s 4 warps and 4 steps; the source's G1): 4x fewer
//     block totals for pass 2 and half the block-scan compositions a step
//     (RunSplit, as the filters' FilterSplit; runs of 16 took longer, as a
//     thread's steps read where they lie outgrew L1).  Walking its run from
//     the last step, pass 1 stores, as it enters each of its pass-3 runs
//     but the last, the element of its later steps, and its in-block
//     exclusive suffix where the last pass-3 run's is kept (prefix_slot); a
//     pass-3 thread composes the g and L legs of its block's carry with the
//     suffix and, but for the last of its pass-1 run, with that element;
//   - in float32 passes 1 and 2 inline the composition (SmootherOp's
//     CALL = false): as a call, its two elements went through local
//     memory, and passes 1 and 2 took 1.3x and 2x as long;
//   - kernel 3 sums the constants' gradients in shared memory, not in
//     registers (UniformAdjStepsO).
// Pass 1 is the lean source's for both routes (Pass1Of).
// ---------------------------------------------------------------------------

// The tiling of passes that read each step where they lie: R_ steps a
// thread (Tiling<D>'s by default) and WARPS_ warps a block, no stage.
template <int D, int R_ = Tiling<D>::R, int WARPS_ = Tiling<D>::THREADS / 32>
struct UnstagedTiling {
  static constexpr int R = R_, NV = 0, WARPS = WARPS_, THREADS = 32 * WARPS;
  static constexpr bool STAGED = false;
  static constexpr int64_t TILE = int64_t(THREADS) * R;
  static constexpr int SCAN_THREADS = 512;
};

// Pass 1's source and tiling of a Koopman backward: a source with a lean
// twin (Src::Totals) runs the twin's pass 1, in the twin's tiling G1; any
// other source runs its own pass 1 in its own tiling G.  keeps: the twin
// sets KEEP and this source's pass 3 is the lean one, so pass 1 keeps its
// stage 1 and pass 3 reads it.
// Op: the composition of passes 1 and 2, inlined for the sources with a
// lean twin in float32 (in float64, inlined at d = 6, ptxas kept 32
// registers, spilled 114 KB and pass 1 took 3-5x as long).
template <class Src, class = void>
struct Pass1Of {
  using type = Src;
  using G1 = typename Src::G;
  using Op = SmootherOp<typename Src::T, Src::D>;
  static constexpr bool keeps = false;
};
template <class Src>
struct Pass1Of<Src, std::void_t<typename Src::Totals>> {
  using type = typename Src::Totals;
  using G1 = typename type::G1;
  using Op = SmootherOp<typename Src::T, Src::D,
                        std::is_same_v<typename Src::T, double> && (Src::D >= 4)>;
  static constexpr bool keeps = type::KEEP && !Src::OBS;
};

template <class Src>
using AdjointSplit = RunSplit<typename Pass1Of<Src>::G1, typename Src::G>;

// Values a thread of pass 3 keeps in the block's dynamic shared memory
// (Src::SMEM3, after the stage; the source takes them in sums_in), else 0.
template <class Src, class = void>
struct Smem3Of {
  static constexpr int value = 0;
};
template <class Src>
struct Smem3Of<Src, std::void_t<decltype(Src::SMEM3)>> {
  static_assert(!Src::G::STAGED, "its pass 3 reads its steps where they lie");
  static constexpr int value = Src::SMEM3;
};

// Dynamic shared memory of pass 3: the stage of nv values a step, and
// Smem3Of.
template <class Src>
size_t adjoint_pass3_bytes(int nv) {
  using G = typename Src::G;
  return general_stage_bytes<G, typename Src::T>(nv) +
         size_t(Smem3Of<Src>::value) * G::THREADS * sizeof(typename Src::T);
}

// Stage 1 of step k at o x o sites: fp = F P_{k-1} and, for the element,
// lk = L_k, e and W (mp = m_{k-1} is read into it first).
template <typename T, int D, int O>
struct GadjStage1O {
  static constexpr int SIZE = D + 2 * D * D + O + O * O;
  T mp[D], fp[D * D], lk[D * D], e[O], w[O * O];

  // the SIZE values, mp, fp, lk, e, w, to and from base[v * stride], each
  // read once: marked first to go from the caches
  MF_DEV void store(T* base, int64_t stride) const {
    each(*this, [&](int v, const T& x) { __stcs(base + v * stride, x); });
  }
  MF_DEV void load(const T* base, int64_t stride) {
    each(*this, [&](int v, T& x) { x = __ldcs(base + v * stride); });
  }
  template <class S, class F>
  static MF_DEV void each(S& s, const F& f) {
    int v = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) f(v++, s.mp[i]);
#pragma unroll
    for (int i = 0; i < D * D; ++i) f(v++, s.fp[i]);
#pragma unroll
    for (int i = 0; i < D * D; ++i) f(v++, s.lk[i]);
#pragma unroll
    for (int i = 0; i < O; ++i) f(v++, s.e[i]);
#pragma unroll
    for (int i = 0; i < O * O; ++i) f(v++, s.w[i]);
  }

  MF_DEV void build(const GeneralInO<T, D, O>& in, const T* pprev, const T* fn) {
    T pp[D * D], a[D], ph[D * O];
    terms(in, pprev, fn, pp, a, ph);
  }

  // ... and Pp, a = F m_{k-1} + c and ph = Pp H^T [d x o] to pp, a and ph
  MF_DEV void terms(const GeneralInO<T, D, O>& in, const T* pprev, const T* fn, T* pp, T* a,
                    T* ph) {
    constexpr int K = O + 1;
    mm<T, D, D, D>(in.f, pprev, fp);
    mm_nt<T, D, D, D>(fp, in.f, pp);
    add_to<T, D * D>(pp, in.q);
    sym<T, D>(pp);
    mm<T, D, D, 1>(in.f, mp, a);
    add_to<T, D>(a, in.c);
    mm_nt<T, D, D, O>(pp, in.h, ph);
    T s[O * O], ha[O], lha[O], mt[O * O], rhs[O * K], x[O * K];
    mm<T, O, D, O>(in.h, ph, s);
    mm<T, O, D, 1>(in.h, a, ha);
    mm<T, O, O, 1>(in.lam, ha, lha);
    mm<T, O, O, O>(in.lam, s, mt);
    add_eye<T, O>(mt);  // I + lam S
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < O; ++j) rhs[i * K + j] = in.lam[i * O + j];
      rhs[i * K + O] = in.nu[i] - lha[i];
    }
    gauss_jordan_solve<T, O, K>(mt, rhs, x);
    T wh[O * D], fph[D * O];
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < O; ++j) w[i * O + j] = T(0.5) * (x[i * K + j] + x[j * K + i]);
      e[i] = x[i * K + O];
    }
    mm<T, O, O, D>(w, in.h, wh);
    mm<T, D, D, O>(fn, ph, fph);
    mm<T, D, O, D>(fph, wh, lk);
#pragma unroll
    for (int i = 0; i < D * D; ++i) lk[i] = fn[i] - lk[i];
  }
};

// GadjStage1O that also keeps Pp, a and Pp H^T for the observation terms.
template <typename T, int D, int O>
struct GadjStage1ObsO : GadjStage1O<T, D, O> {
  T pp[D * D], a[D], ph[D * O];

  MF_DEV void build(const GeneralInO<T, D, O>& in, const T* pprev, const T* fn) {
    this->terms(in, pprev, fn, pp, a, ph);
  }
};

// gadjoint_fold at o x o sites: g <- L_k^T g + H^T e,
// L <- sym(L_k^T L L_k + H^T W H) and, when FULL, E <- L_k^T E.
template <typename T, int D, bool FULL, int O>
MF_DEV void gadjoint_fold(SElem<T, D>& x, const GadjStage1O<T, D, O>& st, const T* h) {
  using E = SElem<T, D>;
  T *ee = x.v + E::OE, *g = x.v + E::OG, *l = x.v + E::OL;
  T t[D * D], u[D * D], v[D], he[D], wh[O * D];
  mm_tn<T, D, D, 1>(st.lk, g, v);
  mm<T, D, D, D>(l, st.lk, t);
  mm_tn<T, D, D, D>(st.lk, t, u);
  if constexpr (FULL) {
    mm_tn<T, D, D, D>(st.lk, ee, t);
#pragma unroll
    for (int i = 0; i < D * D; ++i) ee[i] = t[i];
  }
  mm_tn<T, D, O, 1>(h, st.e, he);
  mm<T, O, O, D>(st.w, h, wh);
  mm_tn<T, D, O, D>(h, wh, t);  // H^T W H
#pragma unroll
  for (int i = 0; i < D; ++i) g[i] = v[i] + he[i];
#pragma unroll
  for (int i = 0; i < D * D; ++i) l[i] = u[i] + t[i];
  sym<T, D>(l);
}

// Stage 2's observation terms at o x o sites, unscaled, through the
// smoothed moments m_s = a + Pp r and A = Pp - Pp NDK Pp + m_s m_s^T (Pp
// and NDK are symmetric, so A H^T = Pp H^T - Pp NDK (Pp H^T) + m_s (H m_s)^T
// in d^2 o products), with y = lam^-1 nu:
//   gh = nu m_s^T - lam H A [o x d],  gnu = H m_s - y [o],
//   glam = (y y^T - H A H^T + lam^-1) / 2 [o x o];
// gnu and glam only with `sites`; a masked step gives zeros.
template <typename T, int D, int O>
MF_DEV void gadjoint_obs_o(const GeneralInO<T, D, O>& in, const GadjStage1ObsO<T, D, O>& s1,
                           const T* r, const T* ndk, bool sites, T* gh, T* gnu, T* glam) {
  if (!in.keep) {
#pragma unroll
    for (int i = 0; i < O * D; ++i) gh[i] = T(0);
#pragma unroll
    for (int i = 0; i < O; ++i) gnu[i] = T(0);
#pragma unroll
    for (int i = 0; i < O * O; ++i) glam[i] = T(0);
    return;
  }
  T ms[D], t1[D * O], hak[D * O], hms[O];
  mm<T, D, D, 1>(s1.pp, r, ms);
  add_to<T, D>(ms, s1.a);
  mm<T, D, D, O>(ndk, s1.ph, t1);
  mm<T, D, D, O>(s1.pp, t1, hak);
  mm<T, O, D, 1>(in.h, ms, hms);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < O; ++j) hak[i * O + j] = s1.ph[i * O + j] - hak[i * O + j] + ms[i] * hms[j];
  }
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = in.nu[i] * ms[j];
#pragma unroll
      for (int k = 0; k < O; ++k) acc -= in.lam[i * O + k] * hak[j * O + k];
      gh[i * D + j] = acc;
    }
  }
  if (!sites) return;
  constexpr int K = O + 1;
  T rhs[O * K], x[O * K], hah[O * O];
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < O; ++j) rhs[i * K + j] = T(i == j);
    rhs[i * K + O] = in.nu[i];
  }
  gauss_jordan_solve<T, O, K>(in.lam, rhs, x);  // [lam^-1 | y]
  mm<T, O, D, O>(in.h, hak, hah);
#pragma unroll
  for (int i = 0; i < O; ++i) {
    gnu[i] = hms[i] - x[i * K + O];
#pragma unroll
    for (int j = 0; j < O; ++j)
      glam[i * O + j] =
          T(0.5) * (x[i * K + O] * x[j * K + O] - hah[i * O + j] + x[i * K + j]);
  }
}

// Kernel 7 at o = 2..d: per-step F, Q, c and H [o, d] through their
// strides, each step read where it lies, every gradient written to step k;
// with OBS_ also the observation terms (gH, gnu, glam) where asked for.
template <typename T_, int D_, int O_, bool OBS_>
struct GeneralAdjStepsO {
  using T = T_;
  static constexpr int D = D_, O = O_;
  static constexpr bool OBS = OBS_;
  using Prior = GeneralAdjointPrior<T>;
  using G = UnstagedTiling<D>;
  using In = GeneralInO<T, D, O>;
  using Stage1 = std::conditional_t<OBS, GadjStage1ObsO<T, D, O>, GadjStage1O<T, D, O>>;
  using G1 = UnstagedTiling<D, D <= 3 ? G::R : 8, D <= 3 ? G::WARPS : 8>;  // pass 1's
  using Totals = GeneralAdjStepsO<T, D, O, false>;
  static constexpr int NSUM = 0;
  static constexpr bool STAGED1 = false, KEEP = true;

  MF_DEV void load(const Prior&, int64_t) {}

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
                   int lane, int r, const Prior& p, int64_t b, int64_t k, bool once,
                   int64_t n) const {
    in.template read<false>(st, sl, lane, r, p.k, p, b, k, once);
    read_prev_moments<false, D>(p, st, sl, lane, r, b, k, n, mp, pprev);
  }

  // H of step k to h (only once, once, where its step stride is 0)
  MF_DEV void read_h(const Prior& p, int64_t b, int64_t k, bool once, T* h) const {
    const GeneralPrior<T>& q = p.k;
    if (!once && q.h_st == 0) return;
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        h[i * D + j] = q.h[b * q.h_sb + i * q.h_si + j * q.h_sj + k * q.h_st];
    }
  }

  // gF, gc, gQ (gadjoint_prior_grads) and, with OBS, the observation
  // terms, scaled by gs, at step k (null: not asked for)
  MF_DEV void out(const Prior& p, const In& in, const Stage1& s1, const T* rv, const T* ndk,
                  T gs, const WarpStage<T, G::R>&, int, int, int64_t b, int64_t k,
                  int64_t n) {
    T nm[D * D];
    gadjoint_n<T, D>(rv, ndk, nm);
    const auto at = [&](T* arr, int rows) { return arr == nullptr ? arr : arr + b * rows * n + k; };
    gadjoint_prior_grads<T, D>(s1, rv, nm, gs, at(p.gf, D * D), at(p.gc, D), at(p.gq, D * D), n);
    if constexpr (OBS) {
      if (p.gh == nullptr && p.gnu == nullptr && p.glam == nullptr) return;
      T gh[O * D], gnu[O], glam[O * O];
      gadjoint_obs_o<T, D, O>(in, s1, rv, ndk, p.gnu != nullptr || p.glam != nullptr, gh, gnu,
                              glam);
      if (p.gh != nullptr) {
#pragma unroll
        for (int i = 0; i < O * D; ++i) p.gh[(b * O * D + i) * n + k] = gs * gh[i];
      }
      if (p.gnu != nullptr) {
#pragma unroll
        for (int i = 0; i < O; ++i) p.gnu[(b * O + i) * n + k] = gs * gnu[i];
      }
      if (p.glam != nullptr) {
#pragma unroll
        for (int i = 0; i < O * O; ++i) p.glam[(b * O * O + i) * n + k] = gs * glam[i];
      }
    }
  }

  template <int THREADS>
  MF_DEV void finish(const Prior&, const SmootherArgs<T>&, const WarpStage<T, G::R>&, int64_t,
                     T*) const {}
};

// The (d, o) pairs of the Koopman backwards at o > 1 are those of the
// general filter (MF_GENERAL_O_PAIRS): adjointo_inst.cu instantiates both,
// each with and without the observation terms.

// The kept stage 1 of pass-1 thread t1's step r1 (of its run), batch row b
// (nblk1: pass 1's blocks a row): value v at the result + v nblk1 TILE1, in
// rows of pass-1 threads, so that pass 1's lanes store whole rows and pass
// 3's (SUB to a pass-1 thread) load SUB whole half rows.
template <class Src>
MF_DEV typename Src::T* kept_stage1(typename Src::T* kept, int64_t b, int64_t t1, int r1,
                                    int64_t nblk1) {
  using G1 = typename Pass1Of<Src>::G1;
  constexpr int SIZE1 = Pass1Of<Src>::type::Stage1::SIZE;
  return kept + (b * SIZE1 * G1::R + r1) * (nblk1 * G1::THREADS) + t1;
}

template <class Src>
__global__ void __launch_bounds__(Pass1Of<Src>::G1::THREADS)
gadjoint_totals(SmootherArgs<typename Src::T> a, typename Src::Prior p) {
  using T = typename Src::T;
  constexpr int D = Src::D;
  using G = typename Pass1Of<Src>::G1;
  using Op = typename Pass1Of<Src>::Op;
  using E = SElem<T, D>;
  constexpr int THREADS = G::THREADS, SUB = AdjointSplit<Src>::SUB, R3 = G::R / SUB;
  __shared__ E smem[THREADS / 32 + 1];
  const int64_t b = blockIdx.y, n = a.n, t = blockIdx.x * int64_t(THREADS) + threadIdx.x;
  const int64_t pre = a.nblk * THREADS * SUB;  // the stored elements of a row
  Src src;
  src.load(p, b);
  WarpStage<T, G::R> st;
  GeneralSlots sl{};
  src.template stage<Src::STAGED1>(p, b, t, n, st, sl);
  E run, excl, total;
  Op::identity(run);
  gadjoint_walk<G, Src::STAGED1>(src, p, b, t, n, st, sl,
                [&](const typename Src::In& in, const typename Src::Stage1& s1, int64_t k,
                    int r) {
                  // stage 1 kept for the lean pass 3 (kept_stage1)
                  if constexpr (Pass1Of<Src>::keeps) {
                    if (p.kept != nullptr)
                      s1.store(kept_stage1<Src>(p.kept, b, t, r, a.nblk), a.nblk * G::TILE);
                  }
                  // entering one of its pass-3 runs but the last (its first
                  // step walked): the element of the run's later steps
                  if constexpr (SUB > 1) {
                    if (((r + 1) % R3 == 0 || k + 1 == n) && r / R3 < SUB - 1)
                      store_thread_elem(a.prefix, run, b,
                                        prefix_slot<SUB>(t * SUB + r / R3, pre), pre);
                  }
                  gadjoint_fold<T, D, true>(run, s1, in.h);
                });
  block_scan<Op, THREADS, true>(run, excl, total, smem);
  store_thread_elem(a.prefix, excl, b, prefix_slot<SUB>(t * SUB + SUB - 1, pre), pre);
  if (threadIdx.x == 0) reinterpret_cast<E*>(a.totals)[b * a.nblk + blockIdx.x] = total;
}

// a.nblk: pass 3's blocks a row, AdjointSplit's BPB to each of pass 1's
template <class Src>
__global__ void __launch_bounds__(Src::G::THREADS)
gadjoint_outputs(SmootherArgs<typename Src::T> a, typename Src::Prior p) {
  using T = typename Src::T;
  constexpr int D = Src::D;
  using G = typename Src::G;
  using E = SElem<T, D>;
  constexpr int THREADS = G::THREADS, SUB = AdjointSplit<Src>::SUB,
                BPB = AdjointSplit<Src>::BPB;
  const int64_t b = blockIdx.y, n = a.n, t = blockIdx.x * int64_t(THREADS) + threadIdx.x;
  const int64_t pre = a.nblk * THREADS;  // the stored elements of a row
  const int lane = lane_id();
  Src src;
  src.load(p, b);
  WarpStage<T, G::R> st;
  GeneralSlots sl{};
  src.template stage<G::STAGED>(p, b, t, n, st, sl);
  if constexpr (Smem3Of<Src>::value > 0) src.sums_in(reinterpret_cast<T*>(mf_wide_smem));
  // the g and L legs of all later blocks of pass 1, then the later threads
  // of this one, then, where SUB > 1, the later steps of its pass-1
  // thread's run
  E run;
  {
    E x;
    load_thread_elem(a.prefix, x, b, prefix_slot<SUB>(t - t % SUB + SUB - 1, pre), pre);
    const E& c = reinterpret_cast<const E*>(a.totals)[b * (a.nblk / BPB) + blockIdx.x / BPB];
    smoother_gl<T, D>(x.v + E::OE, x.v + E::OG, x.v + E::OL, c.v + E::OG, c.v + E::OL,
                      run.v + E::OG, run.v + E::OL);
    if constexpr (SUB > 1) {
      if (t % SUB != SUB - 1) {
        T g[D], l[D * D];
        load_thread_elem(a.prefix, x, b, prefix_slot<SUB>(t, pre), pre);
        smoother_gl<T, D>(x.v + E::OE, x.v + E::OG, x.v + E::OL, run.v + E::OG, run.v + E::OL,
                          g, l);
#pragma unroll
        for (int i = 0; i < D; ++i) run.v[E::OG + i] = g[i];
#pragma unroll
        for (int i = 0; i < D * D; ++i) run.v[E::OL + i] = l[i];
      }
    }
  }
  const T gs = p.gscale[b];
  const auto step = [&](const typename Src::In& in, const typename Src::Stage1& s1, int64_t k,
                        int r) {
    gadjoint_fold<T, D, false>(run, s1, in.h);
    src.out(p, in, s1, run.v + E::OG, run.v + E::OL, gs, st, lane, r, b, k, n);
  };
  if constexpr (Pass1Of<Src>::keeps) {
    // stage 1 as pass 1 kept it, H where it lies: no other input of a step
    const int64_t first = t * G::R, last = imin(first + G::R, n) - 1;
    typename Src::In in;
    typename Src::Stage1 s1;
    for (int r = int(last - first); r >= 0; --r) {
      const int64_t k = first + r;
      src.read_h(p, b, k, k == last, in.h);
      s1.load(kept_stage1<Src>(p.kept, b, t / SUB, int(t % SUB) * G::R + r, a.nblk / BPB),
              a.nblk / BPB * Pass1Of<Src>::G1::TILE);
      step(in, s1, k, r);
    }
  } else {
    gadjoint_walk<G, G::STAGED>(src, p, b, t, n, st, sl, step);
  }
  if constexpr (Smem3Of<Src>::value > 0) {
    src.template finish<THREADS>(p, a, b);
  } else if constexpr (Src::NSUM > 0) {
    __shared__ T red[Src::NSUM * (THREADS / 32)];
    src.template finish<THREADS>(p, a, st, b, red);
  } else {
    src.template finish<THREADS>(p, a, st, b, nullptr);
  }
}

// Scratch of the Koopman backward passes in elements of T: pass 1's block
// totals, every pass-3 thread's stored element, the NSUM partial sums of
// each pass-3 block and, for a lean pass 3 that reads it, the kept stage 1
// of every step.
template <class Src>
int64_t general_adjoint_scratch(int64_t batch, int64_t n) {
  using P1 = Pass1Of<Src>;
  constexpr int SIZE = SElem<typename Src::T, Src::D>::SIZE;
  const int64_t nblk = num_blocks(n, P1::G1::TILE), nblk3 = nblk * AdjointSplit<Src>::BPB;
  int64_t kept = 0;
  if constexpr (P1::keeps) kept = nblk * P1::G1::TILE * P1::type::Stage1::SIZE;
  return batch * (nblk * SIZE + nblk3 * (SIZE * Src::G::THREADS + Src::NSUM) + kept);
}

// pass_occupancy of passes 1, 3 and 2 (out[0..11]), staged for the largest
// number of values a step.
template <class Src>
int general_adjoint_occupancy(int64_t* out) {
  using T = typename Src::T;
  using S1 = typename Pass1Of<Src>::type;
  using G = typename Src::G;
  using G1 = typename Pass1Of<Src>::G1;
  const size_t bytes = adjoint_pass3_bytes<Src>(G::NV),
               b1 = S1::STAGED1 ? general_stage_bytes<G1, T>(G1::NV) : 0;
  int err = wide_smem_bytes(gadjoint_totals<S1>, b1);
  if (err == 0) err = wide_smem_bytes(gadjoint_outputs<Src>, bytes);
  if (err == 0) err = pass_occupancy(gadjoint_totals<S1>, G1::THREADS, b1, out);
  if (err == 0) err = pass_occupancy(gadjoint_outputs<Src>, G::THREADS, bytes, out + 4);
  if (err == 0)
    err = pass_occupancy(scan_totals<typename Pass1Of<Src>::Op, G::SCAN_THREADS, true>,
                         G::SCAN_THREADS, 0, out + 8);
  return err;
}

template <class Src>
int launch_general_adjoint(typename Src::Prior p, typename Src::T* scratch, int64_t batch,
                           int64_t n, cudaStream_t stream) {
  using T = typename Src::T;
  constexpr int D = Src::D, SIZE = SElem<T, D>::SIZE;
  using S1 = typename Pass1Of<Src>::type;
  using G = typename Src::G;
  using G1 = typename Pass1Of<Src>::G1;
  SmootherArgs<T> a{nullptr, nullptr, scratch, n, num_blocks(n, G1::TILE)};
  a.prefix = scratch + batch * a.nblk * SIZE;
  SmootherArgs<T> a3 = a;  // pass 3's blocks
  a3.nblk = a.nblk * AdjointSplit<Src>::BPB;
  T* partials = a.prefix + batch * a3.nblk * G::THREADS * SIZE;
  if constexpr (Src::NSUM > 0) p.partials = partials;
  // the kept stage 1, where the lean pass 3 reads it
  if constexpr (Pass1Of<Src>::keeps) p.kept = partials + batch * a3.nblk * Src::NSUM;
  const size_t bytes = adjoint_pass3_bytes<Src>(Src::slots(p).nv),
               b1 = S1::STAGED1 ? general_stage_bytes<G1, T>(S1::slots(p).nv) : 0;
  int err = wide_smem_bytes(gadjoint_totals<S1>, b1);
  if (err == 0) err = wide_smem_bytes(gadjoint_outputs<Src>, bytes);
  if (err != 0) return err;
  gadjoint_totals<S1><<<dim3(unsigned(a.nblk), unsigned(batch)), G1::THREADS, b1, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  scan_totals<typename Pass1Of<Src>::Op, G::SCAN_THREADS, true>
      <<<unsigned(batch), G::SCAN_THREADS, 0, stream>>>(
      reinterpret_cast<SElem<T, D>*>(a.totals), a.nblk);
  MF_CHECK_LAUNCH();
  gadjoint_outputs<Src><<<dim3(unsigned(a3.nblk), unsigned(batch)), G::THREADS, bytes, stream>>>(
      a3, p);
  MF_CHECK_LAUNCH();
  if constexpr (Src::NSUM > 0) {
    sum_partials<T, 256><<<dim3(unsigned(Src::NSUM), unsigned(batch)), 256, 0, stream>>>(
        p.partials, a3.nblk, Src::NSUM, p.gscale, p.gsums);
    MF_CHECK_LAUNCH();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// d = 7..12: a warp per element (wide_scan.cuh), o = 1.
//
// Both passes walk a warp's steps from the last to the first.  Stage 1 at
// o = 1 needs no inverse (Zt, W and e are scalars), and its L_k is a
// rank-one update of F_{k+1}: L_k = F_{k+1} (I - Pp H^T W H) =
// F_{k+1} - (F_{k+1} Pp H^T)(W H), so a step's stage 1 is two d^3 products
// (F P_{k-1} F^T).  F P_{k-1} is also what stage 2's gF needs, so pass 3
// keeps it.  Pass 3 folds each element into the suffix's g and L legs only:
// stage 2 reads r = g and NDK = L, and no E product is formed.  F_{k+1} of a
// step is F_k of the step after it, so each step fetches F, Q, c, h,
// m_{k-1} and P_{k-1} once, with cp.async, while the step before computes.
// Stage 1 is recomputed in pass 3, not kept from pass 1: kept, each step's
// element (2 d^2 + d values, 68 MB at d = 9, T = 1e5 in float32) would be
// written and read again to save one d^3 product and the reads of Q_k and
// F_{k+1}, which cost about as many bytes as the element.
// ---------------------------------------------------------------------------

// A warp's workspace: the run (a smoothing element; pass 3 uses its g and L
// legs) and the next run, two chunks of CH step slots [F, Q, c, h, P_{k-1},
// m_{k-1}] (the chunk being folded in and the one before it in time, in
// flight; pass 3 writes each step's gradients over its inputs, [gQ, gc, gH,
// gF, gnu, glam] over [Q, c, h, P_{k-1}, m_{k-1}], and the chunk goes out
// from there), F_{k+1} of the chunk's last step, six d x d temporaries and
// five vectors.
template <typename T>
struct WideAdjWork {
  static constexpr int CH = 16 / sizeof(T);  // steps a chunk: 16 bytes a value
  T *run, *nxt, *chunk[2], *fn;
  T *fp, *pp, *lk, *t0, *t1, *t2, *a, *ph, *fph, *v0, *v1;

  static __host__ __device__ int per(int d) { return 3 * d * d + 3 * d; }
  static __host__ __device__ int floats(int d) {
    return 2 * wide_smoother_size(d) + 2 * CH * per(d) + 7 * d * d + 5 * d;
  }

  MF_DEV WideAdjWork(T* p, int d) {
    const int dd = d * d;
    run = p; p += wide_smoother_size(d);
    nxt = p; p += wide_smoother_size(d);
    chunk[0] = p; p += CH * per(d);
    chunk[1] = p; p += CH * per(d);
    fn = p; p += dd;
    fp = p; p += dd;
    pp = p; p += dd;
    lk = p; p += dd;
    t0 = p; p += dd;
    t1 = p; p += dd;
    t2 = p; p += dd;
    a = p; p += d;
    ph = p; p += d;
    fph = p; p += d;
    v0 = p; p += d;
    v1 = p;
  }
};

// Value v of step k's slot [F, Q, c, h, P_{k-1}, m_{k-1}] (null: 0, the
// moments before step 0).
template <typename T>
MF_DEV const T* wide_gadjoint_src(const GeneralAdjointPrior<T>& p, int64_t b, int v,
                                  int64_t k, int64_t n, int d) {
  const int dd = d * d;
  if (v < 2 * dd + 2 * d) return WideGeneralRow<T>::src(p.k, b, v, k, d);
  v -= 2 * dd + 2 * d;
  if (k == 0) return nullptr;
  return v < dd ? p.p_f + ((b * dd + v) * n + k - 1) : p.m_f + ((b * d + v - dd) * n + k - 1);
}

// Stage 1 of the step in slot st with F_{k+1} = fnext
// (GadjStage1): fp = F P_{k-1}, Pp = sym(F P_{k-1} F^T + Q),
// a = F m_{k-1} + c, ph = Pp H^T, lk = L_k and t1 = H^T W H; the element is
// (E = L_k^T, g = H^T ev, ell = H^T W H).
template <typename T>
MF_DEV void wide_gadjoint_stage1(WideAdjWork<T>& w, const T* st, const T* fnext,
                                 const WideSite<T>& site, T& ev, int d) {
  const int dd = d * d;
  const T *f = st, *q = st + dd, *c = st + 2 * dd, *h = st + 2 * dd + d,
          *pprev = st + 2 * dd + 2 * d, *mprev = st + 3 * dd + 2 * d;
  WProd<T> p1[] = {wnn(f, pprev, w.fp, d), wnv(f, mprev, w.a, d, c)};
  wprods(p1);
  WProd<T> p2[] = {wsym_nt(w.fp, f, w.pp, d, q)};
  wprods(p2);
  WProd<T> p3[] = {wnv(w.pp, h, w.ph, d)};
  wprods(p3);
  // Zt = 1 / (1 + Lam H Pp H^T), W = Zt Lam, e = Zt (nu - Lam H a)
  const T zt = T(1) / (site.lam * wdot(h, w.ph, d) + T(1));
  const T wv = zt * site.lam;
  ev = zt * (site.nu - site.lam * wdot(h, w.a, d));
  WProd<T> p4[] = {wnv(fnext, w.ph, w.fph, d)};
  wprods(p4);
  for (int e = lane_id(); e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    w.lk[e] = fnext[e] - w.fph[i] * (wv * h[j]);
    w.t1[e] = wv * (h[i] * h[j]);
  }
  for (int e = lane_id(); e < d; e += 32) w.v1[e] = h[e] * ev;
  __syncwarp();
}

// nxt = (E, g, L) of the step's element (E = L_k^T, g = H^T ev in v1,
// ell = t1) composed with the suffix run, then swapped into run; the E leg
// only when FULL (pass 1).
template <typename T, bool FULL>
MF_DEV void wide_gadjoint_fold(WideAdjWork<T>& w, int d) {
  const int dd = d * d, OE = 0, OG = dd, OL = dd + d;
  // g = L_k^T g + H^T ev, L L_k, E = L_k^T E
  const WProd<T> g = wtv(w.lk, w.run + OG, w.nxt + OG, d, w.v1),
                 l = wnn(w.run + OL, w.lk, w.t0, d);
  if constexpr (FULL) {
    WProd<T> p1[] = {g, l, wtn(w.lk, w.run + OE, w.nxt + OE, d)};
    wprods(p1);
  } else {
    WProd<T> p1[] = {g, l};
    wprods(p1);
  }
  WProd<T> p2[] = {wtn(w.lk, w.t0, w.nxt + OL, d, w.t1)};  // sym(L_k^T L L_k + ell)
  p2[0].sym = true;
  wprods(p2);
  T* t = w.run; w.run = w.nxt; w.nxt = t;
}

// Stage 2 of the step in slot st (gadjoint_stage2) from
// r = run.g and NDK = run.L, scaled by gs; the gradients go over the slot's
// inputs: gQ over Q, gc over c, gH over h, gF over P_{k-1}, gnu and glam
// over m_{k-1}.
template <typename T>
MF_DEV void wide_gadjoint_stage2(const GeneralAdjointPrior<T>& p, WideAdjWork<T>& w, T* st,
                                 const WideSite<T>& site, T gs, int d) {
  const int dd = d * d, lane = lane_id();
  const T *r = w.run + dd, *ndk = w.run + dd + d;
  T *gq = st + dd, *gc = st + 2 * dd, *h = st + 2 * dd + d, *gf = st + 2 * dd + 2 * d,
    *mp = st + 3 * dd + 2 * d;
  T *nm = w.t0, *nfp = w.t2;
  for (int e = lane; e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    nm[e] = T(0.5) * (r[i] * r[j] - ndk[e]);
  }
  __syncwarp();
  if (p.gf != nullptr) {
    WProd<T> pn[] = {wnn(nm, w.fp, nfp, d)};
    wprods(pn);
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      gf[e] = gs * (r[i] * mp[j] + T(2) * nfp[e]);
    }
  }
  for (int e = lane; e < d; e += 32) gc[e] = gs * r[e];
  for (int e = lane; e < dd; e += 32) gq[e] = gs * nm[e];
  __syncwarp();
  if (p.gh == nullptr && p.gnu == nullptr && p.glam == nullptr) return;
  T gnu = T(0), glam = T(0);
  if (site.keep) {
    // smoothed moments m_s = a + Pp r, A = sym(Pp - Pp NDK Pp) + m_s m_s^T
    T *ms = w.v0, *hak = w.v1, *npp = w.lk, *ps = w.t2;
    WProd<T> p1[] = {wnv(w.pp, r, ms, d, w.a), wnn(ndk, w.pp, npp, d)};
    wprods(p1);
    WProd<T> p2[] = {wnn(w.pp, npp, ps, d, w.pp)};  // sym(Pp - Pp NDK Pp)
    p2[0].alpha = T(-1);
    p2[0].sym = true;
    wprods(p2);
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      ps[e] += ms[i] * ms[j];
    }
    __syncwarp();
    const T li = T(1) / site.lam, y = li * site.nu;
    WProd<T> p3[] = {wtv(ps, h, hak, d)};  // H A
    wprods(p3);
    const T hakh = wdot(hak, h, d), hm = wdot(h, ms, d);
    gnu = gs * (hm - y);
    glam = gs * (T(0.5) * (y * y - hakh + li));
    __syncwarp();  // every lane has read h
    for (int e = lane; e < d; e += 32) h[e] = gs * (site.nu * ms[e] - site.lam * hak[e]);
  } else {  // masked steps: zero observation gradients
    for (int e = lane; e < d; e += 32) h[e] = T(0);
  }
  if (lane == 0) {
    mp[0] = gnu;
    mp[1] = glam;
  }
  __syncwarp();
}

// Passes 1 (OUTPUTS = false: fold the warp's steps into its suffix total)
// and 3 (OUTPUTS: fold them into the suffix of all later warps, g and L
// only, and write each step's gradients), a chunk of CH steps at a time,
// last chunk first.
template <typename T, bool OUTPUTS>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_gadjoint_pass(SmootherArgs<T> a, GeneralAdjointPrior<T> p, int d, int64_t steps) {
  using W = WideAdjWork<T>;
  constexpr int CH = W::CH;
  const int warp = threadIdx.x >> 5, size = wide_smoother_size(d), dd = d * d;
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp, n = a.n;
  if (u >= a.nblk) return;  // the whole warp; this kernel has no block barrier
  W w(reinterpret_cast<T*>(mf_wide_smem) + warp * W::floats(d), d);
  const int per = W::per(d);
  const auto src = [&](int v, int64_t k) { return wide_gadjoint_src(p, b, v, k, n, d); };
  // [gQ, gc, gH, gF, gnu, glam] from slot offset dd
  const auto dst = [&](int v, int64_t k) -> T* {
    if (v < dd) return p.gq == nullptr ? nullptr : p.gq + ((b * dd + v) * n + k);
    if ((v -= dd) < d) return p.gc == nullptr ? nullptr : p.gc + ((b * d + v) * n + k);
    if ((v -= d) < d) return p.gh == nullptr ? nullptr : p.gh + ((b * d + v) * n + k);
    if ((v -= d) < dd) return p.gf == nullptr ? nullptr : p.gf + ((b * dd + v) * n + k);
    if ((v -= dd) == 0) return p.gnu == nullptr ? nullptr : p.gnu + (b * n + k);
    return v == 1 && p.glam != nullptr ? p.glam + (b * n + k) : nullptr;
  };
  T* total = a.totals + (b * a.nblk + u) * size;
  if (OUTPUTS) wcopy(w.run + dd, total + dd, d + dd);  // g, L of all later warps
  else wide_identity(w.run, size, d);
  const T gs = OUTPUTS ? p.gscale[b] : T(0);
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, n);
  int64_t kc = k0 + (k1 - 1 - k0) / CH * CH;  // k0 is a multiple of CH
  fetch_chunk<1>(w.fn, dd, k1, 1, [&](int v, int64_t k) {  // F_{k1}, 0 past the grid
    return k < n ? WideGeneralRow<T>::src(p.k, b, v, k, d) : nullptr;
  });
  fetch_chunk<CH>(w.chunk[0], per, kc, int(k1 - kc), src);
  WideSite<T> site = wide_site<T>(p, b, k1 - 1);
  wide_fetch_wait();
  for (int cur = 0; kc >= k0; kc -= CH, cur ^= 1) {
    const int cnt = int(imin(CH, k1 - kc));
    if (kc > k0) fetch_chunk<CH>(w.chunk[cur ^ 1], per, kc - CH, CH, src);
    for (int s = cnt - 1; s >= 0; --s) {
      const int64_t k = kc + s;
      const WideSite<T> next = k > k0 ? wide_site<T>(p, b, k - 1) : site;
      T* st = w.chunk[cur] + s * per;
      T ev;
      wide_gadjoint_stage1(w, st, s + 1 < cnt ? st + per : w.fn, site, ev, d);
      wide_gadjoint_fold<T, !OUTPUTS>(w, d);
      if (OUTPUTS) wide_gadjoint_stage2(p, w, st, site, gs, d);
      site = next;
    }
    if (OUTPUTS) store_chunk<CH>(w.chunk[cur], per, dd, 2 * dd + 3 * d, kc, cnt, dst);
    wcopy(w.fn, w.chunk[cur], dd);  // F_kc: F_{k+1} of step kc - 1
    wide_fetch_wait();
  }
  if (!OUTPUTS) wcopy(total, w.run, size);
}

template <typename T>
int launch_wide_general_adjoint(GeneralAdjointPrior<T> p, T* scratch, int64_t batch,
                                int64_t n, int d, cudaStream_t stream) {
  if (d < WIDE_MIN_D || d > WIDE_MAX_D) return int(cudaErrorInvalidValue);
  const int64_t steps = wide_steps(n);
  SmootherArgs<T> a{nullptr, nullptr, scratch, n, num_blocks(n, steps)};
  const dim3 grid(unsigned(num_blocks(a.nblk, WIDE_WARPS)), unsigned(batch));
  const size_t bytes = size_t(WIDE_WARPS) * WideAdjWork<T>::floats(d) * sizeof(T);
  int err = wide_smem_bytes(wide_gadjoint_pass<T, false>, bytes);
  if (err == 0) err = wide_smem_bytes(wide_gadjoint_pass<T, true>, bytes);
  if (err != 0) return err;
  wide_gadjoint_pass<T, false><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<WideSmootherOp<T>, true, T>(
      a.totals, a.nblk, batch, d, a.totals + batch * a.nblk * wide_smoother_size(d), stream);
  if (err != 0) return err;
  wide_gadjoint_pass<T, true><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  return 0;
}

}  // namespace mf

// C entry point for one dtype (T, suffix), as in general_scan.cuh: the
// strides of F, c, Q, H and the sites in the general filter's order; the
// scratch is mf_general_adjoint_scratch_*'s; any gradient pointer may be
// null; the output dim o is 1 or, at d <= 6, one of MF_GENERAL_O_PAIRS (where
// gH, gnu and glam are all null, through the lean pass 3) or o > d, or at
// d = 7..12 2..12 (launch_wide_info_adjoint, wide_info.cuh, which
// entry_points.cu includes).
#define MF_DEFINE_GENERAL_ADJOINT_ENTRY_POINTS(T, SUFFIX)                              \
  extern "C" int mf_general_adjoint_##SUFFIX(                                          \
      const T* f, const T* c, const T* q, const T* h, const T* nu, const T* lam,       \
      const T* mask, const int64_t* st, const T* m_f, const T* p_f, const T* gscale,   \
      T* gf, T* gc, T* gq, T* gh, T* gnu, T* glam, T* scratch, int64_t batch,          \
      int64_t n, int64_t d, int64_t o, void* stream) {                                 \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::GeneralAdjointPrior<T> p{};                                                    \
    p.k = mf::GeneralPrior<T>{f, c, q, h,                                              \
                              st[0], st[1], st[2], st[3],                              \
                              st[4], st[5], st[6],                                     \
                              st[7], st[8], st[9], st[10],                             \
                              st[11], st[12], st[13], st[14]};                         \
    p.nu = nu; p.lam = lam; p.mask = mask;                                             \
    mf::set_site_strides(p, st + 15);                                                  \
    p.m_f = m_f; p.p_f = p_f; p.gscale = gscale;                                       \
    p.gf = gf; p.gc = gc; p.gq = gq; p.gh = gh; p.gnu = gnu; p.glam = glam; p.o = o;   \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (o != 1 && d >= mf::WIDE_MIN_D)                                                 \
      return mf::launch_wide_info_adjoint<T>(p, scratch, batch, n, int(d), s);         \
    if (o > d)                                                                         \
      MF_SWITCH_D(d, (mf::launch_general_adjoint<mf::GeneralAdjStepsW<T, D_>>(p, scratch, \
                                                                            batch, n, s)), \
                  int(cudaErrorInvalidValue))                                          \
    if (o != 1 && gh == nullptr && gnu == nullptr && glam == nullptr)                  \
      MF_SWITCH_DO(d, o,                                                               \
                   (mf::launch_general_adjoint<mf::GeneralAdjStepsO<T, D_, O_, false>>( \
                       p, scratch, batch, n, s)),                                      \
                   int(cudaErrorInvalidValue))                                         \
    if (o != 1)                                                                        \
      MF_SWITCH_DO(d, o,                                                               \
                   (mf::launch_general_adjoint<mf::GeneralAdjStepsO<T, D_, O_, true>>(  \
                       p, scratch, batch, n, s)),                                      \
                   int(cudaErrorInvalidValue))                                         \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_general_adjoint<T>(p, scratch, batch, n, int(d), s);      \
    MF_SWITCH_D(d, (mf::launch_general_adjoint<mf::GeneralAdjSteps<T, D_>>(p, scratch, \
                                                                           batch, n, s)), \
                int(cudaErrorInvalidValue))                                            \
  }
