// Uniform-grid Koopman backward kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel markovflow_tpu/ops/pallas_scan.py::
// pallas_adjoint_pipeline_uniform (_uniform_adjoint_kernel): the gradient of
// the uniform-grid log-likelihood by the Koopman score.  The plain PyTorch
// version is adjoint_pipeline_uniform_plain in
// markovflow_tpu_torch/ops/adjoint.py.
//
// For each step k, from the constant prior step, the sites and the saved
// filtered moments (m, P)_{k-1} (stage 1, adjoint_scan_elements):
//   a = F m_{k-1} + c, Pp = sym(F P_{k-1} F^T + Q),
//   Zt = (I + Lam H Pp H^T)^-1, W = sym(Zt Lam), e = Zt (nu - Lam H a),
//   L_k = F_{k+1} (I - Pp H^T W H)   (F_{k+1} = 0 at the last step),
// and the smoothing element (E = L_k^T, g = H^T e, ell = sym(H^T W H)).
// Its reverse scan gives r_k (the g leg) and NDK_k (the ell leg); stage 2
// (adjoint_grads_from_scan) turns them into the six gradients.
//
// Passes: those of the general Koopman backward at d <= 6
// (general_adjoint.cuh: gadjoint_totals, scan_totals, gadjoint_outputs) with
// the step source UniformAdjSteps below (UniformAdjStepsO at o x o sites,
// o = 2..d), then sum_partials.  At o = 1 stage
// 1 is the rank-one GadjStage1 (no inverse, two d^3 products).  Pass 1 folds
// each thread's steps with the full composition and stores its in-block
// suffix; pass 3 composes the g and L legs of that suffix with the block's
// carry, folds its steps into those legs only, and per step adds
// r m_{k-1}^T + 2 N (F P_{k-1}), r and N (k >= 1) and the gH term (every k,
// through the smoothed moments) to the thread's sums, writes gmu0 and gP0 at
// step 0 and, when asked, gnu and glam per step through the stage; the
// block's sums go out as one partial (block_sum), which sum_partials adds
// in a fixed order.  No float atomics: a run repeats bit for bit.
//
// What bounds it on an H100: at d = 2, float32, GPR's backward reads nu
// (lam is one expanded value) and (m, P)_{k-1}, 28 B a step, in each of
// passes 1 and 3, plus the stored in-block suffix (10 values a thread,
// written and read): ~66 MB at N = 1e6, ~20 us at 3.35 TB/s (the
// function's own floor, each input read once, is 8.4 us); with the site
// gradients it also writes 8 B a step.  Pass 3 stages each warp's 32 R
// steps through shared memory (every d <= 6: at most d^2 + d + 3 values a
// step, 5,760 a warp at d = 6), so a warp's load of one value is whole
// rows, not 32 sectors, and its site gradients go out the same way; pass 1,
// which only reads, reads each step where it lies (a thread's R steps of a
// value share their sectors; staged, it was 18% slower at d = 2 and 60% at
// d = 6, PERF.md).  Per step
// pass 1 does stage 1 and a full fold (five d^3 products), pass 3 stage 1,
// a g-and-L fold and N F P (four) and the smoothed moments' site terms in
// d^2 products, in dependent chains (PERF.md has the times).
#pragma once

#include "general_adjoint.cuh"
#include "uniform_scan.cuh"

namespace mf {

// The summed gradients, in this order: Fc [d, d], cc [d], Qc [d, d], Hc [o, d].
template <int D, int O>
struct AdjointSums {
  static constexpr int OF = 0, OC = D * D, OQ = OC + D, OH = OQ + D * D, NV = OH + O * D;
};

template <typename T>
struct AdjointPrior {
  UniformPrior<T> k;  // the constants
  // sites, any strides, as in FilterArgs
  const T *nu, *lam, *mask;
  int64_t nu_sb, nu_si, nu_st;
  int64_t lam_sb, lam_si, lam_sj, lam_st;
  int64_t mask_sb, mask_st;
  // filtered moments, contiguous: m_f [B, d, 1, N], P_f [B, d, d, N]
  const T *m_f, *p_f;
  const T* gscale;  // [B], the cotangent of each row's log-likelihood
  T *gnu, *glam;    // [B, o, 1, N], [B, o, o, N], contiguous; may be null
  T *gm0, *gp0;     // [B, d], [B, d, d]
  T* gsums;         // [B, NV]: the summed gradients (AdjointSums), scaled by gscale
  T* partials;      // scratch: [B, nblk, NV] block partials of the sums
  T* kept;          // scratch: the stage 1 pass 1 keeps for the lean pass 3 (o > 1), or null
  int64_t o;        // the output dim, for the sources that take it at run time (o > d)
};

// Stage 2's prior-step terms at step k into the sums acc (AdjointSums
// order, sum v at acc[v * STRIDE], unscaled: sum_partials scales them)
// from r = rv, N = nm and stage 1's fp = F P_{k-1}, mp = m_{k-1}:
// Fc += r m_{k-1}^T + 2 N F P_{k-1}, cc += r, Qc += N at k >= 1; gmu0 =
// gs r and gP0 = gs N at k = 0.
template <typename T, int D, class S1, int STRIDE = 1>
MF_DEV void adjoint_prior_sums(const AdjointPrior<T>& p, const S1& s1, const T* rv, const T* nm,
                               T gs, T* acc, int64_t b, int64_t k) {
  using S = AdjointSums<D, 1>;  // the offsets of Fc, cc and Qc do not depend on o
  if (k == 0) {
#pragma unroll
    for (int i = 0; i < D; ++i) p.gm0[b * D + i] = gs * rv[i];
#pragma unroll
    for (int i = 0; i < D * D; ++i) p.gp0[b * D * D + i] = gs * nm[i];
    return;
  }
  T nfp[D * D];
  mm<T, D, D, D>(nm, s1.fp, nfp);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    acc[(S::OC + i) * STRIDE] += rv[i];
#pragma unroll
    for (int j = 0; j < D; ++j)
      acc[(S::OF + i * D + j) * STRIDE] += rv[i] * s1.mp[j] + T(2) * nfp[i * D + j];
  }
#pragma unroll
  for (int i = 0; i < D * D; ++i) acc[(S::OQ + i) * STRIDE] += nm[i];
}

// Kernel 3's step source of the Koopman backward passes
// (general_adjoint.cuh): the constants of batch row b in registers, loaded
// once a thread (UniformRow), with the prior (F_0 = 0, Q_0 = P0, c_0 = mu0)
// at global step 0 and F_{k+1} = Fc but at step n - 1; staged in pass 3:
// P_{k-1} and m_{k-1} (stage_steps' slots shifted by one step), then nu,
// lam and the mask where they change with the step.  Pass 3 puts gnu and
// glam over the first two moment slots of a step it has read, and sums the
// constants' gradients in registers.
template <typename T_, int D_>
struct UniformAdjSteps : UniformRow<T_, D_, 1> {
  using T = T_;
  static constexpr int D = D_;
  using Prior = AdjointPrior<T>;
  using G = StagedTiling<T, D, D * D + D + 3>;
  using In = GeneralIn<T, D>;
  using Stage1 = GadjStage1<T, D>;
  using S = AdjointSums<D, 1>;
  static constexpr int NSUM = S::NV;
  static constexpr int GNU_OUT = 0, GLAM_OUT = 1;
  static_assert(G::STAGED, "kernel 3 stages every d <= 6 in pass 3");
  static constexpr bool STAGED1 = false;
  T acc[NSUM];

  MF_DEV void load(const Prior& p, int64_t b) {
    UniformRow<T, D, 1>::load(p.k, b);
#pragma unroll
    for (int i = 0; i < NSUM; ++i) acc[i] = T(0);
  }

  static __host__ __device__ GeneralSlots slots(const Prior& p) {
    GeneralSlots s{0, D * D, -1, -1, -1, -1, D * D + D};
    s.nu = p.nu_st != 0 ? s.nv++ : -1;
    s.lam = p.lam_st != 0 ? s.nv++ : -1;
    s.mask = p.mask != nullptr ? s.nv++ : -1;
    return s;
  }

  template <bool STAGED>
  MF_DEV void stage(const Prior& p, int64_t b, int64_t t, int64_t n, WarpStage<T, G::R>& st,
                    GeneralSlots& sl) const {
    if constexpr (!STAGED) return;
    sl = slots(p);
    st.place(t, sl.nv, n);
#pragma unroll
    for (int i = 0; i < D * D; ++i)
      st.template fetch<true>(sl.pprev + i, p.p_f + (b * D * D + i) * n, 1);
#pragma unroll
    for (int i = 0; i < D; ++i) st.template fetch<true>(sl.mprev + i, p.m_f + (b * D + i) * n, 1);
    if (sl.nu >= 0) st.fetch(sl.nu, p.nu + b * p.nu_sb, p.nu_st);
    if (sl.lam >= 0) st.fetch(sl.lam, p.lam + b * p.lam_sb, p.lam_st);
    if (sl.mask >= 0) st.fetch(sl.mask, p.mask + b * p.mask_sb, p.mask_st);
    wide_fetch_wait();
  }

  MF_DEV void f_after(const Prior&, int64_t, int64_t, int64_t last, int64_t n,
                      const WarpStage<T, G::R>&, T* fn) const {
#pragma unroll
    for (int i = 0; i < D * D; ++i) fn[i] = last + 1 >= n ? T(0) : this->f[i];
  }

  // Unstaged (pass 1), nu and lam from step k and no mask (the fold reads
  // none).
  template <bool STAGED>
  MF_DEV void read(In& in, T* mp, T* pprev, const WarpStage<T, G::R>& st,
                   const GeneralSlots& sl, int lane, int r, const Prior& p, int64_t b,
                   int64_t k, bool once, int64_t n) const {
    if constexpr (STAGED) this->read_step(in, st, sl, lane, r, p, b, k, once);
    else this->read_step(in, st, GeneralSlots{-1, -1, -1, -1, -1, -1, 0}, lane, r, p, b, k, true);
    read_prev_moments<STAGED, D>(p, st, sl, lane, r, b, k, n, mp, pprev);
  }

  // Stage 2 (adjoint_grads_from_scan) into the sums, unscaled (sum_partials
  // scales them): N = (r r^T - NDK) / 2; Fc += r m_{k-1}^T + 2 N F P_{k-1},
  // cc += r, Qc += N at k >= 1, gmu0 = gs r and gP0 = gs N at k = 0; at
  // kept steps, through the smoothed moments m_s = a + Pp r and
  // A = Pp - Pp NDK Pp + m_s m_s^T, Hc += nu m_s^T - lam H A and, with
  // y = nu / lam, gnu = gs (H m_s - y) and glam = gs (y^2 - H A H^T +
  // 1 / lam) / 2 (0 at masked steps).
  MF_DEV void out(const Prior& p, const In& in, const GadjStage1<T, D>& s1, const T* rv,
                  const T* ndk, T gs, const WarpStage<T, G::R>& st, int lane, int r, int64_t b,
                  int64_t k, int64_t) {
    T nm[D * D];
    gadjoint_n<T, D>(rv, ndk, nm);
    adjoint_prior_sums<T, D>(p, s1, rv, nm, gs, acc, b, k);
    T gnu = T(0), glam = T(0);
    if (in.s.keep) {
      // A H^T = Pp H^T - Pp NDK (Pp H^T) + m_s (H m_s): d^2 products (Pp
      // and NDK are symmetric, so A is without the sym of gadjoint_stage2)
      T ms[D], hak[D], ph[D], t1[D];
      mm<T, D, D, 1>(s1.pp, rv, ms);
      add_to<T, D>(ms, s1.a);
      mm<T, D, D, 1>(s1.pp, in.h, ph);
      mm<T, D, D, 1>(ndk, ph, t1);
      mm<T, D, D, 1>(s1.pp, t1, hak);
      const T hm = dot<T, D>(in.h, ms);
#pragma unroll
      for (int i = 0; i < D; ++i) hak[i] = ph[i] - hak[i] + ms[i] * hm;
#pragma unroll
      for (int j = 0; j < D; ++j) acc[S::OH + j] += in.s.nu * ms[j] - in.s.lam * hak[j];
      if (p.gnu != nullptr) {
        const T li = T(1) / in.s.lam, y = li * in.s.nu;
        gnu = gs * (hm - y);
        glam = gs * (T(0.5) * (y * y - dot<T, D>(hak, in.h) + li));
      }
    }
    if (p.gnu != nullptr) {
      *st.at(GNU_OUT, lane, r) = gnu;
      *st.at(GLAM_OUT, lane, r) = glam;
    }
  }

  // gnu and glam from the stage; the block's sums to its partial
  template <int THREADS>
  MF_DEV void finish(const Prior& p, const SmootherArgs<T>& a, const WarpStage<T, G::R>& st,
                     int64_t b, T* red) {
    if (p.gnu != nullptr) {
      __syncwarp();
      st.store(GNU_OUT, p.gnu + b * a.n);
      st.store(GLAM_OUT, p.glam + b * a.n);
    }
    block_sum<T, THREADS, NSUM>(acc, red);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < NSUM; ++i) p.partials[(b * a.nblk + blockIdx.x) * NSUM + i] = acc[i];
    }
  }
};

// Kernel 3 at o = 2..d (d <= 6): UniformAdjSteps' passes with o x o
// sites (general_adjoint.cuh: GadjStage1O, gadjoint_obs_o; from d = 4
// pass 1's runs of 8 steps, 8 warps a block: G1).  The constants of the
// block's batch row (F, Q, c, Hc, P0, mu0: 3 d^2 + 2 d + o d values) lie
// in shared memory, read at each step: in registers they held 138 of 255
// at d = 6.  Each step's nu, lam, mask and (m, P)_{k-1} are read where
// they lie and gnu, glam written to step k (GeneralAdjStepsO's notes say
// why).  In pass 3 each thread sums the constants' gradients in its column
// of the block's dynamic shared memory (NSUM values; Hc's only with OBS_,
// without which they stay 0, not asked for), and the block adds the
// columns to one partial, in a fixed order (in registers the 96 sums at
// d = 6, o = 3 spilled).
template <typename T_, int D_, int O_, bool OBS_>
struct UniformAdjStepsO {
  using T = T_;
  static constexpr int D = D_, O = O_;
  static constexpr bool OBS = OBS_;
  using Prior = AdjointPrior<T>;
  using G = UnstagedTiling<D>;
  using In = GeneralInO<T, D, O>;
  using Stage1 = std::conditional_t<OBS, GadjStage1ObsO<T, D, O>, GadjStage1O<T, D, O>>;
  using G1 = UnstagedTiling<D, D <= 3 ? G::R : 8, D <= 3 ? G::WARPS : 8>;  // pass 1's
  using Totals = UniformAdjStepsO<T, D, O, false>;
  using S = AdjointSums<D, O>;
  static constexpr int NSUM = S::NV;
  // float64 keeps stage 1 for the lean pass 3 (general_adjoint.cuh): built
  // there, ptxas kept 32 registers and pass 3 took 18 ms at (6, 3); in
  // float32 pass 1's stores cost more than pass 3 saved
  static constexpr bool STAGED1 = false, KEEP = std::is_same_v<T, double>;
  // the constants' offsets in the block's row
  static constexpr int OF = 0, OQ = D * D, OC = 2 * D * D, OH = OC + D, OP0 = OH + O * D,
                       OM0 = OP0 + D * D, NROW = OM0 + D;
  // pass 3's dynamic shared memory, values a thread: its column of sums
  static constexpr int SMEM3 = NSUM;
  const volatile T* row;
  T* acc;  // sum v at acc[v * G::THREADS]

  // Every thread of the block calls it (a barrier).
  MF_DEV void load(const Prior& p, int64_t b) {
    __shared__ T consts[NROW];
    const UniformPrior<T>& u = p.k;
    for (int i = threadIdx.x; i < NROW; i += blockDim.x)
      consts[i] = i < OQ    ? u.fc[b * D * D + i - OF]
                  : i < OC  ? u.qc[b * D * D + i - OQ]
                  : i < OH  ? u.cc[b * D + i - OC]
                  : i < OP0 ? u.hc[b * O * D + i - OH]
                  : i < OM0 ? u.p0[b * D * D + i - OP0]
                            : u.mu0[b * D + i - OM0];
    __syncthreads();
    row = consts;
  }

  // pass 3: the thread's sums in column threadIdx.x of smem, zeroed
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

  // The constant prior step, (0, P0, mu0) at global step 0, and Hc from
  // the row; nu, lam (only once, once, where their step stride is 0) and
  // the mask of step k and (m, P)_{k-1} where they lie.
  template <bool STAGED, int R>
  MF_DEV void read(In& in, T* mp, T* pprev, const WarpStage<T, R>& st, const GeneralSlots& sl,
                   int lane, int r, const Prior& p, int64_t b, int64_t k, bool once,
                   int64_t n) const {
    const bool first = k == 0;
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
      in.f[i] = first ? T(0) : row[OF + i];
      in.q[i] = row[(first ? OP0 : OQ) + i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) in.c[i] = row[(first ? OM0 : OC) + i];
#pragma unroll
    for (int i = 0; i < O * D; ++i) in.h[i] = row[OH + i];
    in.read_site_values(p, b, k, once);
    read_prev_moments<false, D>(p, st, sl, lane, r, b, k, n, mp, pprev);
  }

  // Hc to h (once, from the row)
  MF_DEV void read_h(const Prior&, int64_t, int64_t, bool once, T* h) const {
    if (!once) return;
#pragma unroll
    for (int i = 0; i < O * D; ++i) h[i] = row[OH + i];
  }

  // Stage 2 into the sums, unscaled, as UniformAdjSteps::out; with OBS,
  // Hc += gH of every step (gadjoint_obs_o), and gnu, glam, scaled by gs,
  // to step k
  MF_DEV void out(const Prior& p, const In& in, const Stage1& s1, const T* rv, const T* ndk,
                  T gs, const WarpStage<T, G::R>&, int, int, int64_t b, int64_t k, int64_t n) {
    T nm[D * D];
    gadjoint_n<T, D>(rv, ndk, nm);
    adjoint_prior_sums<T, D, Stage1, G::THREADS>(p, s1, rv, nm, gs, acc, b, k);
    if constexpr (OBS) {
      T gh[O * D], gnu[O], glam[O * O];
      gadjoint_obs_o<T, D, O>(in, s1, rv, ndk, p.gnu != nullptr, gh, gnu, glam);
#pragma unroll
      for (int i = 0; i < O * D; ++i) acc[(S::OH + i) * G::THREADS] += gh[i];
      if (p.gnu != nullptr) {
#pragma unroll
        for (int i = 0; i < O; ++i) p.gnu[(b * O + i) * n + k] = gs * gnu[i];
#pragma unroll
        for (int i = 0; i < O * O; ++i) p.glam[(b * O * O + i) * n + k] = gs * glam[i];
      }
    }
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

// C entry point for one dtype (T, suffix), as in uniform_scan.cuh.  gsums
// [B, NV] receives the summed gradients in AdjointSums order, scaled by
// gscale, Hc's where sum_hc is not 0 (at o = 1 always); gnu and glam may be
// null.  The scratch is mf_adjoint_scratch_*'s; the output dim o is 1, one
// of MF_GENERAL_O_PAIRS (UniformAdjStepsO, the lean pass 3 where neither
// Hc's sums nor gnu and glam are asked for) or o > d (UniformAdjStepsW,
// info_scan.cuh: NV counts INFO_UNIFORM_MAX_O rows of Hc, and Hc's sums
// are made at every call).
#define MF_DEFINE_ADJOINT_ENTRY_POINTS(T, SUFFIX)                                      \
  extern "C" int mf_uniform_adjoint_##SUFFIX(                                          \
      const T* fc, const T* cc, const T* qc, const T* mu0, const T* p0, const T* hc,   \
      const T* nu, const T* lam, const T* mask, const int64_t* site_strides,           \
      const T* m_f, const T* p_f, const T* gscale, T* gnu, T* glam, T* gm0, T* gp0,    \
      T* gsums, int64_t sum_hc, T* scratch, int64_t batch, int64_t n, int64_t d, int64_t o, \
      void* stream) {                                                                  \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    if ((gnu == nullptr) != (glam == nullptr)) return int(cudaErrorInvalidValue);      \
    mf::AdjointPrior<T> p{};                                                           \
    p.k = mf::UniformPrior<T>{fc, cc, qc, mu0, p0, hc};                                \
    p.nu = nu; p.lam = lam; p.mask = mask;                                             \
    mf::set_site_strides(p, site_strides);                                             \
    p.m_f = m_f; p.p_f = p_f; p.gscale = gscale;                                       \
    p.gnu = gnu; p.glam = glam; p.gm0 = gm0; p.gp0 = gp0; p.gsums = gsums; p.o = o;    \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (o > d)                                                                         \
      MF_SWITCH_D5(d, (mf::launch_general_adjoint<mf::UniformAdjStepsW<T, D_>>(         \
                          p, scratch, batch, n, s)),                                   \
                   int(cudaErrorInvalidValue))                                         \
    if (o != 1 && sum_hc == 0 && gnu == nullptr)                                         \
      MF_SWITCH_DO(d, o,                                                               \
                   (mf::launch_general_adjoint<mf::UniformAdjStepsO<T, D_, O_, false>>( \
                       p, scratch, batch, n, s)),                                      \
                   int(cudaErrorInvalidValue))                                         \
    if (o != 1)                                                                        \
      MF_SWITCH_DO(d, o,                                                               \
                   (mf::launch_general_adjoint<mf::UniformAdjStepsO<T, D_, O_, true>>(  \
                       p, scratch, batch, n, s)),                                      \
                   int(cudaErrorInvalidValue))                                         \
    MF_SWITCH_D(d, (mf::launch_general_adjoint<mf::UniformAdjSteps<T, D_>>(p, scratch, \
                                                                           batch, n, s)), \
                int(cudaErrorInvalidValue))                                            \
  }
