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
// Passes: the smoother passes of scan_core.cuh with this element source
// (block totals of the reverse reduce, then scan_totals), then
// adjoint_outputs, which rebuilds the elements, folds in the suffix of all
// later steps and assembles every step's gradients: it writes gnu and glam
// per step (when asked) and reduces the summed gradients (Fc, cc, Qc over
// k >= 1, Hc over all k) to one partial per block, which sum_partials adds
// in a fixed order.  The thread that owns global step 0 writes gmu0 and gP0.
// Global step 0 is found from its index; nothing is padded.
//
// What bounds it on an H100: per step it reads the sites (one expanded
// value for GPR) and (m, P)_{k-1} (d + d^2 values) twice, and writes
// 2 o + o^2 values when the site gradients are asked for: ~30 B a step at
// d = 2, float32, a 9 us floor at N = 1e6.  It does ~3x the smoother's
// arithmetic per step (stage 1 twice, stage 2, two compositions), so it is
// bound by arithmetic latency as the filter is; the design keeps elements
// and the gradient sums in registers and reduces them without atomics.
#pragma once

#include "uniform_scan.cuh"

namespace mf {

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
  T* partials;      // scratch: [B, nblk, NV] block partials of the sums
};

// The summed gradients, in this order: Fc [d, d], cc [d], Qc [d, d], Hc [o, d].
template <int D, int O>
struct AdjointSums {
  static constexpr int OF = 0, OC = D * D, OQ = OC + D, OH = OQ + D * D, NV = OH + O * D;
};

template <typename T, int D, int O>
struct AdjointStep {
  FilterStep<T, D, O> s;  // F, c, Q, H and the sites of step k
  T mp[D], pprev[D * D];  // filtered moments of step k - 1 (0 at k = 0)
  T a[D], pp[D * D];      // predicted moments of step k
};

// Stage 1: the step's inputs, predicted moments and smoothing element.
template <typename T, int D, int O>
MF_DEV void adjoint_stage1_body(const UniformRow<T, D, O>& u, const AdjointPrior<T>& p,
                                int64_t b, int64_t k, int64_t n,
                                AdjointStep<T, D, O>& st, SElem<T, D>& out) {
  using E = SElem<T, D>;
  FilterStep<T, D, O>& s = st.s;
  u.step(p.k, b, k, s);
  s.load_sites(p, b, k);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    st.mp[i] = k > 0 ? p.m_f[(b * D + i) * n + k - 1] : T(0);
#pragma unroll
    for (int j = 0; j < D; ++j)
      st.pprev[i * D + j] = k > 0 ? p.p_f[((b * D + i) * D + j) * n + k - 1] : T(0);
  }
  const T* h = s.h;
  // a = F m + c, Pp = sym(F P F^T + Q)
  mm<T, D, D, 1>(s.f, st.mp, st.a);
  add_to<T, D>(st.a, s.c);
  T t[D * D];
  mm_nt<T, D, D, D>(st.pprev, s.f, t);
  mm<T, D, D, D>(s.f, t, st.pp);
  add_to<T, D * D>(st.pp, s.q);
  sym<T, D>(st.pp);
  // Zt = (I + Lam H Pp H^T)^-1, W = sym(Zt Lam), e = Zt (nu - Lam H a)
  T hp[O * D], hpht[O * O], m1[O * O], zt[O * O], w[O * O];
  mm<T, O, D, D>(h, st.pp, hp);
  mm_nt<T, O, D, O>(hp, h, hpht);
  mm<T, O, O, O>(s.lam, hpht, m1);
  add_eye<T, O>(m1);
  inv<T, O>(m1, zt);
  mm<T, O, O, O>(zt, s.lam, w);
  sym<T, O>(w);
  T ha[O], res[O], e[O];
  mm<T, O, D, 1>(h, st.a, ha);
  mm<T, O, O, 1>(s.lam, ha, res);
#pragma unroll
  for (int i = 0; i < O; ++i) res[i] = s.nu[i] - res[i];
  mm<T, O, O, 1>(zt, res, e);
  // H^T W H; L = F_{k+1} (I - Pp H^T W H)
  T wh[O * D], htwh[D * D], ikh[D * D], lmat[D * D];
  mm<T, O, O, D>(w, h, wh);
  mm_tn<T, D, O, D>(h, wh, htwh);
  mm<T, D, D, D>(st.pp, htwh, ikh);
#pragma unroll
  for (int i = 0; i < D * D; ++i) ikh[i] = -ikh[i];
  add_eye<T, D>(ikh);
  const bool last = k == n - 1;
#pragma unroll
  for (int i = 0; i < D * D; ++i) t[i] = last ? T(0) : u.f[i];  // F_{k+1}
  mm<T, D, D, D>(t, ikh, lmat);
  // element (E = L^T, g = H^T e, ell = sym(H^T W H))
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) out.v[E::OE + i * D + j] = lmat[j * D + i];
  }
  mm_tn<T, D, O, 1>(h, e, out.v + E::OG);
#pragma unroll
  for (int i = 0; i < D * D; ++i) out.v[E::OL + i] = htwh[i];
  sym<T, D>(out.v + E::OL);
}

template <typename T, int D, int O>
__device__ __noinline__ void adjoint_stage1_call(const UniformRow<T, D, O>& u,
                                                 const AdjointPrior<T>& p, int64_t b,
                                                 int64_t k, int64_t n,
                                                 AdjointStep<T, D, O>& st,
                                                 SElem<T, D>& out) {
  adjoint_stage1_body<T, D, O>(u, p, b, k, n, st, out);
}

// Stage 2: the step's gradients from r = suffix.g and NDK = suffix.ell,
// added to the block sums (acc) and written per step.
template <typename T, int D, int O>
MF_DEV void adjoint_stage2_body(const AdjointStep<T, D, O>& st, const SElem<T, D>& suf,
                                const AdjointPrior<T>& p, int64_t b, int64_t k,
                                int64_t n, T gs, T* acc) {
  using E = SElem<T, D>;
  using S = AdjointSums<D, O>;
  const FilterStep<T, D, O>& s = st.s;
  const T* h = s.h;
  const T *r = suf.v + E::OG, *ndk = suf.v + E::OL;
  // N = (r r^T - NDK) / 2 = dL/dQ_k; dL/dc_k = r;
  // dL/dF_k = r m_{k-1}^T + 2 N F P_{k-1}
  T nm[D * D], fp[D * D], nfp[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) nm[i * D + j] = T(0.5) * (r[i] * r[j] - ndk[i * D + j]);
  }
  mm<T, D, D, D>(s.f, st.pprev, fp);
  mm<T, D, D, D>(nm, fp, nfp);
  if (k == 0) {
#pragma unroll
    for (int i = 0; i < D; ++i) p.gm0[b * D + i] = gs * r[i];
#pragma unroll
    for (int i = 0; i < D * D; ++i) p.gp0[b * D * D + i] = gs * nm[i];
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      acc[S::OC + i] += r[i];
#pragma unroll
      for (int j = 0; j < D; ++j)
        acc[S::OF + i * D + j] += r[i] * st.mp[j] + T(2) * nfp[i * D + j];
    }
#pragma unroll
    for (int i = 0; i < D * D; ++i) acc[S::OQ + i] += nm[i];
  }
  // smoothed moments m_s = a + Pp r, P_s = sym(Pp - Pp NDK Pp)
  T ms[D], ps[D * D], t1[D * D];
  mm<T, D, D, 1>(st.pp, r, ms);
  add_to<T, D>(ms, st.a);
  mm<T, D, D, D>(ndk, st.pp, t1);
  mm<T, D, D, D>(st.pp, t1, ps);
#pragma unroll
  for (int i = 0; i < D * D; ++i) ps[i] = st.pp[i] - ps[i];
  sym<T, D>(ps);
  if (!s.keep) {  // masked steps: zero observation gradients
    if (p.gnu == nullptr) return;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      p.gnu[(b * O + i) * n + k] = T(0);
#pragma unroll
      for (int j = 0; j < O; ++j) p.glam[((b * O + i) * O + j) * n + k] = T(0);
    }
    return;
  }
  // y = Lam^-1 nu, A = P_s + m_s m_s^T
  T li[O * O], y[O];
  inv<T, O>(s.lam, li);
  mm<T, O, O, 1>(li, s.nu, y);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) ps[i * D + j] += ms[i] * ms[j];
  }
  T hak[O * D], lhak[O * D], hakh[O * O], hm[O];
  mm<T, O, D, D>(h, ps, hak);
  mm<T, O, O, D>(s.lam, hak, lhak);
  mm_nt<T, O, D, O>(hak, h, hakh);
  mm<T, O, D, 1>(h, ms, hm);
  // dL/dH = nu m_s^T - Lam H A
#pragma unroll
  for (int i = 0; i < O; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      acc[S::OH + i * D + j] += s.nu[i] * ms[j] - lhak[i * D + j];
  }
  if (p.gnu == nullptr) return;
  // dL/dnu = H m_s - y; dL/dLam = (y y^T - H A H^T + Lam^-1) / 2
#pragma unroll
  for (int i = 0; i < O; ++i) {
    p.gnu[(b * O + i) * n + k] = gs * (hm[i] - y[i]);
#pragma unroll
    for (int j = 0; j < O; ++j)
      p.glam[((b * O + i) * O + j) * n + k] =
          gs * (T(0.5) * (y[i] * y[j] - hakh[i * O + j] + li[i * O + j]));
  }
}

template <typename T, int D, int O>
__device__ __noinline__ void adjoint_stage2_call(const AdjointStep<T, D, O>& st,
                                                 const SElem<T, D>& suf,
                                                 const AdjointPrior<T>& p, int64_t b,
                                                 int64_t k, int64_t n, T gs, T* acc) {
  adjoint_stage2_body<T, D, O>(st, suf, p, b, k, n, gs, acc);
}

// Element source of the reverse scan.  For d >= 4 both stages are calls,
// as the compositions are (scan_core.cuh).
template <typename T_, int D_, int O_>
struct AdjointRow {
  using T = T_;
  static constexpr int D = D_, O = O_;
  using Prior = AdjointPrior<T>;
  UniformRow<T, D, O> u;

  MF_DEV void load(const Prior& p, int64_t b) { u.load(p.k, b); }

  MF_DEV void build(const Prior& p, int64_t b, int64_t k, int64_t n,
                    AdjointStep<T, D, O>& st, SElem<T, D>& out) const {
    if constexpr (D >= 4) adjoint_stage1_call<T, D, O>(u, p, b, k, n, st, out);
    else adjoint_stage1_body<T, D, O>(u, p, b, k, n, st, out);
  }

  MF_DEV void elem(const Prior& p, int64_t b, int64_t k, int64_t n,
                   SElem<T, D>& out) const {
    AdjointStep<T, D, O> st;
    build(p, b, k, n, st, out);
  }
};

template <typename T, int D, int O>
__global__ void __launch_bounds__(Tiling<D>::THREADS)
adjoint_outputs(SmootherArgs<T> a, AdjointPrior<T> p) {
  using Row = AdjointRow<T, D, O>;
  using Op = SmootherOp<T, D>;
  using E = SElem<T, D>;
  constexpr int THREADS = Tiling<D>::THREADS, R = Tiling<D>::R;
  constexpr int NV = AdjointSums<D, O>::NV;
  __shared__ E smem[THREADS / 32 + 1];
  __shared__ T red[NV * (THREADS / 32)];
  const int64_t b = blockIdx.y, blk = blockIdx.x, n = a.n;
  const int64_t first_step = (blk * THREADS + threadIdx.x) * R;
  Row row;
  row.load(p, b);
  E excl, total, run, e, t;
  smoother_thread_suffix<Row>(p, row, b, first_step, n, excl, total, smem);
  // the later threads of this block, then all later blocks
  Op::combine(excl, reinterpret_cast<const E*>(a.totals)[b * a.nblk + blk], run);
  const T gs = p.gscale[b];
  T acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = T(0);
  AdjointStep<T, D, O> st;
  for (int r = R - 1; r >= 0; --r) {
    const int64_t k = first_step + r;
    if (k >= n) continue;
    row.build(p, b, k, n, st, e);
    Op::combine(e, run, t);
    run = t;  // (E, r_k, NDK_k): the suffix from step k on
    if constexpr (D >= 4) adjoint_stage2_call<T, D, O>(st, run, p, b, k, n, gs, acc);
    else adjoint_stage2_body<T, D, O>(st, run, p, b, k, n, gs, acc);
  }
  block_sum<T, THREADS, NV>(acc, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) p.partials[(b * a.nblk + blk) * NV + i] = acc[i];
  }
}

template <typename T, int D>
int64_t adjoint_scratch(int64_t batch, int64_t n) {
  return batch * num_blocks(n, Tiling<D>::TILE) *
         (SElem<T, D>::SIZE + AdjointSums<D, 1>::NV);
}

template <typename T, int D>
int launch_adjoint(AdjointPrior<T> p, T* gsums, T* scratch, int64_t batch, int64_t n,
                   cudaStream_t stream) {
  using Row = AdjointRow<T, D, 1>;
  constexpr int THREADS = Tiling<D>::THREADS, NV = AdjointSums<D, 1>::NV;
  SmootherArgs<T> a{nullptr, nullptr, scratch, n, num_blocks(n, Tiling<D>::TILE)};
  p.partials = scratch + batch * a.nblk * SElem<T, D>::SIZE;
  const dim3 grid(unsigned(a.nblk), unsigned(batch));
  smoother_totals<Row><<<grid, THREADS, 0, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  scan_totals<SmootherOp<T, D>, THREADS, true><<<unsigned(batch), THREADS, 0, stream>>>(
      reinterpret_cast<SElem<T, D>*>(a.totals), a.nblk);
  MF_CHECK_LAUNCH();
  adjoint_outputs<T, D, 1><<<grid, THREADS, 0, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  sum_partials<T, THREADS><<<dim3(unsigned(NV), unsigned(batch)), THREADS, 0, stream>>>(
      p.partials, a.nblk, NV, p.gscale, gsums);
  MF_CHECK_LAUNCH();
  return 0;
}

}  // namespace mf

// C entry point for one dtype (T, suffix), as in uniform_scan.cuh.  gsums
// [B, NV] receives the summed gradients in AdjointSums order, scaled by
// gscale; gnu and glam may be null.
#define MF_DEFINE_ADJOINT_ENTRY_POINTS(T, SUFFIX)                                      \
  extern "C" int mf_uniform_adjoint_##SUFFIX(                                          \
      const T* fc, const T* cc, const T* qc, const T* mu0, const T* p0, const T* hc,   \
      const T* nu, const T* lam, const T* mask, const int64_t* site_strides,           \
      const T* m_f, const T* p_f, const T* gscale, T* gnu, T* glam, T* gm0, T* gp0,    \
      T* gsums, T* scratch, int64_t batch, int64_t n, int64_t d, void* stream) {       \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    if ((gnu == nullptr) != (glam == nullptr)) return int(cudaErrorInvalidValue);      \
    mf::AdjointPrior<T> p{};                                                           \
    p.k = mf::UniformPrior<T>{fc, cc, qc, mu0, p0, hc};                                \
    p.nu = nu; p.lam = lam; p.mask = mask;                                             \
    mf::set_site_strides(p, site_strides);                                             \
    p.m_f = m_f; p.p_f = p_f; p.gscale = gscale;                                       \
    p.gnu = gnu; p.glam = glam; p.gm0 = gm0; p.gp0 = gp0;                              \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    MF_SWITCH_D(d, (mf::launch_adjoint<T, D_>(p, gsums, scratch, batch, n, s)),        \
                int(cudaErrorInvalidValue))                                            \
  }
