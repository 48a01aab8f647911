// General-grid (per-step) Koopman backward kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel markovflow_tpu/ops/pallas_scan.py::
// pallas_adjoint_pipeline (_adjoint_kernel): stage 1, the reverse scan and
// stage 2 of the Koopman score in one kernel, for per-step prior steps
// (F, c, Q) and emission H on any time grid.  The plain PyTorch version is
// adjoint_pipeline_plain in markovflow_tpu_torch/ops/adjoint.py (the plain
// stages around the plain reverse scan).
//
// For each step k, stage 1 (adjoint_scan.cuh, with GeneralRow as the
// prior-step source) reads F_k, c_k, Q_k, H_k through their strides, the
// sites, (m, P)_{k-1} from the saved filtered moments and F_{k+1} (0 at the
// last step), and builds the smoothing element (L_k^T, H^T e, H^T W H).  The
// reverse scan of those elements gives r_k and NDK_k; stage 2 turns them into
// the step's gradients, scaled by the row's cotangent gscale:
//   gF_k = r m_{k-1}^T + 2 N F_k P_{k-1},  gc_k = r,  gQ_k = N,
//   N = (r r^T - NDK) / 2,
// and, through the smoothed moments, gH_k, gnu_k, glam_k (0 at masked steps).
// Each output may be null: the kernel writes only what autograd asks for
// (GPR asks for gF, gc and gQ).  Unlike the uniform backward there are no
// sums across steps, so no partials and no fourth pass.
//
// Passes: the smoother passes of scan_core.cuh with this element source
// (block totals of the reverse reduce, then scan_totals), then
// gadjoint_outputs, which rebuilds the elements, folds in the suffix of all
// later steps and writes every step's gradients.  d = 7..12 run the same
// passes a warp per element (wide_scan.cuh), with stage 1 and stage 2
// composed warp-cooperatively in the warp's workspace.
//
// What bounds it on an H100: per step it reads F, c, Q (2 d^2 + d values),
// the sites (one expanded value each for GPR) and (m, P)_{k-1} (d^2 + d)
// twice, and writes gF, gc, gQ (2 d^2 + d): ~108 B a step at d = 2, float32,
// a 32 us floor at N = 1e6.  It does ~3x the smoother scan's arithmetic per
// step (stage 1 twice, stage 2, two compositions), so it is bound by
// arithmetic latency as the filter is.
#pragma once

#include "adjoint_scan.cuh"
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
};

// Stage 2: the step's gradients from r = suf.g and NDK = suf.ell, written
// per step (adjoint_grads_from_scan; adjoint_stage2_body sums them instead).
template <typename T, int D, int O>
MF_DEV void gadjoint_stage2_body(const AdjointStep<T, D, O>& st, const SElem<T, D>& suf,
                                 const GeneralAdjointPrior<T>& p, int64_t b, int64_t k,
                                 int64_t n, T gs) {
  using E = SElem<T, D>;
  const FilterStep<T, D, O>& s = st.s;
  const T* h = s.h;
  const T *r = suf.v + E::OG, *ndk = suf.v + E::OL;
  T nm[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) nm[i * D + j] = T(0.5) * (r[i] * r[j] - ndk[i * D + j]);
  }
  if (p.gf != nullptr) {
    T fp[D * D], nfp[D * D];
    mm<T, D, D, D>(s.f, st.pprev, fp);
    mm<T, D, D, D>(nm, fp, nfp);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        p.gf[((b * D + i) * D + j) * n + k] = gs * (r[i] * st.mp[j] + T(2) * nfp[i * D + j]);
    }
  }
  if (p.gc != nullptr) {
#pragma unroll
    for (int i = 0; i < D; ++i) p.gc[(b * D + i) * n + k] = gs * r[i];
  }
  if (p.gq != nullptr) {
#pragma unroll
    for (int i = 0; i < D * D; ++i) p.gq[(b * D * D + i) * n + k] = gs * nm[i];
  }
  if (p.gh == nullptr && p.gnu == nullptr && p.glam == nullptr) return;
  if (!s.keep) {  // masked steps: zero observation gradients
#pragma unroll
    for (int i = 0; i < O; ++i) {
      if (p.gnu != nullptr) p.gnu[(b * O + i) * n + k] = T(0);
#pragma unroll
      for (int j = 0; j < O; ++j)
        if (p.glam != nullptr) p.glam[((b * O + i) * O + j) * n + k] = T(0);
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (p.gh != nullptr) p.gh[((b * O + i) * D + j) * n + k] = T(0);
    }
    return;
  }
  // smoothed moments m_s = a + Pp r, A = sym(Pp - Pp NDK Pp) + m_s m_s^T
  T ms[D], ps[D * D], t1[D * D];
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
  // y = Lam^-1 nu
  T li[O * O], y[O];
  inv<T, O>(s.lam, li);
  mm<T, O, O, 1>(li, s.nu, y);
  T hak[O * D], lhak[O * D], hakh[O * O], hm[O];
  mm<T, O, D, D>(h, ps, hak);
  mm<T, O, O, D>(s.lam, hak, lhak);
  mm_nt<T, O, D, O>(hak, h, hakh);
  mm<T, O, D, 1>(h, ms, hm);
  // dL/dH = nu m_s^T - Lam H A; dL/dnu = H m_s - y;
  // dL/dLam = (y y^T - H A H^T + Lam^-1) / 2
#pragma unroll
  for (int i = 0; i < O; ++i) {
    if (p.gh != nullptr) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        p.gh[((b * O + i) * D + j) * n + k] = gs * (s.nu[i] * ms[j] - lhak[i * D + j]);
    }
    if (p.gnu != nullptr) p.gnu[(b * O + i) * n + k] = gs * (hm[i] - y[i]);
    if (p.glam != nullptr) {
#pragma unroll
      for (int j = 0; j < O; ++j)
        p.glam[((b * O + i) * O + j) * n + k] =
            gs * (T(0.5) * (y[i] * y[j] - hakh[i * O + j] + li[i * O + j]));
    }
  }
}

template <typename T, int D, int O>
__device__ __noinline__ void gadjoint_stage2_call(const AdjointStep<T, D, O>& st,
                                                  const SElem<T, D>& suf,
                                                  const GeneralAdjointPrior<T>& p, int64_t b,
                                                  int64_t k, int64_t n, T gs) {
  gadjoint_stage2_body<T, D, O>(st, suf, p, b, k, n, gs);
}

template <typename T, int D, int O>
using GeneralAdjointRow = AdjointRow<GeneralRow<T, D, O>, GeneralAdjointPrior<T>>;

template <typename T, int D, int O>
__global__ void __launch_bounds__(Tiling<D>::THREADS)
gadjoint_outputs(SmootherArgs<T> a, GeneralAdjointPrior<T> p) {
  using Row = GeneralAdjointRow<T, D, O>;
  using Op = SmootherOp<T, D>;
  using E = SElem<T, D>;
  constexpr int THREADS = Tiling<D>::THREADS, R = Tiling<D>::R;
  __shared__ E smem[THREADS / 32 + 1];
  const int64_t b = blockIdx.y, blk = blockIdx.x, n = a.n;
  const int64_t first_step = (blk * THREADS + threadIdx.x) * R;
  Row row;
  row.load(p, b);
  E excl, total, run, e, t;
  smoother_thread_suffix<Row>(p, row, b, first_step, n, excl, total, smem);
  // the later threads of this block, then all later blocks
  Op::combine(excl, reinterpret_cast<const E*>(a.totals)[b * a.nblk + blk], run);
  const T gs = p.gscale[b];
  AdjointStep<T, D, O> st;
  for (int r = R - 1; r >= 0; --r) {
    const int64_t k = first_step + r;
    if (k >= n) continue;
    row.build(p, b, k, n, st, e);
    Op::combine(e, run, t);
    run = t;  // (E, r_k, NDK_k): the suffix from step k on
    if constexpr (D >= 4) gadjoint_stage2_call<T, D, O>(st, run, p, b, k, n, gs);
    else gadjoint_stage2_body<T, D, O>(st, run, p, b, k, n, gs);
  }
}

template <typename T, int D>
int launch_general_adjoint(GeneralAdjointPrior<T> p, T* scratch, int64_t batch, int64_t n,
                           cudaStream_t stream) {
  using Row = GeneralAdjointRow<T, D, 1>;
  constexpr int THREADS = Tiling<D>::THREADS;
  SmootherArgs<T> a{nullptr, nullptr, scratch, n, num_blocks(n, Tiling<D>::TILE)};
  const dim3 grid(unsigned(a.nblk), unsigned(batch));
  smoother_totals<Row><<<grid, THREADS, 0, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  scan_totals<SmootherOp<T, D>, THREADS, true><<<unsigned(batch), THREADS, 0, stream>>>(
      reinterpret_cast<SElem<T, D>*>(a.totals), a.nblk);
  MF_CHECK_LAUNCH();
  gadjoint_outputs<T, D, 1><<<grid, THREADS, 0, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// d = 7..12: a warp per element (wide_scan.cuh), o = 1.
// ---------------------------------------------------------------------------

// Stage 1 of step k into out (adjoint_stage1_body, o = 1: Zt, W and e are
// scalars, so no inverse).  What stage 2 reads stays in the warp's
// workspace, where the smoothing composition does not write: F_k in w.f,
// the sites in w, P_{k-1} and Pp in w.aug, m_{k-1} in w.v[5], a in w.v[4].
template <typename T_>
struct WideGeneralAdjointRow {
  using T = T_;
  using Prior = GeneralAdjointPrior<T>;

  static MF_DEV void elem(const Prior& p, int64_t b, int64_t k, int64_t n, T* out,
                          WideWork<T>& w, int d) {
    const int dd = d * d, OE = 0, OG = dd, OL = dd + d, lane = lane_id();
    T *mp = w.v[5], *a = w.v[4], *pprev = w.aug, *pp = w.aug + dd, *ph = w.v[0];
    T *htwh = w.m[1], *ikh = w.m[2], *fnext = w.m[3], *lmat = w.m[0];
    WideGeneralRow<T>::step(p.k, b, k, w, d);
    wide_sites(p, b, k, w);
    for (int e = lane; e < d; e += 32) mp[e] = k > 0 ? p.m_f[(b * d + e) * n + k - 1] : T(0);
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      pprev[e] = k > 0 ? p.p_f[(b * dd + e) * n + k - 1] : T(0);
      fnext[e] = k == n - 1 ? T(0)
                            : p.k.f[b * p.k.f_sb + i * p.k.f_si + j * p.k.f_sj +
                                    (k + 1) * p.k.f_st];
    }
    __syncwarp();
    // a = F m + c, Pp = sym(F P F^T + Q)
    wmm(w.f, mp, a, d, d, 1);
    wadd(a, w.c, d);
    wmm<T, false, true>(pprev, w.f, lmat, d, d, d);
    wmm(w.f, lmat, pp, d, d, d);
    wadd(pp, w.q, dd);
    wsym(pp, d);
    // Zt = 1 / (1 + Lam H Pp H^T), W = Zt Lam, e = Zt (nu - Lam H a)
    wmm<T, false, true>(pp, w.h, ph, d, d, 1);
    const T zt = T(1) / (w.lam * wdot(w.h, ph, d) + T(1));
    const T wv = zt * w.lam;
    const T ev = zt * (w.nu - w.lam * wdot(w.h, a, d));
    // H^T W H; L = F_{k+1} (I - Pp H^T W H)
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      htwh[e] = w.h[i] * (wv * w.h[j]);
    }
    __syncwarp();
    wmm(pp, htwh, ikh, d, d, d);
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      ikh[e] = (i == j ? T(1) : T(0)) - ikh[e];
    }
    __syncwarp();
    wmm(fnext, ikh, lmat, d, d, d);
    // element (E = L^T, g = H^T e, ell = sym(H^T W H))
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      out[OE + e] = lmat[j * d + i];
      out[OL + e] = htwh[e];
    }
    for (int e = lane; e < d; e += 32) out[OG + e] = w.h[e] * ev;
    __syncwarp();
    wsym(out + OL, d);
  }
};

// Stage 2 of the step in w (gadjoint_stage2_body, o = 1) from the suffix
// suf = (E, r, NDK).
template <typename T>
MF_DEV void wide_gadjoint_stage2(const GeneralAdjointPrior<T>& p, const T* suf,
                                 WideWork<T>& w, int64_t b, int64_t k, int64_t n, T gs,
                                 int d) {
  const int dd = d * d, lane = lane_id();
  const T *r = suf + dd, *ndk = suf + dd + d;
  const T *mp = w.v[5], *a = w.v[4], *pprev = w.aug, *pp = w.aug + dd;
  T *nm = w.m[1], *fp = w.m[2], *nfp = w.m[3];
  for (int e = lane; e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    nm[e] = T(0.5) * (r[i] * r[j] - ndk[e]);
  }
  __syncwarp();
  if (p.gf != nullptr) {
    wmm(w.f, pprev, fp, d, d, d);
    wmm(nm, fp, nfp, d, d, d);
    for (int e = lane; e < dd; e += 32) {
      const int i = e / d, j = e - i * d;
      p.gf[(b * dd + e) * n + k] = gs * (r[i] * mp[j] + T(2) * nfp[e]);
    }
  }
  if (p.gc != nullptr)
    for (int e = lane; e < d; e += 32) p.gc[(b * d + e) * n + k] = gs * r[e];
  if (p.gq != nullptr)
    for (int e = lane; e < dd; e += 32) p.gq[(b * dd + e) * n + k] = gs * nm[e];
  __syncwarp();
  if (p.gh == nullptr && p.gnu == nullptr && p.glam == nullptr) return;
  if (!w.keep) {  // masked steps: zero observation gradients
    if (p.gh != nullptr)
      for (int e = lane; e < d; e += 32) p.gh[(b * d + e) * n + k] = T(0);
    if (lane == 0 && p.gnu != nullptr) p.gnu[b * n + k] = T(0);
    if (lane == 0 && p.glam != nullptr) p.glam[b * n + k] = T(0);
    __syncwarp();
    return;
  }
  // smoothed moments m_s = a + Pp r, A = sym(Pp - Pp NDK Pp) + m_s m_s^T
  T *ms = w.v[0], *hak = w.v[1], *t1 = w.m[0], *ps = w.m[2];
  wmm(pp, r, ms, d, d, 1);
  wadd(ms, a, d);
  wmm(ndk, pp, t1, d, d, d);
  wmm(pp, t1, ps, d, d, d);
  for (int e = lane; e < dd; e += 32) ps[e] = pp[e] - ps[e];
  __syncwarp();
  wsym(ps, d);
  for (int e = lane; e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    ps[e] += ms[i] * ms[j];
  }
  __syncwarp();
  const T li = T(1) / w.lam, y = li * w.nu;
  wmm(w.h, ps, hak, 1, d, d);  // H A
  const T hakh = wdot(hak, w.h, d), hm = wdot(w.h, ms, d);
  if (p.gh != nullptr)
    for (int e = lane; e < d; e += 32)
      p.gh[(b * d + e) * n + k] = gs * (w.nu * ms[e] - w.lam * hak[e]);
  if (lane == 0 && p.gnu != nullptr) p.gnu[b * n + k] = gs * (hm - y);
  if (lane == 0 && p.glam != nullptr)
    p.glam[b * n + k] = gs * (T(0.5) * (y * y - hakh + li));
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_gadjoint_outputs(SmootherArgs<T> a, GeneralAdjointPrior<T> p, int d, int64_t steps) {
  const int warp = threadIdx.x >> 5, size = wide_smoother_size(d);
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp, n = a.n;
  if (u >= a.nblk) return;
  WideWork<T> w = wide_work<T>(reinterpret_cast<T*>(mf_wide_smem) + warp * wide_floats(d), d);
  T *run = w.slot[0], *nxt = w.slot[1], *e = w.slot[2];
  wcopy(run, a.totals + (b * a.nblk + u) * size, size);  // suffix of all later warps
  const T gs = p.gscale[b];
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, n);
  for (int64_t k = k1 - 1; k >= k0; --k) {
    WideGeneralAdjointRow<T>::elem(p, b, k, n, e, w, d);
    WideSmootherOp<T>::combine(e, run, nxt, w, d);
    T* s = run; run = nxt; nxt = s;
    wide_gadjoint_stage2(p, run, w, b, k, n, gs, d);
  }
}

template <typename T>
int launch_wide_general_adjoint(GeneralAdjointPrior<T> p, T* scratch, int64_t batch,
                                int64_t n, int d, cudaStream_t stream) {
  using Row = WideGeneralAdjointRow<T>;
  if (d < WIDE_MIN_D || d > WIDE_MAX_D) return int(cudaErrorInvalidValue);
  const int64_t steps = wide_steps(n);
  SmootherArgs<T> a{nullptr, nullptr, scratch, n, num_blocks(n, steps)};
  const dim3 grid(unsigned(num_blocks(a.nblk, WIDE_WARPS)), unsigned(batch));
  const size_t bytes = size_t(WIDE_WARPS) * wide_floats(d) * sizeof(T);
  int err = wide_smem_bytes(wide_smoother_totals<Row>, bytes);
  if (err == 0) err = wide_smem_bytes(wide_gadjoint_outputs<T>, bytes);
  if (err != 0) return err;
  wide_smoother_totals<Row><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<WideSmootherOp<T>, true, T>(a.totals, a.nblk, batch, d, stream);
  if (err != 0) return err;
  wide_gadjoint_outputs<T><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  return 0;
}

}  // namespace mf

// C entry point for one dtype (T, suffix), as in general_scan.cuh: the
// strides of F, c, Q, H and the sites in the general filter's order; the
// scratch is the smoother scan's (mf_smoother_scratch_*); any gradient
// pointer may be null.
#define MF_DEFINE_GENERAL_ADJOINT_ENTRY_POINTS(T, SUFFIX)                              \
  extern "C" int mf_general_adjoint_##SUFFIX(                                          \
      const T* f, const T* c, const T* q, const T* h, const T* nu, const T* lam,       \
      const T* mask, const int64_t* st, const T* m_f, const T* p_f, const T* gscale,   \
      T* gf, T* gc, T* gq, T* gh, T* gnu, T* glam, T* scratch, int64_t batch,          \
      int64_t n, int64_t d, void* stream) {                                            \
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
    p.gf = gf; p.gc = gc; p.gq = gq; p.gh = gh; p.gnu = gnu; p.glam = glam;            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_general_adjoint<T>(p, scratch, batch, n, int(d), s);      \
    MF_SWITCH_D(d, (mf::launch_general_adjoint<T, D_>(p, scratch, batch, n, s)),       \
                int(cudaErrorInvalidValue))                                            \
  }
