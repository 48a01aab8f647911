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
// three passes a warp per element (wide_gadjoint_pass and the pass 2 of
// wide_scan.cuh), with stage 1 and stage 2 composed warp-cooperatively in
// the warp's workspace (see the notes above wide_gadjoint_pass).
//
// What bounds it on an H100: per step it reads F, c, Q (2 d^2 + d values),
// the sites (one expanded value each for GPR) and (m, P)_{k-1} (d^2 + d)
// twice, and writes gF, gc, gQ (2 d^2 + d): ~108 B a step at d = 2, float32,
// a 32 us floor at N = 1e6 (52 us at d = 9, N = 1e5).  It does ~3x the
// smoother scan's arithmetic per step (stage 1 twice, stage 2, two
// compositions), so it is bound by arithmetic latency as the filter is: at
// d = 7..12 by the chain of a warp's steps, each a few shared-memory
// products of d x d matrices, which the wide route shortens (rank-one
// stage 1, no E product in pass 3, a pass 2 over many SMs).
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
// (adjoint_stage1_body, o = 1): fp = F P_{k-1}, Pp = sym(F P_{k-1} F^T + Q),
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

// Stage 2 of the step in slot st (gadjoint_stage2_body, o = 1) from
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
