// General-grid Kalman filter, smoother-scan and filter-scan kernels for
// Hopper (sm_90a).
//
// Replace the TPU kernels of markovflow_tpu/ops/pallas_scan.py:
//   * filter:        pallas_filter_pipeline (_pipeline_kernel)
//   * smoother scan: pallas_smoother_scan (_smoother_kernel)
//   * filter scan:   pallas_filter_scan (_filter_kernel)
// The plain PyTorch versions are filter_pipeline_plain / smoother_scan_plain
// / filter_scan_plain in markovflow_tpu_torch/ops/cuda_scan.py.  The
// filter reads per-step (F, c, Q, H) through their strides (F_0 = 0 is the
// prior row; for GPR, H is a stride-0 expansion of one row), so one kernel
// serves any time grid; at d <= 6 it has passes of its own (below), the
// other two run the passes of scan_core.cuh.  The smoother
// scan composes prebuilt (E, g, L) elements: the RTS elements of the general
// smoother.  The filter scan composes prebuilt (A, b, C, J, eta) elements
// (the ops filter API, ops.kalman.parallel_filter) with the filter's passes,
// without sites or log-likelihood, and writes the b and C legs.  It moves
// 3 d^2 + 2 d values a step in and d^2 + d out (88 B at d = 2, float32) and
// does one composition a step with a d x d inverse, so it is bound as the
// general filter is.
//
// What bounds them on an H100: the filter reads the prior steps besides the
// sites, 2 d^2 + d values a step (40 B at d = 2, float32) twice, and writes
// d^2 + d; per step it does a rank-one fold in pass 1 and a Kalman
// predict/update in pass 3 (two or three d^3 products, no inverse), so at
// d = 2 its ~100 dependent flops a step leave it latency-bound.  The
// smoother scan reads 2 d^2 + d values a step twice and writes d^2 + d, with
// one composition per step and no inverse: at d = 2, float32, ~104 B a step,
// 31 us at 3.35 TB/s for N = 1e6, close to its arithmetic.  The TPU kernels
// take d <= 12: d = 1..6 are instantiated here, with every element in
// registers; d = 7..12 (an FElem at d = 12 has 456 values) run through the
// warp-per-element kernels of wide_scan.cuh with the Wide*Row sources below.
#pragma once

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
// The general filter (kernel 4) and the general Koopman backward (kernel 7,
// general_adjoint.cuh) at d = 1..6, o = 1: passes of their own, with the
// elements in registers and a run of R consecutive steps a thread.
//
// Kernel 4:
//   1. each thread folds its steps into its run as rank-one site updates
//      (fold_site, the register twin of wide_fold_site: three d^3 products
//      and no inverse a step); the block scan gives every thread its
//      exclusive prefix within the block, which goes to the scratch
//      (store_thread_elem), and the block total;
//   2. scan_totals (scan_core.cuh);
//   3. each thread composes the b and C legs of its block's carry with its
//      stored prefix (filter_moments_through: the filtered moments before
//      its first step, one d x d inverse a thread) and runs the Kalman
//      predict/update from them (kalman_step, the twin of
//      wide_kalman_step), whose prediction also gives the step's
//      log-likelihood; only the moments are carried.
// Pass 3 thus neither rebuilds the in-block prefix nor builds an element.
//
// Steps staged through shared memory.  A thread owns R consecutive steps of
// the time-last arrays, so a warp's load of one value reads 32 sectors R
// steps apart, and a step's few products cannot hide the wait for them.
// Where a warp's steps are at most 6,144 values (STAGED, 24 KB in float32:
// kernel 4 to d = 4, kernel 7 to d = 3, every Matern), each warp first
// copies the values of its 32 R steps into shared memory with cp.async, the
// lanes of one copy on 32 neighbouring steps of one value, all in flight at
// once; each lane then reads its own steps there, and writes its outputs
// there over the inputs it has consumed, which the warp stores the same
// way.  Values that do not change with the step (stride 0: GPR's emission
// row and lam) are read once.  Larger d read each step's values where they
// lie.
// ---------------------------------------------------------------------------

template <typename T, int D, bool MOMENTS>
struct GeneralTiling {
  static constexpr int R = Tiling<D>::R;
  // the values of a step at most: F, Q, c, H, nu, lam, the mask and, with
  // MOMENTS (kernel 7), P_{k-1} and m_{k-1}
  static constexpr int NV = (MOMENTS ? 3 : 2) * (D * D + D) + 3;
  static constexpr int WARP_BYTES = NV * 32 * R * int(sizeof(T));
  static constexpr bool STAGED = NV * 32 * R <= 6144;
  // staged: 8 warps a block, or as many as 192 KB hold (float64): the
  // block's tile of steps sets the number of totals that pass 2 scans in
  // one block, whose chain of compositions grows with them
  static constexpr int WARPS =
      !STAGED ? Tiling<D>::THREADS / 32 : (8 * WARP_BYTES <= 196608 ? 8 : 196608 / WARP_BYTES);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int64_t TILE = int64_t(THREADS) * R;
  static constexpr int SCAN_THREADS = 512;  // pass 2's block: 1 or 2 totals a thread at N = 1e6
};

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
  constexpr int R = G::R;
  st = {nullptr, (t - lane_id()) * R, n};
  if constexpr (G::STAGED) {
    sl = general_slots<D>(p, a, m_f != nullptr);
    st.base = reinterpret_cast<T*>(mf_wide_smem) + (threadIdx.x >> 5) * sl.nv * 32 * R;
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

template <typename T, int D>
__global__ void __launch_bounds__(GeneralTiling<T, D, false>::THREADS)
gfilter_totals(FilterArgs<T> a, GeneralPrior<T> p) {
  using G = GeneralTiling<T, D, false>;
  using Op = FilterOp<T, D>;
  using E = FElem<T, D>;
  constexpr int THREADS = G::THREADS, R = G::R;
  __shared__ E smem[THREADS / 32 + 1];
  const int64_t b = blockIdx.y, n = a.n, t = blockIdx.x * int64_t(THREADS) + threadIdx.x;
  const int lane = lane_id();
  WarpStage<T, R> st;
  GeneralSlots sl{};
  stage_steps<G, D>(p, a, b, t, n, (const T*)nullptr, (const T*)nullptr, st, sl);
  E run, excl, total;
  Op::identity(run);
  GeneralIn<T, D> in;
  for (int r = 0; r < R; ++r) {
    if (t * R + r >= n) break;
    in.template read<G::STAGED>(st, sl, lane, r, p, a, b, t * R + r, r == 0);
    fold_site<T, D>(run, in);
  }
  block_scan<Op, THREADS, false>(run, excl, total, smem);
  store_thread_elem(a.prefix, excl, b, t, a.nblk * THREADS);
  if (threadIdx.x == 0) reinterpret_cast<E*>(a.totals)[b * a.nblk + blockIdx.x] = total;
}

template <typename T, int D>
__global__ void __launch_bounds__(GeneralTiling<T, D, false>::THREADS)
gfilter_outputs(FilterArgs<T> a, GeneralPrior<T> p) {
  using G = GeneralTiling<T, D, false>;
  using E = FElem<T, D>;
  constexpr int THREADS = G::THREADS, R = G::R;
  __shared__ T red[THREADS / 32];
  const int64_t b = blockIdx.y, n = a.n, t = blockIdx.x * int64_t(THREADS) + threadIdx.x;
  const int lane = lane_id();
  // the moments before the thread's first step: all earlier blocks, then
  // the earlier threads of this block (b = 0, C = 0 before step 0, where
  // F = 0 makes them irrelevant)
  T m[D], P[D * D];
  {
    E y;
    load_thread_elem(a.prefix, y, b, t, a.nblk * THREADS);
    const E& x = reinterpret_cast<const E*>(a.totals)[b * a.nblk + blockIdx.x];
    filter_moments_through<T, D>(x.v + E::OB, x.v + E::OC, y, m, P);
  }
  WarpStage<T, R> st;
  GeneralSlots sl{};
  stage_steps<G, D>(p, a, b, t, n, (const T*)nullptr, (const T*)nullptr, st, sl);
  T ll[1] = {T(0)};
  GeneralIn<T, D> in;
  for (int r = 0; r < R; ++r) {
    const int64_t k = t * R + r;
    if (k >= n) break;
    in.template read<G::STAGED>(st, sl, lane, r, p, a, b, k, r == 0);
    ll[0] += kalman_step<T, D>(m, P, in);
    // P_f over the staged Q and m_f over c, or at step k
    T *pf = G::STAGED ? st.at(D * D, lane, r) : a.p_f + b * D * D * n + k,
      *mf = G::STAGED ? st.at(2 * D * D, lane, r) : a.m_f + b * D * n + k;
    const int64_t stride = G::STAGED ? 32 * R : n;
#pragma unroll
    for (int i = 0; i < D * D; ++i) pf[i * stride] = P[i];
#pragma unroll
    for (int i = 0; i < D; ++i) mf[i * stride] = m[i];
  }
  if constexpr (G::STAGED) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D * D; ++i) st.store(D * D + i, a.p_f + (b * D * D + i) * n);
#pragma unroll
    for (int i = 0; i < D; ++i) st.store(2 * D * D + i, a.m_f + (b * D + i) * n);
  }
  block_sum<T, THREADS, 1>(ll, red);
  if (threadIdx.x == 0) a.partials[b * a.nblk + blockIdx.x] = ll[0];
}

// Scratch of the general filter in elements of T: the block totals, the
// partial sums and every thread's in-block prefix.
template <typename T, int D>
int64_t general_filter_scratch(int64_t batch, int64_t n) {
  using G = GeneralTiling<T, D, false>;
  return batch * num_blocks(n, G::TILE) * (FElem<T, D>::SIZE * (1 + G::THREADS) + 1);
}

// Dynamic shared memory of a staged pass: nv values of 32 R steps a warp.
template <class G, typename T>
size_t general_stage_bytes(int nv) {
  return G::STAGED ? size_t(G::THREADS / 32) * nv * 32 * G::R * sizeof(T) : 0;
}

// pass_occupancy of passes 1, 3 and 2 (out[0..11]), staged for the largest
// number of values a step.
template <typename T, int D>
int general_filter_occupancy(int64_t* out) {
  using G = GeneralTiling<T, D, false>;
  const size_t bytes = general_stage_bytes<G, T>(G::NV);
  int err = wide_smem_bytes(gfilter_totals<T, D>, bytes);
  if (err == 0) err = wide_smem_bytes(gfilter_outputs<T, D>, bytes);
  if (err == 0) err = pass_occupancy(gfilter_totals<T, D>, G::THREADS, bytes, out);
  if (err == 0) err = pass_occupancy(gfilter_outputs<T, D>, G::THREADS, bytes, out + 4);
  if (err == 0)
    err = pass_occupancy(scan_totals<FilterOp<T, D>, G::SCAN_THREADS, false>, G::SCAN_THREADS,
                         0, out + 8);
  return err;
}

template <typename T, int D>
int launch_general_filter(FilterArgs<T> a, GeneralPrior<T> p, T* scratch, int64_t batch,
                          cudaStream_t stream) {
  using G = GeneralTiling<T, D, false>;
  constexpr int SIZE = FElem<T, D>::SIZE;
  a.nblk = num_blocks(a.n, G::TILE);
  a.totals = scratch;
  a.partials = scratch + batch * a.nblk * SIZE;
  a.prefix = a.partials + batch * a.nblk;
  const size_t bytes = general_stage_bytes<G, T>(general_slots<D>(p, a, false).nv);
  int err = wide_smem_bytes(gfilter_totals<T, D>, bytes);
  if (err == 0) err = wide_smem_bytes(gfilter_outputs<T, D>, bytes);
  if (err != 0) return err;
  const dim3 grid(unsigned(a.nblk), unsigned(batch));
  gfilter_totals<T, D><<<grid, G::THREADS, bytes, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  scan_totals<FilterOp<T, D>, G::SCAN_THREADS, false>
      <<<unsigned(batch), G::SCAN_THREADS, 0, stream>>>(
      reinterpret_cast<FElem<T, D>*>(a.totals), a.nblk);
  MF_CHECK_LAUNCH();
  gfilter_outputs<T, D><<<grid, G::THREADS, bytes, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  sum_partials<T, 256><<<dim3(1u, unsigned(batch)), 256, 0, stream>>>(
      a.partials, a.nblk, 1, nullptr, a.loglik);
  MF_CHECK_LAUNCH();
  return 0;
}

// prebuilt filtering elements, contiguous: A, C, J [B, d, d, N],
// b, eta [B, d, 1, N]
template <typename T>
struct FilterPrebuilt {
  const T *a, *b, *c, *j, *e;
};

template <typename T_, int D_>
struct FilterPrebuiltRow {
  using T = T_;
  static constexpr int D = D_, O = 1;
  static constexpr bool PREBUILT = true;
  using Prior = FilterPrebuilt<T>;

  MF_DEV void load(const Prior&, int64_t) {}

  MF_DEV void elem(const Prior& a, int64_t b, int64_t k, int64_t n,
                   FElem<T, D>& out) const {
    using E = FElem<T, D>;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      out.v[E::OB + i] = a.b[(b * D + i) * n + k];
      out.v[E::OE + i] = a.e[(b * D + i) * n + k];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int64_t at = ((b * D + i) * D + j) * n + k;
        out.v[E::OA + i * D + j] = a.a[at];
        out.v[E::OC + i * D + j] = a.c[at];
        out.v[E::OJ + i * D + j] = a.j[at];
      }
    }
  }
};

// prebuilt smoothing elements: Prebuilt (wide_scan.cuh)
template <typename T_, int D_>
struct PrebuiltRow {
  using T = T_;
  static constexpr int D = D_;
  using Prior = Prebuilt<T>;

  MF_DEV void load(const Prior&, int64_t) {}

  MF_DEV void elem(const Prior& a, int64_t b, int64_t k, int64_t n,
                   SElem<T, D>& out) const {
    using E = SElem<T, D>;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      out.v[E::OG + i] = a.g[(b * D + i) * n + k];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        out.v[E::OE + i * D + j] = a.e[((b * D + i) * D + j) * n + k];
        out.v[E::OL + i * D + j] = a.l[((b * D + i) * D + j) * n + k];
      }
    }
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
struct WidePrebuiltRow : WideReadRow<T_> {
  using Prior = Prebuilt<T_>;

  static MF_DEV WideRows<const T_*> rows(const Prior& a, int d) {
    return wide_element_rows(a, d);
  }
};

template <typename T_>
struct WideFilterPrebuiltRow {
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
// Q and H as F, then the sites as set_site_strides takes them.
#define MF_DEFINE_GENERAL_ENTRY_POINTS(T, SUFFIX)                                      \
  extern "C" int mf_general_filter_##SUFFIX(                                           \
      const T* f, const T* c, const T* q, const T* h, const T* nu, const T* lam,       \
      const T* mask, const int64_t* st, T* m_f, T* p_f, T* loglik, T* scratch,         \
      int64_t batch, int64_t n, int64_t d, void* stream) {                             \
    if (batch < 1 || batch > 65535 || n < 1) return int(cudaErrorInvalidValue);        \
    mf::GeneralPrior<T> p{f, c, q, h,                                                  \
                          st[0], st[1], st[2], st[3],                                  \
                          st[4], st[5], st[6],                                         \
                          st[7], st[8], st[9], st[10],                                 \
                          st[11], st[12], st[13], st[14]};                             \
    mf::FilterArgs<T> a{};                                                             \
    a.nu = nu; a.lam = lam; a.mask = mask;                                             \
    mf::set_site_strides(a, st + 15);                                                  \
    a.m_f = m_f; a.p_f = p_f; a.loglik = loglik; a.n = n;                              \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                \
    if (d >= mf::WIDE_MIN_D)                                                           \
      return mf::launch_wide_filter<mf::WideGeneralRow<T>>(a, p, scratch, batch, int(d), \
                                                           s);                         \
    MF_SWITCH_D(d, (mf::launch_general_filter<T, D_>(a, p, scratch, batch, s)),         \
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
      return mf::launch_wide_smoother<mf::WidePrebuiltRow<T>>(a, p, scratch, batch,    \
                                                              int(d), s);              \
    MF_SWITCH_D(d, (mf::launch_smoother<mf::PrebuiltRow<T, D_>>(a, p, scratch, batch,  \
                                                                s)),                   \
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
      return mf::launch_wide_filter<mf::WideFilterPrebuiltRow<T>>(a, p, scratch, batch,  \
                                                                  int(d), s);          \
    MF_SWITCH_D(d, (mf::launch_filter<mf::FilterPrebuiltRow<T, D_>>(a, p, scratch,     \
                                                                    batch, s)),        \
                int(cudaErrorInvalidValue))                                            \
  }
