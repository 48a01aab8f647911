// Shared core of the Kalman scan kernels for Hopper (sm_90a): associative
// elements and their compositions, the block-wide scan, and the passes of
// the filter and smoother kernels, written once for every element source.
//
// Design: reduce, then scan, then fix up.  The TPU kernels thread one carry
// through a sequential grid; here blocks run in no order, so
//   1. each thread owns R consecutive steps, builds their associative
//      elements in registers and composes them in order; a warp-shuffle
//      scan plus a scan of the warp totals gives the block total, which is
//      written out (one element per block);
//   2. one block per batch row scans the block totals into exclusive
//      carries, in place;
//   3. each thread rebuilds its elements (re-reading the inputs is cheaper
//      than storing 3d^2 + 2d values per step), folds in its exclusive
//      prefix and writes the outputs.  A reduction over steps (the
//      filter's log-likelihood, the adjoint's gradient sums) goes out as one
//      partial per block;
//   4. one block per (value, batch row) sums the partials in a fixed order.
// No float atomics: a run repeats bit for bit.  The general filter and the
// general Koopman backward have passes of their own that keep pass 1's
// in-block prefix instead of rebuilding it (general_scan.cuh).
//
// A source ("Row") supplies the elements of one batch row: the filter's
// rows build (F, c, Q, H) and the sites of each step (FilterStep), or, with
// Row::PREBUILT, read a prebuilt filtering element (no sites, no
// log-likelihood); the smoother's rows build one smoothing element per step.  The prior element
// sits at global step 0 and a smoother's boundary element at global step
// N-1; both are found from global indices, and steps past N are absent.
#pragma once

#include <stdint.h>

#include "small_linalg.cuh"

namespace mf {

// Threads per block and steps per thread, sized by the state dimension.
template <int D>
struct Tiling {
  static constexpr int THREADS = D <= 2 ? 256 : 128;
  static constexpr int R = D <= 2 ? 8 : 4;
  static constexpr int64_t TILE = int64_t(THREADS) * R;
};

inline int64_t num_blocks(int64_t n, int64_t tile) { return (n + tile - 1) / tile; }

MF_DEV int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// ---------------------------------------------------------------------------
// Associative elements and their compositions.
// ---------------------------------------------------------------------------

// Filtering element (A, b, C, J, eta) of Sarkka & Garcia-Fernandez (2021).
template <typename T, int D>
struct FElem {
  static constexpr int OA = 0, OB = D * D, OC = OB + D, OJ = OC + D * D,
                       OE = OJ + D * D, SIZE = OE + D;
  T v[SIZE];
};

// Smoothing element (E, g, L).
template <typename T, int D>
struct SElem {
  static constexpr int OE = 0, OG = D * D, OL = OG + D, SIZE = OL + D * D;
  T v[SIZE];
};

template <typename T, int D>
struct FilterOp {
  using Elem = FElem<T, D>;

  static MF_DEV void identity(Elem& x) {
#pragma unroll
    for (int i = 0; i < Elem::SIZE; ++i) x.v[i] = T(0);
#pragma unroll
    for (int i = 0; i < D; ++i) x.v[Elem::OA + i * D + i] = T(1);
  }

  // out = x (earlier) composed with y (later)
  static MF_DEV void combine(const Elem& x, const Elem& y, Elem& out) {
    if constexpr (D >= 4) combine_call(x, y, out);
    else combine_body(x, y, out);
  }

  // For d >= 4 the composition is a call, not inlined at each of its uses:
  // those instantiations spill registers anyway, and inlining them took most
  // of the build time.
  static __device__ __noinline__ void combine_call(const Elem& x, const Elem& y,
                                                   Elem& out) {
    combine_body(x, y, out);
  }

  static MF_DEV void combine_body(const Elem& x, const Elem& y, Elem& out) {
    const T *xa = x.v + Elem::OA, *xb = x.v + Elem::OB, *xc = x.v + Elem::OC,
            *xj = x.v + Elem::OJ, *xe = x.v + Elem::OE;
    const T *ya = y.v + Elem::OA, *yb = y.v + Elem::OB, *yc = y.v + Elem::OC,
            *yj = y.v + Elem::OJ, *ye = y.v + Elem::OE;
    T *oa = out.v + Elem::OA, *ob = out.v + Elem::OB, *oc = out.v + Elem::OC,
      *oj = out.v + Elem::OJ, *oe = out.v + Elem::OE;
    T t1[D * D], t2[D * D], minv[D * D], v1[D], v2[D];
    mm<T, D, D, D>(xc, yj, t1);
    add_eye<T, D>(t1);
    inv<T, D>(t1, minv);
    // A = ya minv xa
    mm<T, D, D, D>(minv, xa, t1);
    mm<T, D, D, D>(ya, t1, oa);
    // b = ya minv (xb + xc ye) + yb
    mm<T, D, D, 1>(xc, ye, v1);
    add_to<T, D>(v1, xb);
    mm<T, D, D, 1>(minv, v1, v2);
    mm<T, D, D, 1>(ya, v2, ob);
    add_to<T, D>(ob, yb);
    // C = sym(ya (minv xc) ya^T + yc)
    mm<T, D, D, D>(minv, xc, t1);
    mm_nt<T, D, D, D>(t1, ya, t2);
    mm<T, D, D, D>(ya, t2, oc);
    add_to<T, D * D>(oc, yc);
    sym<T, D>(oc);
    // eta = xa^T minv^T (ye - yj xb) + xe
    mm<T, D, D, 1>(yj, xb, v1);
#pragma unroll
    for (int i = 0; i < D; ++i) v1[i] = ye[i] - v1[i];
    mm_tn<T, D, D, 1>(minv, v1, v2);
    mm_tn<T, D, D, 1>(xa, v2, oe);
    add_to<T, D>(oe, xe);
    // J = sym(xa^T minv^T yj xa + xj)
    mm<T, D, D, D>(yj, xa, t1);
    mm_tn<T, D, D, D>(minv, t1, t2);
    mm_tn<T, D, D, D>(xa, t2, oj);
    add_to<T, D * D>(oj, xj);
    sym<T, D>(oj);
  }
};

template <typename T, int D>
struct SmootherOp {
  using Elem = SElem<T, D>;

  static MF_DEV void identity(Elem& x) {
#pragma unroll
    for (int i = 0; i < Elem::SIZE; ++i) x.v[i] = T(0);
#pragma unroll
    for (int i = 0; i < D; ++i) x.v[Elem::OE + i * D + i] = T(1);
  }

  // out = e (earlier) composed with l (later, the suffix):
  // E = eE lE, g = eE lg + eg, L = sym(eE lL eE^T + eL)
  static MF_DEV void combine(const Elem& e, const Elem& l, Elem& out) {
    if constexpr (D >= 4) combine_call(e, l, out);
    else combine_body(e, l, out);
  }

  static __device__ __noinline__ void combine_call(const Elem& e, const Elem& l,
                                                   Elem& out) {
    combine_body(e, l, out);
  }

  static MF_DEV void combine_body(const Elem& e, const Elem& l, Elem& out) {
    const T* ee = e.v + Elem::OE;
    mm<T, D, D, D>(ee, l.v + Elem::OE, out.v + Elem::OE);
    mm<T, D, D, 1>(ee, l.v + Elem::OG, out.v + Elem::OG);
    add_to<T, D>(out.v + Elem::OG, e.v + Elem::OG);
    T t[D * D];
    mm_nt<T, D, D, D>(l.v + Elem::OL, ee, t);
    mm<T, D, D, D>(ee, t, out.v + Elem::OL);
    add_to<T, D * D>(out.v + Elem::OL, e.v + Elem::OL);
    sym<T, D>(out.v + Elem::OL);
  }
};

// ---------------------------------------------------------------------------
// Block-wide exclusive scan of one element per thread.
// ---------------------------------------------------------------------------

template <typename E>
MF_DEV void shfl(const E& src, E& dst, int off, bool down) {
#pragma unroll
  for (int i = 0; i < E::SIZE; ++i)
    dst.v[i] = down ? __shfl_down_sync(0xffffffffu, src.v[i], off)
                    : __shfl_up_sync(0xffffffffu, src.v[i], off);
}

// Inclusive scan across the 32 lanes of a warp.  REV = false runs in time
// order (lane 0 earliest); REV = true accumulates suffixes (lane 31 last).
template <class Op, bool REV>
MF_DEV void warp_inclusive(typename Op::Elem& incl) {
  using E = typename Op::Elem;
  const int lane = threadIdx.x & 31;
  E y, t;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    shfl(incl, y, off, REV);
    if (REV ? lane + off < 32 : lane >= off) {
      if (REV) Op::combine(incl, y, t);
      else Op::combine(y, incl, t);
      incl = t;
    }
  }
}

// excl: for REV = false the composition of the elements of all earlier
// threads of the block, for REV = true that of all later threads.  total:
// the composition over the whole block.  smem holds THREADS / 32 + 1
// elements.  Every thread of the block must call it.
template <class Op, int THREADS, bool REV>
MF_DEV void block_scan(const typename Op::Elem& x, typename Op::Elem& excl,
                       typename Op::Elem& total, typename Op::Elem* smem) {
  using E = typename Op::Elem;
  constexpr int NW = THREADS / 32;
  static_assert(THREADS % 32 == 0 && NW <= 32, "1 to 32 full warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  E incl = x, wex;
  warp_inclusive<Op, REV>(incl);
  shfl(incl, wex, 1, REV);
  if (lane == (REV ? 31 : 0)) Op::identity(wex);
  if (lane == (REV ? 0 : 31)) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    E w, wx;
    if (lane < NW) w = smem[lane];
    else Op::identity(w);  // lanes past the last warp: harmless identities
    warp_inclusive<Op, REV>(w);
    shfl(w, wx, 1, REV);
    if (lane == (REV ? 31 : 0)) Op::identity(wx);
    if (lane < NW) smem[lane] = wx;
    if (lane == (REV ? 0 : NW - 1)) smem[NW] = w;
  }
  __syncthreads();
  if (REV) Op::combine(wex, smem[warp], excl);
  else Op::combine(smem[warp], wex, excl);
  total = smem[NW];
  __syncthreads();
}

// Pass 2: exclusive scan of the block totals of each batch row, in place.
// One block per row; each thread composes a contiguous run of totals.
template <class Op, int THREADS, bool REV>
__global__ void __launch_bounds__(THREADS)
scan_totals(typename Op::Elem* totals, int64_t nblk) {
  using E = typename Op::Elem;
  __shared__ E smem[THREADS / 32 + 1];
  E* row = totals + int64_t(blockIdx.x) * nblk;
  const int64_t per = (nblk + THREADS - 1) / THREADS;
  const int64_t i0 = imin(int64_t(threadIdx.x) * per, nblk);
  const int64_t i1 = imin(i0 + per, nblk);
  E acc, t, excl, total;
  Op::identity(acc);
  if (REV) {
    for (int64_t i = i1 - 1; i >= i0; --i) { Op::combine(row[i], acc, t); acc = t; }
  } else {
    for (int64_t i = i0; i < i1; ++i) { Op::combine(acc, row[i], t); acc = t; }
  }
  block_scan<Op, THREADS, REV>(acc, excl, total, smem);
  E run = excl;
  if (REV) {
    for (int64_t i = i1 - 1; i >= i0; --i) {
      const E x = row[i];
      row[i] = run;
      Op::combine(x, run, t);
      run = t;
    }
  } else {
    for (int64_t i = i0; i < i1; ++i) {
      const E x = row[i];
      row[i] = run;
      Op::combine(run, x, t);
      run = t;
    }
  }
}

// The exclusive prefix (or suffix) of every thread within its block, kept
// by pass 1 for pass 3 so that pass 3 need not rebuild it: value v of the
// element of thread t (of nthreads = nblk * THREADS a batch row) of batch row
// b at pre[(b * SIZE + v) * nthreads + t], so that the lanes of a warp touch
// neighbouring addresses.
template <class E, typename T>
MF_DEV void store_thread_elem(T* pre, const E& x, int64_t b, int64_t t, int64_t nthreads) {
#pragma unroll
  for (int v = 0; v < E::SIZE; ++v) pre[(b * E::SIZE + v) * nthreads + t] = x.v[v];
}

template <class E, typename T>
MF_DEV void load_thread_elem(const T* pre, E& x, int64_t b, int64_t t, int64_t nthreads) {
#pragma unroll
  for (int v = 0; v < E::SIZE; ++v) x.v[v] = pre[(b * E::SIZE + v) * nthreads + t];
}

// ---------------------------------------------------------------------------
// Fixed-order sums.
// ---------------------------------------------------------------------------

// The block's sum of NV values held by every thread, in a fixed order
// (warp shuffles, then the warp sums in warp order); valid in thread 0.
// smem holds NV * THREADS / 32 values.  Every thread of the block must call
// it.
template <typename T, int THREADS, int NV>
MF_DEV void block_sum(T (&v)[NV], T* smem) {
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    T x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) smem[i * NW + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      T s = smem[i * NW];
#pragma unroll
      for (int w = 1; w < NW; ++w) s += smem[i * NW + w];
      v[i] = s;
    }
  }
  __syncthreads();
}

// Pass 4: out[b, v] = scale[b] * sum over blocks of partials[b, blk, v],
// in a fixed order.  One block per (value v, batch row b); scale may be
// null (a scale of 1).
template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
sum_partials(const T* partials, int64_t nblk, int64_t nv, const T* scale, T* out) {
  __shared__ T red[THREADS];
  const int64_t v = blockIdx.x, b = blockIdx.y;
  const T* row = partials + b * nblk * nv + v;
  T s = T(0);
  for (int64_t i = threadIdx.x; i < nblk; i += THREADS) s += row[i * nv];
  red[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[b * nv + v] = scale == nullptr ? red[0] : scale[b] * red[0];
}

// ---------------------------------------------------------------------------
// Filter passes, for any Row that fills a FilterStep.
// ---------------------------------------------------------------------------

template <typename T>
struct FilterArgs {
  // sites: nu [B, o, 1, N], lam [B, o, o, N], mask [B, 1, 1, N] (may be
  // null: every step kept), any strides (0 reads an expanded tensor)
  const T *nu, *lam, *mask;
  int64_t nu_sb, nu_si, nu_st;
  int64_t lam_sb, lam_si, lam_sj, lam_st;
  int64_t mask_sb, mask_st;
  // outputs, contiguous: m_f [B, d, 1, N], P_f [B, d, d, N], loglik [B]
  T *m_f, *p_f, *loglik;
  // scratch: block totals [B, nblk] elements, then partial sums [B, nblk];
  // the general filter's d <= 6 passes also keep each thread's in-block
  // prefix (store_thread_elem)
  T *totals, *partials, *prefix;
  int64_t n, nblk;
};

// The site strides as the C entry points take them: nu (batch, row, step),
// lam (batch, row, column, step), mask (batch, step).
template <class A>
inline void set_site_strides(A& a, const int64_t* s) {
  a.nu_sb = s[0]; a.nu_si = s[1]; a.nu_st = s[2];
  a.lam_sb = s[3]; a.lam_si = s[4]; a.lam_sj = s[5]; a.lam_st = s[6];
  a.mask_sb = s[7]; a.mask_st = s[8];
}

// The inputs of one global step k: prior step (F, c, Q), with the prior
// (0, mu0, P0) at k = 0, the emission H and the sites.
template <typename T, int D, int O>
struct FilterStep {
  T f[D * D], c[D], q[D * D], h[O * D], nu[O], lam[O * O];
  bool keep;

  template <typename A>
  MF_DEV void load_sites(const A& a, int64_t b, int64_t k) {
#pragma unroll
    for (int i = 0; i < O; ++i) nu[i] = a.nu[b * a.nu_sb + i * a.nu_si + k * a.nu_st];
#pragma unroll
    for (int i = 0; i < O; ++i) {
#pragma unroll
      for (int j = 0; j < O; ++j)
        lam[i * O + j] = a.lam[b * a.lam_sb + i * a.lam_si + j * a.lam_sj + k * a.lam_st];
    }
    keep = a.mask == nullptr || a.mask[b * a.mask_sb + k * a.mask_st] > T(0.5);
  }
};

// Filter element of one step (make_filter_elements_tl / _make_elem_slice).
template <typename T, int D, int O>
MF_DEV void make_filter_elem(const FilterStep<T, D, O>& s, FElem<T, D>& out) {
  using E = FElem<T, D>;
  const T* h = s.h;
  T qht[D * O], hqht[O * O], t[O * O], z[O * O], lz[O * O], gain[D * O];
  mm_nt<T, D, D, O>(s.q, h, qht);  // Q H^T
  mm<T, O, D, O>(h, qht, hqht);
  mm<T, O, O, O>(hqht, s.lam, t);
  add_eye<T, O>(t);
  inv<T, O>(t, z);
  mm<T, O, O, O>(s.lam, z, lz);  // S^-1
  sym<T, O>(lz);
  mm<T, D, O, O>(qht, lz, gain);
  T igh[D * D];
  mm<T, D, O, D>(gain, h, igh);
#pragma unroll
  for (int i = 0; i < D * D; ++i) igh[i] = -igh[i];
  add_eye<T, D>(igh);  // I - K H
  mm<T, D, D, D>(igh, s.f, out.v + E::OA);
  // b = (I - K H) c + Q H^T z^T nu
  T ztnu[O], v[D];
  mm_tn<T, O, O, 1>(z, s.nu, ztnu);
  mm<T, D, D, 1>(igh, s.c, out.v + E::OB);
  mm<T, D, O, 1>(qht, ztnu, v);
  add_to<T, D>(out.v + E::OB, v);
  // C = sym((I - K H) Q)
  mm<T, D, D, D>(igh, s.q, out.v + E::OC);
  sym<T, D>(out.v + E::OC);
  // eta = F^T H^T (z^T nu - S^-1 H c)
  T hc[O], r[O], htr[D];
  mm<T, O, D, 1>(h, s.c, hc);
  mm<T, O, O, 1>(lz, hc, r);
#pragma unroll
  for (int i = 0; i < O; ++i) r[i] = ztnu[i] - r[i];
  mm_tn<T, D, O, 1>(h, r, htr);
  mm_tn<T, D, D, 1>(s.f, htr, out.v + E::OE);
  // J = sym((H F)^T S^-1 (H F))
  T hf[O * D], lhf[O * D];
  mm<T, O, D, D>(h, s.f, hf);
  mm<T, O, O, D>(lz, hf, lhf);
  mm_tn<T, D, O, D>(hf, lhf, out.v + E::OJ);
  sym<T, D>(out.v + E::OJ);
}

// Site log-likelihood of one step given the previous filtered moments
// (pm, pp), in lam form (filter_pipeline_tl / _ll_slice).  Masked steps
// give 0 and use the identity in place of lam.
template <typename T, int D, int O>
MF_DEV T step_loglik(const FilterStep<T, D, O>& s, const T* pm, const T* pp) {
  const T* h = s.h;
  T mp[D], t[D * D], ppred[D * D];
  mm<T, D, D, 1>(s.f, pm, mp);
  add_to<T, D>(mp, s.c);
  mm_nt<T, D, D, D>(pp, s.f, t);
  mm<T, D, D, D>(s.f, t, ppred);
  add_to<T, D * D>(ppred, s.q);
  sym<T, D>(ppred);
  T hm[O], ph[D * O], hpht[O * O], w[O];
  mm<T, O, D, 1>(h, mp, hm);
  mm_nt<T, D, D, O>(ppred, h, ph);
  mm<T, O, D, O>(h, ph, hpht);
  mm<T, O, O, 1>(s.lam, hm, w);
#pragma unroll
  for (int i = 0; i < O; ++i) w[i] = s.nu[i] - w[i];
  T lsafe[O * O], mmat[O * O], hl[O * O];
  if (s.keep) {
#pragma unroll
    for (int i = 0; i < O * O; ++i) lsafe[i] = s.lam[i];
    mm<T, O, O, O>(hpht, s.lam, hl);
    mm<T, O, O, O>(s.lam, hl, mmat);
    add_to<T, O * O>(mmat, s.lam);
  } else {
    set_eye<T, O>(lsafe);
    set_eye<T, O>(mmat);
  }
  T mi[O * O], sol[O];
  inv<T, O>(mmat, mi);
  mm<T, O, O, 1>(mi, w, sol);
  T quad = T(0);
#pragma unroll
  for (int i = 0; i < O; ++i) quad += w[i] * sol[i];
  mm<T, O, O, O>(hpht, lsafe, hl);
  add_eye<T, O>(hl);
  const T log_det_s = log(fabs(det<T, O>(hl))) - log(fabs(det<T, O>(lsafe)));
  const T log_2pi = T(1.8378770664093453);
  const T ll = T(-0.5) * (quad + log_det_s + T(O) * log_2pi);
  return s.keep ? ll : T(0);
}

// Pass 1 and the first half of pass 3: the composition of this thread's run
// of R steps, and its exclusive prefix within the block.
template <class Row>
MF_DEV void filter_thread_prefix(const FilterArgs<typename Row::T>& a,
                                 const typename Row::Prior& p, const Row& row,
                                 int64_t b, int64_t first_step,
                                 FElem<typename Row::T, Row::D>& excl,
                                 FElem<typename Row::T, Row::D>& total,
                                 FElem<typename Row::T, Row::D>* smem) {
  using T = typename Row::T;
  constexpr int D = Row::D, O = Row::O;
  using Op = FilterOp<T, D>;
  using E = FElem<T, D>;
  E run, e, t;
  Op::identity(run);
  FilterStep<T, D, O> s;
  for (int r = 0; r < Tiling<D>::R; ++r) {
    const int64_t k = first_step + r;
    if (k >= a.n) break;
    if constexpr (Row::PREBUILT) {
      row.elem(p, b, k, a.n, e);
    } else {
      row.step(p, b, k, s);
      s.load_sites(a, b, k);
      make_filter_elem<T, D, O>(s, e);
    }
    Op::combine(run, e, t);
    run = t;
  }
  block_scan<Op, Tiling<D>::THREADS, false>(run, excl, total, smem);
}

template <class Row>
__global__ void __launch_bounds__(Tiling<Row::D>::THREADS)
filter_totals(FilterArgs<typename Row::T> a, typename Row::Prior p) {
  using E = FElem<typename Row::T, Row::D>;
  constexpr int THREADS = Tiling<Row::D>::THREADS;
  __shared__ E smem[THREADS / 32 + 1];
  const int64_t b = blockIdx.y, blk = blockIdx.x;
  Row row;
  row.load(p, b);
  E excl, total;
  filter_thread_prefix<Row>(a, p, row, b,
                            (blk * THREADS + threadIdx.x) * Tiling<Row::D>::R,
                            excl, total, smem);
  if (threadIdx.x == 0) reinterpret_cast<E*>(a.totals)[b * a.nblk + blk] = total;
}

template <class Row>
__global__ void __launch_bounds__(Tiling<Row::D>::THREADS)
filter_outputs(FilterArgs<typename Row::T> a, typename Row::Prior p) {
  using T = typename Row::T;
  constexpr int D = Row::D, O = Row::O;
  using Op = FilterOp<T, D>;
  using E = FElem<T, D>;
  constexpr int THREADS = Tiling<D>::THREADS, R = Tiling<D>::R;
  __shared__ E smem[THREADS / 32 + 1];
  __shared__ T red[THREADS / 32];
  const int64_t b = blockIdx.y, blk = blockIdx.x, n = a.n;
  const int64_t first_step = (blk * THREADS + threadIdx.x) * R;
  Row row;
  row.load(p, b);
  E excl, total, run, e, t;
  filter_thread_prefix<Row>(a, p, row, b, first_step, excl, total, smem);
  // carry of all earlier blocks, then of the earlier threads of this block
  Op::combine(reinterpret_cast<const E*>(a.totals)[b * a.nblk + blk], excl, run);
  T ll[1] = {T(0)};
  FilterStep<T, D, O> s;
  for (int r = 0; r < R; ++r) {
    const int64_t k = first_step + r;
    if (k >= n) break;
    if constexpr (Row::PREBUILT) {
      row.elem(p, b, k, n, e);
    } else {
      row.step(p, b, k, s);
      s.load_sites(a, b, k);
      // run holds the filtered moments of step k - 1 (b = 0, C = 0 before
      // step 0, where F = 0 makes them irrelevant)
      ll[0] += step_loglik<T, D, O>(s, run.v + E::OB, run.v + E::OC);
      make_filter_elem<T, D, O>(s, e);
    }
    Op::combine(run, e, t);
    run = t;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      a.m_f[(b * D + i) * n + k] = run.v[E::OB + i];
#pragma unroll
      for (int j = 0; j < D; ++j) a.p_f[((b * D + i) * D + j) * n + k] = run.v[E::OC + i * D + j];
    }
  }
  if constexpr (!Row::PREBUILT) {
    block_sum<T, THREADS, 1>(ll, red);
    if (threadIdx.x == 0) a.partials[b * a.nblk + blk] = ll[0];
  }
}

// What the runtime reports of a pass launched with `threads` a block and
// `bytes` of dynamic shared memory: registers a thread, local memory a
// thread, and shared memory a block (static and dynamic, bytes), and the
// warps an SM keeps resident by the occupancy calculator (out[0..3]).
template <class K>
int pass_occupancy(K kernel, int threads, size_t bytes, int64_t* out) {
  cudaFuncAttributes attr{};
  int blocks = 0;
  int err = int(cudaFuncGetAttributes(&attr, kernel));
  if (err == 0)
    err = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes));
  out[0] = attr.numRegs;
  out[1] = int64_t(attr.localSizeBytes);
  out[2] = int64_t(attr.sharedSizeBytes + bytes);
  out[3] = int64_t(blocks) * threads / 32;
  return err;
}

#define MF_CHECK_LAUNCH()                      \
  do {                                         \
    const cudaError_t err = cudaGetLastError(); \
    if (err != cudaSuccess) return int(err);   \
  } while (0)

template <typename T, int D>
int64_t filter_scratch(int64_t batch, int64_t n) {
  const int64_t nblk = num_blocks(n, Tiling<D>::TILE);
  return batch * nblk * (FElem<T, D>::SIZE + 1);
}

template <class Row>
int launch_filter(FilterArgs<typename Row::T> a, typename Row::Prior p,
                  typename Row::T* scratch, int64_t batch, cudaStream_t stream) {
  using T = typename Row::T;
  constexpr int D = Row::D, THREADS = Tiling<D>::THREADS;
  a.nblk = num_blocks(a.n, Tiling<D>::TILE);
  a.totals = scratch;
  a.partials = scratch + batch * a.nblk * FElem<T, D>::SIZE;
  const dim3 grid(unsigned(a.nblk), unsigned(batch));
  filter_totals<Row><<<grid, THREADS, 0, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  scan_totals<FilterOp<T, D>, THREADS, false><<<unsigned(batch), THREADS, 0, stream>>>(
      reinterpret_cast<FElem<T, D>*>(a.totals), a.nblk);
  MF_CHECK_LAUNCH();
  filter_outputs<Row><<<grid, THREADS, 0, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  if constexpr (!Row::PREBUILT) {
    sum_partials<T, THREADS><<<dim3(1u, unsigned(batch)), THREADS, 0, stream>>>(
        a.partials, a.nblk, 1, nullptr, a.loglik);
    MF_CHECK_LAUNCH();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Smoother passes, for any Row that builds one smoothing element per step.
// ---------------------------------------------------------------------------

template <typename T>
struct SmootherArgs {
  // outputs, contiguous: m_s [B, d, 1, N], P_s [B, d, d, N]
  T *m_s, *p_s;
  T* totals;  // scratch: block totals [B, nblk] elements
  int64_t n, nblk;
  T* prefix;  // the general Koopman backward's d <= 6 in-block suffixes
};

// The composition of this thread's run of R steps, and the exclusive
// suffix within the block (all later threads).
template <class Row>
MF_DEV void smoother_thread_suffix(const typename Row::Prior& p, const Row& row,
                                   int64_t b, int64_t first_step, int64_t n,
                                   SElem<typename Row::T, Row::D>& excl,
                                   SElem<typename Row::T, Row::D>& total,
                                   SElem<typename Row::T, Row::D>* smem) {
  using T = typename Row::T;
  constexpr int D = Row::D;
  using Op = SmootherOp<T, D>;
  using E = SElem<T, D>;
  E run, e, t;
  Op::identity(run);
  for (int r = Tiling<D>::R - 1; r >= 0; --r) {
    const int64_t k = first_step + r;
    if (k >= n) continue;
    row.elem(p, b, k, n, e);
    Op::combine(e, run, t);
    run = t;
  }
  block_scan<Op, Tiling<D>::THREADS, true>(run, excl, total, smem);
}

template <class Row>
__global__ void __launch_bounds__(Tiling<Row::D>::THREADS)
smoother_totals(SmootherArgs<typename Row::T> a, typename Row::Prior p) {
  using E = SElem<typename Row::T, Row::D>;
  constexpr int THREADS = Tiling<Row::D>::THREADS;
  __shared__ E smem[THREADS / 32 + 1];
  const int64_t b = blockIdx.y, blk = blockIdx.x;
  Row row;
  row.load(p, b);
  E excl, total;
  smoother_thread_suffix<Row>(p, row, b, (blk * THREADS + threadIdx.x) * Tiling<Row::D>::R,
                              a.n, excl, total, smem);
  if (threadIdx.x == 0) reinterpret_cast<E*>(a.totals)[b * a.nblk + blk] = total;
}

template <class Row>
__global__ void __launch_bounds__(Tiling<Row::D>::THREADS)
smoother_outputs(SmootherArgs<typename Row::T> a, typename Row::Prior p) {
  using T = typename Row::T;
  constexpr int D = Row::D;
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
  for (int r = R - 1; r >= 0; --r) {
    const int64_t k = first_step + r;
    if (k >= n) continue;
    row.elem(p, b, k, n, e);
    Op::combine(e, run, t);
    run = t;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      a.m_s[(b * D + i) * n + k] = run.v[E::OG + i];
#pragma unroll
      for (int j = 0; j < D; ++j) a.p_s[((b * D + i) * D + j) * n + k] = run.v[E::OL + i * D + j];
    }
  }
}

template <typename T, int D>
int64_t smoother_scratch(int64_t batch, int64_t n) {
  return batch * num_blocks(n, Tiling<D>::TILE) * SElem<T, D>::SIZE;
}

template <class Row>
int launch_smoother(SmootherArgs<typename Row::T> a, typename Row::Prior p,
                    typename Row::T* scratch, int64_t batch, cudaStream_t stream) {
  using T = typename Row::T;
  constexpr int D = Row::D, THREADS = Tiling<D>::THREADS;
  a.nblk = num_blocks(a.n, Tiling<D>::TILE);
  a.totals = scratch;
  const dim3 grid(unsigned(a.nblk), unsigned(batch));
  smoother_totals<Row><<<grid, THREADS, 0, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  scan_totals<SmootherOp<T, D>, THREADS, true><<<unsigned(batch), THREADS, 0, stream>>>(
      reinterpret_cast<SElem<T, D>*>(a.totals), a.nblk);
  MF_CHECK_LAUNCH();
  smoother_outputs<Row><<<grid, THREADS, 0, stream>>>(a, p);
  MF_CHECK_LAUNCH();
  return 0;
}

}  // namespace mf

// Dispatch of a runtime state dimension to the compile-time instantiations
// d = 1..6.
#define MF_SWITCH_D(d, EXPR_OF_D, BAD) \
  switch (d) {                         \
    case 1: { constexpr int D_ = 1; return EXPR_OF_D; } \
    case 2: { constexpr int D_ = 2; return EXPR_OF_D; } \
    case 3: { constexpr int D_ = 3; return EXPR_OF_D; } \
    case 4: { constexpr int D_ = 4; return EXPR_OF_D; } \
    case 5: { constexpr int D_ = 5; return EXPR_OF_D; } \
    case 6: { constexpr int D_ = 6; return EXPR_OF_D; } \
    default: return BAD;               \
  }
