// Shared core of the Kalman scan kernels for Hopper (sm_90a): associative
// elements and their compositions, the block-wide scan, the scan of the
// block totals, each thread's stored in-block prefix, fixed-order sums, and
// the tiling of the d <= 6 passes.
//
// Design: reduce, then scan, then fix up.  The TPU kernels thread one carry
// through a sequential grid; here blocks run in no order, so
//   1. each thread owns R consecutive steps, builds their associative
//      elements in registers and composes them in order; a warp-shuffle
//      scan plus a scan of the warp totals gives the block total, which is
//      written out (one element per block), and each thread's exclusive
//      in-block prefix (suffix), which is kept for pass 3
//      (store_thread_elem);
//   2. one block per batch row scans the block totals into exclusive
//      carries, in place (scan_totals);
//   3. each thread composes its block's carry with its stored prefix and
//      carries only the moments (the backwards: the g and L legs) through
//      its steps, writing the outputs.  A reduction over steps (the
//      filter's log-likelihood, the adjoint's gradient sums) goes out as
//      one partial per block;
//   4. one block per (value, batch row) sums the partials in a fixed order.
// No float atomics: a run repeats bit for bit.  The d <= 6 passes are
// templates over a step source: the filters and the RTS smoothers
// (kernels 1, 4, 6; 2, 5) in general_scan.cuh, the Koopman backwards
// (kernels 3, 7) in general_adjoint.cuh; the d = 7..12 passes are in
// wide_scan.cuh.
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

// CALL: the composition is a call (combine_call), not inlined; the default
// at d >= 4, as FilterOp's.  The Koopman backwards at o x o sites inline it
// in float32 (general_adjoint.cuh, Pass1Of): there the call's arguments,
// two elements through local memory, took half of each composition's time.
template <typename T, int D, bool CALL = (D >= 4)>
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
    if constexpr (CALL) combine_call(e, l, out);
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

// The g and L legs of x (earlier) composed with y (later): g = xE yg + xg,
// L = sym(xE yL xE^T + xL), which read nothing of y but its g and L.  With
// y the suffix from step k + 1 on, they carry the smoothed moments (or the
// Koopman backward's r and NDK) through x.  g and l may not alias an input.
template <typename T, int D>
MF_DEV void smoother_gl(const T* xe, const T* xg, const T* xl, const T* yg, const T* yl, T* g,
                        T* l) {
  T u[D * D];
  mm<T, D, D, 1>(xe, yg, g);
  add_to<T, D>(g, xg);
  mm_nt<T, D, D, D>(yl, xe, u);
  mm<T, D, D, D>(xe, u, l);
  add_to<T, D * D>(l, xl);
  sym<T, D>(l);
}

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
// The filters' arguments.
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
  // the d <= 6 passes also keep each thread's in-block prefix
  // (store_thread_elem), and kernel 1's rank-o route its table of the
  // steps' constant terms (UniformStepsRankO)
  T *totals, *partials, *prefix, *table;
  int64_t n, nblk;
  int64_t o;  // the output dim, for the sources that take it at run time (o > d)
};

// The site strides as the C entry points take them: nu (batch, row, step),
// lam (batch, row, column, step), mask (batch, step).
template <class A>
inline void set_site_strides(A& a, const int64_t* s) {
  a.nu_sb = s[0]; a.nu_si = s[1]; a.nu_st = s[2];
  a.lam_sb = s[3]; a.lam_si = s[4]; a.lam_sj = s[5]; a.lam_st = s[6];
  a.mask_sb = s[7]; a.mask_st = s[8];
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

// ---------------------------------------------------------------------------
// The smoothers' arguments.
// ---------------------------------------------------------------------------

template <typename T>
struct SmootherArgs {
  // outputs, contiguous: m_s [B, d, 1, N], P_s [B, d, d, N]
  T *m_s, *p_s;
  T* totals;  // scratch: block totals [B, nblk] elements
  int64_t n, nblk;
  T* prefix;  // the d <= 6 in-block suffixes of kernels 2, 3, 5 and 7
};

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
