// The Kalman scan kernels for state dims 7..12 on Hopper (sm_90a): a warp
// composes each associative element, which lives in shared memory.
//
// Replace the d = 7..12 range of the TPU kernels of
// markovflow_tpu/ops/pallas_scan.py that the d9 path runs:
// pallas_filter_pipeline_uniform, pallas_smoother_pipeline_uniform,
// pallas_filter_pipeline and pallas_smoother_scan (the element sources are
// the Wide*Row types of uniform_scan.cuh and general_scan.cuh).  The plain
// PyTorch versions are the *_plain functions of
// markovflow_tpu_torch/ops/cuda_scan.py.
//
// Why another layout: at d = 12 a filtering element holds 456 values and a
// composition keeps three d x d temporaries besides its operands and result,
// ~2,000 values in all.  One thread per run of steps with its elements in
// registers (scan_core.cuh, d <= 6) would keep them in local memory, and a
// warp-shuffle scan would move 456 values a level.  Here the 32 lanes of a
// warp share every product (a lane per output entry, up to 5 entries at
// d = 12), the pivoted Gauss-Jordan inverse (a lane per column) and the
// element builds, and each warp keeps its elements and temporaries in its
// own slice of dynamic shared memory (17 d^2 + 15 d values: 21 KB at d = 12
// in float64).  Nothing is held per lane beyond a few scalars, so no
// register spills; the products are bound by shared-memory bandwidth.
//
// Passes, as in scan_core.cuh with a warp in place of a thread:
//   1. each warp owns R consecutive steps (R grows with N: wide_steps) and
//      composes their elements in order; its total goes out;
//   2. one block per batch row scans the totals into exclusive carries, in
//      place: each of its P warps composes a contiguous run of totals, warp
//      0 scans the P run totals, and each warp rewrites its run;
//   3. each warp rebuilds its elements from its carry and writes the
//      outputs; the filter's log-likelihood goes out as one partial per warp
//      and sum_partials adds them in a fixed order.
// The warps of passes 1 and 3 never wait on each other, so a block holds
// several only to fill the SM.  The state dimension is a runtime argument
// and the loops are not unrolled: one instantiation per (element source,
// dtype) serves d = 7..12.  Output dimension 1.  No float atomics.
#pragma once

#include "scan_core.cuh"

namespace mf {

constexpr int WIDE_MIN_D = 7, WIDE_MAX_D = 12;
constexpr int WIDE_WARPS = 4;        // warps per block in passes 1 and 3
constexpr int WIDE_SCAN_WARPS = 32;  // at most, in pass 2

// Steps per warp: enough warps to fill the card at N = 1e5 (~2,000), few
// enough totals for pass 2.
inline int64_t wide_steps(int64_t n) {
  const int64_t r = (n + 2047) / 2048;
  return r < 8 ? 8 : (r > 256 ? 256 : r);
}

__host__ __device__ inline int wide_filter_size(int d) { return 3 * d * d + 2 * d; }
__host__ __device__ inline int wide_smoother_size(int d) { return 2 * d * d + d; }

// Values of T in one warp's workspace: three element slots, the step's
// F, Q, c, h, four d x d temporaries, the d x 2d Gauss-Jordan matrix and
// seven vectors.
__host__ __device__ inline int wide_floats(int d) {
  return 3 * wide_filter_size(d) + 2 * d * d + 2 * d + 4 * d * d + 2 * d * d + 7 * d;
}

template <typename T>
struct WideWork {
  T* slot[3];
  T *f, *q, *c, *h;  // the step: F [d, d], Q [d, d], c [d], H [1, d]
  T* m[4];           // d x d temporaries
  T* aug;            // d x 2d
  T* v[7];           // d vectors; v[6] belongs to winv
  T nu, lam;         // the step's sites (o = 1), the same in every lane
  bool keep;
};

template <typename T>
MF_DEV WideWork<T> wide_work(T* base, int d) {
  WideWork<T> w;
  const int dd = d * d;
  for (int i = 0; i < 3; ++i) { w.slot[i] = base; base += wide_filter_size(d); }
  w.f = base; base += dd;
  w.q = base; base += dd;
  w.c = base; base += d;
  w.h = base; base += d;
  for (int i = 0; i < 4; ++i) { w.m[i] = base; base += dd; }
  w.aug = base; base += 2 * dd;
  for (int i = 0; i < 7; ++i) { w.v[i] = base; base += d; }
  return w;
}

MF_DEV int lane_id() { return threadIdx.x & 31; }

// ---------------------------------------------------------------------------
// Warp-cooperative small linear algebra on row-major matrices.  Every
// function is called by all 32 lanes and ends with __syncwarp(), so the next
// one sees its writes.  No output may alias an input.
// ---------------------------------------------------------------------------

// out [r x c] = op(a) op(b) with op(a) [r x k], op(b) [k x c]; TA: a is
// stored [k x r] (a^T), TB: b is stored [c x k] (b^T).
template <typename T, bool TA = false, bool TB = false>
MF_DEV void wmm(const T* a, const T* b, T* out, int r, int k, int c) {
  for (int e = lane_id(); e < r * c; e += 32) {
    const int i = e / c, j = e - i * c;
    T acc = T(0);
    for (int l = 0; l < k; ++l)
      acc += (TA ? a[l * r + i] : a[i * k + l]) * (TB ? b[j * k + l] : b[l * c + j]);
    out[e] = acc;
  }
  __syncwarp();
}

template <typename T>
MF_DEV void wcopy(T* dst, const T* src, int n) {
  for (int e = lane_id(); e < n; e += 32) dst[e] = src[e];
  __syncwarp();
}

template <typename T>
MF_DEV void wadd(T* a, const T* b, int n) {
  for (int e = lane_id(); e < n; e += 32) a[e] += b[e];
  __syncwarp();
}

// a = (a + a^T) / 2 in place, a [d x d]
template <typename T>
MF_DEV void wsym(T* a, int d) {
  for (int e = lane_id(); e < d * d; e += 32) {
    const int i = e / d, j = e - i * d;
    if (j > i) {
      const T s = T(0.5) * (a[i * d + j] + a[j * d + i]);
      a[i * d + j] = s;
      a[j * d + i] = s;
    }
  }
  __syncwarp();
}

template <typename T>
MF_DEV void wadd_eye(T* a, int d) {
  if (lane_id() < d) a[lane_id() * (d + 1)] += T(1);
  __syncwarp();
}

// The same value in every lane.
template <typename T>
MF_DEV T wdot(const T* a, const T* b, int n) {
  T acc = T(0);
  for (int l = 0; l < n; ++l) acc += a[l] * b[l];
  return acc;
}

// Inverse of m [d x d] into out by Gauss-Jordan elimination on [m | I] with
// partial pivoting (aug: d x 2d, fac: d of scratch): at column j the pivot
// is the first of rows j.. with the largest magnitude, swapped into row j.
// The plain _gauss_jordan_tl (ops/kalman.py) reaches the same pivot row by a
// chain of swaps: the other rows end in another order, which changes no
// value.  Every lane searches for the pivot between two __syncwarp()s (the
// lanes of a warp need not run in step), so all see the same column and
// take the same branch.
template <typename T>
MF_DEV void winv(const T* m, T* out, T* aug, T* fac, int d) {
  const int lane = lane_id(), w = 2 * d;
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d, j = e - i * d;
    aug[i * w + j] = m[e];
    aug[i * w + d + j] = i == j ? T(1) : T(0);
  }
  __syncwarp();
  for (int j = 0; j < d; ++j) {
    int p = j;
    T best = fabs(aug[j * w + j]);
    for (int i = j + 1; i < d; ++i) {
      const T v = fabs(aug[i * w + j]);
      if (v > best) { best = v; p = i; }
    }
    __syncwarp();  // no lane swaps rows while another still searches
    if (p != j) {
      for (int c = j + lane; c < w; c += 32) {
        const T x = aug[j * w + c];
        aug[j * w + c] = aug[p * w + c];
        aug[p * w + c] = x;
      }
      __syncwarp();
    }
    const T r = T(1) / aug[j * w + j];
    if (lane < d) fac[lane] = aug[lane * w + j];
    __syncwarp();
    for (int c = j + lane; c < w; c += 32) aug[j * w + c] *= r;
    __syncwarp();
    const int cols = w - j;
    for (int e = lane; e < d * cols; e += 32) {
      const int i = e / cols, c = j + e - i * cols;
      if (i != j) aug[i * w + c] -= fac[i] * aug[j * w + c];
    }
    __syncwarp();
  }
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d, j = e - i * d;
    out[e] = aug[i * w + d + j];
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Elements and compositions (the formulas of scan_core.cuh, o = 1).
// ---------------------------------------------------------------------------

// The identity: every value 0 but the leading d x d block's diagonal (A of
// a filtering element, E of a smoothing element).
template <typename T>
MF_DEV void wide_identity(T* x, int size, int d) {
  for (int e = lane_id(); e < size; e += 32)
    x[e] = e < d * d && e % (d + 1) == 0 ? T(1) : T(0);
  __syncwarp();
}

template <typename T>
struct WideFilterOp {
  static __host__ __device__ int size(int d) { return wide_filter_size(d); }

  // out = x (earlier) composed with y (later); FilterOp::combine_body
  static MF_DEV void combine(const T* x, const T* y, T* out, WideWork<T>& w, int d) {
    const int dd = d * d, OA = 0, OB = dd, OC = dd + d, OJ = 2 * dd + d, OE = 3 * dd + d;
    T *t1 = w.m[0], *t2 = w.m[1], *minv = w.m[2], *v1 = w.v[0], *v2 = w.v[1];
    wmm(x + OC, y + OJ, t1, d, d, d);
    wadd_eye(t1, d);
    winv(t1, minv, w.aug, w.v[6], d);
    // A = ya minv xa
    wmm(minv, x + OA, t1, d, d, d);
    wmm(y + OA, t1, out + OA, d, d, d);
    // b = ya minv (xb + xc ye) + yb
    wmm(x + OC, y + OE, v1, d, d, 1);
    wadd(v1, x + OB, d);
    wmm(minv, v1, v2, d, d, 1);
    wmm(y + OA, v2, out + OB, d, d, 1);
    wadd(out + OB, y + OB, d);
    // C = sym(ya (minv xc) ya^T + yc)
    wmm(minv, x + OC, t1, d, d, d);
    wmm<T, false, true>(t1, y + OA, t2, d, d, d);
    wmm(y + OA, t2, out + OC, d, d, d);
    wadd(out + OC, y + OC, dd);
    wsym(out + OC, d);
    // eta = xa^T minv^T (ye - yj xb) + xe
    wmm(y + OJ, x + OB, v1, d, d, 1);
    for (int e = lane_id(); e < d; e += 32) v1[e] = y[OE + e] - v1[e];
    __syncwarp();
    wmm<T, true, false>(minv, v1, v2, d, d, 1);
    wmm<T, true, false>(x + OA, v2, out + OE, d, d, 1);
    wadd(out + OE, x + OE, d);
    // J = sym(xa^T minv^T yj xa + xj)
    wmm(y + OJ, x + OA, t1, d, d, d);
    wmm<T, true, false>(minv, t1, t2, d, d, d);
    wmm<T, true, false>(x + OA, t2, out + OJ, d, d, d);
    wadd(out + OJ, x + OJ, dd);
    wsym(out + OJ, d);
  }
};

template <typename T>
struct WideSmootherOp {
  static __host__ __device__ int size(int d) { return wide_smoother_size(d); }

  // out = e (earlier) composed with l (later, the suffix):
  // E = eE lE, g = eE lg + eg, L = sym(eE lL eE^T + eL)
  static MF_DEV void combine(const T* e, const T* l, T* out, WideWork<T>& w, int d) {
    const int dd = d * d, OE = 0, OG = dd, OL = dd + d;
    wmm(e + OE, l + OE, out + OE, d, d, d);
    wmm(e + OE, l + OG, out + OG, d, d, 1);
    wadd(out + OG, e + OG, d);
    wmm<T, false, true>(l + OL, e + OE, w.m[0], d, d, d);
    wmm(e + OE, w.m[0], out + OL, d, d, d);
    wadd(out + OL, e + OL, dd);
    wsym(out + OL, d);
  }
};

// The step's sites into w (FilterStep::load_sites, o = 1), from FilterArgs
// or any struct with the same site fields.
template <typename T, class A>
MF_DEV void wide_sites(const A& a, int64_t b, int64_t k, WideWork<T>& w) {
  w.nu = a.nu[b * a.nu_sb + k * a.nu_st];
  w.lam = a.lam[b * a.lam_sb + k * a.lam_st];
  w.keep = a.mask == nullptr || a.mask[b * a.mask_sb + k * a.mask_st] > T(0.5);
}

// Filter element of the step in w (make_filter_elem, o = 1).
template <typename T>
MF_DEV void wide_filter_elem(WideWork<T>& w, T* out, int d) {
  const int dd = d * d, OA = 0, OB = dd, OC = dd + d, OJ = 2 * dd + d, OE = 3 * dd + d;
  const int lane = lane_id();
  T *qht = w.v[0], *gain = w.v[1], *htr = w.v[2], *hf = w.v[3], *lhf = w.v[4];
  T* igh = w.m[0];
  wmm<T, false, true>(w.q, w.h, qht, d, d, 1);  // Q H^T
  const T z = T(1) / (wdot(w.h, qht, d) * w.lam + T(1));
  const T lz = w.lam * z;  // S^-1
  for (int e = lane; e < d; e += 32) gain[e] = qht[e] * lz;
  __syncwarp();
  for (int e = lane; e < dd; e += 32) {  // I - K H
    const int i = e / d, j = e - i * d;
    igh[e] = (i == j ? T(1) : T(0)) - gain[i] * w.h[j];
  }
  __syncwarp();
  wmm(igh, w.f, out + OA, d, d, d);
  // b = (I - K H) c + Q H^T z nu
  const T ztnu = z * w.nu;
  wmm(igh, w.c, out + OB, d, d, 1);
  for (int e = lane; e < d; e += 32) out[OB + e] += qht[e] * ztnu;
  __syncwarp();
  // C = sym((I - K H) Q)
  wmm(igh, w.q, out + OC, d, d, d);
  wsym(out + OC, d);
  // eta = F^T H^T (z nu - S^-1 H c)
  const T r = ztnu - lz * wdot(w.h, w.c, d);
  for (int e = lane; e < d; e += 32) htr[e] = w.h[e] * r;
  __syncwarp();
  wmm<T, true, false>(w.f, htr, out + OE, d, d, 1);
  // J = sym((H F)^T S^-1 (H F))
  wmm(w.h, w.f, hf, 1, d, d);
  for (int e = lane; e < d; e += 32) lhf[e] = lz * hf[e];
  __syncwarp();
  for (int e = lane; e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    out[OJ + e] = hf[i] * lhf[j];
  }
  __syncwarp();
  wsym(out + OJ, d);
}

// Site log-likelihood of the step in w given the previous filtered moments
// (pm, pp) (step_loglik, o = 1); the same value in every lane.
template <typename T>
MF_DEV T wide_step_loglik(WideWork<T>& w, const T* pm, const T* pp, int d) {
  const int dd = d * d;
  T *mp = w.v[0], *ph = w.v[1], *t = w.m[0], *ppred = w.m[1];
  wmm(w.f, pm, mp, d, d, 1);
  wadd(mp, w.c, d);
  wmm<T, false, true>(pp, w.f, t, d, d, d);
  wmm(w.f, t, ppred, d, d, d);
  wadd(ppred, w.q, dd);
  wsym(ppred, d);
  const T hm = wdot(w.h, mp, d);
  wmm<T, false, true>(ppred, w.h, ph, d, d, 1);
  const T hpht = wdot(w.h, ph, d);
  const T res = w.nu - w.lam * hm;
  const T lsafe = w.keep ? w.lam : T(1);
  const T mmat = w.keep ? w.lam * (hpht * w.lam) + w.lam : T(1);
  const T quad = res * ((T(1) / mmat) * res);
  const T log_det_s = log(fabs(hpht * lsafe + T(1))) - log(fabs(lsafe));
  const T ll = T(-0.5) * (quad + log_det_s + T(1.8378770664093453));
  return w.keep ? ll : T(0);
}

extern __shared__ __align__(16) unsigned char mf_wide_smem[];

// ---------------------------------------------------------------------------
// Pass 2, for either composition.
// ---------------------------------------------------------------------------

// Exclusive scan of the totals [nblk elements of Op::size(d)] of batch row
// blockIdx.x, in place; REV scans suffixes.  Dynamic shared memory: one
// workspace per warp, then one element per warp.
template <class Op, bool REV, typename T>
__global__ void __launch_bounds__(WIDE_SCAN_WARPS * 32)
wide_scan_totals(T* totals, int64_t nblk, int d) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5, size = Op::size(d);
  T* smem = reinterpret_cast<T*>(mf_wide_smem);
  WideWork<T> w = wide_work<T>(smem + warp * wide_floats(d), d);
  T* wtot = smem + nw * wide_floats(d);
  T* row = totals + int64_t(blockIdx.x) * nblk * size;
  const int64_t per = (nblk + nw - 1) / nw;
  const int64_t i0 = imin(warp * per, nblk), i1 = imin(i0 + per, nblk);
  T *acc = w.slot[0], *nxt = w.slot[1], *x = w.slot[2];
  wide_identity(acc, size, d);
  if (REV) {
    for (int64_t i = i1 - 1; i >= i0; --i) {
      Op::combine(row + i * size, acc, nxt, w, d);
      T* s = acc; acc = nxt; nxt = s;
    }
  } else {
    for (int64_t i = i0; i < i1; ++i) {
      Op::combine(acc, row + i * size, nxt, w, d);
      T* s = acc; acc = nxt; nxt = s;
    }
  }
  wcopy(wtot + warp * size, acc, size);
  __syncthreads();
  if (warp == 0) {  // the warps' runs, in place: each gets its exclusive carry
    wide_identity(acc, size, d);
    for (int s = 0; s < nw; ++s) {
      T* tv = wtot + (REV ? nw - 1 - s : s) * size;
      wcopy(x, tv, size);
      wcopy(tv, acc, size);
      if (REV) Op::combine(x, acc, nxt, w, d);
      else Op::combine(acc, x, nxt, w, d);
      T* t = acc; acc = nxt; nxt = t;
    }
  }
  __syncthreads();
  wcopy(acc, wtot + warp * size, size);
  for (int64_t s = 0; s < i1 - i0; ++s) {
    T* ti = row + (REV ? i1 - 1 - s : i0 + s) * size;
    wcopy(x, ti, size);
    wcopy(ti, acc, size);
    if (REV) Op::combine(x, acc, nxt, w, d);
    else Op::combine(acc, x, nxt, w, d);
    T* t = acc; acc = nxt; nxt = t;
  }
}

// ---------------------------------------------------------------------------
// Filter passes 1 and 3, for any Row with a static
// step(prior, b, k, WideWork&, d) that writes the step's F, Q, c and h, or,
// with Row::PREBUILT, a static elem(prior, b, k, n, out, WideWork&, d) that
// reads a prebuilt filtering element (no sites, no log-likelihood).
// ---------------------------------------------------------------------------

template <class Row>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_filter_totals(FilterArgs<typename Row::T> a, typename Row::Prior p, int d,
                   int64_t steps) {
  using T = typename Row::T;
  const int warp = threadIdx.x >> 5, size = wide_filter_size(d);
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp;
  if (u >= a.nblk) return;  // the whole warp; this kernel has no block barrier
  WideWork<T> w = wide_work<T>(reinterpret_cast<T*>(mf_wide_smem) + warp * wide_floats(d), d);
  T *run = w.slot[0], *nxt = w.slot[1], *e = w.slot[2];
  wide_identity(run, size, d);
  const int64_t k1 = imin((u + 1) * steps, a.n);
  for (int64_t k = u * steps; k < k1; ++k) {
    if constexpr (Row::PREBUILT) {
      Row::elem(p, b, k, a.n, e, w, d);
    } else {
      Row::step(p, b, k, w, d);
      wide_sites(a, b, k, w);
      wide_filter_elem(w, e, d);
    }
    WideFilterOp<T>::combine(run, e, nxt, w, d);
    T* s = run; run = nxt; nxt = s;
  }
  wcopy(a.totals + (b * a.nblk + u) * size, run, size);
}

template <class Row>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_filter_outputs(FilterArgs<typename Row::T> a, typename Row::Prior p, int d,
                    int64_t steps) {
  using T = typename Row::T;
  const int warp = threadIdx.x >> 5, lane = lane_id(), size = wide_filter_size(d);
  const int dd = d * d, OB = dd, OC = dd + d;
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp, n = a.n;
  if (u >= a.nblk) return;
  WideWork<T> w = wide_work<T>(reinterpret_cast<T*>(mf_wide_smem) + warp * wide_floats(d), d);
  T *run = w.slot[0], *nxt = w.slot[1], *e = w.slot[2];
  wcopy(run, a.totals + (b * a.nblk + u) * size, size);  // carry of all earlier warps
  T ll = T(0);
  const int64_t k1 = imin((u + 1) * steps, n);
  for (int64_t k = u * steps; k < k1; ++k) {
    if constexpr (Row::PREBUILT) {
      Row::elem(p, b, k, n, e, w, d);
    } else {
      Row::step(p, b, k, w, d);
      wide_sites(a, b, k, w);
      // run holds the filtered moments of step k - 1 (b = 0, C = 0 before
      // step 0, where F = 0 makes them irrelevant)
      ll += wide_step_loglik(w, run + OB, run + OC, d);
      wide_filter_elem(w, e, d);
    }
    WideFilterOp<T>::combine(run, e, nxt, w, d);
    T* s = run; run = nxt; nxt = s;
    for (int i = lane; i < d; i += 32) a.m_f[(b * d + i) * n + k] = run[OB + i];
    for (int i = lane; i < dd; i += 32) a.p_f[(b * dd + i) * n + k] = run[OC + i];
    __syncwarp();
  }
  if (!Row::PREBUILT && lane == 0) a.partials[b * a.nblk + u] = ll;
}

template <typename T>
int64_t wide_filter_scratch(int d, int64_t batch, int64_t n) {
  return batch * num_blocks(n, wide_steps(n)) * (wide_filter_size(d) + 1);
}

// Dynamic shared memory of a kernel, allowed above the 48 KB default.
template <typename K>
inline int wide_smem_bytes(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  return int(err);
}

// Warps of pass 2: as many as fit, up to WIDE_SCAN_WARPS.
template <typename T>
inline int wide_scan_warps(int d, int size) {
  int dev = 0, optin = 48 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int per = (wide_floats(d) + size) * int(sizeof(T));
  const int nw = optin / per;
  return nw < 1 ? 1 : (nw > WIDE_SCAN_WARPS ? WIDE_SCAN_WARPS : nw);
}

template <class Op, bool REV, typename T>
int launch_wide_scan(T* totals, int64_t nblk, int64_t batch, int d, cudaStream_t stream) {
  const int size = Op::size(d), nw = wide_scan_warps<T>(d, size);
  const size_t bytes = size_t(nw) * (wide_floats(d) + size) * sizeof(T);
  int err = wide_smem_bytes(wide_scan_totals<Op, REV, T>, bytes);
  if (err != 0) return err;
  wide_scan_totals<Op, REV, T><<<unsigned(batch), nw * 32, bytes, stream>>>(totals, nblk, d);
  MF_CHECK_LAUNCH();
  return 0;
}

template <class Row>
int launch_wide_filter(FilterArgs<typename Row::T> a, typename Row::Prior p,
                       typename Row::T* scratch, int64_t batch, int d,
                       cudaStream_t stream) {
  using T = typename Row::T;
  if (d < WIDE_MIN_D || d > WIDE_MAX_D) return int(cudaErrorInvalidValue);
  const int64_t steps = wide_steps(a.n);
  a.nblk = num_blocks(a.n, steps);
  a.totals = scratch;
  a.partials = scratch + batch * a.nblk * wide_filter_size(d);
  const dim3 grid(unsigned(num_blocks(a.nblk, WIDE_WARPS)), unsigned(batch));
  const size_t bytes = size_t(WIDE_WARPS) * wide_floats(d) * sizeof(T);
  int err = wide_smem_bytes(wide_filter_totals<Row>, bytes);
  if (err == 0) err = wide_smem_bytes(wide_filter_outputs<Row>, bytes);
  if (err != 0) return err;
  wide_filter_totals<Row><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<WideFilterOp<T>, false, T>(a.totals, a.nblk, batch, d, stream);
  if (err != 0) return err;
  wide_filter_outputs<Row><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  if constexpr (!Row::PREBUILT) {
    sum_partials<T, 128><<<dim3(1u, unsigned(batch)), 128, 0, stream>>>(
        a.partials, a.nblk, 1, nullptr, a.loglik);
    MF_CHECK_LAUNCH();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Smoother passes 1 and 3, for any Row with a static
// elem(prior, b, k, n, out, WideWork&, d) that builds the step's element.
// ---------------------------------------------------------------------------

template <class Row>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_smoother_totals(SmootherArgs<typename Row::T> a, typename Row::Prior p, int d,
                     int64_t steps) {
  using T = typename Row::T;
  const int warp = threadIdx.x >> 5, size = wide_smoother_size(d);
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp;
  if (u >= a.nblk) return;
  WideWork<T> w = wide_work<T>(reinterpret_cast<T*>(mf_wide_smem) + warp * wide_floats(d), d);
  T *run = w.slot[0], *nxt = w.slot[1], *e = w.slot[2];
  wide_identity(run, size, d);
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, a.n);
  for (int64_t k = k1 - 1; k >= k0; --k) {
    Row::elem(p, b, k, a.n, e, w, d);
    WideSmootherOp<T>::combine(e, run, nxt, w, d);
    T* s = run; run = nxt; nxt = s;
  }
  wcopy(a.totals + (b * a.nblk + u) * size, run, size);
}

template <class Row>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_smoother_outputs(SmootherArgs<typename Row::T> a, typename Row::Prior p, int d,
                      int64_t steps) {
  using T = typename Row::T;
  const int warp = threadIdx.x >> 5, lane = lane_id(), size = wide_smoother_size(d);
  const int dd = d * d, OG = dd, OL = dd + d;
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp, n = a.n;
  if (u >= a.nblk) return;
  WideWork<T> w = wide_work<T>(reinterpret_cast<T*>(mf_wide_smem) + warp * wide_floats(d), d);
  T *run = w.slot[0], *nxt = w.slot[1], *e = w.slot[2];
  wcopy(run, a.totals + (b * a.nblk + u) * size, size);  // suffix of all later warps
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, n);
  for (int64_t k = k1 - 1; k >= k0; --k) {
    Row::elem(p, b, k, n, e, w, d);
    WideSmootherOp<T>::combine(e, run, nxt, w, d);
    T* s = run; run = nxt; nxt = s;
    for (int i = lane; i < d; i += 32) a.m_s[(b * d + i) * n + k] = run[OG + i];
    for (int i = lane; i < dd; i += 32) a.p_s[(b * dd + i) * n + k] = run[OL + i];
    __syncwarp();
  }
}

template <typename T>
int64_t wide_smoother_scratch(int d, int64_t batch, int64_t n) {
  return batch * num_blocks(n, wide_steps(n)) * wide_smoother_size(d);
}

template <class Row>
int launch_wide_smoother(SmootherArgs<typename Row::T> a, typename Row::Prior p,
                         typename Row::T* scratch, int64_t batch, int d,
                         cudaStream_t stream) {
  using T = typename Row::T;
  if (d < WIDE_MIN_D || d > WIDE_MAX_D) return int(cudaErrorInvalidValue);
  const int64_t steps = wide_steps(a.n);
  a.nblk = num_blocks(a.n, steps);
  a.totals = scratch;
  const dim3 grid(unsigned(num_blocks(a.nblk, WIDE_WARPS)), unsigned(batch));
  const size_t bytes = size_t(WIDE_WARPS) * wide_floats(d) * sizeof(T);
  int err = wide_smem_bytes(wide_smoother_totals<Row>, bytes);
  if (err == 0) err = wide_smem_bytes(wide_smoother_outputs<Row>, bytes);
  if (err != 0) return err;
  wide_smoother_totals<Row><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<WideSmootherOp<T>, true, T>(a.totals, a.nblk, batch, d, stream);
  if (err != 0) return err;
  wide_smoother_outputs<Row><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  return 0;
}

}  // namespace mf
