// The Kalman scan kernels for state dims 7..12 on Hopper (sm_90a): a warp
// composes each associative element, which lives in shared memory.
//
// Replace the d = 7..12 range of the TPU kernels of
// markovflow_tpu/ops/pallas_scan.py that the d9 path runs:
// pallas_filter_pipeline_uniform, pallas_smoother_pipeline_uniform,
// pallas_filter_pipeline, pallas_smoother_scan and pallas_filter_scan (the
// element sources are the Wide*Row types of uniform_scan.cuh and
// general_scan.cuh); general_adjoint.cuh runs pallas_adjoint_pipeline on the
// same machinery.  The plain PyTorch versions are the *_plain functions of
// markovflow_tpu_torch/ops/cuda_scan.py.
//
// Why another layout: at d = 12 a filtering element holds 456 values and a
// composition keeps three d x d temporaries besides its operands and result,
// ~2,000 values in all.  One thread per run of steps with its elements in
// registers (scan_core.cuh, d <= 6) would keep them in local memory, and a
// warp-shuffle scan would move 456 values a level.  Here the 32 lanes of a
// warp share every product (a lane per output entry, up to 5 entries at
// d = 12), the pivoted Gauss-Jordan inverse (a lane per column of [M | I],
// held in registers) and the element builds, and each warp keeps its
// elements and temporaries in its own slice of dynamic shared memory.
//
// Passes, as in scan_core.cuh with a warp in place of a thread:
//   1. each warp owns R consecutive steps (R grows with N: wide_steps) and
//      folds them in order into its total, which goes out;
//   2. the totals of each batch row are scanned into exclusive carries, in
//      place, by a hierarchy spread over the card (launch_wide_scan): a warp
//      per group of WIDE_GROUP consecutive totals reduces its group, the
//      group totals are scanned the same way one level up (recursively,
//      until one group is left, which one warp scans), and each group's
//      warp rewrites its totals from its group's exclusive carry;
//   3. each warp restarts from its carry and writes the outputs; the
//      filter's log-likelihood goes out as one partial per warp and
//      sum_partials adds them in a fixed order.
// The warps never wait on each other, so a block holds WIDE_WARPS only to
// fill the SM.  The state dimension is a runtime argument and the loops are
// not unrolled over it: one instantiation per (element source, dtype)
// serves d = 7..12.  Output dimension 1.  No float atomics: the order of
// every composition is fixed, and a run repeats bit for bit.
//
// What bounds them on an H100: latency.  At d = 9, T = 1e5 the filter must
// move ~31 us of bytes, and every pass is a chain of small dependent steps
// in one warp: shared-memory products of 9 x 9 matrices, each phase ended by
// a __syncwarp().  The tensor cores do not help: a 9 x 9 product would fill
// a small part of an mma tile, and TF32 keeps about three digits where the
// d9 model's float32 loss already sits 2.4e-5 from float64.  So the design
// cuts the work on the chain and what each step waits for:
//   * pass 2 runs on many SMs, and its chain is ~2 WIDE_GROUP compositions a
//     level (log_4 of the totals: 5 levels and ~37 compositions at T = 1e5,
//     where groups of 8 took ~49 over 3 levels, 0.15 ms more at d = 9)
//     instead of one SM composing ~160 in order;
//   * with sites (o = 1) a step's filtering element is a rank-one update of
//     the run: folding it in is the sequential predict/update of the run's
//     conditional moments (A, b, C) and information (J, eta), three d^3
//     products and no inverse (Sherman-Morrison applied once, by hand: the
//     composition's (I + C J)^-1 with a rank-one J), where the general
//     composition takes eleven and a pivoted inverse;
//   * pass 3 carries only the filtered moments (b, C of the prefix) and runs
//     the Kalman predict/update from them: two d^3 products a step, and the
//     prediction is the one the log-likelihood needs anyway;
//   * a step's inputs (F, Q, c, h: 2 d^2 + 2 d values) lie N apart in the
//     time-last layout, so one step at a time reads a 32-byte sector per
//     value.  The passes of kernels 1, 4 and 7 fetch a chunk of CH steps
//     with cp.async (fetch_chunk: the lanes of one copy take neighbouring
//     steps of a value), into slots in shared memory, while the chunk before
//     computes; outputs go over the consumed inputs of their slot and out a
//     chunk at a time (store_chunk);
//   * the general composition (pass 2, and the prebuilt sources) runs in
//     four phases of independent products (wprods) around a register
//     Gauss-Jordan inverse whose lanes trade pivots and factors by shuffles,
//     where one product a __syncwarp() and a shared-memory pivot search
//     took ~25 phases and ~45 __syncwarp()s.
// Prebuilt elements (the filter scan) are not rank one: they keep the
// general composition in passes 1 and 3.
#pragma once

#include "scan_core.cuh"

namespace mf {

constexpr int WIDE_MIN_D = 7, WIDE_MAX_D = 12;
constexpr int WIDE_WARPS = 4;  // warps per block in every wide pass
constexpr int WIDE_GROUP = 4;  // totals a warp folds at each level of pass 2

// Steps per warp: a multiple of 8, so that every warp's chunks of steps
// (below) start on a 32-byte sector of the time-last arrays; ~2,000 warps
// at N = 1e5 (48 steps each, 2,084 warps: 15.8 an SM, one wave, where the
// shared memory of the passes of kernels 4 and 7 keeps 16 resident an SM at
// d = 9 in float32).
inline int64_t wide_steps(int64_t n) {
  const int64_t r = (n + 2047) / 2048 / 8 * 8;
  return r < 8 ? 8 : (r > 256 ? 256 : r);
}

__host__ __device__ inline int wide_filter_size(int d) { return 3 * d * d + 2 * d; }
__host__ __device__ inline int wide_smoother_size(int d) { return 2 * d * d + d; }

// Values of T in one warp's workspace for the general compositions: three
// element slots, the step's F, Q, c, h, six d x d temporaries and seven
// vectors.
__host__ __device__ inline int wide_floats(int d) {
  return 3 * wide_filter_size(d) + 2 * d * d + 2 * d + 6 * d * d + 7 * d;
}

template <typename T>
struct WideWork {
  T* slot[3];
  T *f, *q, *c, *h;  // the step: F [d, d], Q [d, d], c [d], H [1, d]
  T* m[6];           // d x d temporaries
  T* v[7];           // d vectors
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
  for (int i = 0; i < 6; ++i) { w.m[i] = base; base += dd; }
  for (int i = 0; i < 7; ++i) { w.v[i] = base; base += d; }
  return w;
}

MF_DEV int lane_id() { return threadIdx.x & 31; }

// ---------------------------------------------------------------------------
// Warp-cooperative small linear algebra on row-major matrices.  Every
// function is called by all 32 lanes and ends with __syncwarp(), so the next
// one sees its writes.  No output may alias an input.
// ---------------------------------------------------------------------------

template <typename T>
MF_DEV void wcopy(T* dst, const T* src, int n) {
  for (int e = lane_id(); e < n; e += 32) dst[e] = src[e];
  __syncwarp();
}

// The same value in every lane.
template <typename T>
MF_DEV T wdot(const T* a, const T* b, int n) {
  T acc = T(0);
  for (int l = 0; l < n; ++l) acc += a[l] * b[l];
  return acc;
}

// Row i and column j of the e-th entry of the upper triangle (row by row).
MF_DEV void tri_index(int e, int d, int& i, int& j) {
  i = 0;
  while (e >= d - i) { e -= d - i; ++i; }
  j = i + e;
}

// Inverse of m [d x d] into out by Gauss-Jordan elimination on [m | I] with
// partial pivoting: at column j the pivot is the first of rows j.. with the
// largest magnitude, swapped into row j.  The plain _gauss_jordan_tl
// (ops/kalman.py) reaches the same pivot row by a chain of swaps: the other
// rows end in another order, which changes no value.  Lane c < 2d holds
// column c of [m | I] in registers (the loops over rows are unrolled to
// WIDE_MAX_D), so a row swap, the scaling and the elimination are register
// operations; lane j's column gives the pivot row and the factors by
// shuffles.  No shared memory and no __syncwarp() until the inverse goes
// out.
template <typename T>
MF_DEV void winv(const T* m, T* out, int d) {
  const int lane = lane_id();
  T col[WIDE_MAX_D];
#pragma unroll
  for (int i = 0; i < WIDE_MAX_D; ++i)
    col[i] = i >= d ? T(0) : lane < d ? m[i * d + lane] : T(lane - d == i ? 1 : 0);
#pragma unroll
  for (int j = 0; j < WIDE_MAX_D; ++j) {
    if (j >= d) break;
    int p = j;
    T best = fabs(col[j]);
#pragma unroll
    for (int i = j + 1; i < WIDE_MAX_D; ++i)
      if (i < d && fabs(col[i]) > best) { best = fabs(col[i]); p = i; }
    p = __shfl_sync(0xffffffffu, p, j);
    T x = col[j];
#pragma unroll
    for (int i = j + 1; i < WIDE_MAX_D; ++i)
      if (i == p) { const T t = col[i]; col[i] = x; x = t; }
    col[j] = x * (T(1) / __shfl_sync(0xffffffffu, x, j));
#pragma unroll
    for (int i = 0; i < WIDE_MAX_D; ++i) {
      if (i == j || i >= d) continue;
      const T f = __shfl_sync(0xffffffffu, col[i], j);
      col[i] -= f * col[j];
    }
  }
  if (lane >= d && lane < 2 * d) {
#pragma unroll
    for (int i = 0; i < WIDE_MAX_D; ++i)
      if (i < d) out[i * d + lane - d] = col[i];
  }
  __syncwarp();
}

// One product of a fused phase (wprods): out [r x c] = alpha op(a) op(b)
// + add (+ I when eye), inner dim k <= 12, with op(a)(i, l) =
// a[i * ai + l * al] and op(b)(l, j) = b[l * bl + j * bj] (a transpose is a
// swap of strides); sym: out = (X + X^T) / 2 for that X (r = c), a lane per
// pair of entries (i, j), (j, i).  The average, not the upper triangle
// mirrored: in float32 the d9 model's filtered means lose 2-8x more to the
// mirrored form.
template <typename T>
struct WProd {
  const T* a;
  int ai, al;
  const T* b;
  int bl, bj;
  T* out;
  int r, c, k;
  const T* add;
  T alpha;
  bool eye, sym;

  MF_DEV int size() const { return sym ? r * (r + 1) / 2 : r * c; }
};

// d x d products: a b, a^T b, a b^T
template <typename T>
MF_DEV WProd<T> wnn(const T* a, const T* b, T* out, int d, const T* add = nullptr) {
  return {a, d, 1, b, d, 1, out, d, d, d, add, T(1), false, false};
}
template <typename T>
MF_DEV WProd<T> wtn(const T* a, const T* b, T* out, int d, const T* add = nullptr) {
  return {a, 1, d, b, d, 1, out, d, d, d, add, T(1), false, false};
}
template <typename T>
MF_DEV WProd<T> wnt(const T* a, const T* b, T* out, int d) {
  return {a, d, 1, b, 1, d, out, d, d, d, nullptr, T(1), false, false};
}
// d x d matrix times a d vector, and its transpose
template <typename T>
MF_DEV WProd<T> wnv(const T* a, const T* x, T* out, int d, const T* add = nullptr) {
  return {a, d, 1, x, 1, 0, out, d, 1, d, add, T(1), false, false};
}
template <typename T>
MF_DEV WProd<T> wtv(const T* a, const T* x, T* out, int d, const T* add = nullptr) {
  return {a, 1, d, x, 1, 0, out, d, 1, d, add, T(1), false, false};
}

// Entry (i, j) of a product.
template <typename T>
MF_DEV T wprod_entry(const WProd<T>& pr, int i, int j) {
  const T* pa = pr.a + i * pr.ai;
  const T* pb = pr.b + j * pr.bj;
  T acc = T(0);
#pragma unroll
  for (int l = 0; l < WIDE_MAX_D; ++l)
    if (l < pr.k) acc += pa[l * pr.al] * pb[l * pr.bl];
  acc *= pr.alpha;
  if (pr.add != nullptr) acc += pr.add[i * pr.c + j];
  if (pr.eye && i == j) acc += T(1);
  return acc;
}

// The products of one phase, independent of each other; entry e of their
// concatenated entries goes to lane e % 32.  Then __syncwarp().
template <typename T, int NP>
MF_DEV void wprods(const WProd<T> (&ps)[NP]) {
  const int lane = lane_id();
  int base = 0;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const WProd<T>& pr = ps[q];
    const int n = pr.size();
    for (int idx = (lane - base % 32 + 32) % 32; idx < n; idx += 32) {
      int i, j;
      if (pr.sym) tri_index(idx, pr.r, i, j);
      else { i = idx / pr.c; j = idx - i * pr.c; }
      T acc = wprod_entry(pr, i, j);
      if (pr.sym) {
        acc = T(0.5) * (acc + wprod_entry(pr, j, i));
        pr.out[j * pr.c + i] = acc;
      }
      pr.out[i * pr.c + j] = acc;
    }
    base += n;
  }
  __syncwarp();
}

// sym(a b^T + add) [d x d]
template <typename T>
MF_DEV WProd<T> wsym_nt(const T* a, const T* b, T* out, int d, const T* add) {
  WProd<T> pr = wnt(a, b, out, d);
  pr.add = add;
  pr.sym = true;
  return pr;
}

// One value from global to shared memory without a register on the way
// (cp.async, sm_80 and later); it lands by wide_fetch_wait().
template <typename T>
MF_DEV void cp_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(int(sizeof(T))));
#else
  *dst = *src;
#endif
}

// Every lane's copies have landed and every lane sees them.
MF_DEV void wide_fetch_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  __syncwarp();
}

// Starts the copies of steps k .. k + cnt - 1 (cnt <= CH) into CH slots of
// per values: value v of step k + s lands at slots[s * per + v], from
// src(v, k + s) (null: 0).  The lanes take (v, s) with s fastest, so one
// copy instruction reads CH neighbouring steps of 32 / CH values: a sector
// each in the time-last layout, where a step at a time reads 32 sectors.
template <int CH, typename T, class Src>
MF_DEV void fetch_chunk(T* slots, int per, int64_t k, int cnt, const Src& src) {
  for (int idx = lane_id(); idx < per * CH; idx += 32) {
    const int v = idx / CH, s = idx - v * CH;
    if (s >= cnt) continue;
    const T* from = src(v, k + s);
    if (from != nullptr) cp_async(slots + s * per + v, from);
    else slots[s * per + v] = T(0);
  }
}

// The other way: value v of the outputs of steps k .. k + cnt - 1 from
// slots[s * per + off + v] to dst(v, k + s) (null: not written), v < nv;
// then __syncwarp().
template <int CH, typename T, class Dst>
MF_DEV void store_chunk(const T* slots, int per, int off, int nv, int64_t k, int cnt,
                        const Dst& dst) {
  for (int idx = lane_id(); idx < nv * CH; idx += 32) {
    const int v = idx / CH, s = idx - v * CH;
    if (s >= cnt) continue;
    T* to = dst(v, k + s);
    if (to != nullptr) *to = slots[s * per + off + v];
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

  // out = x (earlier) composed with y (later); FilterOp::combine_body in
  // four phases of independent products around the inverse.
  static MF_DEV void combine(const T* x, const T* y, T* out, WideWork<T>& w, int d) {
    const int dd = d * d, OA = 0, OB = dd, OC = dd + d, OJ = 2 * dd + d, OE = 3 * dd + d;
    T *mm = w.m[0], *minv = w.m[1], *ma = w.m[2], *mc = w.m[3], *ja = w.m[4],
      *t2 = w.m[5];
    T *v1 = w.v[0], *v2 = w.v[1], *u2 = w.v[2], *w2 = w.v[3];
    // M = I + xc yj, v1 = xc ye + xb, yj xa, u2 = ye - yj xb
    WProd<T> p1[] = {wnn(x + OC, y + OJ, mm, d), wnv(x + OC, y + OE, v1, d, x + OB),
                     wnn(y + OJ, x + OA, ja, d), wnv(y + OJ, x + OB, u2, d, y + OE)};
    p1[0].eye = true;
    p1[3].alpha = T(-1);
    wprods(p1);
    winv(mm, minv, d);
    // minv xa, minv xc, minv v1, minv^T u2, minv^T (yj xa)
    WProd<T> p2[] = {wnn(minv, x + OA, ma, d), wnn(minv, x + OC, mc, d),
                     wnv(minv, v1, v2, d), wtv(minv, u2, w2, d), wtn(minv, ja, mm, d)};
    wprods(p2);
    // A = ya minv xa, b = ya minv v1 + yb, eta = xa^T minv^T u2 + xe,
    // J = sym(xa^T minv^T yj xa + xj), (minv xc) ya^T
    WProd<T> p3[] = {wnn(y + OA, ma, out + OA, d), wnv(y + OA, v2, out + OB, d, y + OB),
                     wtv(x + OA, w2, out + OE, d, x + OE), wtn(x + OA, mm, out + OJ, d, x + OJ),
                     wnt(mc, y + OA, t2, d)};
    p3[3].sym = true;
    wprods(p3);
    // C = sym(ya (minv xc) ya^T + yc)
    WProd<T> p4[] = {wnn(y + OA, t2, out + OC, d, y + OC)};
    p4[0].sym = true;
    wprods(p4);
  }
};

template <typename T>
struct WideSmootherOp {
  static __host__ __device__ int size(int d) { return wide_smoother_size(d); }

  // out = e (earlier) composed with l (later, the suffix):
  // E = eE lE, g = eE lg + eg, L = sym(eE lL eE^T + eL)
  static MF_DEV void combine(const T* e, const T* l, T* out, WideWork<T>& w, int d) {
    const int dd = d * d, OE = 0, OG = dd, OL = dd + d;
    T* tmp = w.m[0];
    WProd<T> p1[] = {wnn(e + OE, l + OE, out + OE, d), wnv(e + OE, l + OG, out + OG, d, e + OG),
                     wnt(l + OL, e + OE, tmp, d)};
    wprods(p1);
    WProd<T> p2[] = {wnn(e + OE, tmp, out + OL, d, e + OL)};
    p2[0].sym = true;
    wprods(p2);
  }
};

// The sites of one step (o = 1): the same values in every lane.
template <typename T>
struct WideSite {
  T nu, lam;
  bool keep;
};

// The step's sites (FilterStep::load_sites, o = 1), from FilterArgs or any
// struct with the same site fields.
template <typename T, class A>
MF_DEV WideSite<T> wide_site(const A& a, int64_t b, int64_t k) {
  return {a.nu[b * a.nu_sb + k * a.nu_st], a.lam[b * a.lam_sb + k * a.lam_st],
          a.mask == nullptr || a.mask[b * a.mask_sb + k * a.mask_st] > T(0.5)};
}

// Site log-likelihood of a step from its predicted observation: hm = H mp,
// hpht = H Ppred H^T (step_loglik, o = 1).
template <typename T>
MF_DEV T wide_loglik(const WideSite<T>& s, T hm, T hpht) {
  const T res = s.nu - s.lam * hm;
  const T lsafe = s.keep ? s.lam : T(1);
  const T mmat = s.keep ? s.lam * (hpht * s.lam) + s.lam : T(1);
  const T quad = res * ((T(1) / mmat) * res);
  const T log_det_s = log(fabs(hpht * lsafe + T(1))) - log(fabs(lsafe));
  const T ll = T(-0.5) * (quad + log_det_s + T(1.8378770664093453));
  return s.keep ? ll : T(0);
}

extern __shared__ __align__(16) unsigned char mf_wide_smem[];

// ---------------------------------------------------------------------------
// Pass 2, for either composition.
// ---------------------------------------------------------------------------

// One level of pass 2 over the totals [B, nblk elements of Op::size(d)] of
// batch row blockIdx.y, a warp per group of WIDE_GROUP consecutive totals.
// REDUCE: fold the group (REV: as a suffix) into up[b, group].  Otherwise
// rewrite the group's totals in place as exclusive scans from up[b, group],
// the group's exclusive carry (up null: the identity, for the one group of
// the top level).  Dynamic shared memory: one wide_floats workspace a warp.
template <class Op, bool REV, bool REDUCE, typename T>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_scan_level(T* totals, T* up, int64_t nblk, int d) {
  const int warp = threadIdx.x >> 5, size = Op::size(d);
  const int64_t b = blockIdx.y, g = int64_t(blockIdx.x) * WIDE_WARPS + warp;
  const int64_t ngroups = (nblk + WIDE_GROUP - 1) / WIDE_GROUP;
  if (g >= ngroups) return;  // the whole warp; no block barrier follows
  WideWork<T> w = wide_work<T>(reinterpret_cast<T*>(mf_wide_smem) + warp * wide_floats(d), d);
  T *acc = w.slot[0], *nxt = w.slot[1], *x = w.slot[2];
  T* row = totals + b * nblk * size;
  T* carry = up == nullptr ? nullptr : up + (b * ngroups + g) * size;
  const int64_t i0 = g * WIDE_GROUP, i1 = imin(i0 + WIDE_GROUP, nblk);
  int64_t s = 0;
  if (REDUCE || carry == nullptr) {  // the fold starts from the first total
    T* first = row + (REV ? i1 - 1 : i0) * size;
    wcopy(acc, first, size);
    if (!REDUCE) wide_identity(first, size, d);
    s = 1;
  } else {
    wcopy(acc, carry, size);
  }
  for (; s < i1 - i0; ++s) {
    T* ti = row + (REV ? i1 - 1 - s : i0 + s) * size;
    wcopy(x, ti, size);
    if (!REDUCE) wcopy(ti, acc, size);
    if (REV) Op::combine(x, acc, nxt, w, d);
    else Op::combine(acc, x, nxt, w, d);
    T* t = acc; acc = nxt; nxt = t;
  }
  if (REDUCE) wcopy(carry, acc, size);
}

// Values of T the levels of pass 2 keep above nblk totals of one row.
inline int64_t wide_scan_levels(int64_t nblk, int size) {
  int64_t vals = 0;
  for (int64_t n = nblk; n > WIDE_GROUP; n = (n + WIDE_GROUP - 1) / WIDE_GROUP)
    vals += (n + WIDE_GROUP - 1) / WIDE_GROUP * size;
  return vals;
}

// Dynamic shared memory of a kernel, allowed above the 48 KB default.
template <typename K>
inline int wide_smem_bytes(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  return int(err);
}

// Exclusive scan of the totals [batch, nblk elements], in place; REV scans
// suffixes.  levels: wide_scan_levels(nblk, size) values per batch row.
template <class Op, bool REV, typename T>
int launch_wide_scan(T* totals, int64_t nblk, int64_t batch, int d, T* levels,
                     cudaStream_t stream) {
  const size_t bytes = size_t(WIDE_WARPS) * wide_floats(d) * sizeof(T);
  int err = wide_smem_bytes(wide_scan_level<Op, REV, true, T>, bytes);
  if (err == 0) err = wide_smem_bytes(wide_scan_level<Op, REV, false, T>, bytes);
  if (err != 0) return err;
  if (nblk <= WIDE_GROUP) {
    wide_scan_level<Op, REV, false, T><<<dim3(1u, unsigned(batch)), WIDE_WARPS * 32, bytes,
                                         stream>>>(totals, nullptr, nblk, d);
    MF_CHECK_LAUNCH();
    return 0;
  }
  const int64_t ngroups = (nblk + WIDE_GROUP - 1) / WIDE_GROUP;
  const dim3 grid(unsigned(num_blocks(ngroups, WIDE_WARPS)), unsigned(batch));
  wide_scan_level<Op, REV, true, T><<<grid, WIDE_WARPS * 32, bytes, stream>>>(
      totals, levels, nblk, d);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<Op, REV, T>(levels, ngroups, batch, d,
                                     levels + batch * ngroups * Op::size(d), stream);
  if (err != 0) return err;
  wide_scan_level<Op, REV, false, T><<<grid, WIDE_WARPS * 32, bytes, stream>>>(
      totals, levels, nblk, d);
  MF_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------------------
// Filter passes 1 and 3, for any Row with a static
// src(prior, b, v, k, d): the address of value v of step k's inputs
// [F (d x d), Q (d x d), c (d), H (d)] (null for a 0), or, with
// Row::PREBUILT, a static elem(prior, b, k, n, out, WideWork&, d) that reads
// a prebuilt filtering element (no sites, no log-likelihood).
// ---------------------------------------------------------------------------

// A warp's workspace in the passes of a site source: the run element (pass
// 1; pass 3 keeps the filtered moments in its b and C legs), two chunks of
// CH step slots [F, Q, c, h] (the chunk being folded in and the next, in
// flight; pass 3 writes each step's P_f and m_f over its Q and c, and the
// chunk goes out from there), three d x d temporaries and three vectors.
template <typename T>
struct WideSeqWork {
  static constexpr int CH = 32 / sizeof(T);  // steps a chunk: a sector a value
  T *run, *chunk[2];
  T *m0, *m1, *m2, *v0, *v1, *v2;

  static __host__ __device__ int per(int d) { return 2 * d * d + 2 * d; }
  static __host__ __device__ int floats(int d) {
    return wide_filter_size(d) + 2 * CH * per(d) + 3 * d * d + 3 * d;
  }

  MF_DEV WideSeqWork(T* p, int d) {
    const int dd = d * d;
    run = p; p += wide_filter_size(d);
    chunk[0] = p; p += CH * per(d);
    chunk[1] = p; p += CH * per(d);
    m0 = p; p += dd;
    m1 = p; p += dd;
    m2 = p; p += dd;
    v0 = p; p += d;
    v1 = p; p += d;
    v2 = p;
  }
};

// Pass 1 with sites: fold step (f, q, c, h, s) into the run (A, b, C, J,
// eta), the element of the steps so far given the state before them.  The
// step's element has J = lz (H F)^T (H F), rank one, so composing it
// (FilterOp) is the sequential Kalman step of the run's conditional moments,
// with the gain row g = H F A:
//   Pp = F C F^T + Q, mp = F b + c, ph = Pp H^T, z = 1 / (lam H ph + 1),
//   lz = lam z, r = z nu - lz H mp;
//   A <- F A - lz ph g, b <- mp + ph r, C <- Pp - lz ph ph^T,
//   J <- J + lz g^T g, eta <- eta + g^T r.
template <typename T>
MF_DEV void wide_fold_site(WideSeqWork<T>& w, const T* f, const T* q, const T* c,
                           const T* h, const WideSite<T>& s, int d) {
  const int dd = d * d, lane = lane_id();
  T *A = w.run, *bb = w.run + dd, *C = w.run + dd + d, *J = w.run + 2 * dd + d,
    *eta = w.run + 3 * dd + d;
  T *fa = w.m0, *fc = w.m1, *pp = w.m2, *mp = w.v0, *ph = w.v1, *g = w.v2;
  WProd<T> p1[] = {wnn(f, A, fa, d), wnn(f, C, fc, d), wnv(f, bb, mp, d, c)};
  wprods(p1);
  WProd<T> p2[] = {wsym_nt(fc, f, pp, d, q), wtv(fa, h, g, d)};  // Pp, g = (H F A)^T
  wprods(p2);
  WProd<T> p3[] = {wnv(pp, h, ph, d)};
  wprods(p3);
  const T z = T(1) / (s.lam * wdot(h, ph, d) + T(1)), lz = s.lam * z;
  const T r = z * s.nu - lz * wdot(h, mp, d);
  for (int e = lane; e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    A[e] = fa[e] - lz * ph[i] * g[j];
    C[e] = pp[e] - lz * (ph[i] * ph[j]);
    J[e] += lz * (g[i] * g[j]);
  }
  for (int e = lane; e < d; e += 32) {
    bb[e] = mp[e] + ph[e] * r;
    eta[e] += g[e] * r;
  }
  __syncwarp();
}

// Pass 3 with sites: the Kalman step from the filtered moments (m, P) of
// the step before (the b and C legs of the run) to this step's, in place;
// returns the step's site log-likelihood (the same value in every lane).
template <typename T>
MF_DEV T wide_kalman_step(WideSeqWork<T>& w, const T* f, const T* q, const T* c,
                          const T* h, const WideSite<T>& s, int d) {
  const int dd = d * d, lane = lane_id();
  T *m = w.run + dd, *P = w.run + dd + d;
  T *fp = w.m0, *pp = w.m1, *mp = w.v0, *ph = w.v1;
  WProd<T> p1[] = {wnn(f, P, fp, d), wnv(f, m, mp, d, c)};
  wprods(p1);
  WProd<T> p2[] = {wsym_nt(fp, f, pp, d, q)};  // Ppred = sym(F P F^T + Q)
  wprods(p2);
  WProd<T> p3[] = {wnv(pp, h, ph, d)};
  wprods(p3);
  const T hpht = wdot(h, ph, d), hm = wdot(h, mp, d);
  const T z = T(1) / (s.lam * hpht + T(1)), lz = s.lam * z;
  const T r = z * s.nu - lz * hm;
  for (int e = lane; e < dd; e += 32) {
    const int i = e / d, j = e - i * d;
    P[e] = pp[e] - lz * (ph[i] * ph[j]);
  }
  for (int e = lane; e < d; e += 32) m[e] = mp[e] + ph[e] * r;
  __syncwarp();
  return wide_loglik(s, hm, hpht);
}

template <class Row>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_filter_totals(FilterArgs<typename Row::T> a, typename Row::Prior p, int d,
                   int64_t steps) {
  using T = typename Row::T;
  const int warp = threadIdx.x >> 5, size = wide_filter_size(d);
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp;
  if (u >= a.nblk) return;  // the whole warp; this kernel has no block barrier
  T* smem = reinterpret_cast<T*>(mf_wide_smem);
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, a.n);
  if constexpr (Row::PREBUILT) {
    WideWork<T> w = wide_work<T>(smem + warp * wide_floats(d), d);
    T *run = w.slot[0], *nxt = w.slot[1], *e = w.slot[2];
    wide_identity(run, size, d);
    for (int64_t k = k0; k < k1; ++k) {
      Row::elem(p, b, k, a.n, e, w, d);
      WideFilterOp<T>::combine(run, e, nxt, w, d);
      T* s = run; run = nxt; nxt = s;
    }
    wcopy(a.totals + (b * a.nblk + u) * size, run, size);
  } else {
    using W = WideSeqWork<T>;
    constexpr int CH = W::CH;
    W w(smem + warp * W::floats(d), d);
    const int per = W::per(d), dd = d * d;
    const auto src = [&](int v, int64_t k) { return Row::src(p, b, v, k, d); };
    wide_identity(w.run, size, d);
    fetch_chunk<CH>(w.chunk[0], per, k0, int(imin(CH, k1 - k0)), src);
    WideSite<T> site = wide_site<T>(a, b, k0);
    wide_fetch_wait();
    for (int64_t kc = k0, cur = 0; kc < k1; kc += CH, cur ^= 1) {
      const int cnt = int(imin(CH, k1 - kc));
      if (kc + CH < k1)
        fetch_chunk<CH>(w.chunk[cur ^ 1], per, kc + CH, int(imin(CH, k1 - kc - CH)), src);
      for (int s = 0; s < cnt; ++s) {
        const WideSite<T> next = kc + s + 1 < k1 ? wide_site<T>(a, b, kc + s + 1) : site;
        const T* st = w.chunk[cur] + s * per;
        wide_fold_site(w, st, st + dd, st + 2 * dd, st + 2 * dd + d, site, d);
        site = next;
      }
      wide_fetch_wait();
    }
    wcopy(a.totals + (b * a.nblk + u) * size, w.run, size);
  }
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
  T* smem = reinterpret_cast<T*>(mf_wide_smem);
  const T* carry = a.totals + (b * a.nblk + u) * size;  // all earlier warps
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, n);
  if constexpr (Row::PREBUILT) {
    WideWork<T> w = wide_work<T>(smem + warp * wide_floats(d), d);
    T *run = w.slot[0], *nxt = w.slot[1], *e = w.slot[2];
    wcopy(run, carry, size);
    for (int64_t k = k0; k < k1; ++k) {
      Row::elem(p, b, k, n, e, w, d);
      WideFilterOp<T>::combine(run, e, nxt, w, d);
      T* s = run; run = nxt; nxt = s;
      for (int i = lane; i < d; i += 32) a.m_f[(b * d + i) * n + k] = run[OB + i];
      for (int i = lane; i < dd; i += 32) a.p_f[(b * dd + i) * n + k] = run[OC + i];
      __syncwarp();
    }
  } else {
    // The carry's b and C legs are the filtered moments of step k0 - 1
    // (b = 0, C = 0 before step 0, where F = 0 makes them irrelevant).
    using W = WideSeqWork<T>;
    constexpr int CH = W::CH;
    W w(smem + warp * W::floats(d), d);
    const int per = W::per(d);
    const auto src = [&](int v, int64_t k) { return Row::src(p, b, v, k, d); };
    // P_f over Q and m_f over c: values v < dd + d from slot offset dd
    const auto dst = [&](int v, int64_t k) {
      return v < dd ? a.p_f + ((b * dd + v) * n + k) : a.m_f + ((b * d + v - dd) * n + k);
    };
    wcopy(w.run + OB, carry + OB, d + dd);
    fetch_chunk<CH>(w.chunk[0], per, k0, int(imin(CH, k1 - k0)), src);
    WideSite<T> site = wide_site<T>(a, b, k0);
    wide_fetch_wait();
    T ll = T(0);
    for (int64_t kc = k0, cur = 0; kc < k1; kc += CH, cur ^= 1) {
      const int cnt = int(imin(CH, k1 - kc));
      if (kc + CH < k1)
        fetch_chunk<CH>(w.chunk[cur ^ 1], per, kc + CH, int(imin(CH, k1 - kc - CH)), src);
      for (int s = 0; s < cnt; ++s) {
        const WideSite<T> next = kc + s + 1 < k1 ? wide_site<T>(a, b, kc + s + 1) : site;
        T* st = w.chunk[cur] + s * per;
        ll += wide_kalman_step(w, st, st + dd, st + 2 * dd, st + 2 * dd + d, site, d);
        for (int e = lane; e < dd; e += 32) st[dd + e] = w.run[OC + e];
        for (int e = lane; e < d; e += 32) st[2 * dd + e] = w.run[OB + e];
        __syncwarp();
        site = next;
      }
      store_chunk<CH>(w.chunk[cur], per, dd, dd + d, kc, cnt, dst);
      wide_fetch_wait();
    }
    if (lane == 0) a.partials[b * a.nblk + u] = ll;
  }
}

template <typename T>
int64_t wide_filter_scratch(int d, int64_t batch, int64_t n) {
  const int64_t nblk = num_blocks(n, wide_steps(n));
  return batch * (nblk * (wide_filter_size(d) + 1) +
                  wide_scan_levels(nblk, wide_filter_size(d)));
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
  T* levels = a.partials + batch * a.nblk;
  const dim3 grid(unsigned(num_blocks(a.nblk, WIDE_WARPS)), unsigned(batch));
  const int per = Row::PREBUILT ? wide_floats(d) : WideSeqWork<T>::floats(d);
  const size_t bytes = size_t(WIDE_WARPS) * per * sizeof(T);
  int err = wide_smem_bytes(wide_filter_totals<Row>, bytes);
  if (err == 0) err = wide_smem_bytes(wide_filter_outputs<Row>, bytes);
  if (err != 0) return err;
  wide_filter_totals<Row><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<WideFilterOp<T>, false, T>(a.totals, a.nblk, batch, d, levels,
                                                    stream);
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

// The totals [batch, nblk] and the levels of pass 2.
template <typename T>
int64_t wide_smoother_scratch(int d, int64_t batch, int64_t n) {
  const int64_t nblk = num_blocks(n, wide_steps(n));
  return batch * (nblk * wide_smoother_size(d) +
                  wide_scan_levels(nblk, wide_smoother_size(d)));
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
  err = launch_wide_scan<WideSmootherOp<T>, true, T>(
      a.totals, a.nblk, batch, d, a.totals + batch * a.nblk * wide_smoother_size(d), stream);
  if (err != 0) return err;
  wide_smoother_outputs<Row><<<grid, WIDE_WARPS * 32, bytes, stream>>>(a, p, d, steps);
  MF_CHECK_LAUNCH();
  return 0;
}

}  // namespace mf
