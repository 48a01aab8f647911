// The Kalman scan kernels for state dims 7..12 on Hopper (sm_90a): a warp
// composes each associative element, which lives in shared memory.
//
// Replace the d = 7..12 range of the TPU kernels of
// markovflow_tpu/ops/pallas_scan.py that the d9 path runs:
// pallas_filter_pipeline_uniform, pallas_smoother_pipeline_uniform,
// pallas_filter_pipeline, pallas_smoother_scan and pallas_filter_scan (the
// element sources are the Wide* types of uniform_scan.cuh and
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
//     value.  The passes fetch a chunk of CH steps with cp.async (the lanes
//     of one copy take neighbouring steps of a value: fetch_chunk for the
//     strided inputs of kernels 1, 4 and 7, fetch_rows for the contiguous
//     elements and moments of kernels 2, 5 and 6), into slots in shared
//     memory, while the chunk before computes; outputs go over the consumed
//     inputs of their slot and out a chunk at a time (store_chunk,
//     store_rows);
//   * the general composition (pass 2, and pass 1 of the filter scan and
//     the smoothers) runs in four phases of independent products (wprods)
//     around a register Gauss-Jordan inverse whose lanes trade pivots and
//     factors by shuffles, where one product a __syncwarp() and a
//     shared-memory pivot search took ~25 phases and ~45 __syncwarp()s.
// Prebuilt elements (the filter scan) are not rank one: pass 1 folds them
// with the general composition, since a run total is a whole element, but
// pass 3 needs only the b and C legs of the prefix, which read nothing of
// the earlier element but its own b and C (wide_filter_moments: a pivoted
// solve on d + 1 right-hand sides and three products a step).  The
// smoothers' pass 3 likewise carries only the g and L legs
// (wide_smoother_moments); the uniform RTS source builds each element once,
// in pass 1, and keeps it for pass 3: its E leg in the scratch, its g and L
// legs in m_s and P_s, which pass 3 overwrites with the moments.
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

// The temporaries of the general compositions and of the steps of the
// staged passes: six d x d matrices and four vectors.
__host__ __device__ inline int wide_temps_floats(int d) { return 6 * d * d + 4 * d; }

template <typename T>
struct WideTemps {
  T* m[6];
  T* v[4];

  MF_DEV WideTemps(T* p, int d) {
    for (int i = 0; i < 6; ++i) { m[i] = p; p += d * d; }
    for (int i = 0; i < 4; ++i) { v[i] = p; p += d; }
  }
};

// Values of T in one warp's workspace of pass 2: three element slots, 2 d^2
// + 2 d unused, the temporaries and 3 d unused.  The unused values keep the
// temporaries where they lay before the staged passes shared WideTemps:
// without them one call's pass 2 took up to 0.013 ms more at d = 9 in
// float32 (PERF.md).  A fused phase of products (wprods) reads several
// matrices in one instruction, so their offsets may set its bank conflicts.
__host__ __device__ inline int wide_floats(int d) {
  return 3 * wide_filter_size(d) + 2 * d * d + 2 * d + wide_temps_floats(d) + 3 * d;
}

template <typename T>
struct WideWork {
  T* slot[3];
  WideTemps<T> t;

  MF_DEV WideWork(T* p, int d) : t(p + 3 * wide_filter_size(d) + 2 * d * d + 2 * d, d) {
    for (int i = 0; i < 3; ++i) slot[i] = p + i * wide_filter_size(d);
  }
};

MF_DEV int lane_id() { return threadIdx.x & 31; }

// ---------------------------------------------------------------------------
// Warp-cooperative small linear algebra on row-major matrices.  Every
// function is called by all 32 lanes and ends with __syncwarp(), so the next
// one sees its writes.  No output may alias an input, but for the add of a
// product (WProd), which each lane reads only at the entries it writes.
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

// Solves m [X | x] = [B | v] for m, B [d x d] and v [d] by Gauss-Jordan
// elimination with partial pivoting: at column j the pivot is the first of
// rows j.. with the largest magnitude, swapped into row j.  The plain
// _gauss_jordan_tl (ops/kalman.py) reaches the same pivot row by a chain of
// swaps: the other rows end in another order, which changes no value.  Lane
// c < d holds column c of m in registers (the loops over rows are unrolled
// to WIDE_MAX_D), lane d + c column c of B (of I when B is null), lane 2d
// the vector v (none when v is null), so a row swap, the scaling and the
// elimination are register operations; lane j's column gives the pivot row
// and the factors by shuffles.  No shared memory and no __syncwarp() until
// X goes to out (X^T when TRANS) and x to xo.  With LD every lane returns
// log|det m| (the sum of the pivots' log magnitudes), else 0.
template <typename T, bool TRANS = false, bool LD = false>
MF_DEV T wsolve(const T* m, const T* bm, const T* v, T* out, T* xo, int d) {
  const int lane = lane_id();
  T col[WIDE_MAX_D], ld = T(0);
#pragma unroll
  for (int i = 0; i < WIDE_MAX_D; ++i)
    col[i] = i >= d                  ? T(0)
             : lane < d              ? m[i * d + lane]
             : lane >= 2 * d         ? (lane == 2 * d && v != nullptr ? v[i] : T(0))
             : bm != nullptr         ? bm[i * d + lane - d]
                                     : T(lane - d == i ? 1 : 0);
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
    const T piv = __shfl_sync(0xffffffffu, x, j);
    if constexpr (LD) ld += log(fabs(piv));
    col[j] = x * (T(1) / piv);
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
      if (i < d) out[TRANS ? (lane - d) * d + i : i * d + lane - d] = col[i];
  } else if (lane == 2 * d && xo != nullptr) {
#pragma unroll
    for (int i = 0; i < WIDE_MAX_D; ++i)
      if (i < d) xo[i] = col[i];
  }
  __syncwarp();
  return ld;
}

// Inverse of m [d x d] into out.
template <typename T>
MF_DEV void winv(const T* m, T* out, int d) {
  wsolve<T>(m, nullptr, nullptr, out, nullptr, d);
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
// src(v, k + s) (null: 0), for v < nv (0: every value of the slot).  The
// lanes take (v, s) with s fastest, so one copy instruction reads CH
// neighbouring steps of 32 / CH values: a sector (CH = 32 / sizeof(T)) or
// half of one each in the time-last layout, where a step at a time reads
// 32 sectors.
template <int CH, typename T, class Src>
MF_DEV void fetch_chunk(T* slots, int per, int64_t k, int cnt, const Src& src, int nv = 0) {
  for (int idx = lane_id(); idx < (nv > 0 ? nv : per) * CH; idx += 32) {
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

// Up to five contiguous time-last arrays [B, rows, N] whose rows, one after
// another, are the values of a staged slot: value v of batch row b at step
// k is base[i][(b * rows[i] + v - (rows[0] + ... + rows[i - 1])) * n + k]
// for the array i that holds v.
template <typename P>
struct WideRows {
  P base[5];
  int rows[5];
};

// Calls copy(v, s, address of value v at step k + s) for the (v, s), v <
// nv, s < CH, of fetch_chunk's lane order.  32 % CH == 0, so a lane keeps
// its s and steps v by 32 / CH: within an array the address moves by that
// many rows, and it is computed afresh only at the start of each array,
// where fetch_chunk's src computes it for every value.  The arrays are
// walked with constant indices, so r stays in registers.
template <int CH, typename P, class Copy>
MF_DEV void walk_rows(const WideRows<P>& r, int nv, int64_t b, int64_t n, int64_t k,
                      const Copy& copy) {
  constexpr int STEP = 32 / CH;
  const int s = lane_id() % CH, v0 = lane_id() / CH;
  int start = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int end = imin(start + r.rows[i], nv);
    int v = start + (v0 - start % STEP + STEP) % STEP;  // the lane's first value from start
    P at = r.base[i] + ((b * r.rows[i] + v - start) * n + k + s);
    for (; v < end; v += STEP, at += STEP * n) copy(v, s, at);
    start += r.rows[i];
  }
}

// fetch_chunk from the arrays of r: value v < nv of step k + s (s < cnt)
// lands at slots[s * per + v].
template <int CH, typename T>
MF_DEV void fetch_rows(T* slots, int per, int nv, const WideRows<const T*>& r, int64_t b,
                       int64_t n, int64_t k, int cnt) {
  walk_rows<CH>(r, nv, b, n, k, [&](int v, int s, const T* at) {
    if (s < cnt) cp_async(slots + s * per + v, at);
  });
}

// store_chunk to the arrays of r: slots[s * per + v] goes to value v < nv
// of step k + s (s < cnt); then __syncwarp().
template <int CH, typename T>
MF_DEV void store_rows(const T* slots, int per, int nv, const WideRows<T*>& r, int64_t b,
                       int64_t n, int64_t k, int cnt) {
  walk_rows<CH>(r, nv, b, n, k, [&](int v, int s, T* at) {
    if (s < cnt) *at = slots[s * per + v];
  });
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
  static MF_DEV void combine(const T* x, const T* y, T* out, WideTemps<T>& w, int d) {
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
  static MF_DEV void combine(const T* e, const T* l, T* out, WideTemps<T>& w, int d) {
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
// hpht = H Ppred H^T, in lam form (ops/kalman.py filter_pipeline_tl, o = 1);
// masked steps give 0.
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
  WideWork<T> w(reinterpret_cast<T*>(mf_wide_smem) + warp * wide_floats(d), d);
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
    if (REV) Op::combine(x, acc, nxt, w.t, d);
    else Op::combine(acc, x, nxt, w.t, d);
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

// The shared memory a warp and the warps an SM keeps resident, by the
// occupancy calculator (registers and each block's reserve included), of a
// kernel launched with bytes of dynamic shared memory: out[0], out[1].
template <class K>
int wide_occupancy(K kernel, size_t bytes, int64_t* out) {
  int blocks = 0;
  int err = wide_smem_bytes(kernel, bytes);
  if (err == 0)
    err = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WIDE_WARPS * 32,
                                                            bytes));
  out[0] = int64_t(bytes / WIDE_WARPS);
  out[1] = int64_t(blocks) * WIDE_WARPS;
  return err;
}

// Dynamic shared memory of pass 2's launches.
template <typename T>
size_t wide_scan_bytes(int d) {
  return size_t(WIDE_WARPS) * wide_floats(d) * sizeof(T);
}

// Exclusive scan of the totals [batch, nblk elements], in place; REV scans
// suffixes.  levels: wide_scan_levels(nblk, size) values per batch row.
template <class Op, bool REV, typename T>
int launch_wide_scan(T* totals, int64_t nblk, int64_t batch, int d, T* levels,
                     cudaStream_t stream) {
  const size_t bytes = wide_scan_bytes<T>(d);
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
// The staged passes of whole elements: the filter scan of prebuilt elements
// and the smoothers.
// ---------------------------------------------------------------------------

// A warp's workspace there: the temporaries, the run and the next run (pass
// 3 keeps the moments of the step next to the chunk in the run's b and C,
// or g and L, legs), two chunks of CH slots of one element each (the chunk
// being folded in and the next, in flight; pass 3 writes each step's
// moments over its slot's b and C, or g and L, legs, and the chunk goes out
// from there) and nconst constants of the element source.  CH = 16 / sizeof
// (T): with 8 steps a chunk in float32 the filter scan would keep 8 warps an
// SM resident at d = 9, not 16 (PERF.md).
template <typename T>
struct WideStageWork {
  static constexpr int CH = 16 / sizeof(T);
  WideTemps<T> t;
  T *run, *nxt, *chunk[2], *cst;

  static __host__ __device__ int floats(int d, int size, int nconst) {
    return wide_temps_floats(d) + 2 * size + 2 * CH * size + nconst;
  }

  MF_DEV WideStageWork(T* p, int d, int size) : t(p, d) {
    p += wide_temps_floats(d);
    run = p; p += size;
    nxt = p; p += size;
    chunk[0] = p; p += CH * size;
    chunk[1] = p; p += CH * size;
    cst = p;
  }
};

// Pass 3 of the filter scan: the filtered moments after the prebuilt
// element in slot st from those before it (mp: m, then P), which are the b
// and C legs of the elements composed so far; WideFilterOp::combine's b and
// C legs read nothing else of the earlier element:
//   M = I + P J, [X | x] = M^-1 [P | m + P eta] (wsolve),
//   P' = sym(A X A^T + C), m' = A x + b,
// written over the slot's b and C legs.
template <typename T>
MF_DEV void wide_filter_moments(T* st, const T* mp, WideTemps<T>& w, int d) {
  const int dd = d * d, OB = dd, OC = dd + d, OJ = 2 * dd + d, OE = 3 * dd + d;
  const T *m = mp, *P = mp + d;
  T *mm = w.m[0], *X = w.m[1], *ax = w.m[2], *v = w.v[0], *x = w.v[1];
  WProd<T> p1[] = {wnn(P, st + OJ, mm, d), wnv(P, st + OE, v, d, m)};
  p1[0].eye = true;
  wprods(p1);
  wsolve(mm, P, v, X, x, d);
  WProd<T> p2[] = {wnn(st, X, ax, d), wnv(st, x, st + OB, d, st + OB)};
  wprods(p2);
  WProd<T> p3[] = {wsym_nt(ax, st, st + OC, d, st + OC)};
  wprods(p3);
}

// Pass 3 of the smoothers: the smoothed moments of a step from those of the
// step after it (mp: m', then P'), which are the g and L legs of the
// elements composed after it, through the step's element (E, g, L) in slot
// st: m = E m' + g, P = sym(E P' E^T + L), written over the slot's g and L
// legs.  The composition's E leg is never formed.
template <typename T>
MF_DEV void wide_smoother_moments(T* st, const T* mp, WideTemps<T>& w, int d) {
  const int dd = d * d, OG = dd, OL = dd + d;
  T* t = w.m[0];
  WProd<T> p1[] = {wnt(mp + d, st, t, d), wnv(st, mp, st + OG, d, st + OG)};
  wprods(p1);
  WProd<T> p2[] = {wnn(st, t, st + OL, d, st + OL)};
  p2[0].sym = true;
  wprods(p2);
}

// ---------------------------------------------------------------------------
// Filter passes 1 and 3, for any Row with a static
// src(prior, b, v, k, d): the address of value v of step k's inputs
// [F (d x d), Q (d x d), c (d), H (d)] (null for a 0), or, with
// Row::PREBUILT, a static rows(prior, d): the arrays (WideRows) of the
// prebuilt filtering elements [A, b, C, J, eta] (no sites, no
// log-likelihood).
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
    // the general composition, since a run total is a whole element
    using W = WideStageWork<T>;
    constexpr int CH = W::CH;
    W w(smem + warp * W::floats(d, size, 0), d, size);
    const WideRows<const T*> in = Row::rows(p, d);
    T *run = w.run, *nxt = w.nxt, *cur = w.chunk[0], *ahead = w.chunk[1];
    wide_identity(run, size, d);
    fetch_rows<CH>(cur, size, size, in, b, a.n, k0, int(imin(CH, k1 - k0)));
    wide_fetch_wait();
    for (int64_t kc = k0; kc < k1; kc += CH) {
      const int cnt = int(imin(CH, k1 - kc));
      if (kc + CH < k1)
        fetch_rows<CH>(ahead, size, size, in, b, a.n, kc + CH, int(imin(CH, k1 - kc - CH)));
      for (int s = 0; s < cnt; ++s) {
        WideFilterOp<T>::combine(run, cur + s * size, nxt, w.t, d);
        T* t = run; run = nxt; nxt = t;
      }
      wide_fetch_wait();
      T* t = cur; cur = ahead; ahead = t;
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
    // only the moments: the b and C legs of the carry, then of each step
    using W = WideStageWork<T>;
    constexpr int CH = W::CH;
    W w(smem + warp * W::floats(d, size, 0), d, size);
    const WideRows<const T*> in = Row::rows(p, d);
    // m_f over b and P_f over C: values v < d + dd from slot offset OB
    const WideRows<T*> out{{a.m_f, a.p_f}, {d, dd}};
    T *cur = w.chunk[0], *ahead = w.chunk[1];
    wcopy(w.run + OB, carry + OB, d + dd);
    fetch_rows<CH>(cur, size, size, in, b, n, k0, int(imin(CH, k1 - k0)));
    wide_fetch_wait();
    for (int64_t kc = k0; kc < k1; kc += CH) {
      const int cnt = int(imin(CH, k1 - kc));
      if (kc + CH < k1)
        fetch_rows<CH>(ahead, size, size, in, b, n, kc + CH, int(imin(CH, k1 - kc - CH)));
      const T* mp = w.run + OB;
      for (int s = 0; s < cnt; ++s) {
        T* st = cur + s * size;
        wide_filter_moments(st, mp, w.t, d);
        mp = st + OB;
      }
      store_rows<CH>(cur + OB, size, d + dd, out, b, n, kc, cnt);
      wcopy(w.run + OB, mp, d + dd);
      wide_fetch_wait();
      T* t = cur; cur = ahead; ahead = t;
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

// Dynamic shared memory of passes 1 and 3.
template <class Row>
size_t wide_filter_bytes(int d) {
  using T = typename Row::T;
  const int per = Row::PREBUILT ? WideStageWork<T>::floats(d, wide_filter_size(d), 0)
                                : WideSeqWork<T>::floats(d);
  return size_t(WIDE_WARPS) * per * sizeof(T);
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
  const size_t bytes = wide_filter_bytes<Row>(d);
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
// Smoother passes 1 and 3.  Pass 1 folds the elements (E, g, L) of a Row
// with static members:
//   BUILD: whether pass 1 builds the elements (and keeps them for pass 3)
//     or reads them whole;
//   consts(d), load(prior, b, cst, d): constants of batch row b, loaded
//     once a warp into cst (all lanes, then __syncwarp());
//   offset(d), rows(prior, d): the arrays (WideRows) whose value v lands at
//     slot offset offset(d) + v;
//   build(cst, st, k, n, WideTemps&, d): turns slot st into step k's
//     element, in place;
// A source that builds its elements keeps E in the scratch and g and L in
// m_s and P_s, where pass 3 writes each step's moments over them.  Pass 3
// reads the elements whole and carries only the moments.
// ---------------------------------------------------------------------------

// A source that reads whole elements: nothing to load or build.
template <typename T_>
struct WideReadRow {
  using T = T_;
  static constexpr bool BUILD = false;
  static __host__ __device__ int consts(int) { return 0; }
  template <class P>
  static MF_DEV void load(const P&, int64_t, T*, int) {}
  static MF_DEV int offset(int) { return 0; }
  static MF_DEV void build(const T*, T*, int64_t, int64_t, WideTemps<T>&, int) {}
};

// prebuilt smoothing elements, contiguous: E [B, d, d, N], g [B, d, 1, N],
// L [B, d, d, N]
template <typename T>
struct Prebuilt {
  const T *e, *g, *l;
};

// The arrays of prebuilt elements, value v of slot [E, g, L] in order.
template <typename T>
MF_DEV WideRows<const T*> wide_element_rows(const Prebuilt<T>& e, int d) {
  return {{e.e, e.g, e.l}, {d * d, d, d * d}};
}

// Pass 1: fold the warp's steps, last first, into its suffix total, a chunk
// of CH steps at a time (the last chunk first); with Row::BUILD each
// chunk's elements also go out, E to e and g and L to m_s and P_s.
template <class Row>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_rts_totals(SmootherArgs<typename Row::T> a, typename Row::Prior p, int d,
                int64_t steps, typename Row::T* e) {
  using T = typename Row::T;
  using W = WideStageWork<T>;
  constexpr int CH = W::CH;
  const int warp = threadIdx.x >> 5, size = wide_smoother_size(d), off = Row::offset(d);
  const int dd = d * d;
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp, n = a.n;
  if (u >= a.nblk) return;  // the whole warp; this kernel has no block barrier
  W w(reinterpret_cast<T*>(mf_wide_smem) + warp * W::floats(d, size, Row::consts(d)), d,
      size);
  const WideRows<const T*> in = Row::rows(p, d);
  const WideRows<T*> kept{{e, a.m_s, a.p_s}, {dd, d, dd}};
  T *run = w.run, *nxt = w.nxt, *cur = w.chunk[0], *ahead = w.chunk[1];
  Row::load(p, b, w.cst, d);
  wide_identity(run, size, d);
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, n);
  int64_t kc = k0 + (k1 - 1 - k0) / CH * CH;  // k0 is a multiple of CH
  fetch_rows<CH>(cur + off, size, size - off, in, b, n, kc, int(k1 - kc));
  wide_fetch_wait();
  for (; kc >= k0; kc -= CH) {
    const int cnt = int(imin(CH, k1 - kc));
    if (kc > k0) fetch_rows<CH>(ahead + off, size, size - off, in, b, n, kc - CH, CH);
    for (int s = cnt - 1; s >= 0; --s) {
      T* st = cur + s * size;
      Row::build(w.cst, st, kc + s, n, w.t, d);
      WideSmootherOp<T>::combine(st, run, nxt, w.t, d);
      T* t = run; run = nxt; nxt = t;
    }
    if constexpr (Row::BUILD) store_rows<CH>(cur, size, size, kept, b, n, kc, cnt);
    wide_fetch_wait();
    T* t = cur; cur = ahead; ahead = t;
  }
  wcopy(a.totals + (b * a.nblk + u) * size, run, size);
}

// Pass 3: the smoothed moments of the warp's steps, last first, from the g
// and L legs of its carry (the suffix of all later warps: the smoothed
// moments of step k1; 0 after the last step, whose element has E = 0).  A
// chunk's elements are fetched before its moments go out, so e's g and L
// may be m_s and P_s.
template <typename T>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
wide_rts_outputs(SmootherArgs<T> a, Prebuilt<T> e, int d, int64_t steps) {
  using W = WideStageWork<T>;
  constexpr int CH = W::CH;
  const int warp = threadIdx.x >> 5, size = wide_smoother_size(d);
  const int dd = d * d, OG = dd;
  const int64_t b = blockIdx.y, u = int64_t(blockIdx.x) * WIDE_WARPS + warp, n = a.n;
  if (u >= a.nblk) return;
  W w(reinterpret_cast<T*>(mf_wide_smem) + warp * W::floats(d, size, 0), d, size);
  const WideRows<const T*> in = wide_element_rows(e, d);
  // m_s over g and P_s over L: values v < d + dd from slot offset OG
  const WideRows<T*> out{{a.m_s, a.p_s}, {d, dd}};
  T *cur = w.chunk[0], *ahead = w.chunk[1];
  wcopy(w.run + OG, a.totals + (b * a.nblk + u) * size + OG, d + dd);
  const int64_t k0 = u * steps, k1 = imin(k0 + steps, n);
  int64_t kc = k0 + (k1 - 1 - k0) / CH * CH;
  fetch_rows<CH>(cur, size, size, in, b, n, kc, int(k1 - kc));
  wide_fetch_wait();
  for (; kc >= k0; kc -= CH) {
    const int cnt = int(imin(CH, k1 - kc));
    if (kc > k0) fetch_rows<CH>(ahead, size, size, in, b, n, kc - CH, CH);
    const T* mp = w.run + OG;
    for (int s = cnt - 1; s >= 0; --s) {
      T* st = cur + s * size;
      wide_smoother_moments(st, mp, w.t, d);
      mp = st + OG;
    }
    store_rows<CH>(cur + OG, size, d + dd, out, b, n, kc, cnt);
    wcopy(w.run + OG, mp, d + dd);
    wide_fetch_wait();
    T* t = cur; cur = ahead; ahead = t;
  }
}

// The totals [batch, nblk], the levels of pass 2 and, for a source that
// builds its elements, their E legs [batch, d^2, n]: d values a step fewer
// than the moments the call writes.
template <typename T>
int64_t wide_smoother_scratch(int d, int64_t batch, int64_t n, bool build = false) {
  const int64_t nblk = num_blocks(n, wide_steps(n));
  return batch * (nblk * wide_smoother_size(d) + wide_scan_levels(nblk, wide_smoother_size(d)) +
                  (build ? n * d * d : 0));
}

// Dynamic shared memory of passes 1 and 3 (out[0], out[1]).
template <class Row>
void wide_smoother_bytes(int d, size_t* out) {
  using W = WideStageWork<typename Row::T>;
  const int size = wide_smoother_size(d);
  out[0] = size_t(WIDE_WARPS) * W::floats(d, size, Row::consts(d)) * sizeof(typename Row::T);
  out[1] = size_t(WIDE_WARPS) * W::floats(d, size, 0) * sizeof(typename Row::T);
}

template <class Row>
int launch_wide_smoother(SmootherArgs<typename Row::T> a, typename Row::Prior p,
                         typename Row::T* scratch, int64_t batch, int d,
                         cudaStream_t stream) {
  using T = typename Row::T;
  if (d < WIDE_MIN_D || d > WIDE_MAX_D) return int(cudaErrorInvalidValue);
  const int size = wide_smoother_size(d);
  const int64_t steps = wide_steps(a.n);
  a.nblk = num_blocks(a.n, steps);
  a.totals = scratch;
  T* levels = scratch + batch * a.nblk * size;
  T* e = Row::BUILD ? levels + batch * wide_scan_levels(a.nblk, size) : nullptr;
  Prebuilt<T> elems;
  if constexpr (Row::BUILD) elems = {e, a.m_s, a.p_s};
  else elems = p;
  const dim3 grid(unsigned(num_blocks(a.nblk, WIDE_WARPS)), unsigned(batch));
  size_t bytes[2];
  wide_smoother_bytes<Row>(d, bytes);
  int err = wide_smem_bytes(wide_rts_totals<Row>, bytes[0]);
  if (err == 0) err = wide_smem_bytes(wide_rts_outputs<T>, bytes[1]);
  if (err != 0) return err;
  wide_rts_totals<Row><<<grid, WIDE_WARPS * 32, bytes[0], stream>>>(a, p, d, steps, e);
  MF_CHECK_LAUNCH();
  err = launch_wide_scan<WideSmootherOp<T>, true, T>(a.totals, a.nblk, batch, d, levels,
                                                     stream);
  if (err != 0) return err;
  wide_rts_outputs<T><<<grid, WIDE_WARPS * 32, bytes[1], stream>>>(a, elems, d, steps);
  MF_CHECK_LAUNCH();
  return 0;
}

// wide_occupancy of pass 1, pass 3 and pass 2's launches of the smoother
// of Row (out[0..5]).
template <class Row>
int wide_smoother_occupancy(int d, int64_t* out) {
  using T = typename Row::T;
  size_t bytes[2];
  wide_smoother_bytes<Row>(d, bytes);
  int err = wide_occupancy(wide_rts_totals<Row>, bytes[0], out);
  if (err == 0) err = wide_occupancy(wide_rts_outputs<T>, bytes[1], out + 2);
  if (err == 0)
    err = wide_occupancy(wide_scan_level<WideSmootherOp<T>, true, true, T>,
                         wide_scan_bytes<T>(d), out + 4);
  return err;
}

// The same for the filter of Row.
template <class Row>
int wide_filter_occupancy(int d, int64_t* out) {
  using T = typename Row::T;
  const size_t bytes = wide_filter_bytes<Row>(d);
  int err = wide_occupancy(wide_filter_totals<Row>, bytes, out);
  if (err == 0) err = wide_occupancy(wide_filter_outputs<Row>, bytes, out + 2);
  if (err == 0)
    err = wide_occupancy(wide_scan_level<WideFilterOp<T>, false, true, T>,
                         wide_scan_bytes<T>(d), out + 4);
  return err;
}

}  // namespace mf
