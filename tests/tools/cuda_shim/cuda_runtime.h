// A g++ stand-in for the CUDA runtime, to rehearse the kernels of
// markovflow_tpu_torch/ops/csrc/ on the CPU (see build.py): each block's
// threads run as fibers (ucontext) on the calling thread, blocks one after
// another; __syncthreads and __syncwarp are barriers (one per block, one per
// warp) at which a lane's fiber gives way to the next ready lane, the warp
// shuffles go through a buffer per warp, and the dynamic shared memory of a
// launch is a NaN-filled buffer.  Between two barriers each lane runs alone,
// in turn, in ascending order of lanes in even blocks and descending in odd
// ones: a lane that reads what another lane writes without a barrier between
// them reads the NaN fill or a stale value in one of the two orders.  A
// barrier that some lane never reaches aborts the process ("shim: lanes
// stuck").  A launch beyond the H100's limits (227 KB of shared memory, 1024
// threads, 65535 rows of blocks) fails as cudaGetLastError() reports it.
//
// Fibers, not threads: with a thread per lane, each barrier put hundreds of
// threads to sleep and woke them on a few cores, and the kernel's scheduling
// of them (system time above user time) made a run's length depend on the
// load of the machine.
#pragma once
#include <deque>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>
#include <ucontext.h>
using std::fabs;
using std::log;
using std::sqrt;

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static

struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };

namespace mf_shim {
// The lanes of the block that runs: one fiber each, with a stack of its own.
struct Lane {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  uint3 tid;
  struct WarpState* warp;
};
inline constexpr size_t kStack = 512 * 1024;
inline std::vector<Lane> lanes;
inline std::deque<unsigned> ready;
inline ucontext_t sched_ctx;
inline unsigned cur = 0, finished = 0;

// std::barrier's arrive_and_wait and arrive_and_drop between fibers: the
// last lane to arrive makes the waiting ones ready and runs on.
class Bar {
 public:
  explicit Bar(int n) : expected_(n), next_(n) {}
  void arrive_and_wait() {
    if (arrive(false)) return;
    waiting_.push_back(cur);
    swapcontext(&lanes[cur].ctx, &sched_ctx);
  }
  void arrive_and_drop() { arrive(true); }

 private:
  bool arrive(bool drop) {
    if (drop) --next_;
    if (++arrived_ < expected_) return false;
    arrived_ = 0;
    expected_ = next_;
    for (unsigned l : waiting_) ready.push_back(l);
    waiting_.clear();
    return true;
  }
  std::vector<unsigned> waiting_;
  int arrived_ = 0, expected_, next_;
};

struct WarpState { Bar bar{32}; alignas(8) unsigned char buf[32][8]; };
inline uint3 tid, bid;
inline dim3 bdim, gdim;
inline unsigned char* dyn_smem;
inline Bar* block_bar;
inline WarpState* warp_state;
inline int last_error = 0;
inline size_t max_smem_seen = 0;
inline void (*lane_body)(void*);
inline void* lane_arg;

inline void lane_main() {
  lane_body(lane_arg);
  warp_state->bar.arrive_and_drop();
  block_bar->arrive_and_drop();
  ++finished;
}

template <class F>
void launch(dim3 g, dim3 b, size_t smem, void*, F&& body) {
  const unsigned nt = b.x * b.y * b.z;
  if (smem > 232448 || nt > 1024 || nt % 32 != 0 || g.y > 65535) {
    std::fprintf(stderr, "shim: bad launch smem=%zu threads=%u grid.y=%u\n", smem, nt, g.y);
    last_error = 9;
    return;
  }
  if (smem > max_smem_seen) max_smem_seen = smem;
  if (lanes.size() < nt) lanes.resize(nt);
  lane_body = [](void* f) { (*static_cast<F*>(f))(); };
  lane_arg = &body;
  bdim = b;
  gdim = g;
  unsigned parity = 0;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx, parity ^= 1) {
        std::vector<double> dyn(smem / 8 + 2, std::nan(""));
        Bar blk{int(nt)};
        std::vector<std::unique_ptr<WarpState>> warps;
        for (unsigned w = 0; w < nt / 32; ++w) warps.emplace_back(new WarpState);
        bid = {bx, by, bz};
        dyn_smem = reinterpret_cast<unsigned char*>(dyn.data());
        block_bar = &blk;
        for (unsigned t = 0; t < nt; ++t) {
          Lane& l = lanes[t];
          if (!l.stack) l.stack.reset(new char[kStack]);
          getcontext(&l.ctx);
          l.ctx.uc_stack = {l.stack.get(), 0, kStack};
          l.ctx.uc_link = &sched_ctx;
          makecontext(&l.ctx, lane_main, 0);
          l.tid = {t % b.x, (t / b.x) % b.y, t / (b.x * b.y)};
          l.warp = warps[t / 32].get();
          ready.push_back(parity ? nt - 1 - t : t);
        }
        finished = 0;
        while (!ready.empty()) {
          cur = ready.front();
          ready.pop_front();
          tid = lanes[cur].tid;
          warp_state = lanes[cur].warp;
          swapcontext(&sched_ctx, &lanes[cur].ctx);
        }
        if (finished != nt) {
          std::fprintf(stderr, "shim: lanes stuck at a barrier (%u of %u finished)\n", finished, nt);
          std::abort();
        }
      }
}
}  // namespace mf_shim

#define threadIdx (mf_shim::tid)
#define blockIdx (mf_shim::bid)
#define blockDim (mf_shim::bdim)
#define gridDim (mf_shim::gdim)

inline void __syncthreads() { mf_shim::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { mf_shim::warp_state->bar.arrive_and_wait(); }

// Lane src's v (v itself when src is outside the warp).
template <typename T>
T mf_shim_shfl_from(T v, int src) {
  auto* w = mf_shim::warp_state;
  const int lane = mf_shim::tid.x & 31;
  std::memcpy(w->buf[lane], &v, sizeof(T));
  w->bar.arrive_and_wait();
  T r = v;
  if (src >= 0 && src < 32) std::memcpy(&r, w->buf[src], sizeof(T));
  w->bar.arrive_and_wait();
  return r;
}
template <typename T> T __shfl_sync(unsigned, T v, int src) { return mf_shim_shfl_from(v, src); }
template <typename T> T __shfl_up_sync(unsigned, T v, int off) {
  return mf_shim_shfl_from(v, int(mf_shim::tid.x & 31) - off);
}
template <typename T> T __shfl_down_sync(unsigned, T v, int off) {
  return mf_shim_shfl_from(v, int(mf_shim::tid.x & 31) + off);
}

// Loads and stores with a cache hint: plain ones here.
template <typename T> T __ldcs(const T* p) { return *p; }
template <typename T> void __stcs(T* p, T v) { *p = v; }

template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes, sharedSizeBytes;
};
// The stand-in knows nothing of a kernel's resources.
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, K) {
  *attr = cudaFuncAttributes{};
  return cudaSuccess;
}
// The stand-in runs one block at a time.
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { int e = mf_shim::last_error; mf_shim::last_error = 0; return e; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 232448; return 0; }
