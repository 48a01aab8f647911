// A g++ stand-in for the CUDA runtime, to rehearse the kernels of
// markovflow_tpu_torch/ops/csrc/ on the CPU (see build.py): each block's
// threads run as std::threads, blocks one after another; __syncthreads and
// __syncwarp are std::barriers (one per block, one per warp), the warp
// shuffles go through a buffer per warp, and the dynamic shared memory of a
// launch is a NaN-filled buffer.  Lanes are real threads, so a race between
// the lanes of a warp, which a GPU may hide, shows here.  A launch beyond
// the H100's limits (227 KB of shared memory, 1024 threads, 65535 rows of
// blocks) fails as cudaGetLastError() reports it.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
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
using Bar = std::barrier<>;
struct WarpState { Bar bar{32}; alignas(8) unsigned char buf[32][8]; };
inline thread_local uint3 tid, bid;
inline thread_local dim3 bdim, gdim;
inline thread_local unsigned char* dyn_smem;
inline thread_local Bar* block_bar;
inline thread_local WarpState* warp_state;
inline int last_error = 0;
inline size_t max_smem_seen = 0;

template <class F>
void launch(dim3 g, dim3 b, size_t smem, void*, F&& body) {
  const unsigned nt = b.x * b.y * b.z;
  if (smem > 232448 || nt > 1024 || nt % 32 != 0 || g.y > 65535) {
    std::fprintf(stderr, "shim: bad launch smem=%zu threads=%u grid.y=%u\n", smem, nt, g.y);
    last_error = 9;
    return;
  }
  if (smem > max_smem_seen) max_smem_seen = smem;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx) {
        std::vector<double> dyn(smem / 8 + 2, std::nan(""));
        Bar blk(nt);
        std::vector<std::unique_ptr<WarpState>> warps;
        for (unsigned w = 0; w < nt / 32; ++w) warps.emplace_back(new WarpState);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            tid = {t % b.x, (t / b.x) % b.y, t / (b.x * b.y)};
            bid = {bx, by, bz};
            bdim = b;
            gdim = g;
            dyn_smem = reinterpret_cast<unsigned char*>(dyn.data());
            block_bar = &blk;
            warp_state = warps[t / 32].get();
            body();
            warp_state->bar.arrive_and_drop();
            block_bar->arrive_and_drop();
          });
        for (auto& th : ts) th.join();
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
