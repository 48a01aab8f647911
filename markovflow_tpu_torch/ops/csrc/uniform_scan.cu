// C entry points of the uniform-grid filter and smoother kernels (see
// uniform_scan.cuh).  The kernels themselves are instantiated in the
// uniform_scan_inst.cu units, one per (dtype, state dimension).
#include "uniform_scan.cuh"

#define MF_EXTERN(T, D)                                                                   \
  extern template int mf::launch_filter<T, D>(mf::FilterArgs<T>, T*, int64_t,           \
                                              cudaStream_t);                             \
  extern template int mf::launch_smoother<T, D>(mf::SmootherArgs<T>, T*, int64_t,       \
                                                cudaStream_t);
#define MF_EXTERN_ALL_D(T) \
  MF_EXTERN(T, 1) MF_EXTERN(T, 2) MF_EXTERN(T, 3) MF_EXTERN(T, 4) MF_EXTERN(T, 5) MF_EXTERN(T, 6)

MF_EXTERN_ALL_D(float)
MF_EXTERN_ALL_D(double)

MF_DEFINE_ENTRY_POINTS(float, f32)
MF_DEFINE_ENTRY_POINTS(double, f64)
