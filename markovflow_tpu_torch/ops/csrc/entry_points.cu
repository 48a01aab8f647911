// C entry points of the scan kernels (see uniform_scan.cuh, general_scan.cuh
// and adjoint_scan.cuh).  The kernels themselves are instantiated in the
// *_inst.cu units, one per (kernel family, dtype, state dimension).
#include "adjoint_scan.cuh"
#include "general_scan.cuh"

#define MF_EXTERN(T, D)                                                                   \
  extern template int mf::launch_filter<mf::UniformRow<T, D, 1>>(                        \
      mf::FilterArgs<T>, mf::UniformPrior<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_smoother<mf::UniformRtsRow<T, D>>(                      \
      mf::SmootherArgs<T>, mf::UniformRts<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_filter<mf::GeneralRow<T, D, 1>>(                        \
      mf::FilterArgs<T>, mf::GeneralPrior<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_smoother<mf::PrebuiltRow<T, D>>(                        \
      mf::SmootherArgs<T>, mf::Prebuilt<T>, T*, int64_t, cudaStream_t);                   \
  extern template int mf::launch_adjoint<T, D>(mf::AdjointPrior<T>, T*, T*, int64_t,     \
                                               int64_t, cudaStream_t);
#define MF_EXTERN_ALL_D(T) \
  MF_EXTERN(T, 1) MF_EXTERN(T, 2) MF_EXTERN(T, 3) MF_EXTERN(T, 4) MF_EXTERN(T, 5) MF_EXTERN(T, 6)

MF_EXTERN_ALL_D(float)
MF_EXTERN_ALL_D(double)

// Scratch sizes in elements of T.
#define MF_DEFINE_SCRATCH(T, SUFFIX)                                                    \
  extern "C" int64_t mf_filter_scratch_##SUFFIX(int64_t d, int64_t batch, int64_t n) {  \
    MF_SWITCH_D(d, (mf::filter_scratch<T, D_>(batch, n)), -1)                           \
  }                                                                                     \
  extern "C" int64_t mf_smoother_scratch_##SUFFIX(int64_t d, int64_t batch, int64_t n) { \
    MF_SWITCH_D(d, (mf::smoother_scratch<T, D_>(batch, n)), -1)                         \
  }                                                                                     \
  extern "C" int64_t mf_adjoint_scratch_##SUFFIX(int64_t d, int64_t batch, int64_t n) { \
    MF_SWITCH_D(d, (mf::adjoint_scratch<T, D_>(batch, n)), -1)                          \
  }

MF_DEFINE_SCRATCH(float, f32)
MF_DEFINE_SCRATCH(double, f64)
MF_DEFINE_UNIFORM_ENTRY_POINTS(float, f32)
MF_DEFINE_UNIFORM_ENTRY_POINTS(double, f64)
MF_DEFINE_GENERAL_ENTRY_POINTS(float, f32)
MF_DEFINE_GENERAL_ENTRY_POINTS(double, f64)
MF_DEFINE_ADJOINT_ENTRY_POINTS(float, f32)
MF_DEFINE_ADJOINT_ENTRY_POINTS(double, f64)
