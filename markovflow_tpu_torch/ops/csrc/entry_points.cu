// C entry points of the scan kernels (see uniform_scan.cuh, general_scan.cuh,
// adjoint_scan.cuh, general_adjoint.cuh and wide_scan.cuh).  The kernels
// themselves are instantiated in the *_inst.cu units, one per (kernel family,
// dtype, state dimension) for d <= 6, one per (family, dtype, d, o) for the
// o x o sites at d <= 6 (generalo_inst.cu: the filters; adjointo_inst.cu:
// the Koopman backwards) and one per (kernel family, dtype) for d = 7..12.
#include "adjoint_scan.cuh"

#define MF_EXTERN(T, D)                                                                   \
  extern template int mf::launch_general_filter<mf::UniformSteps<T, D>>(                 \
      mf::FilterArgs<T>, mf::UniformPrior<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_rts<mf::UniformRtsRow<T, D>>(                           \
      mf::SmootherArgs<T>, mf::UniformRts<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_general_filter<mf::GeneralSteps<T, D>>(                 \
      mf::FilterArgs<T>, mf::GeneralPrior<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_rts<mf::PrebuiltRts<T, D>>(                             \
      mf::SmootherArgs<T>, mf::Prebuilt<T>, T*, int64_t, cudaStream_t);                   \
  extern template int mf::launch_general_adjoint<mf::UniformAdjSteps<T, D>>(             \
      mf::AdjointPrior<T>, T*, int64_t, int64_t, cudaStream_t);                           \
  extern template int mf::launch_general_filter<mf::PrebuiltSteps<T, D>>(                \
      mf::FilterArgs<T>, mf::FilterPrebuilt<T>, T*, int64_t, cudaStream_t);               \
  extern template int mf::launch_general_adjoint<mf::GeneralAdjSteps<T, D>>(             \
      mf::GeneralAdjointPrior<T>, T*, int64_t, int64_t, cudaStream_t);                    \
  extern template int mf::general_filter_occupancy<mf::UniformSteps<T, D>>(int64_t*);    \
  extern template int mf::general_filter_occupancy<mf::GeneralSteps<T, D>>(int64_t*);    \
  extern template int mf::general_filter_occupancy<mf::PrebuiltSteps<T, D>>(int64_t*);   \
  extern template int mf::general_adjoint_occupancy<mf::GeneralAdjSteps<T, D>>(int64_t*); \
  extern template int mf::general_adjoint_occupancy<mf::UniformAdjSteps<T, D>>(int64_t*); \
  extern template int mf::rts_occupancy<mf::UniformRtsRow<T, D>>(int64_t*);              \
  extern template int mf::rts_occupancy<mf::PrebuiltRts<T, D>>(int64_t*);
#define MF_EXTERN_ALL_D(T) \
  MF_EXTERN(T, 1) MF_EXTERN(T, 2) MF_EXTERN(T, 3) MF_EXTERN(T, 4) MF_EXTERN(T, 5) MF_EXTERN(T, 6)

MF_EXTERN_ALL_D(float)
MF_EXTERN_ALL_D(double)

#define MF_EXTERN_ADJOINT_O(T, D, O, OBS)                                                \
  extern template int mf::launch_general_adjoint<mf::UniformAdjStepsO<T, D, O, OBS>>(    \
      mf::AdjointPrior<T>, T*, int64_t, int64_t, cudaStream_t);                           \
  extern template int mf::launch_general_adjoint<mf::GeneralAdjStepsO<T, D, O, OBS>>(    \
      mf::GeneralAdjointPrior<T>, T*, int64_t, int64_t, cudaStream_t);
#define MF_EXTERN_O(T, D, O)                                                             \
  extern template int mf::launch_general_filter<mf::GeneralStepsO<T, D, O>>(             \
      mf::FilterArgs<T>, mf::GeneralPrior<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_general_filter<mf::UniformStepsO<T, D, O>>(             \
      mf::FilterArgs<T>, mf::UniformPrior<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_general_filter<mf::GeneralStepsRankO<T, D, O>>(         \
      mf::FilterArgs<T>, mf::GeneralPrior<T>, T*, int64_t, cudaStream_t);                 \
  extern template int mf::launch_general_filter<mf::UniformStepsRankO<T, D, O>>(         \
      mf::FilterArgs<T>, mf::UniformPrior<T>, T*, int64_t, cudaStream_t);                 \
  MF_EXTERN_ADJOINT_O(T, D, O, false) MF_EXTERN_ADJOINT_O(T, D, O, true)
#define MF_EXTERN_O_BOTH(D, O) MF_EXTERN_O(float, D, O) MF_EXTERN_O(double, D, O)
MF_GENERAL_O_PAIRS(MF_EXTERN_O_BOTH)

#define MF_EXTERN_WIDE(T)                                                                 \
  extern template int mf::launch_wide_filter<mf::WideUniformRow<T>>(                     \
      mf::FilterArgs<T>, mf::UniformPrior<T>, T*, int64_t, int, cudaStream_t);            \
  extern template int mf::launch_wide_smoother<mf::WideUniformRtsRow<T>>(                 \
      mf::SmootherArgs<T>, mf::UniformRts<T>, T*, int64_t, int, cudaStream_t);            \
  extern template int mf::launch_wide_filter<mf::WideGeneralRow<T>>(                     \
      mf::FilterArgs<T>, mf::GeneralPrior<T>, T*, int64_t, int, cudaStream_t);            \
  extern template int mf::launch_wide_smoother<mf::WidePrebuiltRts<T>>(                   \
      mf::SmootherArgs<T>, mf::Prebuilt<T>, T*, int64_t, int, cudaStream_t);              \
  extern template int mf::launch_wide_filter<mf::WidePrebuiltSteps<T>>(                   \
      mf::FilterArgs<T>, mf::FilterPrebuilt<T>, T*, int64_t, int, cudaStream_t);          \
  extern template int mf::launch_wide_general_adjoint<T>(mf::GeneralAdjointPrior<T>, T*,  \
                                                         int64_t, int64_t, int,           \
                                                         cudaStream_t);                   \
  extern template int mf::wide_smoother_occupancy<mf::WideUniformRtsRow<T>>(int,          \
                                                                            int64_t*);    \
  extern template int mf::wide_smoother_occupancy<mf::WidePrebuiltRts<T>>(int, int64_t*);  \
  extern template int mf::wide_filter_occupancy<mf::WidePrebuiltSteps<T>>(int, int64_t*);

MF_EXTERN_WIDE(float)
MF_EXTERN_WIDE(double)

// Scratch sizes in elements of T (-1 for a state (or output) dimension with
// no kernel; the filters and the Koopman backwards take the output dim o,
// 1 or a pair of MF_GENERAL_O_PAIRS, after d; the Koopman backwards then
// obs, 0 where the call writes no observation term: the lean route's
// scratch, which at o > 1 also keeps pass 1's stage 1 where its source
// keeps it):
// mf_smoother_scratch_* for the smoother scan; at d <= 6 the filters, the
// Koopman backwards and the smoothers also keep each thread's in-block
// prefix or suffix (the uniform backward also its partial sums),
// and the uniform smoother's scratch keeps the E legs of its elements at
// d = 7..12.
#define MF_DEFINE_SCRATCH(T, SUFFIX)                                                    \
  extern "C" int64_t mf_uniform_filter_scratch_##SUFFIX(int64_t d, int64_t o,          \
                                                        int64_t batch, int64_t n) {    \
    if (o != 1)                                                                         \
      MF_SWITCH_DO(d, o, (mf::general_filter_scratch_max<mf::UniformStepsO<T, D_, O_>,   \
                                                           mf::UniformStepsRankO<T, D_, O_>>( \
                             batch, n)),                                                \
                   -1)                                                                  \
    if (d >= mf::WIDE_MIN_D && d <= mf::WIDE_MAX_D)                                     \
      return mf::wide_filter_scratch<T>(int(d), batch, n);                              \
    MF_SWITCH_D(d, (mf::general_filter_scratch<mf::UniformSteps<T, D_>>(batch, n)), -1) \
  }                                                                                     \
  extern "C" int64_t mf_filter_scan_scratch_##SUFFIX(int64_t d, int64_t batch,          \
                                                     int64_t n) {                       \
    if (d >= mf::WIDE_MIN_D && d <= mf::WIDE_MAX_D)                                     \
      return mf::wide_filter_scratch<T>(int(d), batch, n);                              \
    MF_SWITCH_D(d, (mf::general_filter_scratch<mf::PrebuiltSteps<T, D_>>(batch, n)), -1) \
  }                                                                                     \
  extern "C" int64_t mf_smoother_scratch_##SUFFIX(int64_t d, int64_t batch, int64_t n) { \
    if (d >= mf::WIDE_MIN_D && d <= mf::WIDE_MAX_D)                                     \
      return mf::wide_smoother_scratch<T>(int(d), batch, n);                            \
    MF_SWITCH_D(d, (mf::rts_scratch<mf::PrebuiltRts<T, D_>>(batch, n)), -1)             \
  }                                                                                     \
  /* the general filter at o x o sites (o = 1, or a pair of */                         \
  /* MF_GENERAL_O_PAIRS) */                                                             \
  extern "C" int64_t mf_general_filter_scratch_##SUFFIX(int64_t d, int64_t o,          \
                                                        int64_t batch, int64_t n) {    \
    if (o != 1)                                                                         \
      MF_SWITCH_DO(d, o, (mf::general_filter_scratch_max<mf::GeneralStepsO<T, D_, O_>,   \
                                                           mf::GeneralStepsRankO<T, D_, O_>>( \
                             batch, n)),                                                \
                   -1)                                                                  \
    if (d >= mf::WIDE_MIN_D && d <= mf::WIDE_MAX_D)                                     \
      return mf::wide_filter_scratch<T>(int(d), batch, n);                              \
    MF_SWITCH_D(d, (mf::general_filter_scratch<mf::GeneralSteps<T, D_>>(batch, n)), -1) \
  }                                                                                     \
  extern "C" int64_t mf_general_adjoint_scratch_##SUFFIX(int64_t d, int64_t o,         \
                                                         int64_t obs, int64_t batch,   \
                                                         int64_t n) {                  \
    if (o != 1 && obs == 0)                                                             \
      MF_SWITCH_DO(d, o,                                                                \
                   (mf::general_adjoint_scratch<mf::GeneralAdjStepsO<T, D_, O_, false>>(batch, n)), \
                   -1)                                                                  \
    if (o != 1)                                                                         \
      MF_SWITCH_DO(d, o,                                                                \
                   (mf::general_adjoint_scratch<mf::GeneralAdjStepsO<T, D_, O_, true>>(batch, n)), \
                   -1)                                                                  \
    if (d >= mf::WIDE_MIN_D && d <= mf::WIDE_MAX_D)                                     \
      return mf::wide_smoother_scratch<T>(int(d), batch, n);                            \
    MF_SWITCH_D(d, (mf::general_adjoint_scratch<mf::GeneralAdjSteps<T, D_>>(batch, n)), -1) \
  }                                                                                     \
  extern "C" int64_t mf_uniform_smoother_scratch_##SUFFIX(int64_t d, int64_t batch,     \
                                                          int64_t n) {                  \
    if (d >= mf::WIDE_MIN_D && d <= mf::WIDE_MAX_D)                                     \
      return mf::wide_smoother_scratch<T>(int(d), batch, n,                             \
                                          mf::WideUniformRtsRow<T>::BUILD);             \
    MF_SWITCH_D(d, (mf::rts_scratch<mf::UniformRtsRow<T, D_>>(batch, n)), -1)           \
  }                                                                                     \
  extern "C" int64_t mf_adjoint_scratch_##SUFFIX(int64_t d, int64_t o, int64_t obs,    \
                                                 int64_t batch, int64_t n) {            \
    if (o != 1 && obs == 0)                                                             \
      MF_SWITCH_DO(d, o,                                                                \
                   (mf::general_adjoint_scratch<mf::UniformAdjStepsO<T, D_, O_, false>>(batch, n)), \
                   -1)                                                                  \
    if (o != 1)                                                                         \
      MF_SWITCH_DO(d, o,                                                                \
                   (mf::general_adjoint_scratch<mf::UniformAdjStepsO<T, D_, O_, true>>(batch, n)), \
                   -1)                                                                  \
    MF_SWITCH_D(d, (mf::general_adjoint_scratch<mf::UniformAdjSteps<T, D_>>(batch, n)), -1) \
  }                                                                                     \
  /* the shared memory a warp and the warps an SM keeps resident of passes */           \
  /* 1, 3 and 2 (out[0..5]) of kernel 2, 5 or 6 at d = 7..12 */                         \
  extern "C" int mf_wide_occupancy_##SUFFIX(int64_t kernel, int64_t d, int64_t* out) {  \
    if (d < mf::WIDE_MIN_D || d > mf::WIDE_MAX_D) return int(cudaErrorInvalidValue);    \
    if (kernel == 2)                                                                    \
      return mf::wide_smoother_occupancy<mf::WideUniformRtsRow<T>>(int(d), out);        \
    if (kernel == 5)                                                                    \
      return mf::wide_smoother_occupancy<mf::WidePrebuiltRts<T>>(int(d), out);          \
    if (kernel == 6)                                                                    \
      return mf::wide_filter_occupancy<mf::WidePrebuiltSteps<T>>(int(d), out);          \
    return int(cudaErrorInvalidValue);                                                  \
  }                                                                                     \
  /* pass_occupancy of passes 1, 3 and 2 (out[0..11]) of kernel 1, 2, 3, 4, 5, */      \
  /* 6 or 7 at d <= 6 */                                                                \
  extern "C" int mf_general_occupancy_##SUFFIX(int64_t kernel, int64_t d, int64_t* out) { \
    if (kernel == 1)                                                                    \
      MF_SWITCH_D(d, (mf::general_filter_occupancy<mf::UniformSteps<T, D_>>(out)),      \
                  int(cudaErrorInvalidValue))                                           \
    if (kernel == 2)                                                                    \
      MF_SWITCH_D(d, (mf::rts_occupancy<mf::UniformRtsRow<T, D_>>(out)),                \
                  int(cudaErrorInvalidValue))                                           \
    if (kernel == 3)                                                                    \
      MF_SWITCH_D(d, (mf::general_adjoint_occupancy<mf::UniformAdjSteps<T, D_>>(out)),  \
                  int(cudaErrorInvalidValue))                                           \
    if (kernel == 4)                                                                    \
      MF_SWITCH_D(d, (mf::general_filter_occupancy<mf::GeneralSteps<T, D_>>(out)),      \
                  int(cudaErrorInvalidValue))                                           \
    if (kernel == 5)                                                                    \
      MF_SWITCH_D(d, (mf::rts_occupancy<mf::PrebuiltRts<T, D_>>(out)),                  \
                  int(cudaErrorInvalidValue))                                           \
    if (kernel == 6)                                                                    \
      MF_SWITCH_D(d, (mf::general_filter_occupancy<mf::PrebuiltSteps<T, D_>>(out)),     \
                  int(cudaErrorInvalidValue))                                           \
    if (kernel == 7)                                                                    \
      MF_SWITCH_D(d, (mf::general_adjoint_occupancy<mf::GeneralAdjSteps<T, D_>>(out)),  \
                  int(cudaErrorInvalidValue))                                           \
    return int(cudaErrorInvalidValue);                                                  \
  }

MF_DEFINE_SCRATCH(float, f32)
MF_DEFINE_SCRATCH(double, f64)
MF_DEFINE_UNIFORM_ENTRY_POINTS(float, f32)
MF_DEFINE_UNIFORM_ENTRY_POINTS(double, f64)
MF_DEFINE_GENERAL_ENTRY_POINTS(float, f32)
MF_DEFINE_GENERAL_ENTRY_POINTS(double, f64)
MF_DEFINE_ADJOINT_ENTRY_POINTS(float, f32)
MF_DEFINE_ADJOINT_ENTRY_POINTS(double, f64)
MF_DEFINE_GENERAL_ADJOINT_ENTRY_POINTS(float, f32)
MF_DEFINE_GENERAL_ADJOINT_ENTRY_POINTS(double, f64)
