// One instantiation of the runtime-d kernels for d = 7..12 (see
// wide_scan.cuh), for the dtype MF_T and the element sources of the uniform
// grid (-DMF_UNIFORM: filter and RTS smoother), of the general grid
// (-DMF_GENERAL: filter, smoother scan and filter scan) or of the general
// Koopman backward (-DMF_GADJOINT) that ops/cuda_scan.py passes.
#include "general_adjoint.cuh"
#include "uniform_scan.cuh"

#ifdef MF_UNIFORM
template int mf::launch_wide_filter<mf::WideUniformRow<MF_T>>(
    mf::FilterArgs<MF_T>, mf::UniformPrior<MF_T>, MF_T*, int64_t, int, cudaStream_t);
template int mf::launch_wide_smoother<mf::WideUniformRtsRow<MF_T>>(
    mf::SmootherArgs<MF_T>, mf::UniformRts<MF_T>, MF_T*, int64_t, int, cudaStream_t);
template int mf::wide_smoother_occupancy<mf::WideUniformRtsRow<MF_T>>(int, int64_t*);
#endif
#ifdef MF_GENERAL
template int mf::launch_wide_filter<mf::WideGeneralRow<MF_T>>(
    mf::FilterArgs<MF_T>, mf::GeneralPrior<MF_T>, MF_T*, int64_t, int, cudaStream_t);
template int mf::launch_wide_smoother<mf::WidePrebuiltRts<MF_T>>(
    mf::SmootherArgs<MF_T>, mf::Prebuilt<MF_T>, MF_T*, int64_t, int, cudaStream_t);
template int mf::launch_wide_filter<mf::WidePrebuiltSteps<MF_T>>(
    mf::FilterArgs<MF_T>, mf::FilterPrebuilt<MF_T>, MF_T*, int64_t, int, cudaStream_t);
template int mf::wide_smoother_occupancy<mf::WidePrebuiltRts<MF_T>>(int, int64_t*);
template int mf::wide_filter_occupancy<mf::WidePrebuiltSteps<MF_T>>(int, int64_t*);
#endif
#ifdef MF_GADJOINT
template int mf::launch_wide_general_adjoint<MF_T>(mf::GeneralAdjointPrior<MF_T>, MF_T*,
                                                   int64_t, int64_t, int, cudaStream_t);
#endif
