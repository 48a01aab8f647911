// One instantiation of the sources at o > d (see info_scan.cuh), for the
// dtype MF_T and state dimension MF_D that ops/cuda_scan.py passes: with
// -DMF_INFO_FILTERS kernels 4 and 1 (GeneralStepsW, UniformStepsW), else
// kernels 7 and 3 (GeneralAdjStepsW, UniformAdjStepsW); the uniform ones
// at d <= 5 only (o > d and o <= 6).
#include "info_scan.cuh"

#ifdef MF_INFO_FILTERS
template int mf::launch_general_filter<mf::GeneralStepsW<MF_T, MF_D>>(
    mf::FilterArgs<MF_T>, mf::GeneralPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
#if MF_D <= 5
template int mf::launch_general_filter<mf::UniformStepsW<MF_T, MF_D>>(
    mf::FilterArgs<MF_T>, mf::UniformPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
#endif
#else
template int mf::launch_general_adjoint<mf::GeneralAdjStepsW<MF_T, MF_D>>(
    mf::GeneralAdjointPrior<MF_T>, MF_T*, int64_t, int64_t, cudaStream_t);
#if MF_D <= 5
template int mf::launch_general_adjoint<mf::UniformAdjStepsW<MF_T, MF_D>>(
    mf::AdjointPrior<MF_T>, MF_T*, int64_t, int64_t, cudaStream_t);
#endif
#endif
