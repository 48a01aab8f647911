// One instantiation of the uniform-grid filter and smoother kernels (see
// uniform_scan.cuh), for the dtype MF_T and state dimension MF_D that
// ops/cuda_scan.py passes (-DMF_T=float -DMF_D=2, ...).  Compiling each
// (kernel family, dtype, d) as its own unit lets the builds run in parallel.
#include "uniform_scan.cuh"

template int mf::launch_general_filter<mf::UniformSteps<MF_T, MF_D>>(
    mf::FilterArgs<MF_T>, mf::UniformPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
template int mf::general_filter_occupancy<mf::UniformSteps<MF_T, MF_D>>(int64_t*);
template int mf::launch_rts<mf::UniformRtsRow<MF_T, MF_D>>(
    mf::SmootherArgs<MF_T>, mf::UniformRts<MF_T>, MF_T*, int64_t, cudaStream_t);
template int mf::rts_occupancy<mf::UniformRtsRow<MF_T, MF_D>>(int64_t*);
