// One instantiation of the uniform-grid kernels (see uniform_scan.cuh), for
// the dtype MF_T and state dimension MF_D that ops/cuda_scan.py passes
// (-DMF_T=float -DMF_D=2, ...).  Compiling each (dtype, d) pair as its own
// unit lets the builds run in parallel.
#include "uniform_scan.cuh"

template int mf::launch_filter<MF_T, MF_D>(mf::FilterArgs<MF_T>, MF_T*, int64_t,
                                           cudaStream_t);
template int mf::launch_smoother<MF_T, MF_D>(mf::SmootherArgs<MF_T>, MF_T*, int64_t,
                                             cudaStream_t);
