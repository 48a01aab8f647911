// One instantiation of the uniform-grid Koopman backward kernel (see
// adjoint_scan.cuh), for the dtype MF_T and state dimension MF_D that
// ops/cuda_scan.py passes, as in uniform_inst.cu.
#include "adjoint_scan.cuh"

template int mf::launch_general_adjoint<mf::UniformAdjSteps<MF_T, MF_D>>(
    mf::AdjointPrior<MF_T>, MF_T*, int64_t, int64_t, cudaStream_t);
template int mf::general_adjoint_occupancy<mf::UniformAdjSteps<MF_T, MF_D>>(int64_t*);
