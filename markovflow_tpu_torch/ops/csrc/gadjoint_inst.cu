// One instantiation of the general-grid Koopman backward kernel (see
// general_adjoint.cuh), for the dtype MF_T and state dimension MF_D that
// ops/cuda_scan.py passes, as in uniform_inst.cu.
#include "general_adjoint.cuh"

template int mf::launch_general_adjoint<mf::GeneralAdjSteps<MF_T, MF_D>>(
    mf::GeneralAdjointPrior<MF_T>, MF_T*, int64_t, int64_t, cudaStream_t);
template int mf::general_adjoint_occupancy<mf::GeneralAdjSteps<MF_T, MF_D>>(int64_t*);
