// One instantiation of the Koopman backwards at o x o sites (see
// general_adjoint.cuh, GeneralAdjStepsO, and adjoint_scan.cuh,
// UniformAdjStepsO: kernels 7 and 3), each with the observation terms and
// without (the lean pass 3; pass 1 is the same kernel for both), for the
// dtype MF_T, state dimension MF_D and output dimension MF_O that
// ops/cuda_scan.py passes, one of MF_GENERAL_O_PAIRS.
#include "adjoint_scan.cuh"

#define MF_INST_ADJOINT_O(OBS)                                                                \
  template int mf::launch_general_adjoint<mf::GeneralAdjStepsO<MF_T, MF_D, MF_O, OBS>>(      \
      mf::GeneralAdjointPrior<MF_T>, MF_T*, int64_t, int64_t, cudaStream_t);                 \
  template int mf::launch_general_adjoint<mf::UniformAdjStepsO<MF_T, MF_D, MF_O, OBS>>(      \
      mf::AdjointPrior<MF_T>, MF_T*, int64_t, int64_t, cudaStream_t);
MF_INST_ADJOINT_O(false)
MF_INST_ADJOINT_O(true)
