// One instantiation of the general-grid filter at o x o sites (see
// general_scan.cuh, GeneralStepsO), for the dtype MF_T, state dimension MF_D
// and output dimension MF_O that ops/cuda_scan.py passes, one of
// MF_GENERAL_O_PAIRS.
#include "general_scan.cuh"

template int mf::launch_general_filter<mf::GeneralStepsO<MF_T, MF_D, MF_O>>(
    mf::FilterArgs<MF_T>, mf::GeneralPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
