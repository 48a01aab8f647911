// One instantiation of the filters at o x o sites (see general_scan.cuh,
// GeneralStepsO and GeneralStepsRankO, and uniform_scan.cuh, UniformStepsO
// and UniformStepsRankO: kernels 4 and 1, each in the element form and,
// for a lam constant over the steps, the rank-o form), for the dtype MF_T,
// state dimension MF_D and output dimension MF_O that ops/cuda_scan.py
// passes, one of MF_GENERAL_O_PAIRS.
#include "uniform_scan.cuh"

template int mf::launch_general_filter<mf::GeneralStepsO<MF_T, MF_D, MF_O>>(
    mf::FilterArgs<MF_T>, mf::GeneralPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
template int mf::launch_general_filter<mf::UniformStepsO<MF_T, MF_D, MF_O>>(
    mf::FilterArgs<MF_T>, mf::UniformPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
template int mf::launch_general_filter<mf::GeneralStepsRankO<MF_T, MF_D, MF_O>>(
    mf::FilterArgs<MF_T>, mf::GeneralPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
template int mf::launch_general_filter<mf::UniformStepsRankO<MF_T, MF_D, MF_O>>(
    mf::FilterArgs<MF_T>, mf::UniformPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
