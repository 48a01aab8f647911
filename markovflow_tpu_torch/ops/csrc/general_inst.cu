// One instantiation of the general-grid filter, smoother-scan and filter-scan
// kernels (see general_scan.cuh), for the dtype MF_T and state dimension MF_D
// that ops/cuda_scan.py passes, as in uniform_inst.cu.
#include "general_scan.cuh"

template int mf::launch_general_filter<mf::GeneralSteps<MF_T, MF_D>>(
    mf::FilterArgs<MF_T>, mf::GeneralPrior<MF_T>, MF_T*, int64_t, cudaStream_t);
template int mf::general_filter_occupancy<mf::GeneralSteps<MF_T, MF_D>>(int64_t*);
template int mf::launch_smoother<mf::PrebuiltRow<MF_T, MF_D>>(
    mf::SmootherArgs<MF_T>, mf::Prebuilt<MF_T>, MF_T*, int64_t, cudaStream_t);
template int mf::launch_general_filter<mf::PrebuiltSteps<MF_T, MF_D>>(
    mf::FilterArgs<MF_T>, mf::FilterPrebuilt<MF_T>, MF_T*, int64_t, cudaStream_t);
template int mf::general_filter_occupancy<mf::PrebuiltSteps<MF_T, MF_D>>(int64_t*);
