// One instantiation of kernels 4 and 7 at o = 2..12 for d = 7..12 (see
// wide_info.cuh), for the dtype MF_T that ops/cuda_scan.py passes: with
// -DMF_WIDE_INFO_FILTER kernel 4 (launch_wide_info_filter), else kernel 7
// (launch_wide_info_adjoint).
#include "wide_info.cuh"

#ifdef MF_WIDE_INFO_FILTER
template int mf::launch_wide_info_filter<MF_T>(mf::FilterArgs<MF_T>, mf::GeneralPrior<MF_T>,
                                               MF_T*, int64_t, int, cudaStream_t);
#else
template int mf::launch_wide_info_adjoint<MF_T>(mf::GeneralAdjointPrior<MF_T>, MF_T*, int64_t,
                                                int64_t, int, cudaStream_t);
#endif
