from .adjoint import (adjoint_pipeline, adjoint_pipeline_plain,
                      adjoint_pipeline_uniform, adjoint_pipeline_uniform_plain)
from .cuda_scan import (filter_pipeline, filter_pipeline_plain, filter_scan,
                        filter_scan_plain, filter_pipeline_uniform,
                        filter_pipeline_uniform_plain, smoother_pipeline_uniform,
                        smoother_pipeline_uniform_plain, smoother_scan,
                        smoother_scan_plain)
from .kalman import (FilterElements, SmootherElements, filter_pipeline_tl,
                     filter_scan_tl, log_likelihood_sites, make_filter_elements,
                     parallel_filter, parallel_smoother, posterior_ssm_params,
                     posterior_ssm_params_tl, predicted_moments,
                     sequential_filter, sequential_smoother,
                     smoother_pipeline_tl)
from .scans import scan_tl
