from .cuda_scan import (filter_pipeline_uniform, filter_pipeline_uniform_plain,
                        smoother_pipeline_uniform,
                        smoother_pipeline_uniform_plain)
from .kalman import filter_pipeline_tl, smoother_pipeline_tl
from .scans import scan_tl
