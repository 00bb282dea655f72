from pcfa_tpu_torch.metrics.flow_errors import (
    compute_AAE,
    compute_EE,
    compute_AEE,
    compute_BP,
    compute_Fl,
    get_all_error_measures,
    get_all_error_measures_area,
)

__all__ = [
    "compute_AAE",
    "compute_EE",
    "compute_AEE",
    "compute_BP",
    "compute_Fl",
    "get_all_error_measures",
    "get_all_error_measures_area",
]
