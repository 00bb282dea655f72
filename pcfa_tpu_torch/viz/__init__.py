from pcfa_tpu_torch.viz.quickvis import (
    quickvis_flow,
    quickvis_tensor,
    quickvisualization_flow,
    quickvisualization_tensor,
)
from pcfa_tpu_torch.viz.flow_plot import (
    colorplot_light,
    colorplot_dark,
    errorplot,
    errorplot_Fl,
    middlebury_colorwheel,
)

__all__ = [
    "quickvis_flow",
    "quickvis_tensor",
    "quickvisualization_flow",
    "quickvisualization_tensor",
    "colorplot_light",
    "colorplot_dark",
    "errorplot",
    "errorplot_Fl",
    "middlebury_colorwheel",
]
