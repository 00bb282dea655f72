"""Attack engine: PCFA with L-BFGS over a leading pair axis, losses,
targets and box constraints."""

from pcfa_tpu_torch.attack.lbfgs import (
    LBFGSState,
    lbfgs_init,
    lbfgs_iteration,
    lbfgs_run,
)
from pcfa_tpu_torch.attack.pcfa import (
    PCFAConfig,
    PCFAMetrics,
    PCFAResult,
    pcfa_attack,
    pcfa_init,
    pcfa_outer_step,
)

__all__ = [
    "LBFGSState", "lbfgs_init", "lbfgs_iteration", "lbfgs_run",
    "PCFAConfig", "PCFAMetrics", "PCFAResult", "pcfa_attack", "pcfa_init",
    "pcfa_outer_step",
]
