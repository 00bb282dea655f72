"""Attack engines: PCFA with L-BFGS over a leading pair axis, I-FGSM, the
universal perturbation; losses, targets and box constraints."""

from pcfa_tpu_torch.attack.fgsm import (
    FGSMConfig,
    FGSMMetrics,
    FGSMResult,
    fgsm_attack,
    fgsm_step,
)
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
from pcfa_tpu_torch.attack.universal import (
    UniversalConfig,
    UniversalMetrics,
    universal_batch_attack,
    universal_init,
    unpack_deltas,
)

__all__ = [
    "FGSMConfig", "FGSMMetrics", "FGSMResult", "fgsm_attack", "fgsm_step",
    "LBFGSState", "lbfgs_init", "lbfgs_iteration", "lbfgs_run",
    "PCFAConfig", "PCFAMetrics", "PCFAResult", "pcfa_attack", "pcfa_init",
    "pcfa_outer_step",
    "UniversalConfig", "UniversalMetrics", "universal_batch_attack",
    "universal_init", "unpack_deltas",
]
