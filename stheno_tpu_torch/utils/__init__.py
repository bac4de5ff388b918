from stheno_tpu_torch.utils.cost import cost_analysis, cost_summary
from stheno_tpu_torch.utils.testing import check_finite_gp, check_process_interface

__all__ = ["check_process_interface", "check_finite_gp", "cost_analysis", "cost_summary"]
