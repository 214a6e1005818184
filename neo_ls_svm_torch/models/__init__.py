"""Model layer: the estimator, its routing policy, the primal and dual solvers, and the
calibrators."""

from neo_ls_svm_torch.models.cqr import CoherentLinearQuantileRegressor
from neo_ls_svm_torch.models.estimator import NeoLSSVM
from neo_ls_svm_torch.models.isotonic import IsotonicCalibrator

__all__ = ["CoherentLinearQuantileRegressor", "IsotonicCalibrator", "NeoLSSVM"]
