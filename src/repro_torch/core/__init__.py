"""Algorithm 1 — calibration, partition, gain tables, the IP — and the
mixed-precision plans it produces."""
from repro_torch.core.mpconfig import MPPlan, as_assignment
from repro_torch.core.pipeline import (AMPOptions, CalibrationBundle,
                                       auto_mixed_precision, calibrate,
                                       predicted_loss_mse,
                                       tabulate_measured_gains)
from repro_torch.core.registry import BundleRegistry

__all__ = ["MPPlan", "as_assignment", "AMPOptions", "BundleRegistry",
           "CalibrationBundle", "auto_mixed_precision", "calibrate",
           "predicted_loss_mse", "tabulate_measured_gains"]
