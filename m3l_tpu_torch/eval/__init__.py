from .tacbench import TestTaskSL, TestForceSL, TestSlipSL, TestPoseSL, TestGraspSL, TestTextileSL, classification_metrics, smooth_slip_predictions  # noqa: F401
from .plots import plot_correlation, plot_forces_error, plot_confusion_matrix, plot_slip_trajectory, plot_delta_forces  # noqa: F401
