"""Bundle adjustment: hand-rolled Levenberg-Marquardt with analytic
Jacobians and Schur-complement landmark elimination — the accelerator
replacement for the reference's Ceres DENSE_SCHUR usage (SURVEY.md §2.12)."""

from .residuals import (Observations, residuals_and_jacobians, huber_weights,
                        apply_pose_update, total_cost)
from .core import (BAMode, BAStats, run_ba, run_ba_cg,
                   observations_from_keyframes)
