"""Run configuration.

Replaces the reference's configuration surface — compile-time ``#define``s
(``utils.h:10-19``), environment variables (``OMP_NUM_THREADS`` etc.,
``main_mpi.bash:9-11``), and estimator selection by commenting code in and
out (``main.c:37-54``) — with one dataclass consumed by the CLI, the
pipeline, and the benchmark harness.
"""

from __future__ import annotations

import dataclasses
import enum


class EstimatorMode(enum.Enum):
    """Which semantics an estimator implements.

    MATH     — textbook-correct estimators; the primary API.  Identical to
               MATLAB for every estimator except PS-MMSE, where the MATLAB
               code builds Rhy = Rhh·F'·X4
               (WiFi_channel_estimation_PS_MMSE.m:30) although the true
               cross-covariance E[h·yᴴ] = Rhh·Fᴴ·X4ᴴ needs the *adjoint*
               of X4.  On the shipped capture the slip is invisible, but
               for complex (e.g. QPSK) tx symbols the MATLAB estimator
               decoheres (~10²× magnitude error vs the true channel).
    MATLAB   — the golden-model semantics (WiFi_channel_estimation_*.m),
               including the X4-conjugation slip above.
    C_PARITY — reproduces the C sequential implementation's quirks
               (SURVEY.md §2.5: real 'hermitian' utils.c:6, uniform
               divided-difference deltas main.c:108-118, Ryy=2σ²I from the
               addition bug utils.c:117, last-segment linear extrapolation
               main.c:96-99, ...).
    """

    MATH = "math"
    MATLAB = "matlab"
    C_PARITY = "c_parity"


ESTIMATOR_NAMES = (
    "lt_ls", "ps_linear", "ps_cubic", "ps_sinc", "ps_spline", "ps_wiener",
    "ps_mmse",
)


@dataclasses.dataclass(frozen=True)
class Config:
    # which estimators to run; "all" in the CLI expands to ESTIMATOR_NAMES
    estimators: tuple = ESTIMATOR_NAMES
    mode: EstimatorMode = EstimatorMode.MATH

    # batch of concurrent frames processed per step
    batch: int = 1024
    # complex compute dtype: "complex64" on the device, "complex128" for
    # CPU parity
    dtype: str = "complex64"

    # MMSE solve strategy: "sm" (Sherman-Morrison rank-1, speed of light),
    # "dense" (batched 53x53 Cholesky solve — the reference's
    # computational shape)
    mmse_solver: str = "sm"

    # mesh: number of data-parallel shards over frames, and over OFDM blocks
    dp: int = 1
    blk: int = 1

    # number of blocks averaged into pilot-based estimates
    avg_blocks: int = 4

    def mesh_shape(self):
        return {"dp": self.dp, "blk": self.blk}
