"""Pilot-subcarrier LS estimators with linear / cubic / sinc / spline
interpolation.

The reference computes, per OFDM block, the four pilot ratios
H_PILOTS = rx[pilots]/tx[pilots] and interpolates them to all 53
subcarriers with scalar loops (main.c:77-146,
WiFi_channel_estimation_PS_{Linear,Cubic,Sinc,Third}.m), then averages the
estimates of the first 4 blocks (..._PS_Linear.m:23).

Design: the interpolation is a static (4, 53) matrix (ops/interp.py), so
the whole estimator over a batch of frames is

    H = (rx[..., pilots] / tx[..., pilots]) @ W      # one einsum

which also subsumes the reference's MPI 5-group×4-rank reduction strategy
(main_mpi.c:361-623): the per-group 4-term MPI_Reduce is the matmul's inner
dimension.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.config import EstimatorMode
from tpu80211.ops.interp import interp_matrix

_PILOTS = np.asarray(C.PILOT_IDX)


def pilot_ratios(tx: jnp.ndarray, rx: jnp.ndarray) -> jnp.ndarray:
    """(..., 53) symbols → (..., 4) pilot ratios rx[p]/tx[p] (main.c:82-84)."""
    return rx[..., _PILOTS] / tx[..., _PILOTS]


def ps_interp_per_block(
    tx: jnp.ndarray,  # (..., 53)
    rx: jnp.ndarray,  # (..., 53)
    kind: str,
    mode: EstimatorMode = EstimatorMode.MATH,
    channel_model: str | None = None,
    snr_db: float | None = None,
) -> jnp.ndarray:
    """Single-block estimate, (..., 53)."""
    w = jnp.asarray(
        interp_matrix(kind, mode, channel_model=channel_model,
                      snr_db=snr_db),
        dtype=tx.dtype,
    )  # (4, 53)
    hp = pilot_ratios(tx, rx)
    return hp @ w


def ps_interp(
    tx_blocks: jnp.ndarray,  # (..., n_blocks, 53)
    rx_blocks: jnp.ndarray,  # (..., n_blocks, 53)
    kind: str,
    mode: EstimatorMode = EstimatorMode.MATH,
    avg_blocks: int = C.N_AVG_BLOCKS,
    channel_model: str | None = None,
    snr_db: float | None = None,
) -> jnp.ndarray:
    """Frame-level estimate: per-block interpolation, averaged over the
    first ``avg_blocks`` blocks (..._PS_Linear.m:23), shape (..., 53).

    In C-parity mode the reference processes only block 0 (main.c:16,29-33
    — SURVEY.md §2.5.8), i.e. ``avg_blocks=1``.
    ``channel_model``/``snr_db``: the Wiener prior (kind="wiener" only).
    """
    if mode == EstimatorMode.C_PARITY:
        avg_blocks = 1
    h = ps_interp_per_block(
        tx_blocks[..., :avg_blocks, :], rx_blocks[..., :avg_blocks, :],
        kind, mode, channel_model=channel_model, snr_db=snr_db,
    )
    return jnp.mean(h, axis=-2)
