"""tpu80211 — a batched 802.11 OFDM channel-estimation framework.

A from-scratch JAX/XLA re-design of the capabilities of
``usmandroid/80211ParallelEstimation`` (five channel estimators, an
equalizer, a full RX chain, and the distributed-execution story), built
for accelerators:

* estimators are pure functions ``(tx, rx, ...) -> H``, ``vmap``-able over
  OFDM blocks and frames;
* interpolation (linear / cubic / sinc / spline) is a single static
  ``(4, 53)`` matrix applied as one matmul — the reference's per-subcarrier
  loops and its 5-group/4-rank MPI reduction tree (main_mpi.c:361-623)
  collapse into one matmul;
* the MMSE estimator exploits the rank-1 structure of
  ``Rhh = ifft(H_LT) ifft(H_LT)'`` (WiFi_channel_estimation_PS_MMSE.m:26)
  via Sherman-Morrison, with dense batched-solve paths kept for parity and
  benchmarking of the reference's 53x53 inverse (utils.c:141-170);
* distribution is a ``jax.sharding.Mesh`` over frames (and optionally OFDM
  blocks), replacing the reference's MPI communicators (main_mpi.c:62-93)
  with GSPMD collectives.
"""

from tpu80211 import constants
from tpu80211.config import Config, EstimatorMode

__version__ = "0.1.0"

__all__ = ["constants", "Config", "EstimatorMode", "__version__"]
