"""Complex-dtype full RX chain — the CPU/golden path.

Composes the complex-dtype ops (tpu80211/ops) and estimators
(tpu80211/models) into the WiFi_RX.m pipeline (WiFi_RX.m:17-60).  Runs at
complex64/complex128 (tests, parity vs the 80-bit oracle, the on-card
reference of chip_smoke.py); the production path is the split-complex
twin in tpu80211/pipeline/sc.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from tpu80211 import constants as C
from tpu80211.config import EstimatorMode
from tpu80211.models import lt_ls, ps_interp, ps_mmse
from tpu80211.ops import (
    equalize,
    extract_blocks,
    noise_power_estimate,
    preamble_fft,
)


class RxOutputs(NamedTuple):
    h_lt: jnp.ndarray       # (…, 53)
    h_linear: jnp.ndarray   # (…, 53)
    h_cubic: jnp.ndarray    # (…, 53)
    h_sinc: jnp.ndarray     # (…, 53)
    h_spline: jnp.ndarray   # (…, 53)
    h_wiener: jnp.ndarray   # (…, 53) MMSE-optimal interpolation (beyond ref)
    h_mmse: jnp.ndarray     # (…, 53)
    eq: jnp.ndarray         # (…, 15, 53)
    ow2: jnp.ndarray        # (…,)


def rx_chain(
    tx_packet: jnp.ndarray,  # (…, 1200)
    rx_packet: jnp.ndarray,  # (…, 1200)
    tx_lptot: jnp.ndarray,   # (…, 160)
    rx_lptot: jnp.ndarray,   # (…, 160)
    mode: EstimatorMode = EstimatorMode.MATH,
    mmse_solver: str = "sm",
    avg_blocks: int = C.N_AVG_BLOCKS,
    equalize_with: str = "h_linear",
) -> RxOutputs:
    """WiFi_RX.m:17-60, batched over leading dims.

    ``equalize_with`` selects the PS estimate blended into the equalizer
    CFR; the golden model fixes PS-Linear (WiFi_RX.m:60)."""
    tx_pre = preamble_fft(tx_lptot)
    rx_pre = preamble_fft(rx_lptot)
    ow2 = noise_power_estimate(rx_lptot)
    tx_blocks = extract_blocks(tx_packet)
    rx_blocks = extract_blocks(rx_packet)
    return rx_chain_freq(
        tx_pre, rx_pre, tx_blocks, rx_blocks, ow2,
        mode=mode, mmse_solver=mmse_solver, avg_blocks=avg_blocks,
        equalize_with=equalize_with,
    )


def rx_chain_freq(
    tx_pre: jnp.ndarray,
    rx_pre: jnp.ndarray,
    tx_blocks: jnp.ndarray,
    rx_blocks: jnp.ndarray,
    ow2,
    mode: EstimatorMode = EstimatorMode.MATH,
    mmse_solver: str = "sm",
    avg_blocks: int = C.N_AVG_BLOCKS,
    equalize_with: str = "h_linear",
) -> RxOutputs:
    """Frequency-domain entry (the C drivers' view, inputs.h).

    ``equalize_with`` selects the PS estimate for the equalizer blend
    (WiFi_RX.m:60 uses PS-Linear)."""
    h_lt = lt_ls(tx_pre, rx_pre, mode=mode)
    kw = dict(mode=mode, avg_blocks=avg_blocks)
    h_lin = ps_interp(tx_blocks, rx_blocks, "linear", **kw)
    h_cub = ps_interp(tx_blocks, rx_blocks, "cubic", **kw)
    h_sin = ps_interp(tx_blocks, rx_blocks, "sinc", **kw)
    h_spl = ps_interp(tx_blocks, rx_blocks, "spline", **kw)
    h_wie = ps_interp(tx_blocks, rx_blocks, "wiener", **kw)
    h_mmse = ps_mmse(
        tx_blocks, rx_blocks, ow2, h_lt,
        mode=mode, solver=mmse_solver, avg_blocks=avg_blocks,
    )
    h_ps = {
        "h_linear": h_lin, "h_cubic": h_cub, "h_sinc": h_sin,
        "h_spline": h_spl, "h_wiener": h_wie, "h_mmse": h_mmse,
    }[equalize_with]
    eq = equalize(rx_blocks, h_lt, h_ps)
    return RxOutputs(
        h_lt, h_lin, h_cub, h_sin, h_spl, h_wie, h_mmse, eq, jnp.asarray(ow2)
    )
