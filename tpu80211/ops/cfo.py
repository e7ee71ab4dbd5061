"""Carrier-frequency-offset (CFO) estimation/correction and pilot-based
common-phase-error (CPE) correction — receiver synchronization stages the
reference *lacks* but its own dataset demands.

The shipped capture was generated with a 20 kHz frequency offset
(WiFi_RX.m:9 ``FO = 20e3``) and the reference chain has no correction
stage for it.  (Measurement note: on the frozen capture itself the
impairment was evidently compensated upstream — the LTS repeats differ by
<1e-4 rad and per-block pilot phases are <1°, so these stages are ≈no-ops
there; the capture's residual EVM is channel-estimation error.  On frames
carrying an actual 20 kHz offset the uncorrected chain's equalized output
is garbage and these stages recover it — tests/test_cfo.py.)  The two
standard 802.11 synchronization steps:

* **CFO (Moose) estimate** from the two identical 64-sample LTS repeats of
  the long preamble: a CFO of ``eps`` cycles/sample rotates the second
  repeat by ``exp(2πi·eps·64)`` relative to the first, so the angle of the
  lag-64 correlation gives eps exactly (unambiguous for |eps| < 1/128,
  i.e. |FO| < 156 kHz at 20 MS/s — 20 kHz is well inside).
* **Derotation** of the time-domain streams by ``exp(−2πi·eps·n)`` on a
  time base continuous from preamble through packet.
* **CPE correction**: after equalization, each OFDM block's residual
  *common* phase (from residual CFO, sampling phase, and the unknown
  preamble→packet gap) is read off the 4 known pilots and removed per
  block.

All split-complex (Cplx) — runs on the production path.  Everything is
elementwise/small-reduction work.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.cplx import Cplx

_TWO_PI = 2.0 * np.pi


def estimate_cfo(rx_lptot: Cplx) -> jnp.ndarray:
    """Moose CFO estimate from the long preamble, (…,) cycles/sample.

    ``rx_lptot`` is the (…, 160) long preamble: [32-sample CP | LTS | LTS].
    Returns ``eps`` such that the received stream is rotated by
    ``exp(+2πi·eps·n)``; multiply FO_hz = eps · sample_rate to get Hz.
    """
    r1 = rx_lptot[..., -2 * C.N_FFT : -C.N_FFT].astype(jnp.float32)  # earlier
    r2 = rx_lptot[..., -C.N_FFT :].astype(jnp.float32)               # later
    c = (r1.conj() * r2).sum(axis=-1)
    return jnp.arctan2(c.im, c.re) / (_TWO_PI * C.N_FFT)


def derotate(x: Cplx, eps: jnp.ndarray, start: int = 0) -> Cplx:
    """Multiply x[…, n] by exp(−2πi·eps·(start+n)); keeps storage dtype.

    ``start`` anchors the time base: the preamble starts at 0 and the data
    packet immediately after it (start=C.PREAMBLE_SAMPLES), so the
    derotated streams stay mutually phase-coherent.
    """
    n = x.shape[-1]
    t = start + jnp.arange(n, dtype=jnp.float32)
    ang = (-_TWO_PI) * eps[..., None].astype(jnp.float32) * t
    rot = Cplx(jnp.cos(ang), jnp.sin(ang))
    return (x.astype(jnp.float32) * rot).astype(x.dtype)


def correct_cfo(
    rx_packet: Cplx, rx_lptot: Cplx, eps: jnp.ndarray | None = None
) -> tuple[Cplx, Cplx, jnp.ndarray]:
    """Estimate (unless given) and remove the CFO from both rx streams.

    Returns (rx_packet', rx_lptot', eps).  The packet is assumed to follow
    the preamble contiguously in time; any constant phase error from a gap
    between them is removed per block by :func:`cpe_correct`.
    """
    if eps is None:
        eps = estimate_cfo(rx_lptot)
    return (
        derotate(rx_packet, eps, start=C.PREAMBLE_SAMPLES),
        derotate(rx_lptot, eps, start=0),
        eps,
    )


def cpe_correct(eq: Cplx, tx_blocks: Cplx) -> Cplx:
    """Remove each block's common phase error using the 4 known pilots.

    ``eq`` (…, 15, 53) are equalized symbols, ``tx_blocks`` the known
    transmitted spectra.  Per block b the pilot-weighted residual rotation
    g_b = Σ_p eq[b,p]·conj(tx[b,p]) is computed and eq[b] is rotated by
    conj(g_b)/|g_b| — phase-only (amplitude errors are the equalizer's
    job, and pilot noise should not modulate data amplitude).
    """
    p = np.asarray(C.PILOT_IDX)
    zp = eq[..., p].astype(jnp.float32)          # (…, 15, 4)
    tp = tx_blocks[..., p].astype(jnp.float32)
    g = (zp * tp.conj()).sum(axis=-1)            # (…, 15)
    mag = jnp.sqrt(g.abs2())
    mag = jnp.where(mag == 0.0, jnp.ones((), mag.dtype), mag)
    rot = Cplx((g.re / mag)[..., None], (-g.im / mag)[..., None])
    return (eq.astype(jnp.float32) * rot).astype(eq.dtype)
