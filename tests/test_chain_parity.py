"""End-to-end parity gates: the full chain in every semantic mode vs the
native C++ 80-bit oracle composed the same way.

This is the "bit-exact-to-tolerance CFR parity" acceptance gate of
BASELINE.json: estimator outputs and equalized symbols of the JAX paths
(complex f64 and split-complex f32) must match the native oracle chain on
the shipped capture.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu80211 import constants as C
from tpu80211.config import EstimatorMode
from tpu80211.cplx import Cplx
from tpu80211.parity import oracle_native as nat
from tpu80211.pipeline import rx as rx_cpx
from tpu80211.pipeline import sc


def _rel(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _native_chain(cap, mode):
    h_lt = nat.lt_ls(cap.tx_preamble_fft, cap.rx_preamble_fft, mode)
    h = {
        "h_lt": h_lt,
        "h_linear": nat.ps_interp(cap.tx_symb, cap.rx_symb, "linear", mode),
        "h_cubic": nat.ps_interp(cap.tx_symb, cap.rx_symb, "cubic", mode),
        "h_sinc": nat.ps_interp(cap.tx_symb, cap.rx_symb, "sinc", mode),
        "h_spline": nat.ps_interp(cap.tx_symb, cap.rx_symb, "spline", mode),
        "h_mmse": nat.ps_mmse(cap.tx_symb, cap.rx_symb, cap.ow2, h_lt, mode),
    }
    # the golden chain equalizes with PS-Linear (WiFi_RX.m:60)
    h["eq"] = nat.equalize(cap.rx_symb, h_lt, h["h_linear"])
    return h


@pytest.mark.parametrize("mode", list(EstimatorMode))
def test_complex_chain_vs_native(capture, mode):
    """Complex-dtype f64 pipeline == native long-double chain, all modes."""
    out = rx_cpx.rx_chain_freq(
        jnp.asarray(capture.tx_preamble_fft),
        jnp.asarray(capture.rx_preamble_fft),
        jnp.asarray(capture.tx_symb),
        jnp.asarray(capture.rx_symb),
        capture.ow2,
        mode=mode,
    )
    want = _native_chain(capture, mode)
    for name in ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline", "h_mmse", "eq"):
        got = getattr(out, name)
        assert _rel(got, want[name]) < 1e-8, (mode, name)


def test_sc_chain_vs_native_math(capture):
    """Split-complex f32 pipeline == native chain (MATH mode) within
    the f32/SNR tolerance — the production-path parity gate."""
    out = sc.rx_chain_freq(
        Cplx.from_complex(capture.tx_preamble_fft),
        Cplx.from_complex(capture.rx_preamble_fft),
        Cplx.from_complex(capture.tx_symb),
        Cplx.from_complex(capture.rx_symb),
        jnp.asarray(capture.ow2, jnp.float32) * jnp.ones(()),
    )
    want = _native_chain(capture, EstimatorMode.MATH)
    tols = {
        "h_lt": 1e-5,
        "h_linear": 1e-5,
        "h_cubic": 1e-5,
        "h_sinc": 1e-5,
        "h_spline": 1e-5,
        # MMSE magnitudes scale as 1/σ² (σ²≈1e-7): f32 relative error grows
        "h_mmse": 5e-3,
        "eq": 1e-4,
    }
    for name, tol in tols.items():
        got = getattr(out, name)
        got = got.to_complex() if isinstance(got, Cplx) else got
        assert _rel(got, want[name]) < tol, (name, _rel(got, want[name]))
