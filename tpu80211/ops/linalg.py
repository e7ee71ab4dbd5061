"""Complex linear-algebra helpers shared by the estimators.

Replacement for the reference's dense kernel library (``utils.c``): the
53×53 DFT matrix (main.c:22-26, WiFi_channel_estimation_PS_MMSE.m:16-22)
is a trace-time constant; the cofactor-expansion inverse
(utils.c:141-170) never exists — where the math needs ``inv(F)`` we use
the unitary-DFT identity ``F⁻¹ = Fᴴ/N``, and where it needs ``Ryy⁻¹·y``
we use the batched Cholesky solve below or the rank-1 Sherman-Morrison
closed form (see models/ps_mmse.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.cplx import Cplx


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int = C.N_SC) -> np.ndarray:
    """F[t, f] = exp(-2πi·t·f/n), float64 NumPy trace-time constant.

    Matches main.c:22-26 / WiFi_channel_estimation_PS_MMSE.m:16-22.
    """
    t = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(t, t) / n)


def idft_apply(x: jnp.ndarray, n: int = C.N_SC) -> jnp.ndarray:
    """ifft along the last axis — F⁻¹ @ x without ever forming a cofactor
    inverse (replaces inverse(F) at main.c:186 / ifft at ..._PS_MMSE.m:26)."""
    return jnp.fft.ifft(x, n=n, axis=-1)


def hermitian_quirk(m: jnp.ndarray) -> jnp.ndarray:
    """The reference's 'hermitian' (utils.c:3-7): res[c][r] = Re(M[r][c]) −
    Im(M[r][c]) — a *real* transpose-like map, NOT the conjugate transpose.
    Kept verbatim for C-parity mode (SURVEY.md §2.5.1)."""
    return jnp.swapaxes(m.real - m.imag, -1, -2).astype(m.dtype)


def addition_quirk(m1: jnp.ndarray, m2: jnp.ndarray) -> jnp.ndarray:
    """The reference's 'addition' (utils.c:111-121) computes M1+M1 and
    ignores M2 (SURVEY.md §2.5.2). Kept for C-parity mode."""
    del m2
    return m1 + m1


def hpd_solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x = a⁻¹·b for a batch of Hermitian positive-definite systems,
    (..., n, n) and (..., n, k), by Cholesky a = L·Lᴴ and two triangular
    solves — the factorization BASELINE.json names for the regularized
    53×53 MMSE system (main.c:201)."""
    lo = jnp.linalg.cholesky(a)
    y = jax.lax.linalg.triangular_solve(lo, b, left_side=True, lower=True)
    return jax.lax.linalg.triangular_solve(lo, y, left_side=True, lower=True,
                                           transpose_a=True, conjugate_a=True)


def rank1_solve(u: Cplx, rx: Cplx, ow2) -> Cplx:
    """z = (σ²I + u·uᴴ)⁻¹·rx per system — the reference's explicit
    regularized solve (BASELINE.json configs[3]), built and solved densely.

    u, rx: Cplx (..., n); ow2: real, broadcastable to (...,).  Computes
    in complex64 and returns Cplx f32 (..., n)."""
    uc = jax.lax.complex(u.re.astype(jnp.float32), u.im.astype(jnp.float32))
    rc = jax.lax.complex(rx.re.astype(jnp.float32), rx.im.astype(jnp.float32))
    n = uc.shape[-1]
    s2 = jnp.asarray(ow2, jnp.float32)[..., None, None]
    a = uc[..., :, None] * jnp.conj(uc[..., None, :]) + s2 * jnp.eye(
        n, dtype=jnp.float32)
    z = hpd_solve(a, rc[..., None])[..., 0]
    return Cplx(jnp.real(z), jnp.imag(z))
