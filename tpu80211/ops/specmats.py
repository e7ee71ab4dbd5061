"""Precomputed spectral matrices.

The block extraction is one (batch·15, 64) @ (64, 53) matmul rather than
a generic FFT: the reference chain immediately fftshifts (circshift by
26) and truncates to 53 used subcarriers (WiFi_blocks_extraction.m:7-9,
WiFi_RX.m:22-29), and the shift and truncation fold into the DFT matrix
at build time, so "CP strip → FFT → shift → slice" is a single
contraction that also takes bf16 storage operands directly.  Whether a
batched FFT is faster on the GPU is an open measurement (PERF.md).

All matrices are float64 NumPy constants baked at trace time.
"""

from __future__ import annotations

import functools

import numpy as np

from tpu80211 import constants as C


@functools.lru_cache(maxsize=None)
def block_dft() -> tuple[np.ndarray, np.ndarray]:
    """(64, 53) real/imag planes of the combined FFT64+fftshift+truncate.

    out[k] = Σ_n x[n]·exp(−2πi·n·(k−26)/64)  —  the (k−26) implements
    circshift(·, 26) followed by keeping bins 0..52.
    """
    n = np.arange(C.N_FFT)[:, None]
    k = np.arange(C.N_SC)[None, :] - C.FFT_SHIFT
    w = np.exp(-2j * np.pi * n * k / C.N_FFT)
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


@functools.lru_cache(maxsize=None)
def dft53() -> tuple[np.ndarray, np.ndarray]:
    """(53, 53) DFT matrix F[t,f] = exp(−2πi·t·f/53) (main.c:22-26)."""
    t = np.arange(C.N_SC)
    w = np.exp(-2j * np.pi * np.outer(t, t) / C.N_SC)
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


@functools.lru_cache(maxsize=None)
def idft53() -> tuple[np.ndarray, np.ndarray]:
    """(53, 53) inverse DFT = conj(F)/53 — replaces the reference's
    cofactor-expansion inverse of F (main.c:186, utils.c:141-170)."""
    re, im = dft53()
    return re / C.N_SC, -im / C.N_SC
