"""Split-complex arithmetic: complex tensors as (re, im) real-plane pairs.

The production pipeline carries complex data as a ``Cplx`` pytree of two
real arrays — f32, bf16 or int8 planes — so that narrow storage dtypes,
which have no complex counterpart, can hold sample streams, and every
spectral transform is a real matmul.

This mirrors the reference's own representation boundary: its MPI layer
also ships complex matrices as separate Re/Im ``long double`` planes
(``complexToDouble``/``doubleToComplex``, utils.c:780-795) because
``MPI_LONG_DOUBLE`` has no complex variant.  Here the split is the
storage format, so there is no conversion anywhere on the hot path.

``Cplx`` is a registered dataclass pytree: it flows through ``jit``,
``vmap``, ``shard_map`` and sharding annotations with the two planes
treated as ordinary leaves.

Matmul precision: f32 operands run at ``Precision.HIGHEST`` (full f32 —
a GPU would otherwise take TF32's ~10-bit mantissa, far outside the
chain's parity tolerances); bf16 storage operands multiply as
bf16×bf16 with f32 accumulation, the precision the samples carry.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cplx:
    re: Any
    im: Any

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_complex(x, dtype=jnp.float32) -> "Cplx":
        x = np.asarray(x)
        return Cplx(
            jnp.asarray(x.real, dtype=dtype), jnp.asarray(x.imag, dtype=dtype)
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Cplx":
        z = jnp.zeros(shape, dtype)
        return Cplx(z, z)

    def to_complex(self) -> np.ndarray:
        return np.asarray(self.re, np.float64) + 1j * np.asarray(self.im, np.float64)

    # -- shape/dtype plumbing --------------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def __getitem__(self, idx) -> "Cplx":
        return Cplx(self.re[idx], self.im[idx])

    def reshape(self, *shape) -> "Cplx":
        return Cplx(self.re.reshape(*shape), self.im.reshape(*shape))

    def astype(self, dtype) -> "Cplx":
        return Cplx(self.re.astype(dtype), self.im.astype(dtype))

    # -- arithmetic -------------------------------------------------------------
    def __add__(self, o) -> "Cplx":
        if isinstance(o, Cplx):
            return Cplx(self.re + o.re, self.im + o.im)
        if isinstance(o, complex):
            return Cplx(self.re + o.real, self.im + o.imag)
        return Cplx(self.re + o, self.im)

    __radd__ = __add__

    def __sub__(self, o) -> "Cplx":
        if isinstance(o, Cplx):
            return Cplx(self.re - o.re, self.im - o.im)
        if isinstance(o, complex):
            return Cplx(self.re - o.real, self.im - o.imag)
        return Cplx(self.re - o, self.im)

    def __rsub__(self, o) -> "Cplx":
        return (-self) + o

    def __neg__(self) -> "Cplx":
        return Cplx(-self.re, -self.im)

    def __mul__(self, o) -> "Cplx":
        if isinstance(o, Cplx):
            return Cplx(
                self.re * o.re - self.im * o.im, self.re * o.im + self.im * o.re
            )
        if isinstance(o, complex):
            return Cplx(
                self.re * o.real - self.im * o.imag,
                self.re * o.imag + self.im * o.real,
            )
        return Cplx(self.re * o, self.im * o)  # real scalar/array

    __rmul__ = __mul__

    def __truediv__(self, o) -> "Cplx":
        if isinstance(o, Cplx):
            d = o.re * o.re + o.im * o.im
            return Cplx(
                (self.re * o.re + self.im * o.im) / d,
                (self.im * o.re - self.re * o.im) / d,
            )
        if isinstance(o, complex):
            return self / Cplx(jnp.asarray(o.real), jnp.asarray(o.imag))
        return Cplx(self.re / o, self.im / o)

    def conj(self) -> "Cplx":
        return Cplx(self.re, -self.im)

    def abs2(self):
        """|x|² — real array."""
        return self.re * self.re + self.im * self.im

    def sum(self, axis=None, keepdims=False) -> "Cplx":
        return Cplx(
            jnp.sum(self.re, axis=axis, keepdims=keepdims),
            jnp.sum(self.im, axis=axis, keepdims=keepdims),
        )

    def mean(self, axis=None, keepdims=False) -> "Cplx":
        return Cplx(
            jnp.mean(self.re, axis=axis, keepdims=keepdims),
            jnp.mean(self.im, axis=axis, keepdims=keepdims),
        )


# -- linear maps ----------------------------------------------------------------


def _mm(a, b):
    """a @ b with f32 accumulation: bf16 operands stay bf16 (the other
    side is rounded to bf16 to match), anything else runs at HIGHEST."""
    f32 = jnp.float32
    if jnp.bfloat16 in (jnp.result_type(a), jnp.result_type(b)):
        return jnp.matmul(jnp.asarray(a, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16),
                          preferred_element_type=f32)
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=f32)


def matmul(a: Cplx, b: Cplx) -> Cplx:
    """Complex matmul as four real matmuls (last-two-dims contraction)."""
    return Cplx(_mm(a.re, b.re) - _mm(a.im, b.im),
                _mm(a.re, b.im) + _mm(a.im, b.re))


def matmul_real(a: Cplx, w) -> Cplx:
    """x @ W for a *real* constant matrix W — two real matmuls."""
    return Cplx(_mm(a.re, w), _mm(a.im, w))


def apply_dft(x: Cplx, w_re, w_im) -> Cplx:
    """y = x @ W for a constant complex matrix given as two real planes.

    The whole 64-point FFT + circshift + truncation of
    WiFi_blocks_extraction.m is one precomputed (64, 53) matrix (see
    ops/specmats.py), so 'FFT' costs four (batch, 64) @ (64, 53) real
    matmuls.
    """
    return Cplx(_mm(x.re, w_re) - _mm(x.im, w_im),
                _mm(x.re, w_im) + _mm(x.im, w_re))


def vdot(a: Cplx, b: Cplx, axis=-1) -> Cplx:
    """aᴴ·b contraction along ``axis`` (sum of conj(a)*b)."""
    return (a.conj() * b).sum(axis=axis)


def dot(a: Cplx, b: Cplx, axis=-1) -> Cplx:
    """Plain (no conjugation) contraction along ``axis``."""
    return (a * b).sum(axis=axis)


def where(mask, a: Cplx, b: Cplx) -> Cplx:
    return Cplx(jnp.where(mask, a.re, b.re), jnp.where(mask, a.im, b.im))


def stack(xs, axis=0) -> Cplx:
    return Cplx(
        jnp.stack([x.re for x in xs], axis=axis),
        jnp.stack([x.im for x in xs], axis=axis),
    )
