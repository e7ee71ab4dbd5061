"""Unit tests for the split-complex Cplx algebra — the load-bearing
storage format of the production path (tpu80211/cplx.py).

Every operation is checked against numpy complex arithmetic on random
operands, plus pytree/jit/vmap plumbing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu80211 import cplx as cx
from tpu80211.cplx import Cplx

RNG = np.random.default_rng(0)


def _rand(shape):
    return RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)


def _close(got: Cplx, want, tol=1e-5):
    g = got.to_complex()
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.abs(w).max(), 1e-30)
    assert np.abs(g - w).max() / scale < tol


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_binary_ops(op):
    a = _rand((4, 7))
    b = _rand((4, 7))
    ca, cb = Cplx.from_complex(a), Cplx.from_complex(b)
    got = {
        "add": ca + cb, "sub": ca - cb, "mul": ca * cb, "div": ca / cb,
    }[op]
    want = {"add": a + b, "sub": a - b, "mul": a * b, "div": a / b}[op]
    _close(got, want)


def test_scalar_and_complex_operands():
    a = _rand((5,))
    ca = Cplx.from_complex(a)
    _close(ca * 2.5, a * 2.5)
    _close(2.5 * ca, a * 2.5)
    _close(ca + (1 + 2j), a + (1 + 2j))
    _close((1 + 2j) + ca, a + (1 + 2j))
    _close(ca - (0.5 - 1j), a - (0.5 - 1j))
    _close((0.5 - 1j) - ca, (0.5 - 1j) - a)
    _close(ca * (1 - 1j), a * (1 - 1j))
    _close(ca / (2 - 1j), a / (2 - 1j))
    _close(-ca, -a)


def test_conj_abs2_reductions():
    a = _rand((3, 6))
    ca = Cplx.from_complex(a)
    _close(ca.conj(), np.conj(a))
    np.testing.assert_allclose(np.asarray(ca.abs2()), np.abs(a) ** 2, rtol=1e-5)
    _close(ca.sum(axis=0), a.sum(axis=0))
    _close(ca.mean(axis=-1), a.mean(axis=-1))


def test_matmul_and_dft():
    a = _rand((4, 8))
    b = _rand((8, 5))
    got = cx.matmul(Cplx.from_complex(a), Cplx.from_complex(b))
    _close(got, a @ b, tol=1e-4)

    w = _rand((8, 5))
    got2 = cx.apply_dft(
        Cplx.from_complex(a),
        jnp.asarray(w.real, jnp.float32),
        jnp.asarray(w.imag, jnp.float32),
    )
    _close(got2, a @ w, tol=1e-4)

    wr = RNG.standard_normal((8, 5))
    got3 = cx.matmul_real(Cplx.from_complex(a), jnp.asarray(wr, jnp.float32))
    _close(got3, a @ wr, tol=1e-4)


def test_vdot_dot_where_stack():
    a = _rand((6,))
    b = _rand((6,))
    _close(cx.vdot(Cplx.from_complex(a), Cplx.from_complex(b)),
           np.vdot(a, b))
    _close(cx.dot(Cplx.from_complex(a), Cplx.from_complex(b)),
           np.sum(a * b))
    mask = np.array([True, False, True, False, True, False])
    got = cx.where(mask, Cplx.from_complex(a), Cplx.from_complex(b))
    _close(got, np.where(mask, a, b))
    st = cx.stack([Cplx.from_complex(a), Cplx.from_complex(b)])
    _close(st, np.stack([a, b]))


def test_pytree_jit_vmap():
    a = _rand((8, 6))
    ca = Cplx.from_complex(a)

    @jax.jit
    def f(x: Cplx) -> Cplx:
        return (x * x.conj() + x).astype(jnp.float32)

    _close(f(ca), a * np.conj(a) + a)

    vf = jax.vmap(lambda x: x.sum())
    _close(vf(ca), a.sum(axis=-1))

    leaves, treedef = jax.tree.flatten(ca)
    assert len(leaves) == 2
    back = jax.tree.unflatten(treedef, leaves)
    _close(back, a)


def test_indexing_reshape():
    a = _rand((4, 10))
    ca = Cplx.from_complex(a)
    _close(ca[1:3, ::2], a[1:3, ::2])
    _close(ca.reshape(2, 20), a.reshape(2, 20))
    idx = np.asarray([0, 3, 7])
    _close(ca[..., idx], a[..., idx])
