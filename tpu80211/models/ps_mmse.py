"""PS-MMSE channel estimator.

Golden-model math (WiFi_channel_estimation_PS_MMSE.m):

    h   = ifft(H_LT)                      (:26)
    Rhh = h·hᴴ                            — rank ONE
    per block:  X4 = diag(tx)             (:29)
                Rhy = Rhh·Fᴴ·X4           (:30)
                Ryy = X4·F·Rhh·Fᴴ·X4ᴴ+σ²I (:31)
                H   = F·Rhy·pinv(Ryy)·rx  (:32)
    H_MMSE = mean of the first 4 block estimates (:34)

Because Rhh is a rank-1 outer product, with v = F·h and u = tx⊙v:

    Ryy      = σ²I + u·uᴴ                 (positive definite ⇒ pinv = inv)
    F·Rhy    = v·(X4ᴴv)ᴴ = v·(conj(tx)⊙v)ᴴ
    Ryy⁻¹·y  = (y − u·(uᴴy)/(σ²+‖u‖²))/σ²          (Sherman-Morrison)
    H        = v · scalar

so the reference's 53×53 cofactor-expansion inverse (utils.c:141-170,
2×53²×52³/3 ≈ 2.6e8 flops — the entire target of its MPI/OpenMP effort)
reduces *exactly* to a handful of length-53 dot products per block.  That
is the "sm" solver — the speed-of-light path.  The "dense" solver builds
Ryy explicitly and uses a batched Cholesky solve, preserving the
reference's computational shape for benchmarking (BASELINE.json
configs[3]).

C-parity mode reproduces main.c:148-212 with its quirks (SURVEY.md §2.5):
the real 'hermitian' (utils.c:6), the addition bug making Ryy = 2σ²I
(utils.c:117), X4 carrying only the 4 pilot entries (main.c:166-178), and
single-block processing.  The aliased GEMM at main.c:195 only affects
values that the addition bug then discards, so it needs no emulation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.config import EstimatorMode
from tpu80211.ops.linalg import (dft_matrix, hermitian_quirk, hpd_solve,
                                 idft_apply)

_X4_PILOT_MASK = np.zeros((C.N_SC,))
_X4_PILOT_MASK[list(C.PILOT_IDX)] = 1.0


def _cdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """aᴴ·b along the last axis, keepdims-free."""
    return jnp.sum(jnp.conj(a) * b, axis=-1)


def _mmse_block_sm(v, tx, rx, ow2, matlab_conj: bool):
    """Sherman-Morrison closed form for one block (broadcast over leading dims).

    v: (..., 53) = F·ifft(H_LT);  tx, rx: (..., 53);  ow2: scalar or (...,).
    ``matlab_conj`` selects the MATLAB X4-conjugation slip (Rhy uses X4,
    ..._PS_MMSE.m:30) instead of the correct X4ᴴ — see EstimatorMode.MATH.
    """
    u = tx * v
    denom = ow2 + _cdot(u, u).real              # σ² + ‖u‖²
    if matlab_conj:
        # MATLAB: s = (X4ᴴv)ᴴ·Ryy⁻¹·rx — general SM form (cancels
        # catastrophically as σ²→0; parity mode, run at f64)
        upp = jnp.conj(tx) * v
        s = (_cdot(upp, rx) - _cdot(upp, u) * _cdot(u, rx) / denom) / ow2
    else:
        # MATH: upp = u makes SM collapse to uᴴrx/(σ²+‖u‖²) — exactly
        # stable for any σ² ≥ 0 (no σ² division, no cancellation)
        s = _cdot(u, rx) / denom
    return v * s[..., None]


def _mmse_block_dense(v, tx, rx, ow2, solve_fn, matlab_conj: bool):
    """Dense path: explicitly build Ryy = σ²I + u·uᴴ and solve.

    Matches the reference's computational shape (53×53 inverse per block,
    main.c:201 / ..._PS_MMSE.m:32) for benchmarking; mathematically equal
    to the sm path.
    """
    u = tx * v
    eye = jnp.eye(C.N_SC, dtype=v.dtype)
    ow2_m = ow2[..., None, None] if jnp.ndim(ow2) else ow2  # (...,1,1) vs eye
    ryy = ow2_m * eye + u[..., :, None] * jnp.conj(u[..., None, :])
    z = solve_fn(ryy, rx[..., :, None])[..., 0]       # Ryy⁻¹·rx
    s = _cdot(jnp.conj(tx) * v if matlab_conj else u, z)
    return v * s[..., None]


def ps_mmse(
    tx_blocks: jnp.ndarray,  # (..., n_blocks, 53)
    rx_blocks: jnp.ndarray,  # (..., n_blocks, 53)
    ow2,                     # σ²: scalar, or per-frame (...,) matching h_lt
    h_lt: jnp.ndarray,       # (..., 53) LT-LS estimate
    mode: EstimatorMode = EstimatorMode.MATH,
    solver: str = "sm",
    avg_blocks: int = C.N_AVG_BLOCKS,
) -> jnp.ndarray:
    """Frame-level MMSE estimate, shape (..., 53)."""
    if mode == EstimatorMode.C_PARITY:
        return _ps_mmse_c_parity(tx_blocks, rx_blocks, ow2, h_lt)

    # v = F·ifft(H_LT) is *exactly* H_LT (F is the same DFT the ifft
    # inverts, WiFi_channel_estimation_PS_MMSE.m:16-26) — so Rhh = h·hᴴ
    # gives F·Rhh·Fᴴ = v·vᴴ with v = H_LT, no transforms needed.
    v = h_lt
    tx = tx_blocks[..., :avg_blocks, :]
    rx = rx_blocks[..., :avg_blocks, :]
    vb = v[..., None, :]                         # broadcast over blocks
    # ow2: scalar, or per-frame with shape == leading dims of h_lt (...,);
    # add the block axis so a (B,) vector never broadcasts into blocks
    ow2 = jnp.asarray(ow2)
    if ow2.ndim:
        ow2 = ow2[..., None]
    mlc = mode == EstimatorMode.MATLAB
    if solver == "sm":
        h = _mmse_block_sm(vb, tx, rx, ow2, mlc)
    elif solver == "dense":
        h = _mmse_block_dense(vb, tx, rx, ow2, hpd_solve, mlc)
    else:
        raise ValueError(f"unknown mmse solver: {solver!r}")
    return jnp.mean(h, axis=-2)


def _ps_mmse_c_parity(tx_blocks, rx_blocks, ow2, h_lt):
    """Reproduce main.c:148-212 exactly (block 0 only, quirks included).

    With the quirks, the whole chain collapses to
        H = F·ifft(H_LT) · ⟨w2, rx⟩ / (2σ²)
    where w2 = ((Re−Im)(ifft(H_LT)) @ hermitian_quirk(F)) ⊙ x4diag and the
    dot product carries no conjugation (reference 'multiply', utils.c:16-31).
    """
    tx = tx_blocks[..., 0, :]
    rx = rx_blocks[..., 0, :]
    t1 = idft_apply(h_lt)                                   # invF·H_LT (main.c:186-187)
    w = (t1.real - t1.imag).astype(t1.dtype)                # hermitian quirk row (utils.c:6)
    fh = jnp.asarray(
        hermitian_quirk(jnp.asarray(dft_matrix(), dtype=t1.dtype))
    )                                                        # main.c:183
    x4diag = tx * jnp.asarray(_X4_PILOT_MASK, dtype=t1.real.dtype)  # main.c:166-178
    w2 = (w @ fh) * x4diag                                   # Rhy row factor (main.c:191-192)
    s = jnp.sum(w2 * rx, axis=-1) / (2.0 * ow2)              # Ryy = 2σ²I (utils.c:117)
    return jnp.fft.fft(t1, axis=-1) * s[..., None]           # F·(...) (main.c:203-208)
