"""Split-complex implementation of the full RX chain.

The production path carries complex data as ``Cplx`` re/im planes
(tpu80211/cplx.py) so that samples can be stored in bf16 or int8, and
expresses every spectral transform as a real matmul
(tpu80211/ops/specmats.py):

  * block extraction "CP-strip → FFT64 → fftshift → 53 bins"
    (WiFi_blocks_extraction.m:5-10) is one (…,15,64) @ (64,53) contraction;
  * the MMSE ifft/fft pair (WiFi_channel_estimation_PS_MMSE.m:26, :32) are
    (…,53) @ (53,53) contractions with the DFT/IDFT matrices;
  * pilot interpolation is the static (4,53) matrix of ops/interp.py;
  * everything else (LS ratios, Sherman-Morrison dots, equalization) is
    elementwise work fused by XLA.

Semantics match the complex-dtype models (tpu80211/models/*) exactly; the
test suite checks sc.* == models.* == the 80-bit oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.config import EstimatorMode
from tpu80211.cplx import Cplx, apply_dft, matmul, matmul_real
from tpu80211.ops import specmats
from tpu80211.ops.interp import interp_matrix

_PILOTS = np.asarray(C.PILOT_IDX)
_DC = np.zeros((C.N_SC,), dtype=bool)
_DC[C.DC_IDX] = True


# -- front end -----------------------------------------------------------------


def extract_blocks(packet: Cplx) -> Cplx:
    """(…, 1200) time-domain packet → (…, 15, 53) frequency-domain blocks."""
    *lead, n = packet.shape
    assert n == C.PACKET_SAMPLES, packet.shape
    blocks = packet.reshape(*lead, C.N_BLOCKS, C.SAMP_PER_BLOCK)[..., C.N_CP :]
    w_re, w_im = specmats.block_dft()
    return apply_dft(
        blocks, jnp.asarray(w_re, jnp.float32), jnp.asarray(w_im, jnp.float32)
    )


def preamble_fft(lptot: Cplx) -> Cplx:
    """(…, 160) long preamble → (…, 53) averaged LTS spectrum (WiFi_RX.m:19-29).

    Computes at f32 even under bf16 storage: LT-LS and PS-MMSE rest on
    this spectrum alone, and a bf16 repeat average and DFT matrix would
    add their rounding to the stored samples' (at 20 dB SNR they cost
    LT-LS about 0.28 dB of NMSE; the preamble is 160 of a frame's 1360
    samples)."""
    *lead, n = lptot.shape
    assert n == C.PREAMBLE_SAMPLES, lptot.shape
    lptot = lptot.astype(jnp.float32)
    rep1 = lptot[..., -C.N_FFT :]
    rep2 = lptot[..., -2 * C.N_FFT : -C.N_FFT]
    avg = (rep1 + rep2) * 0.5
    w_re, w_im = specmats.block_dft()
    return apply_dft(
        avg, jnp.asarray(w_re, jnp.float32), jnp.asarray(w_im, jnp.float32)
    )


def noise_power(rx_lptot: Cplx) -> jnp.ndarray:
    """σ² from the LTS repeat difference (WiFi_RX.m:31); real (…,) array.
    f32 accumulation regardless of storage dtype."""
    rep1 = rx_lptot[..., -C.N_FFT :]
    rep2 = rx_lptot[..., -2 * C.N_FFT : -C.N_FFT]
    d = (rep2 - rep1).astype(jnp.float32)
    return jnp.sum(d.abs2(), axis=-1) / (2 * C.N_FFT)


# -- estimators ----------------------------------------------------------------


def lt_ls(tx_pre: Cplx, rx_pre: Cplx) -> Cplx:
    """LT-LS estimate (…, 53); DC forced to 0 (WiFi_channel_estimation_LT_LS.m).

    Computes at f32 even under bf16 storage — per-subcarrier ratios are
    precision-critical and tiny relative to the frame arrays."""
    tx_pre = tx_pre.astype(jnp.float32)
    rx_pre = rx_pre.astype(jnp.float32)
    denom = tx_pre.abs2()  # conj(X)·X is real
    denom = jnp.where(_DC, jnp.ones((), denom.dtype), denom)
    num = tx_pre.conj() * rx_pre
    h = Cplx(num.re / denom, num.im / denom)
    zero = jnp.zeros((), h.re.dtype)
    return Cplx(jnp.where(_DC, zero, h.re), jnp.where(_DC, zero, h.im))


def pilot_ratios(tx: Cplx, rx: Cplx) -> Cplx:
    """(…, 53) → (…, 4) pilot ratios rx[p]/tx[p] (f32 compute)."""
    return rx[..., _PILOTS].astype(jnp.float32) / tx[..., _PILOTS].astype(
        jnp.float32
    )


def ps_interp(
    tx_blocks: Cplx,
    rx_blocks: Cplx,
    kind: str,
    mode: EstimatorMode = EstimatorMode.MATH,
    avg_blocks: int = C.N_AVG_BLOCKS,
    channel_model: str | None = None,
    snr_db: float | None = None,
) -> Cplx:
    """Pilot-LS + static-matrix interpolation, averaged over the first
    ``avg_blocks`` blocks (…, 53).  ``channel_model``/``snr_db``: the
    receiver's channel prior for kind="wiener" (ops/interp.py)."""
    if mode == EstimatorMode.C_PARITY:
        avg_blocks = 1
    hp = pilot_ratios(
        tx_blocks[..., :avg_blocks, :], rx_blocks[..., :avg_blocks, :]
    )  # (…, avg, 4)
    # (4, 53); complex for kind="wiener"
    w = interp_matrix(kind, mode, channel_model=channel_model, snr_db=snr_db)
    # interpolation is linear: mean-of-interpolated == interpolate-the-mean
    # (WiFi_channel_estimation_PS_Linear.m:23 averages the interpolated
    # blocks; doing the 4-block mean first saves 3/4 of the matmul work)
    hp_bar = hp.mean(axis=-2)
    if np.iscomplexobj(w):
        return matmul(hp_bar, Cplx.from_complex(w))
    return matmul_real(hp_bar, jnp.asarray(w, jnp.float32))


def _vdot(a: Cplx, b: Cplx) -> Cplx:
    """aᴴ·b along the last axis."""
    return (a.conj() * b).sum(axis=-1)


def ps_mmse_sm(
    tx_blocks: Cplx,
    rx_blocks: Cplx,
    ow2: jnp.ndarray,  # (…,) real noise power
    h_lt: Cplx,        # (…, 53)
    avg_blocks: int = C.N_AVG_BLOCKS,
    mode: EstimatorMode = EstimatorMode.MATH,
) -> Cplx:
    """Sherman-Morrison MMSE (models/ps_mmse.py math) in split-complex.

    Rhh = ifft(H_LT)·ifft(H_LT)ᴴ is rank one, so Ryy = σ²I + u·uᴴ and the
    reference's 53×53 cofactor inverse (utils.c:141-170) reduces to dots.
    MATH mode uses the correct X4ᴴ in Rhy; MATLAB mode reproduces the X4
    slip of ..._PS_MMSE.m:30 (see config.EstimatorMode).

    v = F·ifft(H_LT) is *exactly* H_LT (F is the DFT the ifft inverts,
    ..._PS_MMSE.m:16-26), so no spectral transform is computed.
    """
    v = h_lt.astype(jnp.float32)

    tx = tx_blocks[..., :avg_blocks, :].astype(jnp.float32)
    rx = rx_blocks[..., :avg_blocks, :].astype(jnp.float32)
    vb = v[..., None, :]  # broadcast over blocks
    u = tx * vb
    denom = ow2[..., None] + u.abs2().sum(axis=-1)  # (…, avg) real
    urx = _vdot(u, rx)
    if mode == EstimatorMode.MATLAB:
        # general SM form with the X4 slip (cancels as σ²→0; parity only)
        upp = tx.conj() * vb
        s = (_vdot(upp, rx) - _vdot(upp, u) * (urx / denom)) / ow2[..., None]
    else:
        # MATH: stable collapsed form s = uᴴrx/(σ²+‖u‖²)
        s = Cplx(urx.re / denom, urx.im / denom)
    h = vb * Cplx(s.re[..., None], s.im[..., None])
    return h.mean(axis=-2)


def ps_mmse_dense(
    tx_blocks: Cplx,
    rx_blocks: Cplx,
    ow2: jnp.ndarray,
    h_lt: Cplx,
    avg_blocks: int = C.N_AVG_BLOCKS,
) -> Cplx:
    """MMSE via the dense build+solve (ops/linalg.rank1_solve) — the
    reference's computational shape (explicit regularized 53×53 Hermitian
    solve per block, main.c:201) kept as a benchmarkable path.
    Mathematically equal to ps_mmse_sm in MATH mode (s = uᴴ·Ryy⁻¹·rx with
    Ryy = σ²I + u·uᴴ)."""
    from tpu80211.ops.linalg import rank1_solve

    v = h_lt.astype(jnp.float32)  # = F·ifft(H_LT), see ps_mmse_sm
    tx = tx_blocks[..., :avg_blocks, :].astype(jnp.float32)
    rx = rx_blocks[..., :avg_blocks, :].astype(jnp.float32)
    vb = v[..., None, :]
    u = tx * vb
    ow2_b = jnp.broadcast_to(ow2[..., None], u.shape[:-1])
    z = rank1_solve(u, rx, ow2_b)
    s = _vdot(u, z)
    h = vb * Cplx(s.re[..., None], s.im[..., None])
    return h.mean(axis=-2)


def equalize(
    rx_blocks: Cplx, h_lt: Cplx, h_ps: Cplx, block_ids: jnp.ndarray = None
) -> Cplx:
    """Blended-CFR equalization (WiFi_Equalization.m:3-8); DC column zero.
    Output keeps rx_blocks' storage dtype (bf16 in, bf16 out).

    ``block_ids`` (0-based global block indices, one per local block) is
    for block-sharded callers where local index ≠ global index
    (parallel/mesh.py); the blend weight uses the global 1-based index
    over the full 15-block frame.  Out-of-range (pad) ids clamp to the
    final all-PS blend; their output is discarded by the caller."""
    out_dtype = rx_blocks.dtype
    rx_blocks = rx_blocks.astype(jnp.float32)
    h_lt = h_lt.astype(jnp.float32)
    h_ps = h_ps.astype(jnp.float32)
    if block_ids is None:
        n = rx_blocks.shape[-2]
        i = jnp.arange(1, n + 1, dtype=jnp.float32)[:, None]
    else:
        n = C.N_BLOCKS
        i = jnp.minimum(block_ids + 1, n).astype(jnp.float32)[:, None]
    w_lt = (n - i) / n
    w_ps = i / n
    h_util = Cplx(
        w_lt * h_lt.re[..., None, :] + w_ps * h_ps.re[..., None, :],
        w_lt * h_lt.im[..., None, :] + w_ps * h_ps.im[..., None, :],
    )
    safe = Cplx(
        jnp.where(_DC, jnp.ones((), h_util.re.dtype), h_util.re),
        jnp.where(_DC, jnp.zeros((), h_util.im.dtype), h_util.im),
    )
    eq = rx_blocks / safe
    zero = jnp.zeros((), eq.re.dtype)
    eq = Cplx(jnp.where(_DC, zero, eq.re), jnp.where(_DC, zero, eq.im))
    return eq.astype(out_dtype)


# -- full chain ----------------------------------------------------------------


class RxOutputs(NamedTuple):
    """Per-frame outputs of the full RX chain (all Cplx except ow2)."""

    h_lt: Cplx       # (…, 53) LT-LS estimate
    h_linear: Cplx   # (…, 53)
    h_cubic: Cplx    # (…, 53)
    h_sinc: Cplx     # (…, 53)
    h_spline: Cplx   # (…, 53)
    h_wiener: Cplx   # (…, 53) MMSE-optimal pilot interpolation (beyond ref)
    h_mmse: Cplx     # (…, 53)
    eq: Cplx         # (…, 15, 53) equalized symbols (PS-Linear-blended)
    ow2: jnp.ndarray  # (…,) estimated noise power


def rx_chain(
    tx_packet: Cplx,   # (…, 1200)
    rx_packet: Cplx,   # (…, 1200)
    tx_lptot: Cplx,    # (…, 160)
    rx_lptot: Cplx,    # (…, 160)
    avg_blocks: int = C.N_AVG_BLOCKS,
    equalize_with: str = "h_linear",
    sync: bool = False,
) -> RxOutputs:
    """The full WiFi_RX.m chain, batched: time-domain samples → estimates →
    equalized symbols.  Pure function of its inputs; jit/vmap/shard-ready.

    ``equalize_with`` names the PS estimate blended into the equalizer CFR;
    the golden model fixes PS-Linear (WiFi_RX.m:60).

    ``sync=True`` enables the synchronization stages the reference lacks
    (ops/cfo.py): Moose CFO correction from the LTS repeats before the
    front end, and per-block pilot CPE correction after equalization.  Off
    by default — the reference-parity chain runs uncorrected, as the
    reference does (its capture carries 20 kHz of CFO, WiFi_RX.m:9)."""
    if sync:
        from tpu80211.ops import cfo as cfo_ops

        rx_packet, rx_lptot, _ = cfo_ops.correct_cfo(rx_packet, rx_lptot)
    tx_pre = preamble_fft(tx_lptot)
    rx_pre = preamble_fft(rx_lptot)
    ow2 = noise_power(rx_lptot)
    tx_blocks = extract_blocks(tx_packet)
    rx_blocks = extract_blocks(rx_packet)
    out = rx_chain_freq(
        tx_pre, rx_pre, tx_blocks, rx_blocks, ow2,
        avg_blocks=avg_blocks, equalize_with=equalize_with,
    )
    if sync:
        out = out._replace(eq=cfo_ops.cpe_correct(out.eq, tx_blocks))
    return out


def rx_chain_freq(
    tx_pre: Cplx,      # (…, 53)
    rx_pre: Cplx,      # (…, 53)
    tx_blocks: Cplx,   # (…, 15, 53)
    rx_blocks: Cplx,   # (…, 15, 53)
    ow2: jnp.ndarray,  # (…,)
    avg_blocks: int = C.N_AVG_BLOCKS,
    equalize_with: str = "h_linear",
    wiener_model: str | None = None,
    wiener_snr_db: float | None = None,
) -> RxOutputs:
    """Frequency-domain entry (the C drivers' view, inputs.h:20-928):
    skips the front end, runs estimators + equalization.  Semantics are
    MATH-mode (sc implements MATH + MATLAB via ps_mmse_sm's mode arg);
    ``equalize_with`` defaults to the golden model's PS-Linear
    (WiFi_RX.m:60).  ``wiener_model``/``wiener_snr_db``: the Wiener
    estimator's channel prior (ops/interp.py::wiener_matrix_for;
    defaults = the legacy prior)."""
    h_lt = lt_ls(tx_pre, rx_pre)
    h_lin = ps_interp(tx_blocks, rx_blocks, "linear", avg_blocks=avg_blocks)
    h_cub = ps_interp(tx_blocks, rx_blocks, "cubic", avg_blocks=avg_blocks)
    h_sin = ps_interp(tx_blocks, rx_blocks, "sinc", avg_blocks=avg_blocks)
    h_spl = ps_interp(tx_blocks, rx_blocks, "spline", avg_blocks=avg_blocks)
    h_wie = ps_interp(tx_blocks, rx_blocks, "wiener", avg_blocks=avg_blocks,
                      channel_model=wiener_model, snr_db=wiener_snr_db)
    h_mmse = ps_mmse_sm(tx_blocks, rx_blocks, ow2, h_lt, avg_blocks=avg_blocks)
    h_ps = {
        "h_linear": h_lin, "h_cubic": h_cub, "h_sinc": h_sin,
        "h_spline": h_spl, "h_wiener": h_wie, "h_mmse": h_mmse,
    }[equalize_with]
    eq = equalize(rx_blocks, h_lt, h_ps)
    return RxOutputs(h_lt, h_lin, h_cub, h_sin, h_spl, h_wie, h_mmse, eq, ow2)
