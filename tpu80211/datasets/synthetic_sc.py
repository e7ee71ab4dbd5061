"""Device-resident split-complex frame generator — streaming at device rate.

A generator that crosses the host→device boundary per frame caps the
stream at host speed.  This module synthesizes the rx side of a frame
stream *on the device itself*, in the lane-major split-complex layout
the lane-major chain entries consume (pipeline/lane.py) — so a
streamed step is

    seed → [generate on device] → [RX chain] → summaries

with zero per-frame host traffic.  The stream is the tx-constant
production shape: every frame carries the same known transmit packet
(like the reference's own replayed frame, inputs.h), and per frame a
fresh channel + noise:

  * channel: exponential-PDP FIR taps (channel-model-'A'-like,
    WiFi_RX.m:6; same PDP as datasets/synthetic.py), CFR = W @ taps with
    a constant (53, 8) evaluation matrix;
  * rx block spectra: tx_spectrum · H (per block);
  * time-domain synthesis: one constant (64, 53) IDFT matrix per block
    (the exact right-inverse of the extraction matrix, cf.
    synthetic.synthesize_time) — matmuls;
  * AWGN added in the TIME domain (variance σ_t² per complex sample) —
    matching how the reference capture was impaired (WiFi_RX.m:4-9, noise
    on samples) and making the chain's σ̂² repeat-difference estimator
    (WiFi_RX.m:31) read back exactly σ_t².  ``snr_db`` sets
    σ_t² = 10^(−snr/10)/64, i.e. per-used-bin Es/N0 ≈ snr_db for
    unit-power bins.

All randomness is jax.random on-device; deterministic per (key); shapes
static.  Returns lane-major Cplx: packets (1200, B), preambles (160, B).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.cplx import Cplx, matmul
from tpu80211.ops import specmats

N_TAPS = 8
RMS_SPREAD = 2.0


@functools.lru_cache(maxsize=None)
def _synth_mats(n_taps: int = N_TAPS):
    """Constant matrices: IDFT (64, 53) right-inverse of the extraction
    matrix, and the taps→CFR evaluation matrix (n_taps, 53).

    Cached as NUMPY — callers jnp.asarray at use so nothing traced is
    ever cached (an lru-cached jnp array created inside a jit trace leaks
    that trace's tracer into later calls)."""
    wre, wim = specmats.block_dft()          # (64, 53): spec = Wᵀ @ time
    # time = (1/64)·conj(W) @ spec  (WᵀA = 64·δ — see synthetic.synthesize_time)
    a_re = np.asarray(wre, np.float32) / C.N_FFT
    a_im = -np.asarray(wim, np.float32) / C.N_FFT
    # CFR on the shifted 53-bin grid from n_taps FIR taps
    k = (np.arange(C.N_SC) - C.FFT_SHIFT) % C.N_FFT
    n = np.arange(n_taps)
    w = np.exp(-2j * np.pi * np.outer(n, k) / C.N_FFT)  # (taps, 53)
    return (
        a_re, a_im,
        np.ascontiguousarray(w.real, np.float32),
        np.ascontiguousarray(w.imag, np.float32),
    )


def _idft_cols(spec: Cplx) -> Cplx:
    """(53, B) spectrum → (64, B) time samples (one OFDM symbol)."""
    a_re, a_im, _, _ = map(jnp.asarray, _synth_mats())
    return matmul(Cplx(a_re, a_im), spec)


def channel_cfr(key, batch: int, channel_model: str | None = None) -> Cplx:
    """(53, B) per-frame CFR from exponential-PDP taps (lane-major).
    ``channel_model`` ∈ {None, 'A'..'E'} (ops/channel.py)."""
    from tpu80211.ops import channel

    p = channel.pdp(channel_model)
    _, _, w_re, w_im = map(jnp.asarray, _synth_mats(p.size))
    scale = jnp.asarray(np.sqrt(p / 2.0), jnp.float32)[:, None]
    kr, ki = jax.random.split(key)
    t_re = jax.random.normal(kr, (p.size, batch), jnp.float32) * scale
    t_im = jax.random.normal(ki, (p.size, batch), jnp.float32) * scale
    return matmul(Cplx(w_re.T, w_im.T), Cplx(t_re, t_im))


def generate_rx_lane_major(
    key, batch: int, txs: Cplx, tpre: Cplx,
    snr_db: float = 20.0, dtype=jnp.bfloat16,
    channel_model: str | None = None,
    noise: bool = True,
):
    """Synthesize one lane-major rx batch through a fresh channel.

    txs: (53, 15) tx block spectra, tpre: (53, 1) — the precomputed
    constants from pipeline.lane.tx_spectra.
    ``channel_model`` ∈ {None, 'A'..'E'} (ops/channel.py).
    Returns (rx_pkt (1200, B) Cplx, rx_lp (160, B) Cplx, h (53, B) Cplx)
    with packet/preamble planes in ``dtype`` storage and h in f32.
    ``noise=False`` returns the clean channel-filtered frame (the raw
    stream generator adds noise over the whole stream instead).
    """
    k_ch, k_np, k_nl = jax.random.split(key, 3)
    h = channel_cfr(k_ch, batch, channel_model)        # (53, B) f32

    sigma_t2 = (10.0 ** (-snr_db / 10.0)) / C.N_FFT
    nscale = np.sqrt(sigma_t2 / 2.0)

    def _noise(k, shape):
        # generate + scale in f32, store in the packet dtype — noise at
        # bf16 precision is still noise; halving the HBM footprint of
        # these (1200+160, B) tensors is what matters at stream rate
        kr, ki = jax.random.split(k)
        return Cplx(
            (jax.random.normal(kr, shape, jnp.float32) * nscale).astype(dtype),
            (jax.random.normal(ki, shape, jnp.float32) * nscale).astype(dtype),
        )

    # data blocks: spec_b = txs[:, b]·H → time (64, B) → [CP | 64];
    # pieces drop to storage dtype immediately so every (1200, B)
    # intermediate (concat, add) moves dtype-sized bytes, not f32
    pieces = []
    for b in range(C.N_BLOCKS):
        spec = Cplx(txs.re[:, b:b + 1], txs.im[:, b:b + 1]) * h
        t = _idft_cols(spec).astype(dtype)
        pieces.append(Cplx(t.re[-C.N_CP:], t.im[-C.N_CP:]))
        pieces.append(t)
    pkt = Cplx(
        jnp.concatenate([p.re for p in pieces], axis=0),
        jnp.concatenate([p.im for p in pieces], axis=0),
    )
    if noise:
        pkt = pkt + _noise(k_np, (C.PACKET_SAMPLES, batch))

    # long preamble: LTS·H → 64-sample symbol, layout [last 32 | rep | rep]
    # (synthetic.synthesize_preamble_time), independent noise per sample —
    # the repeat difference reads back exactly σ_t² in expectation
    t64 = _idft_cols(Cplx(tpre.re, tpre.im) * h).astype(dtype)
    lp = Cplx(
        jnp.concatenate([t64.re[-32:], t64.re, t64.re], axis=0),
        jnp.concatenate([t64.im[-32:], t64.im, t64.im], axis=0),
    )
    if noise:
        lp = lp + _noise(k_nl, (C.PREAMBLE_SAMPLES, batch))

    return pkt.astype(dtype), lp.astype(dtype), h


def generate_raw_lane_major(
    key, batch: int, txs: Cplx, tpre: Cplx,
    ns: int = 2048, snr_db: float = 20.0, dtype=jnp.bfloat16,
    channel_model: str | None = None,
    min_off: int = 40,
):
    """Synthesize lane-major RAW sample streams: each stream is ``ns``
    samples of AWGN carrying one channel-filtered frame (preamble +
    packet) at a per-stream random offset — the workload of the raw
    receiver (pipeline/raw.py), generated entirely on device.

    The frame is assembled at offset 0 and moved to its per-stream
    offset by one gather (ops/detect.place_streams).  Noise covers the
    full stream, so σ̂², detection normalization, and the noise floor
    behave exactly as on a real capture.

    Returns (x (ns, B) Cplx in ``dtype``, h (53, B) Cplx f32,
    offsets (B,) int32)."""
    total = C.PREAMBLE_SAMPLES + C.PACKET_SAMPLES
    if ns <= total + min_off:
        raise ValueError(
            f"ns={ns} leaves no room for a {total}-sample frame after the "
            f"{min_off}-sample minimum offset")
    k_f, k_o, k_nr, k_ni = jax.random.split(key, 4)
    pkt, lp, h = generate_rx_lane_major(
        k_f, batch, txs, tpre, snr_db=snr_db, dtype=dtype,
        channel_model=channel_model, noise=False,
    )
    sig = Cplx(
        jnp.concatenate(
            [lp.re, pkt.re, jnp.zeros((ns - total, batch), dtype)], axis=0),
        jnp.concatenate(
            [lp.im, pkt.im, jnp.zeros((ns - total, batch), dtype)], axis=0),
    )
    offs = jax.random.randint(k_o, (batch,), min_off, ns - total,
                              dtype=jnp.int32)

    sigma_t2 = (10.0 ** (-snr_db / 10.0)) / C.N_FFT
    nscale = np.sqrt(sigma_t2 / 2.0)

    def noise(k):
        return (jax.random.normal(k, (ns, batch), jnp.float32)
                * nscale).astype(dtype)

    from tpu80211.ops.detect import place_streams

    x = place_streams(sig, Cplx(noise(k_nr), noise(k_ni)), offs)
    return x, h, offs
