"""Raw-sample-stream receiver: detect → extract → full chain, on device.

The complete system the reference's WiFi_RX.m promises (threshold
detection, WiFi_RX.m:7) but never composes: raw ADC-style sample streams
in, channel estimates + equalized symbols out.  Every stage is
device-resident and lane-major (NS, B):

  1. ``ops/detect.detect_and_align`` — Schmidl&Cox coarse detection
     (stride-decimated), LTS matched-filter fine timing with a 4-sample
     advance, and one gather that extracts each stream's 1360 samples;
  2. ``pipeline/lane.rx_chain_txconst`` — the 7-estimator chain.

Undetected streams are processed at offset 0 (static shapes — XLA
cannot skip them) and flagged: gate on ``detected`` before consuming
the estimates.

``gen_raw_system`` is the generative raw system: streams synthesized on
device (datasets/synthetic_sc.generate_raw_lane_major, optionally with a
per-stream CFO) and fed to this receiver.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.cplx import Cplx
from tpu80211.ops.detect import DEFAULT_THRESHOLD, detect_and_align
from tpu80211.pipeline.lane import rx_chain_txconst

# |H|² below this on a used bin is a deep fade: the equalizer divides the
# null out, and that stream's EVM then says nothing of the receiver
FADE_FLOOR = 1e-3


def _evm_sums(eq: Cplx, txs: Cplx) -> jnp.ndarray:
    """Per-stream Σ|eq − tx|² over blocks and bins, (B,)."""
    txb_r = txs.re[:, :C.N_BLOCKS].T[:, :, None]
    txb_i = txs.im[:, :C.N_BLOCKS].T[:, :, None]
    d_re = eq.re.astype(jnp.float32) - txb_r
    d_im = eq.im.astype(jnp.float32) - txb_i
    return jnp.sum(d_re * d_re + d_im * d_im, axis=(0, 1))


def raw_rx_txconst(x: Cplx, lts_ref: Cplx, txs: Cplx, tpre: Cplx,
                   threshold: float | None = None, eps=0.0,
                   serve: bool = False, sync: bool = False,
                   search: int = 192, advance: int = 4,
                   wiener_model: str | None = None,
                   wiener_snr_db: float | None = None,
                   equalize_with: str = "h_linear", lsb=1.0,
                   stream_sums: bool = False, stride: int = 16) -> dict:
    """Full raw-stream receiver for a lane-major (NS, B) stream batch.

    ``lts_ref``: (64,) known time-domain LTS (the matched-filter
    reference); ``txs``/``tpre``: the tx-constant spectra
    (pipeline/lane.tx_spectra).  Returns rx_chain_txconst's output dict
    plus ``detected``/``start``/``metric`` rows from the detector.

    ``x`` may carry int8 ADC words with ``lsb`` their scale (detection
    is scale-free; the LSB applies in the chain).  ``eps`` is the
    benchmark's serialization hook, applied to the chain's rx side.
    ``stream_sums=True`` is the streaming configuration: ``evm_sums``
    (B,) holds per-stream Σ|eq − tx|² and ``eq`` is None.  ``stride``:
    coarse Schmidl&Cox decimation (ops/detect.detect_packet) — the fine
    timing stays full-resolution."""
    thr = DEFAULT_THRESHOLD if threshold is None else threshold
    det, lp, pkt = detect_and_align(x, lts_ref, threshold=thr,
                                    search=search, advance=advance,
                                    stride=stride)
    out = rx_chain_txconst(txs, tpre, pkt, lp, eps=eps, serve=serve,
                           sync=sync, wiener_model=wiener_model,
                           wiener_snr_db=wiener_snr_db, lsb=lsb,
                           equalize_with=equalize_with)
    if stream_sums:
        out["evm_sums"] = _evm_sums(out["eq"], txs)
        out["eq"] = None
    out["detected"] = det["detected"]
    out["start"] = det["start"]
    out["metric"] = det["metric"]
    return out


def gen_raw_system(seed, batch: int, txs: Cplx, tpre: Cplx,
                   lts_ref: Cplx, ns: int = 2048, snr_db: float = 20.0,
                   dtype=jnp.float32, channel_model: str | None = None,
                   threshold: float = DEFAULT_THRESHOLD,
                   equalize_with: str = "h_linear",
                   cfo_khz: float = 0.0, stride: int = 16) -> dict:
    """Synthesize one batch of raw streams on device and receive it.

    Each stream is ``ns`` samples of AWGN carrying one frame through a
    fresh channel at a random offset; with ``cfo_khz`` > 0 each stream
    also carries a carrier-frequency offset uniform in ±cfo_khz (the
    impairment of the reference capture, WiFi_RX.m:9), recovered by the
    chain's CFO + CPE stages (sync=True).  ``dtype`` is the streams'
    sample storage.

    Returns the receiver's serving outputs (stream_sums configuration):
    detected (B,) bool, start/offsets (B,) int32, metric, h_true (53, B)
    Cplx, h_wiener/h_mmse (53, B) Cplx, evm_sums (B,), ow2/cfo/checksum
    (B,), cfo_true (B,) cycles/sample.  Deterministic per seed."""
    from tpu80211.datasets import synthetic_sc

    key = jax.random.fold_in(jax.random.PRNGKey(1234),
                             jnp.asarray(seed, jnp.int32))
    x, h, offs = synthetic_sc.generate_raw_lane_major(
        key, batch, txs, tpre, ns=ns, snr_db=snr_db, dtype=dtype,
        channel_model=channel_model)
    if cfo_khz > 0.0:
        f = cfo_khz * 1e3 / 20e6
        eps_true = jax.random.uniform(jax.random.fold_in(key, 77), (batch,),
                                      jnp.float32, minval=-f, maxval=f)
        ang = (2.0 * np.pi * eps_true[None, :]
               * jnp.arange(ns, dtype=jnp.float32)[:, None])
        cr_, ci_ = jnp.cos(ang), jnp.sin(ang)
        x = Cplx(x.re * cr_ - x.im * ci_,
                 x.re * ci_ + x.im * cr_).astype(dtype)
    else:
        eps_true = jnp.zeros((batch,), jnp.float32)
    out = raw_rx_txconst(x, lts_ref, txs, tpre, threshold=threshold,
                         serve=True, sync=cfo_khz > 0.0,
                         equalize_with=equalize_with, stream_sums=True,
                         stride=stride)
    out["offsets"] = offs
    out["h_true"] = h
    out["cfo_true"] = eps_true
    return out


def evm_stats(out: dict, txs: Cplx) -> dict:
    """Per-stream EVM of a ``gen_raw_system`` result over its detected
    streams, on the host: ``mean``, batch ``rms``, ``worst``, and
    ``rms_no_deep_fade`` — the RMS over the streams whose true channel
    keeps |H|² ≥ FADE_FLOOR on every used bin (``kept``: their share)."""
    den = float(np.sum(np.asarray(txs.re[:, :C.N_BLOCKS]) ** 2
                       + np.asarray(txs.im[:, :C.N_BLOCKS]) ** 2))
    det = np.asarray(out["detected"])
    e2 = np.asarray(out["evm_sums"]) / den
    used = np.arange(C.N_SC) != C.DC_IDX
    h2 = np.asarray(out["h_true"].abs2())[used]
    keep = det & (h2.min(axis=0) >= FADE_FLOOR)
    return {"mean": float(np.sqrt(e2[det]).mean()),
            "rms": float(np.sqrt(e2[det].mean())),
            "worst": float(np.sqrt(e2[det].max())),
            "rms_no_deep_fade": float(np.sqrt(e2[keep].mean())),
            "kept": float(keep.mean())}
